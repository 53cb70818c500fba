"""Nearest neighbors + clustering (TPU-native).

Parity target: reference ``deeplearning4j-nearestneighbors-parent/
nearestneighbor-core`` (VPTree.java:48, KDTree.java:37, KMeansClustering.java,
lsh/RandomProjectionLSH.java, sptree/SpTree.java, quadtree/QuadTree.java).

Design: the TPU-native fast path is :mod:`bruteforce` — batched pairwise
distances on the MXU with ``lax.top_k`` — which on accelerators beats
pointer-chasing trees for any corpus that fits in HBM. The tree structures
(VPTree, KDTree, SPTree) are kept as host-side structures for API parity,
pruning-based search on CPU, and Barnes-Hut t-SNE support.

The port's counterpart of the JAX package's ``clustering/``: brute force,
k-means and LSH run their products on the card (torch), the trees are the
reference's host code.
"""

from .bruteforce import BruteForceNearestNeighbors, pairwise_distance, knn
from .cluster import Cluster, ClusterSet, Point, PointClassification
from .kdtree import HyperRect, KDTree
from .kmeans import KMeansClustering
from .lsh import RandomProjectionLSH
from .sptree import SpTree
from .quadtree import QuadTree
from .vptree import VPTree, VPTreeFillSearch

__all__ = [
    "BruteForceNearestNeighbors", "pairwise_distance", "knn",
    "Cluster", "ClusterSet", "Point", "PointClassification",
    "HyperRect", "KDTree", "KMeansClustering", "RandomProjectionLSH",
    "SpTree", "QuadTree", "VPTree", "VPTreeFillSearch",
]
