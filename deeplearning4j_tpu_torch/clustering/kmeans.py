"""KMeans clustering, Lloyd iterations on the card.

Counterpart of the JAX package's ``clustering/kmeans.py`` (reference
``clustering/kmeans/KMeansClustering.java`` +
``clustering/algorithm/BaseClusteringAlgorithm.java``): one Lloyd step is
an assignment product, an ``argmin`` (the first minimum, as the
reference's) and a recentring product ``one_hot.T @ points``; the loop
reads the step's cost on the host every iteration for its stopping test,
the reference's convergence rule. k-means++ seeding draws from the
reference's numpy generator with weights from the device's distances.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import resolve_device

from .bruteforce import as_tensor, pairwise_distance
from .cluster import ClusterSet, Point


def _lloyd_step(points: torch.Tensor, centers: torch.Tensor, k: int,
                distance: str):
    """One assignment + recenter step. Returns (new_centers, assignment,
    total within-cluster distance), all on the points' device."""
    d = pairwise_distance(points, centers, distance)        # (N, k)
    assign = torch.argmin(d, dim=1)                          # (N,)
    cost = torch.sum(torch.amin(d, dim=1))
    one_hot = F.one_hot(assign, k).to(points.dtype)          # (N, k)
    counts = one_hot.sum(dim=0)                              # (k,)
    sums = one_hot.T @ points                                # (k, D)
    new_centers = sums / torch.clamp(counts, min=1.0)[:, None]
    # keep empty clusters where they were (reference re-seeds via strategy)
    new_centers = torch.where((counts > 0)[:, None], new_centers, centers)
    return new_centers, assign, cost


class KMeansClustering:
    """``KMeansClustering.setup(k, maxIter, distance)`` parity surface.

    ``setup(k, max_iter, distance)`` → instance; ``apply_to(points)`` →
    :class:`ClusterSet`. Convergence: relative cost improvement below
    ``min_distribution_variation`` (reference ``VarianceVariationCondition``)
    or ``max_iter`` sweeps (``FixedIterationCountCondition``). The points
    go to the card unless ``device="cpu"``.
    """

    def __init__(self, k: int, max_iter: int = 100,
                 distance: str = "euclidean",
                 min_distribution_variation: float = 1e-4,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.k = int(k)
        self.max_iter = max(1, int(max_iter))  # one Lloyd sweep minimum:
        # fit() must always produce assignments
        self.distance = distance
        self.min_distribution_variation = float(min_distribution_variation)
        self.seed = seed
        self.iteration_costs: List[float] = []
        self.seed_indices: List[int] = []
        self._assign = None

    @property
    def assignments(self) -> np.ndarray:
        """Per-point cluster ids from the last ``fit`` sweep."""
        if self._assign is None:
            raise ValueError("call fit() before reading assignments")
        return self._assign

    @classmethod
    def setup(cls, cluster_count: int, max_iteration_count: int = 100,
              distance: str = "euclidean", **kw) -> "KMeansClustering":
        return cls(cluster_count, max_iteration_count, distance, **kw)

    # -- core ---------------------------------------------------------------
    def fit(self, matrix) -> np.ndarray:
        """Run Lloyd's algorithm; returns the (k, D) centers."""
        pts = as_tensor(matrix, self.device)
        n = pts.shape[0]
        if n < self.k:
            raise ValueError(f"need >= k={self.k} points, got {n}")
        self.seed_indices = self._seed(pts)
        return self.iterate(pts, pts[self.seed_indices])

    def _seed(self, pts: torch.Tensor) -> List[int]:
        """k-means++ seeding: random first center, then sample proportional
        to SQUARED distance in the chosen metric (sqeuclidean is already
        squared). 'dot' is not a metric (negative = similar) so it seeds by
        uniform draws over not-yet-chosen indices without computing
        distances at all."""
        n = pts.shape[0]
        rng = np.random.default_rng(self.seed)
        chosen = [int(rng.integers(0, n))]
        d_min = None
        for _ in range(1, self.k):
            w = None
            if self.distance != "dot":
                d = pairwise_distance(pts, pts[chosen[-1]][None, :],
                                      self.distance)[:, 0].cpu().numpy()
                d_min = d if d_min is None else np.minimum(d_min, d)
                w = (np.maximum(d_min, 0.0) if self.distance == "sqeuclidean"
                     else np.maximum(d_min, 0.0) ** 2)
            if w is not None and w.sum() > 0:
                chosen.append(int(rng.choice(n, p=w / w.sum())))
            else:  # 'dot', or a duplicates-only remainder
                # free is never empty: len(chosen) < k <= n
                free = np.setdiff1d(np.arange(n), chosen)
                chosen.append(int(rng.choice(free)))
        return chosen

    def iterate(self, pts: torch.Tensor, centers: torch.Tensor) -> np.ndarray:
        """Lloyd steps from ``centers`` until the cost stops moving or
        ``max_iter``; returns the centers on the host."""
        c = centers
        self.iteration_costs = []
        prev_cost = None
        for _ in range(self.max_iter):
            c, assign, cost = _lloyd_step(pts, c, self.k, self.distance)
            cost = float(cost)
            self.iteration_costs.append(cost)
            if prev_cost is not None:
                denom = max(abs(prev_cost), 1e-12)
                if abs(prev_cost - cost) / denom < self.min_distribution_variation:
                    break
            prev_cost = cost
        self._assign = assign.cpu().numpy()
        return c.cpu().numpy()

    def apply_to(self, points: List[Point]) -> ClusterSet:
        """Reference entry point: points → ClusterSet with members placed."""
        matrix = np.stack([p.array for p in points])
        centers = self.fit(matrix)
        cs = ClusterSet(self.distance)
        clusters = [cs.add_new_cluster_with_center(c) for c in centers]
        for p, a in zip(points, self._assign):
            clusters[int(a)].add_point(p)
        cs.remove_empty_clusters()
        return cs

    applyTo = apply_to  # reference-style alias
