"""Vantage-point tree (parity: ``clustering/vptree/VPTree.java:48``,
``VPTreeFillSearch.java``).

Host-side metric tree with tau pruning for single/low-volume queries on CPU.
For batched queries prefer :class:`~.bruteforce.BruteForceNearestNeighbors`
(one MXU matmul replaces the whole traversal). The two are equivalence-tested
against each other, mirroring the reference's cuDNN-vs-builtin validation
pattern.

The port's copy of the JAX package's jax-free ``clustering/vptree.py``: the
same tree, search and fill search (host numpy).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


def _dist(a: np.ndarray, b: np.ndarray, distance: str) -> np.ndarray:
    """Distance from one point ``a`` (D,) to rows of ``b`` (N, D) -> (N,)."""
    b = np.atleast_2d(b)
    if distance in ("euclidean", "sqeuclidean"):
        d = np.sum((b - a) ** 2, axis=-1)
        return d if distance == "sqeuclidean" else np.sqrt(d)
    if distance == "cosine":
        an = a / (np.linalg.norm(a) + 1e-12)
        bn = b / (np.linalg.norm(b, axis=-1, keepdims=True) + 1e-12)
        return 1.0 - bn @ an
    if distance == "manhattan":
        return np.sum(np.abs(b - a), axis=-1)
    if distance == "chebyshev":
        return np.max(np.abs(b - a), axis=-1)
    if distance == "dot":
        return -(b @ a)
    raise ValueError(f"unsupported distance {distance!r}")


@dataclass
class _Node:
    index: int
    threshold: float = 0.0
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None


class VPTree:
    """``VPTree(items, distance)`` then ``search(target, k)``.

    Build: recursive random vantage point + median-of-distances split
    (the reference's parallel build becomes a vectorized distance sweep).
    """

    def __init__(self, items, distance: str = "euclidean",
                 labels: Optional[List[str]] = None, seed: int = 0):
        self.items = np.asarray(items, np.float32)
        self.distance = distance
        self.labels = labels
        self._rng = np.random.default_rng(seed)
        idx = list(range(len(self.items)))
        self.root = self._build(idx)

    def _build(self, idx: List[int]) -> Optional[_Node]:
        if not idx:
            return None
        pos = int(self._rng.integers(0, len(idx)))
        idx[0], idx[pos] = idx[pos], idx[0]
        vp = idx[0]
        rest = idx[1:]
        node = _Node(vp)
        if rest:
            d = _dist(self.items[vp], self.items[rest], self.distance)
            median = float(np.median(d))
            node.threshold = median
            inside = [r for r, dd in zip(rest, d) if dd < median]
            outside = [r for r, dd in zip(rest, d) if dd >= median]
            if not inside or not outside:  # degenerate (duplicates): split evenly
                mid = len(rest) // 2
                inside, outside = rest[:mid], rest[mid:]
            node.left = self._build(inside)
            node.right = self._build(outside)
        return node

    def search(self, target, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """k nearest items to ``target``: ``(distances, indices)`` sorted
        ascending (VPTree.java ``search(INDArray, int, List, List)``)."""
        target = np.asarray(target, np.float32)
        k = min(int(k), len(self.items))
        heap: List[Tuple[float, int]] = []  # max-heap via negated distance
        tau = [np.inf]

        def visit(node: Optional[_Node]):
            if node is None:
                return
            d = float(_dist(target, self.items[node.index][None, :],
                            self.distance)[0])
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif d < tau[0]:
                heapq.heapreplace(heap, (-d, node.index))
                tau[0] = -heap[0][0]
            if node.left is None and node.right is None:
                return
            if d < node.threshold:
                visit(node.left)
                if d + tau[0] >= node.threshold:
                    visit(node.right)
            else:
                visit(node.right)
                if d - tau[0] <= node.threshold:
                    visit(node.left)

        visit(self.root)
        pairs = sorted((-nd, i) for nd, i in heap)
        return (np.array([p[0] for p in pairs], np.float32),
                np.array([p[1] for p in pairs], np.int64))


class VPTreeFillSearch:
    """Search that always returns exactly k results
    (``VPTreeFillSearch.java`` — falls back to a full scan when the tree
    search under-fills)."""

    def __init__(self, tree: VPTree, k: int, target):
        self.tree = tree
        self.k = int(k)
        self.target = np.asarray(target, np.float32)
        self.results: Optional[np.ndarray] = None
        self.distances: Optional[np.ndarray] = None

    def run(self) -> None:
        d, i = self.tree.search(self.target, self.k)
        if len(i) < self.k:  # fill from full scan
            full = _dist(self.target, self.tree.items, self.tree.distance)
            order = np.argsort(full)[: self.k]
            d, i = full[order].astype(np.float32), order.astype(np.int64)
        self.distances, self.results = d, i
