"""KD-tree (parity: ``clustering/kdtree/KDTree.java:37`` +
``HyperRect.java``): insert / delete / nn / knn / range queries.

Host-side structure — incremental insert/delete has no jit analog and the
batch path is :mod:`bruteforce`.

The port's copy of the JAX package's jax-free ``clustering/kdtree.py``: the
same tree and queries (host numpy).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


class HyperRect:
    """Axis-aligned box with min-distance and contains tests
    (``HyperRect.java``)."""

    def __init__(self, lower: np.ndarray, upper: np.ndarray):
        self.lower = np.asarray(lower, np.float64)
        self.upper = np.asarray(upper, np.float64)

    @classmethod
    def infinite(cls, dims: int) -> "HyperRect":
        return cls(np.full(dims, -np.inf), np.full(dims, np.inf))

    def contains(self, point: np.ndarray) -> bool:
        return bool(np.all(point >= self.lower) and np.all(point <= self.upper))

    def min_distance(self, point: np.ndarray) -> float:
        clipped = np.clip(point, self.lower, self.upper)
        return float(np.sqrt(np.sum((point - clipped) ** 2)))

    def get_lower_half(self, dim: int, split: float) -> "HyperRect":
        u = self.upper.copy(); u[dim] = split
        return HyperRect(self.lower, u)

    def get_upper_half(self, dim: int, split: float) -> "HyperRect":
        l = self.lower.copy(); l[dim] = split
        return HyperRect(l, self.upper)


@dataclass
class _KDNode:
    point: np.ndarray
    left: Optional["_KDNode"] = None
    right: Optional["_KDNode"] = None


class KDTree:
    """Incremental KD-tree over ``dims`` dimensions (``KDTree.java:37``)."""

    def __init__(self, dims: int):
        self.dims = int(dims)
        self.root: Optional[_KDNode] = None
        self.size = 0

    def insert(self, point) -> None:
        point = np.asarray(point, np.float64).reshape(self.dims)
        self.size += 1
        if self.root is None:
            self.root = _KDNode(point)
            return
        node, depth = self.root, 0
        while True:
            dim = depth % self.dims
            if point[dim] < node.point[dim]:
                if node.left is None:
                    node.left = _KDNode(point); return
                node = node.left
            else:
                if node.right is None:
                    node.right = _KDNode(point); return
                node = node.right
            depth += 1

    def delete(self, point) -> bool:
        """Remove one node equal to ``point`` (rebuilds the subtree below
        it — simpler than the classic successor dance, same result)."""
        point = np.asarray(point, np.float64).reshape(self.dims)
        collected: List[np.ndarray] = []
        found = [False]

        def collect(n: Optional[_KDNode]):
            if n is None:
                return
            if not found[0] and np.array_equal(n.point, point):
                found[0] = True
            else:
                collected.append(n.point)
            collect(n.left); collect(n.right)

        collect(self.root)
        if not found[0]:
            return False
        self.root, self.size = None, 0
        for p in collected:
            self.insert(p)
        return True

    def nn(self, point) -> Tuple[float, Optional[np.ndarray]]:
        d, pts = self.knn(point, 1)
        return (d[0], pts[0]) if pts else (np.inf, None)

    def knn(self, point, k: int) -> Tuple[List[float], List[np.ndarray]]:
        point = np.asarray(point, np.float64).reshape(self.dims)
        heap: List[Tuple[float, int, np.ndarray]] = []
        counter = [0]

        def visit(node: Optional[_KDNode], depth: int):
            if node is None:
                return
            d = float(np.sqrt(np.sum((node.point - point) ** 2)))
            if len(heap) < k:
                heapq.heappush(heap, (-d, counter[0], node.point)); counter[0] += 1
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, counter[0], node.point)); counter[0] += 1
            dim = depth % self.dims
            diff = point[dim] - node.point[dim]
            near, far = (node.left, node.right) if diff < 0 else (node.right, node.left)
            visit(near, depth + 1)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                visit(far, depth + 1)

        visit(self.root, 0)
        pairs = sorted(((-nd, p) for nd, _, p in heap), key=lambda t: t[0])
        return [p[0] for p in pairs], [p[1] for p in pairs]

    def range(self, lower, upper) -> List[np.ndarray]:
        """All points inside the box (``KDTree.java`` range search)."""
        rect = HyperRect(lower, upper)
        out: List[np.ndarray] = []

        def visit(node: Optional[_KDNode], depth: int):
            if node is None:
                return
            if rect.contains(node.point):
                out.append(node.point)
            dim = depth % self.dims
            if node.point[dim] >= rect.lower[dim]:
                visit(node.left, depth + 1)
            if node.point[dim] <= rect.upper[dim]:
                visit(node.right, depth + 1)

        visit(self.root, 0)
        return out
