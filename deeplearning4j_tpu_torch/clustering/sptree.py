"""Space-partitioning tree for Barnes-Hut (parity:
``clustering/sptree/SpTree.java`` + ``Cell.java``).

d-dimensional generalization of the quadtree: each node stores a center of
mass and point count; ``compute_non_edge_forces`` applies the Barnes-Hut
theta criterion. Host-side (the tree is rebuilt every t-SNE iteration from
the current embedding — cheap at the N where Barnes-Hut beats the exact
on-device path).

The port's copy of the JAX package's jax-free ``clustering/sptree.py``: the
same tree and forces (host numpy).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

_NODE_CAPACITY = 1  # reference SpTree stores one point per leaf


class SpTreeCell:
    """Axis-aligned cell (``sptree/Cell.java``)."""

    def __init__(self, corner: np.ndarray, width: np.ndarray):
        self.corner = corner  # center of the cell
        self.width = width    # half-widths per dimension

    def contains(self, point: np.ndarray) -> bool:
        return bool(np.all(np.abs(point - self.corner) <= self.width + 1e-12))


class SpTree:
    """Barnes-Hut tree over an (N, D) embedding (``SpTree.java``)."""

    def __init__(self, data: np.ndarray, corner: Optional[np.ndarray] = None,
                 width: Optional[np.ndarray] = None):
        data = np.asarray(data, np.float64)
        self.data = data
        self.dims = data.shape[1]
        if corner is None:
            mins, maxs = data.min(0), data.max(0)
            center = (mins + maxs) / 2.0
            half = (maxs - mins) / 2.0 + 1e-5
            self.cell = SpTreeCell(center, half)
        else:
            self.cell = SpTreeCell(corner, width)
        self.center_of_mass = np.zeros(self.dims)
        self.cum_size = 0
        self.point_index: int = -1
        self.is_leaf = True
        self.children: List[Optional[SpTree]] = []
        if corner is None:  # root: insert everything
            for i in range(data.shape[0]):
                self.insert(i)

    # -- construction -------------------------------------------------------
    def _subdivide(self) -> None:
        n_children = 1 << self.dims
        half = self.cell.width / 2.0
        self.children = []
        for c in range(n_children):
            offset = np.array([(1 if (c >> d) & 1 else -1) for d in range(self.dims)])
            child = SpTree.__new__(SpTree)
            child.data = self.data
            child.dims = self.dims
            child.cell = SpTreeCell(self.cell.corner + offset * half, half)
            child.center_of_mass = np.zeros(self.dims)
            child.cum_size = 0
            child.point_index = -1
            child.is_leaf = True
            child.children = []
            self.children.append(child)
        self.is_leaf = False

    def insert(self, index: int) -> bool:
        point = self.data[index]
        if not self.cell.contains(point):
            return False
        self.cum_size += 1
        self.center_of_mass += (point - self.center_of_mass) / self.cum_size
        if self.is_leaf and self.point_index < 0:
            self.point_index = index
            return True
        if self.is_leaf:
            # duplicate point: just accumulate mass, don't split forever
            if np.allclose(self.data[self.point_index], point):
                return True
            old = self.point_index
            self.point_index = -1
            self._subdivide()
            for child in self.children:
                if child.insert(old):
                    break
            for child in self.children:
                if child.insert(index):
                    return True
            return False
        for child in self.children:
            if child.insert(index):
                return True
        return False

    # -- Barnes-Hut forces --------------------------------------------------
    def compute_non_edge_forces(self, index: int, theta: float,
                                neg_f: np.ndarray) -> float:
        """Accumulate repulsive force on ``data[index]`` into ``neg_f``;
        returns the partial sum of Q (``SpTree.computeNonEdgeForces``)."""
        if self.cum_size == 0 or (self.is_leaf and self.point_index == index
                                  and self.cum_size == 1):
            return 0.0
        point = self.data[index]
        diff = point - self.center_of_mass
        d2 = float(diff @ diff)
        max_width = float(np.max(self.cell.width * 2.0))
        if self.is_leaf or max_width * max_width < theta * theta * d2:
            mult = self.cum_size
            if self.is_leaf and self.point_index == index:
                mult -= 1
                if mult <= 0:
                    return 0.0
            q = 1.0 / (1.0 + d2)
            sum_q = mult * q
            neg_f += mult * q * q * diff
            return sum_q
        return sum(child.compute_non_edge_forces(index, theta, neg_f)
                   for child in self.children if child.cum_size > 0)

    def compute_edge_forces(self, rows: np.ndarray, cols: np.ndarray,
                            vals: np.ndarray, pos_f: np.ndarray) -> None:
        """Attractive forces from the sparse P matrix (CSR triplets)
        (``SpTree.computeEdgeForces``). Vectorized over all edges."""
        n = pos_f.shape[0]
        for i in range(n):
            lo, hi = rows[i], rows[i + 1]
            if lo == hi:
                continue
            j = cols[lo:hi]
            diff = self.data[i] - self.data[j]
            q = 1.0 / (1.0 + np.sum(diff * diff, axis=1))
            pos_f[i] = np.sum((vals[lo:hi] * q)[:, None] * diff, axis=0)

    def depth(self) -> int:
        if self.is_leaf:
            return 1
        return 1 + max((c.depth() for c in self.children if c.cum_size > 0),
                       default=0)
