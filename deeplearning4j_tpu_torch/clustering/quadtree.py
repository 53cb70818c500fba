"""2-D quadtree (parity: ``clustering/quadtree/QuadTree.java`` +
``Cell.java``) — the 2-D special case the reference keeps alongside SpTree;
here a thin wrapper that fixes D=2 and preserves the reference surface
(``getIndex``/north-west style subdivision collapses to SpTree's child
indexing).

The port's copy of the JAX package's jax-free ``clustering/quadtree.py``:
the same 2-D tree.
"""

from __future__ import annotations

import numpy as np

from .sptree import SpTree


class QuadTree(SpTree):
    """Quadtree over (N, 2) points; same force interface as SpTree."""

    def __init__(self, data: np.ndarray):
        data = np.asarray(data, np.float64)
        if data.shape[1] != 2:
            raise ValueError("QuadTree requires 2-D points; use SpTree")
        super().__init__(data)

    @property
    def north_west(self):
        return self.children[0] if self.children else None

    @property
    def north_east(self):
        return self.children[1] if self.children else None

    @property
    def south_west(self):
        return self.children[2] if self.children else None

    @property
    def south_east(self):
        return self.children[3] if self.children else None
