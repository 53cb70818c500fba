"""Huffman tree over graph vertices for hierarchical softmax.

Semantics-parity with ``graph/models/deepwalk/GraphHuffman.java``: vertices are
weighted by degree, codes are stored LSB-first (bit ``i`` of the code is the
branch taken at depth ``i``), inner nodes are numbered by pre-order traversal
(root = 0, ``n-1`` inner nodes for ``n`` leaves), and each leaf records the
inner-node path from the root.

Adds batched, padded array exports (:meth:`path_arrays`) so the whole
hierarchical-softmax update can run as one gather/scatter on device.

The port's copy of the JAX package's jax-free ``graph/huffman.py``: the same
tree, codes and padded path arrays.
"""

from __future__ import annotations

import heapq
from typing import List, Tuple

import numpy as np


class GraphHuffman:
    def __init__(self, n_vertices: int, max_code_length: int = 64):
        self.max_code_length = max_code_length
        self.n_vertices = n_vertices
        self.codes = [0] * n_vertices
        self.code_length = [0] * n_vertices
        self.inner_node_path: List[List[int]] = [[] for _ in range(n_vertices)]

    def build_tree(self, vertex_degree) -> "GraphHuffman":
        """Build the tree from per-vertex counts (degrees for DeepWalk)."""
        vertex_degree = list(vertex_degree)
        assert len(vertex_degree) == self.n_vertices
        # heap entries: (count, tiebreak, leaf_idx_or_None, left, right)
        heap: List[Tuple[int, int, object]] = []
        tie = 0
        for i, d in enumerate(vertex_degree):
            heap.append((int(d), tie, (i, None, None)))
            tie += 1
        heapq.heapify(heap)
        while len(heap) > 1:
            c1, _, left = heapq.heappop(heap)
            c2, _, right = heapq.heappop(heap)
            heapq.heappush(heap, (c1 + c2, tie, (-1, left, right)))
            tie += 1
        _, _, tree = heap[0]

        # Pre-order traversal, iterative (graphs can exceed Python recursion
        # depth): inner nodes numbered in visit order, root first.
        inner_count = -1
        # stack entries: (node, code_so_far, code_len, path_tuple)
        stack = [(tree, 0, 0, ())]
        while stack:
            (leaf, left, right), code, length, path = stack.pop()
            if left is None and right is None:
                if length >= self.max_code_length:
                    raise RuntimeError(
                        f"Cannot generate code: code length exceeds {self.max_code_length} bits")
                self.codes[leaf] = code
                self.code_length[leaf] = length
                self.inner_node_path[leaf] = list(path)
                continue
            inner_count += 1
            new_path = path + (inner_count,)
            # push right first so left is visited first (pre-order), matching
            # the reference's left-then-right recursion
            stack.append((right, code | (1 << length), length + 1, new_path))
            stack.append((left, code, length + 1, new_path))
        return self

    # -- reference API ----------------------------------------------------
    def get_code(self, vertex: int) -> int:
        return self.codes[vertex]

    def get_code_length(self, vertex: int) -> int:
        return self.code_length[vertex]

    def get_code_string(self, vertex: int) -> str:
        code, n = self.codes[vertex], self.code_length[vertex]
        return "".join("1" if (code >> i) & 1 else "0" for i in range(n))

    def get_path_inner_nodes(self, vertex: int) -> List[int]:
        return list(self.inner_node_path[vertex])

    # -- batched export ---------------------------------------------------
    def path_arrays(self):
        """Padded arrays for on-device hierarchical softmax.

        Returns ``(path_nodes, bits, mask)`` each of shape
        ``(n_vertices, L)`` with ``L = max code length used``: inner-node row
        index (0-padded), branch bit, and validity mask.
        """
        L = max(self.code_length) if self.code_length else 0
        n = self.n_vertices
        nodes = np.zeros((n, L), dtype=np.int32)
        bits = np.zeros((n, L), dtype=np.float32)
        mask = np.zeros((n, L), dtype=np.float32)
        for v in range(n):
            cl = self.code_length[v]
            mask[v, :cl] = 1.0
            for i, inner in enumerate(self.inner_node_path[v]):
                nodes[v, i] = inner
            for i in range(cl):
                bits[v, i] = (self.codes[v] >> i) & 1
        return nodes, bits, mask
