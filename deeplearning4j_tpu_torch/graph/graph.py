"""Graph structure with CSR adjacency for vectorised walk generation.

Behavioural parity with ``graph/graph/Graph.java`` (vertex values, directed and
undirected edges, multi-edge control, neighbour queries) re-designed so that
random walks over *all* start vertices are generated with vectorised NumPy
gathers over a CSR layout rather than per-vertex object traversal — the shape
that feeds the batched on-device DeepWalk trainer.

The port's copy of the JAX package's jax-free ``graph/graph.py``: the same
graph, CSR and vectorised walks (numpy's generator).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.graph.api import Edge, NoEdgesException, Vertex


class VertexSequence:
    """A sequence of vertices in a graph, e.g. one random walk
    (``graph/graph/VertexSequence.java``)."""

    def __init__(self, graph: "Graph", indices: Sequence[int]):
        self._graph = graph
        self._indices = list(int(i) for i in indices)

    def __len__(self) -> int:
        return len(self._indices)

    def __iter__(self):
        for i in self._indices:
            yield self._graph.get_vertex(i)

    def indices(self) -> List[int]:
        return list(self._indices)

    def sequence_length(self) -> int:
        return len(self._indices)


class Graph:
    """Graph with integer-indexed vertices carrying arbitrary values.

    ``add_edge`` accepts directed or undirected edges; undirected edges appear
    in both endpoints' adjacency (matching ``Graph.java:90-113``). Adjacency is
    materialised to CSR arrays on first use and invalidated on mutation.
    """

    def __init__(self, num_vertices: int = 0, allow_multiple_edges: bool = True,
                 vertices: Optional[Sequence[Any]] = None):
        if vertices is not None:
            self._values = list(vertices)
        else:
            self._values = [None] * num_vertices
        self.allow_multiple_edges = allow_multiple_edges
        self._edges_out: List[List[Edge]] = [[] for _ in self._values]
        self._csr = None  # (ptr, indices, weights) cache

    # -- construction ----------------------------------------------------
    def num_vertices(self) -> int:
        return len(self._values)

    def add_vertex(self, value: Any = None) -> int:
        self._values.append(value)
        self._edges_out.append([])
        self._csr = None
        return len(self._values) - 1

    def add_edge(self, edge_or_from, to: Optional[int] = None, value: Any = None,
                 directed: bool = False) -> None:
        if isinstance(edge_or_from, Edge):
            edge = edge_or_from
        else:
            edge = Edge(int(edge_or_from), int(to), value, directed)
        n = self.num_vertices()
        if not (0 <= edge.from_idx < n and 0 <= edge.to_idx < n):
            raise ValueError(
                f"edge {edge.from_idx}->{edge.to_idx} out of range for {n} vertices")
        if not self.allow_multiple_edges:
            for e in self._edges_out[edge.from_idx]:
                if e.to_idx == edge.to_idx or (not e.directed and e.from_idx == edge.to_idx):
                    return
        self._edges_out[edge.from_idx].append(edge)
        if not edge.directed:
            # Undirected edge is visible from both endpoints (Graph.java:105-112)
            self._edges_out[edge.to_idx].append(
                Edge(edge.to_idx, edge.from_idx, edge.value, False))
        self._csr = None

    # -- queries ---------------------------------------------------------
    def get_vertex(self, idx: int) -> Vertex:
        return Vertex(idx, self._values[idx])

    def get_vertices(self, indices: Sequence[int]) -> List[Vertex]:
        return [self.get_vertex(i) for i in indices]

    def get_edges_out(self, vertex: int) -> List[Edge]:
        return list(self._edges_out[vertex])

    def get_vertex_degree(self, vertex: int) -> int:
        return len(self._edges_out[vertex])

    def vertex_degrees(self) -> np.ndarray:
        return np.array([len(e) for e in self._edges_out], dtype=np.int64)

    def get_connected_vertex_indices(self, vertex: int) -> np.ndarray:
        return np.array([e.to_idx for e in self._edges_out[vertex]], dtype=np.int64)

    def get_connected_vertices(self, vertex: int) -> List[Vertex]:
        return [self.get_vertex(e.to_idx) for e in self._edges_out[vertex]]

    def get_random_connected_vertex(self, vertex: int, rng: np.random.Generator) -> Vertex:
        edges = self._edges_out[vertex]
        if not edges:
            raise NoEdgesException(f"Vertex {vertex} has no outgoing edges")
        e = edges[int(rng.integers(0, len(edges)))]
        return self.get_vertex(e.to_idx)

    # -- CSR + vectorised walks ------------------------------------------
    def csr(self):
        """(ptr, indices, weights) arrays; ptr has length n+1."""
        if self._csr is None:
            n = self.num_vertices()
            degs = self.vertex_degrees()
            ptr = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(degs, out=ptr[1:])
            indices = np.empty(int(ptr[-1]), dtype=np.int64)
            weights = np.empty(int(ptr[-1]), dtype=np.float64)
            for v, edges in enumerate(self._edges_out):
                for k, e in enumerate(edges):
                    indices[ptr[v] + k] = e.to_idx
                    weights[ptr[v] + k] = e.weight()
            self._csr = (ptr, indices, weights)
        return self._csr

    def random_walks(self, starts: np.ndarray, walk_length: int,
                     rng: np.random.Generator, weighted: bool = False,
                     self_loop_disconnected: bool = True) -> np.ndarray:
        """Generate one walk per start vertex, vectorised over all starts.

        Returns an int array of shape ``(len(starts), walk_length + 1)`` — a
        walk of length L visits L+1 vertices (``RandomWalkIterator.java``
        constructor doc). Disconnected vertices self-loop when
        ``self_loop_disconnected`` (the reference's SELF_LOOP_ON_DISCONNECTED
        fills the remainder of the walk with the stuck vertex), else raise
        :class:`NoEdgesException`.
        """
        ptr, indices, weights = self.csr()
        starts = np.asarray(starts, dtype=np.int64)
        n_walks = starts.shape[0]
        walks = np.empty((n_walks, walk_length + 1), dtype=np.int64)
        walks[:, 0] = starts
        if walk_length == 0:
            return walks
        degs = (ptr[1:] - ptr[:-1])
        if not self_loop_disconnected:
            # check reachable-from-start vertices lazily during the walk
            if np.any(degs[starts] == 0):
                bad = int(starts[np.argmax(degs[starts] == 0)])
                raise NoEdgesException(
                    f"Cannot conduct random walk: vertex {bad} has no outgoing edges")
        if len(indices) == 0:
            # edgeless graph: every vertex is stuck
            if not self_loop_disconnected:
                raise NoEdgesException("Graph has no edges")
            walks[:, 1:] = starts[:, None]
            return walks
        weighted = weighted and len(weights) > 0
        if weighted:
            gw = np.cumsum(weights)  # global cumsum; rows are contiguous slices
            row_base = gw[ptr[:-1].clip(max=len(weights) - 1)] \
                - weights[ptr[:-1].clip(max=len(weights) - 1)]  # cum before row
            row_total = np.zeros(self.num_vertices())
            nz = degs > 0
            row_total[nz] = gw[ptr[1:][nz] - 1] - row_base[nz]
        cur = starts.copy()
        for step in range(1, walk_length + 1):
            d = degs[cur]
            stuck = d == 0
            if not self_loop_disconnected and np.any(stuck):
                bad = int(cur[np.argmax(stuck)])
                raise NoEdgesException(
                    f"Cannot conduct random walk: vertex {bad} has no outgoing edges")
            safe_d = np.maximum(d, 1)
            if weighted:
                u = rng.random(n_walks)
                begins = ptr[cur]
                target = row_base[cur] + u * row_total[cur]
                pos = np.searchsorted(gw, target, side="left")
                pos = np.clip(pos, begins, np.maximum(ptr[cur + 1] - 1, begins))
                nxt = indices[np.minimum(pos, len(indices) - 1)]
            else:
                offs = rng.integers(0, safe_d)
                # stuck vertices may index past the end (ptr[v]==len(indices));
                # their result is discarded by the where() below
                nxt = indices[np.minimum(ptr[cur] + offs, len(indices) - 1)]
            cur = np.where(stuck, cur, nxt)
            walks[:, step] = cur
        return walks

    # -- misc ------------------------------------------------------------
    def __eq__(self, other):
        if not isinstance(other, Graph):
            return NotImplemented
        return (self._values == other._values
                and [[(e.from_idx, e.to_idx, e.value, e.directed) for e in lst]
                     for lst in self._edges_out]
                == [[(e.from_idx, e.to_idx, e.value, e.directed) for e in lst]
                    for lst in other._edges_out])

    def __repr__(self):
        n_slots = sum(len(e) for e in self._edges_out)
        return f"Graph(numVertices={self.num_vertices()}, numEdgeSlots={n_slots})"
