"""node2vec: biased second-order random walks + skip-gram embeddings.

Parity with the reference's ``models/node2vec/`` (under deeplearning4j-nlp;
Grover & Leskovec 2016): return parameter ``p`` and in-out parameter ``q``
bias the walk toward BFS- or DFS-like exploration. The walk generator is
vectorised over all active walks per step using a padded neighbour matrix
(candidates for every walk evaluated at once: back-to-previous gets weight
1/p, neighbours-of-previous weight 1, others 1/q), and training reuses the
batched hierarchical-softmax DeepWalk trainer.

The port's copy of the JAX package's ``graph/node2vec.py``: the same numpy
walks (numpy's generator), trained by the port's :class:`DeepWalk` on the
card unless ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk
from deeplearning4j_tpu_torch.graph.graph import Graph


class Node2Vec(DeepWalk):
    def __init__(self, vector_size: int = 100, window_size: int = 2,
                 learning_rate: float = 0.01, seed: int = 12345,
                 p: float = 1.0, q: float = 1.0, walks_per_vertex: int = 10,
                 batch_size: int = 8192, device=None):
        super().__init__(vector_size, window_size, learning_rate, seed,
                         batch_size, device=device)
        self.p = float(p)
        self.q = float(q)
        self.walks_per_vertex = walks_per_vertex

    # -- vectorised biased walks -----------------------------------------
    def _neighbor_matrix(self, graph: Graph):
        """Padded neighbour matrix [n, max_deg] (-1 pad) + sorted-neighbour
        CSR for O(log d) membership tests."""
        ptr, indices, _ = graph.csr()
        n = graph.num_vertices()
        degs = (ptr[1:] - ptr[:-1]).astype(np.int64)
        max_deg = int(degs.max()) if n else 0
        nbr = np.full((n, max(max_deg, 1)), -1, dtype=np.int64)
        for v in range(n):
            nbr[v, :degs[v]] = indices[ptr[v]:ptr[v + 1]]
        sorted_indices = indices.copy()
        for v in range(n):
            sorted_indices[ptr[v]:ptr[v + 1]].sort()
        return nbr, degs, ptr, sorted_indices

    def generate_walks(self, graph: Graph, walk_length: int,
                       rng: np.random.Generator) -> np.ndarray:
        """One biased walk per start vertex x walks_per_vertex."""
        # the adjacency layout is immutable across epochs: build once per graph
        if getattr(self, "_nbr_cache", None) is None or self._nbr_cache[0] is not graph:
            self._nbr_cache = (graph, self._neighbor_matrix(graph))
        nbr, degs, ptr, sorted_idx = self._nbr_cache[1]
        n = graph.num_vertices()
        starts = np.tile(np.arange(n), self.walks_per_vertex)
        rng.shuffle(starts)
        W = len(starts)
        walks = np.empty((W, walk_length + 1), dtype=np.int64)
        walks[:, 0] = starts
        if walk_length == 0:
            return walks
        if len(sorted_idx) == 0:
            # edgeless graph: every walk self-loops (DeepWalk's
            # SELF_LOOP_ON_DISCONNECTED contract)
            walks[:, 1:] = starts[:, None]
            return walks
        # first step: uniform neighbour (no previous vertex yet)
        d = degs[starts]
        safe = np.maximum(d, 1)
        first = nbr[starts, rng.integers(0, safe)]
        cur = np.where(d > 0, first, starts)
        walks[:, 1] = cur
        prev = starts.copy()
        max_deg = nbr.shape[1]
        for step in range(2, walk_length + 1):
            cand = nbr[cur]                              # [W, max_deg]
            valid = cand >= 0
            safe_cand = np.where(valid, cand, 0)
            # membership: is candidate a neighbour of prev? binary search in
            # prev's sorted adjacency row
            lo = ptr[prev][:, None]
            hi = ptr[prev + 1][:, None]
            # searchsorted on the global sorted-per-row array
            pos = np.empty_like(safe_cand)
            flat_c = safe_cand.ravel()
            flat_lo = np.broadcast_to(lo, safe_cand.shape).ravel()
            flat_hi = np.broadcast_to(hi, safe_cand.shape).ravel()
            # vectorised per-element binary search over row segments
            pos_flat = flat_lo.copy()
            lo_w, hi_w = flat_lo.copy(), flat_hi.copy()
            while np.any(lo_w < hi_w):
                mid = (lo_w + hi_w) // 2
                go_right = sorted_idx[np.minimum(mid, len(sorted_idx) - 1)] < flat_c
                active = lo_w < hi_w
                lo_w = np.where(active & go_right, mid + 1, lo_w)
                hi_w = np.where(active & ~go_right, mid, hi_w)
            pos_flat = lo_w
            in_prev = (pos_flat < flat_hi) & (
                sorted_idx[np.minimum(pos_flat, len(sorted_idx) - 1)] == flat_c)
            is_nbr_of_prev = in_prev.reshape(safe_cand.shape)
            w = np.where(safe_cand == prev[:, None], 1.0 / self.p,
                         np.where(is_nbr_of_prev, 1.0, 1.0 / self.q))
            w = np.where(valid, w, 0.0)
            totals = w.sum(axis=1)
            stuck = totals <= 0
            w_cum = np.cumsum(w, axis=1)
            u = rng.random(W) * np.maximum(totals, 1e-30)
            choice = (w_cum < u[:, None]).sum(axis=1).clip(0, max_deg - 1)
            nxt = cand[np.arange(W), choice]
            nxt = np.where(stuck | (nxt < 0), cur, nxt)
            prev, cur = cur, nxt
            walks[:, step] = cur
        return walks

    # -- training ---------------------------------------------------------
    def fit(self, graph: Optional[Graph] = None, walk_length: int = 10,
            epochs: int = 1, walks: Optional[np.ndarray] = None, **kw):
        if graph is None:
            graph = self.graph
        if graph is not None and not self._init_called:
            self.initialize(graph)
        if not self._init_called:
            raise RuntimeError("Node2Vec not initialized")
        rng = np.random.default_rng(self.seed)
        for _ in range(epochs):
            epoch_walks = (np.asarray(walks) if walks is not None
                           else self.generate_walks(graph, walk_length, rng))
            self.fit_walks(epoch_walks)
