"""DeepWalk graph embeddings with batched hierarchical softmax on the card.

Counterpart of the JAX package's ``graph/deepwalk.py`` (reference
``graph/models/deepwalk/DeepWalk.java``, Perozzi et al. 2014 skip-gram over
random walks, and ``graph/models/embeddings/InMemoryGraphLookupTable.java``):

- the tables are torch tensors on the table's device, and every pair of a
  walk batch is trained in one step: gather both tables' rows, compute
  both gradients from those old values, then ``index_add_`` them into both
  tables (repeated rows add up), the batch-synchronous update of the
  reference's jitted ``_hs_batch_update``;
- an epoch's walks reach the device in one copy, its skip-gram pairs are
  gathered there, and the loop over its batches never reads the device
  from the host;
- walk generation is the reference's vectorised numpy
  (:meth:`Graph.random_walks`, ``np.random.default_rng(seed)``), so a fit
  from carried tables follows the reference's step for step;
- ``vectors_and_gradients`` / ``calculate_prob`` / ``calculate_score`` keep
  the reference's per-pair math on the host in f64
  (`InMemoryGraphLookupTable.java:79-160`).

The initial tables are drawn from numpy's generator (U(−0.5, 0.5)/d, the
reference's distribution; its values came from ``jax.random``: ROADMAP
§C, C22).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.graph.api import NoEdgeHandling
from deeplearning4j_tpu_torch.graph.graph import Graph
from deeplearning4j_tpu_torch.graph.huffman import GraphHuffman


def _hs_batch_update(vertex_vectors, out_weights, firsts, nodes, bits, mask,
                     lr):
    """One batched hierarchical-softmax SGD step, in place.

    firsts: (B,) input vertex ids; nodes/bits/mask: (B, L) padded Huffman
    path of the output vertex. Gradients of sum of -log P(out|in) over the
    batch, both computed from the old tables before either is written.
    """
    d = vertex_vectors.shape[1]
    vec = vertex_vectors[firsts]                          # (B, D)
    inner = out_weights[nodes]                            # (B, L, D)
    dots = torch.einsum("bld,bd->bl", inner, vec)         # (B, L)
    g = (torch.sigmoid(dots) - bits) * mask               # (B, L) dL/d(dot)
    inner_grad = g[..., None] * vec[:, None, :]           # (B, L, D)
    vec_grad = torch.einsum("bl,bld->bd", g, inner)       # (B, D)
    out_weights.index_add_(0, nodes.reshape(-1), inner_grad.reshape(-1, d),
                           alpha=-lr)
    vertex_vectors.index_add_(0, firsts, vec_grad, alpha=-lr)


class InMemoryGraphLookupTable:
    """Vertex/inner-node embedding table with hierarchical softmax, its
    tables on the card unless ``device="cpu"``."""

    MAX_EXP = 6.0

    def __init__(self, n_vertices: int, vector_size: int, tree: Optional[GraphHuffman],
                 learning_rate: float, seed: int = 12345, device=None):
        self.device = resolve_device(device)
        self.n_vertices = n_vertices
        self._vector_size = vector_size
        self.tree = tree
        self.learning_rate = float(learning_rate)
        self._seed = seed
        self.reset_weights()
        if tree is not None:
            nodes, bits, mask = tree.path_arrays()
            self._paths = (nodes, bits, mask)
            self._place_paths()

    def _place_paths(self) -> None:
        nodes, bits, mask = self._paths
        dtype = self.vertex_vectors.dtype
        self._path_nodes = torch.from_numpy(nodes.astype(np.int64)).to(self.device)
        self._path_bits = torch.from_numpy(bits).to(self.device, dtype)
        self._path_mask = torch.from_numpy(mask).to(self.device, dtype)

    # -- reference API ----------------------------------------------------
    def vector_size(self) -> int:
        return self._vector_size

    def get_num_vertices(self) -> int:
        return self.n_vertices

    def reset_weights(self):
        """U(-0.5, 0.5)/vector_size init, matching
        ``InMemoryGraphLookupTable.resetWeights`` (rand-0.5)/size, from
        numpy's generator seeded by the table's seed. A full binary tree
        with L leaves has L-1 inner nodes."""
        rng = np.random.default_rng(self._seed)
        d = self._vector_size
        rows = max(self.n_vertices - 1, 1)
        self.vertex_vectors = self._tensor(
            (rng.random((self.n_vertices, d), dtype=np.float32) - 0.5) / d)
        self.out_weights = self._tensor(
            (rng.random((rows, d), dtype=np.float32) - 0.5) / d)

    def _tensor(self, values, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.array(values, copy=True)).to(self.device, dtype)

    def to(self, device=None, dtype=None) -> "InMemoryGraphLookupTable":
        """Moves (and casts) both tables and the paths to ``device`` /
        ``dtype`` in place of the old ones; ``device=None`` keeps the
        table's device."""
        if device is not None:
            self.device = resolve_device(device)
        self.vertex_vectors = self.vertex_vectors.to(
            self.device, dtype or self.vertex_vectors.dtype)
        self.out_weights = self.out_weights.to(self.device, dtype or self.out_weights.dtype)
        if self.tree is not None:
            self._place_paths()
        return self

    def set_learning_rate(self, lr: float):
        self.learning_rate = float(lr)

    def get_vector(self, idx: int) -> np.ndarray:
        return self.vertex_vectors[idx].cpu().numpy()

    def get_vertex_vectors(self) -> np.ndarray:
        return self.vertex_vectors.cpu().numpy()

    def set_vertex_vectors(self, arr):
        self.vertex_vectors = torch.as_tensor(np.array(arr, copy=True)).to(
            self.device, self.vertex_vectors.dtype)

    def get_inner_node_vector(self, inner_node: int) -> np.ndarray:
        return self.out_weights[inner_node].cpu().numpy()

    def get_tree(self) -> Optional[GraphHuffman]:
        return self.tree

    # -- training ---------------------------------------------------------
    def iterate(self, first: int, second: int):
        """Single-pair update (reference ``iterate``); prefer iterate_batch."""
        self.iterate_batch(np.array([first]), np.array([second]))

    def iterate_batch(self, firsts, seconds):
        """One step over the pairs (numpy arrays or int64 tensors on the
        table's device)."""
        firsts = torch.as_tensor(firsts, dtype=torch.int64).to(self.device)
        seconds = torch.as_tensor(seconds, dtype=torch.int64).to(self.device)
        _hs_batch_update(self.vertex_vectors, self.out_weights, firsts,
                         self._path_nodes[seconds], self._path_bits[seconds],
                         self._path_mask[seconds], self.learning_rate)

    # -- per-pair math (gradient-check parity) -----------------------------
    def _pair_rows(self, first: int, second: int):
        """The input vector and the inner-node rows on the path to
        ``second``, on the host in f64 (one read), with the code."""
        path = self.tree.get_path_inner_nodes(second)
        vec = self.vertex_vectors[first].detach().cpu().double().numpy()
        inner = self.out_weights[path].detach().cpu().double().numpy()
        return vec, inner, self.tree.get_code(second), self.tree.get_code_length(second)

    def vectors_and_gradients(self, first: int, second: int):
        """[vectors, grads] for (input vertex, inner nodes on path to second);
        mirrors ``InMemoryGraphLookupTable.vectorsAndGradients`` for tests."""
        vec, inner, code, code_len = self._pair_rows(first, second)
        vectors = [vec]
        grads = [np.zeros_like(vec)]
        accum = np.zeros_like(vec)
        for i in range(code_len):
            inner_vec = inner[i]
            bit = (code >> i) & 1
            sig = 1.0 / (1.0 + np.exp(-np.dot(inner_vec, vec)))
            g = sig - bit
            vectors.append(inner_vec)
            grads.append(g * vec)
            accum += g * inner_vec
        grads[0] = accum
        return vectors, grads

    def calculate_prob(self, first: int, second: int) -> float:
        """P(second | first) under hierarchical softmax."""
        vec, inner, code, code_len = self._pair_rows(first, second)
        prob = 1.0
        for i in range(code_len):
            dot = float(np.dot(inner[i], vec))
            bit = (code >> i) & 1
            z = dot if bit else -dot
            # numerically stable sigmoid(z)
            p = 1.0 / (1.0 + np.exp(-z)) if z >= 0 else np.exp(z) / (1.0 + np.exp(z))
            prob *= p
        return prob

    def calculate_score(self, first: int, second: int) -> float:
        return -float(np.log(self.calculate_prob(first, second)))


class GraphVectors:
    """Learned vertex representations: similarity and nearest-vertex queries
    (``graph/models/GraphVectors.java`` / ``embeddings/GraphVectorsImpl.java``),
    computed on the table's device."""

    def __init__(self, lookup_table: InMemoryGraphLookupTable,
                 graph: Optional[Graph] = None):
        self.lookup_table = lookup_table
        self.graph = graph

    def num_vertices(self) -> int:
        return self.lookup_table.get_num_vertices()

    def get_vector_size(self) -> int:
        return self.lookup_table.vector_size()

    def get_vertex_vector(self, vertex_idx: int) -> np.ndarray:
        return self.lookup_table.get_vector(int(vertex_idx))

    def similarity(self, v1: int, v2: int) -> float:
        """Cosine similarity between two vertex vectors."""
        a = self.lookup_table.vertex_vectors[int(v1)]
        b = self.lookup_table.vertex_vectors[int(v2)]
        return float(torch.dot(a, b)
                     / (torch.linalg.norm(a) * torch.linalg.norm(b) + 1e-12))

    def vertices_nearest(self, vertex_idx: int, top: int) -> np.ndarray:
        """Top-N nearest vertices by cosine similarity: one product over the
        whole table, equal similarities lowest index first (the order of
        the reference's ``jax.lax.top_k``)."""
        vv = self.lookup_table.vertex_vectors
        q = vv[int(vertex_idx)]
        norms = torch.linalg.norm(vv, dim=1) * (torch.linalg.norm(q) + 1e-12)
        sims = (vv @ q) / torch.clamp(norms, min=1e-12)
        sims[int(vertex_idx)] = -torch.inf
        _, idx = torch.sort(sims, descending=True, stable=True)
        return idx[:top].cpu().numpy()


class DeepWalk(GraphVectors):
    """DeepWalk: skip-gram with hierarchical softmax over random walks, on
    the card unless ``device="cpu"``."""

    def __init__(self, vector_size: int = 100, window_size: int = 2,
                 learning_rate: float = 0.01, seed: int = 12345,
                 batch_size: int = 8192, device=None):
        self.device = resolve_device(device)
        self.vector_size = vector_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.seed = seed
        self.batch_size = batch_size
        self.lookup_table: Optional[InMemoryGraphLookupTable] = None
        self.graph: Optional[Graph] = None
        self._init_called = False

    class Builder:
        """Fluent builder mirroring ``DeepWalk.Builder``; ``device(d)``
        places the model (None: the card)."""

        def __init__(self):
            self._vector_size, self._window_size = 100, 2
            self._learning_rate, self._seed = 0.01, 12345
            self._device = None

        def vector_size(self, v):
            self._vector_size = v
            return self

        def window_size(self, w):
            self._window_size = w
            return self

        def learning_rate(self, lr):
            self._learning_rate = lr
            return self

        def seed(self, s):
            self._seed = s
            return self

        def device(self, d):
            self._device = d
            return self

        def build(self) -> "DeepWalk":
            return DeepWalk(self._vector_size, self._window_size,
                            self._learning_rate, self._seed, device=self._device)

    # -- lifecycle --------------------------------------------------------
    def initialize(self, graph_or_degrees):
        """Build the Huffman tree from vertex degrees and allocate the table
        (``DeepWalk.initialize``)."""
        if isinstance(graph_or_degrees, Graph):
            self.graph = graph_or_degrees
            degrees = graph_or_degrees.vertex_degrees()
        else:
            degrees = np.asarray(graph_or_degrees, dtype=np.int64)
        tree = GraphHuffman(len(degrees)).build_tree(degrees)
        self.lookup_table = InMemoryGraphLookupTable(
            len(degrees), self.vector_size, tree, self.learning_rate, self.seed,
            device=self.device)
        self._init_called = True

    def set_learning_rate(self, lr: float):
        self.learning_rate = lr
        if self.lookup_table is not None:
            self.lookup_table.set_learning_rate(lr)

    def get_vector_size(self) -> int:
        return self.vector_size

    def get_window_size(self) -> int:
        return self.window_size

    def get_learning_rate(self) -> float:
        return self.learning_rate

    # -- training ---------------------------------------------------------
    def fit(self, graph: Optional[Graph] = None, walk_length: int = 10,
            epochs: int = 1, walks: Optional[np.ndarray] = None,
            no_edge_handling: NoEdgeHandling = NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED,
            weighted: bool = False):
        """Fit on random walks (one walk per vertex per epoch, shuffled start
        order — ``RandomWalkIterator`` semantics), or on pre-generated
        ``walks`` of shape (n_walks, walk_len+1)."""
        if graph is None:
            graph = self.graph
        if graph is not None and not self._init_called:
            self.initialize(graph)
        if not self._init_called:
            raise RuntimeError("DeepWalk not initialized (call initialize before fit)")
        if graph is None and walks is None:
            raise ValueError("fit() needs a graph or pre-generated walks")
        rng = np.random.default_rng(self.seed)
        for _ in range(epochs):
            if walks is None:
                starts = rng.permutation(graph.num_vertices())
                epoch_walks = graph.random_walks(
                    starts, walk_length, rng, weighted=weighted,
                    self_loop_disconnected=(
                        no_edge_handling is NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED))
            else:
                epoch_walks = np.asarray(walks)
            self.fit_walks(epoch_walks)

    def fit_walks(self, walks: np.ndarray):
        """Train on an array of walks: extract all (center, context) skip-gram
        pairs (``DeepWalk.skipGram``: centers range over positions with a full
        window on both sides) in the reference's order and apply them in
        batches of ``batch_size``. The walks go to the device in one copy and
        the pairs are gathered there."""
        walks = np.asarray(walks)
        L = walks.shape[1]
        w = self.window_size
        if L - 2 * w <= 0:
            return
        device = self.lookup_table.device
        walks = torch.from_numpy(walks.astype(np.int64, copy=False)).to(device)
        centers_pos = torch.arange(w, L - w, device=device)
        offsets = torch.cat([torch.arange(-w, 0), torch.arange(1, w + 1)]).to(device)
        # (n_walks, n_centers, n_offsets), flattened
        firsts = walks[:, centers_pos, None].expand(-1, -1, len(offsets)).reshape(-1)
        seconds = walks[:, centers_pos[:, None] + offsets[None, :]].reshape(-1)
        bs = self.batch_size
        for i in range(0, firsts.numel(), bs):
            self.lookup_table.iterate_batch(firsts[i:i + bs], seconds[i:i + bs])
