"""The port's graph embeddings against the JAX package's on the CPU.

The copied modules (``Graph``, the loaders, the walks and their iterators,
``GraphHuffman``) give the reference's outputs on the reference's own test
inputs (``tests/test_graph_embeddings.py``), one parametrised test a module.
DeepWalk and Node2Vec train two 20-vertex cliques joined by one edge at
d = 16 for 2 epochs from the reference's initial tables carried in: both
tables lie within 1e-5 × their largest entry of the reference's (the walks
are the same numpy draws; the sums run in another order). One reference
fit a model is shared by the cases. Also: the per-pair math and the
queries on the carried tables, the serializer's files byte for byte read
both ways, and the carry's refusals.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import graph as R
from deeplearning4j_tpu_torch import graph as P
from deeplearning4j_tpu_torch.util.convert import load_reference_graph_lookup_table
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5  # × the table's largest entry


def _ring(mod, n=10):
    g = mod.Graph(n)
    for i in range(n):
        g.add_edge(i, (i + 1) % n)
    return g


def _cliques(mod, n=20):
    """Two cliques of ``n`` joined by one edge."""
    g = mod.Graph(2 * n)
    for c in (0, n):
        for i in range(c, c + n):
            for j in range(i + 1, c + n):
                g.add_edge(i, j)
    g.add_edge(n - 1, n)
    return g


def _edges(g):
    return [[(e.from_idx, e.to_idx, e.value, e.directed) for e in g.get_edges_out(v)]
            for v in range(g.num_vertices())]


def _describe(g):
    """Everything the graph answers, as plain values."""
    ptr, idx, w = g.csr()
    n = g.num_vertices()
    return {"edges": _edges(g), "degrees": g.vertex_degrees().tolist(),
            "values": [g.get_vertex(v).get_value() for v in range(n)],
            "connected": [g.get_connected_vertex_indices(v).tolist() for v in range(n)],
            "csr": (ptr.tolist(), idx.tolist(), w.tolist()), "repr": repr(g)}


# ------------------------------------------------------------------ Graph
def _graph_undirected(mod):
    g = mod.Graph(4)
    g.add_edge(0, 1)
    g.add_edge(mod.Edge(2, 3, 2.5))
    return g


def _graph_directed(mod):
    g = mod.Graph(3)
    g.add_edge(0, 1, directed=True)
    g.add_edge(2, 0, value=4.0, directed=True)
    return g


def _graph_no_multiple_edges(mod):
    g = mod.Graph(3, allow_multiple_edges=False)
    g.add_edge(0, 1)
    g.add_edge(0, 1)
    g.add_edge(1, 0)
    g.add_edge(1, 2)
    return g


def _graph_values(mod):
    g = mod.Graph(vertices=["a", "b", "c"])
    v = g.add_vertex("d")
    g.add_edge(v, 0)
    return g


GRAPHS = {"undirected": _graph_undirected, "directed": _graph_directed,
          "no_multiple_edges": _graph_no_multiple_edges, "values": _graph_values,
          "ring": _ring, "cliques": _cliques}


@pytest.mark.parametrize("case", list(GRAPHS))
def test_graph_matches_the_reference(case):
    ref, port = GRAPHS[case](R), GRAPHS[case](P)
    assert _describe(port) == _describe(ref)
    assert port == GRAPHS[case](P)
    rng_r, rng_p = np.random.default_rng(3), np.random.default_rng(3)
    for v in range(ref.num_vertices()):
        if ref.get_vertex_degree(v):
            assert (port.get_random_connected_vertex(v, rng_p).idx
                    == ref.get_random_connected_vertex(v, rng_r).idx)
    with pytest.raises(ValueError, match="out of range"):
        port.add_edge(0, port.num_vertices())


# ------------------------------------------------------------------ loaders
LOADERS = {
    "edge_list": ({"edges.txt": "0,1\n1,2\n2,3\n3,0\n"},
                  lambda m, d: m.GraphLoader.load_undirected_graph_edge_list_file(
                      os.path.join(d, "edges.txt"), 4)),
    "weighted": ({"edges.txt": "# comment\n0,1,1.5\n1,2,2.5\n"},
                 lambda m, d: m.GraphLoader.load_weighted_edge_list_file(
                     os.path.join(d, "edges.txt"), 3, directed=True)),
    "tab_delimited": ({"edges.txt": "// header\n0\t2\n\n2\t1\n"},
                      lambda m, d: m.GraphLoader.load_undirected_graph_edge_list_file(
                          os.path.join(d, "edges.txt"), 3, delim="\t")),
    "vertex_and_edge_files": ({"v.txt": "0:alpha\n1:beta\n2:gamma\n", "e.txt": "0,1\n1,2\n"},
                              lambda m, d: m.GraphLoader.load_graph_from_vertex_and_edge_files(
                                  os.path.join(d, "v.txt"), os.path.join(d, "e.txt"))),
    "bad_line": ({"edges.txt": "0,1,2\n"},
                 lambda m, d: m.GraphLoader.load_undirected_graph_edge_list_file(
                     os.path.join(d, "edges.txt"), 3)),
}


@pytest.mark.parametrize("case", list(LOADERS))
def test_loaders_match_the_reference(case, tmp_path):
    files, load = LOADERS[case]
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    if case == "bad_line":
        with pytest.raises(R.ParseException) as want:
            load(R, str(tmp_path))
        with pytest.raises(P.ParseException) as got:
            load(P, str(tmp_path))
        assert str(got.value) == str(want.value)
        return
    assert _describe(load(P, str(tmp_path))) == _describe(load(R, str(tmp_path)))


# ------------------------------------------------------------------ walks
def _weighted(mod):
    g = mod.Graph(3)
    g.add_edge(0, 1, value=0.0, directed=True)
    g.add_edge(0, 2, value=5.0, directed=True)
    g.add_edge(2, 0, value=1.0, directed=True)
    return g


def _disconnected(mod):
    g = mod.Graph(3)
    g.add_edge(0, 1)
    return g


def _iterated(it):
    return [seq.indices() for seq in it] + [it.walks_array().tolist()]


WALKS = {
    "ring": lambda m: m.RandomWalkIterator(_ring(m, 12), walk_length=5, seed=7),
    "cliques": lambda m: m.RandomWalkIterator(_cliques(m), walk_length=10, seed=1),
    "weighted": lambda m: m.WeightedRandomWalkIterator(
        _weighted(m), walk_length=20, seed=3, mode=m.NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED),
    "self_loop": lambda m: m.RandomWalkIterator(
        _disconnected(m), walk_length=3, seed=1, mode=m.NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED),
    "range": lambda m: m.RandomWalkIterator(_ring(m, 12), walk_length=4, seed=2,
                                            first_vertex=3, last_vertex=9),
    "zero_length": lambda m: m.RandomWalkIterator(_ring(m, 5), walk_length=0, seed=2),
    "provider": lambda m: m.RandomWalkGraphIteratorProvider(
        _cliques(m), walk_length=6, seed=4).get_graph_walk_iterators(3),
    "weighted_provider": lambda m: m.WeightedRandomWalkGraphIteratorProvider(
        _weighted(m), walk_length=6, seed=4).get_graph_walk_iterators(2),
    "reset": lambda m: m.RandomWalkIterator(_ring(m, 8), walk_length=3, seed=9),
    "exception": lambda m: m.RandomWalkIterator(
        _disconnected(m), walk_length=3, seed=1, mode=m.NoEdgeHandling.EXCEPTION_ON_DISCONNECTED),
}


@pytest.mark.parametrize("case", list(WALKS))
def test_walks_and_iterators_match_the_reference(case):
    if case == "exception":
        with pytest.raises(R.NoEdgesException) as want:
            WALKS[case](R)
        with pytest.raises(P.NoEdgesException) as got:
            WALKS[case](P)
        assert str(got.value) == str(want.value)
        return
    ref, port = WALKS[case](R), WALKS[case](P)
    if case.endswith("provider"):
        assert [_iterated(i) for i in port] == [_iterated(i) for i in ref]
        return
    if case == "reset":
        for it in (ref, port):
            it.next()
            it.reset()
    assert port.walk_length() == ref.walk_length()
    assert _iterated(port) == _iterated(ref)
    assert not port.has_next()
    with pytest.raises(StopIteration):
        port.next()


# ------------------------------------------------------------------ Huffman
HUFFMAN = {"skewed": [1, 50, 3, 2, 1, 100, 2, 1], "small": [4, 2, 7, 1, 9, 3],
           "equal": [5] * 9, "single": [3], "cliques": None}


@pytest.mark.parametrize("case", list(HUFFMAN))
def test_huffman_matches_the_reference(case):
    degrees = HUFFMAN[case] or _cliques(R).vertex_degrees().tolist()
    ref = R.GraphHuffman(len(degrees)).build_tree(degrees)
    port = P.GraphHuffman(len(degrees)).build_tree(degrees)
    for v in range(len(degrees)):
        assert port.get_code(v) == ref.get_code(v)
        assert port.get_code_length(v) == ref.get_code_length(v)
        assert port.get_code_string(v) == ref.get_code_string(v)
        assert port.get_path_inner_nodes(v) == ref.get_path_inner_nodes(v)
    for got, want in zip(port.path_arrays(), ref.path_arrays()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="exceeds 2 bits"):
        P.GraphHuffman(len(degrees) + 4, max_code_length=2).build_tree(
            list(degrees) + [1, 1, 1, 1])


# ------------------------------------------------------------------ DeepWalk
MODELS = {
    "deepwalk": ("DeepWalk", dict(vector_size=16, window_size=2, learning_rate=0.05,
                                  seed=11, batch_size=256)),
    "node2vec": ("Node2Vec", dict(vector_size=16, window_size=2, learning_rate=0.05,
                                  seed=11, batch_size=256, p=0.25, q=4.0,
                                  walks_per_vertex=2)),
}
FIT = dict(walk_length=10, epochs=2)


def _initial(mod, name):
    cls, kw = MODELS[name]
    model = getattr(mod, cls)(**kw) if mod is R else getattr(mod, cls)(**kw, device="cpu")
    model.initialize(_cliques(mod))
    return model


def _table(model):
    t = model.lookup_table
    return {n: (getattr(t, n).numpy() if isinstance(getattr(t, n), torch.Tensor)
                else np.asarray(getattr(t, n))) for n in ("vertex_vectors", "out_weights")}


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(initial tables, the fitted reference model)."""
    ref = _initial(R, name)
    start = _table(ref)
    ref.fit(ref.graph, **FIT)
    return start, ref


def _port(name, dtype=torch.float32):
    start, _ = _reference(name)
    port = _initial(P, name)
    load_reference_graph_lookup_table(port, start["vertex_vectors"], start["out_weights"])
    port.lookup_table.to(dtype=dtype)
    port.fit(port.graph, **FIT)
    return port


@pytest.mark.parametrize("name", list(MODELS))
def test_tables_from_carried_weights_match_the_reference(name):
    _, ref = _reference(name)
    port = _port(name)
    want, got = _table(ref), _table(port)
    for n, w in want.items():
        assert got[n].dtype == np.float32 and got[n].shape == w.shape, n
        err = np.abs(got[n] - w).max()
        assert err <= TOL * np.abs(w).max(), (name, n, err)
        assert not np.array_equal(w, _reference(name)[0][n]), "training moved nothing"


def test_node2vec_walks_equal_the_reference_s():
    ref, port = _initial(R, "node2vec"), _initial(P, "node2vec")
    for walk_length in (0, 1, 7):
        want = ref.generate_walks(ref.graph, walk_length, np.random.default_rng(5))
        got = port.generate_walks(port.graph, walk_length, np.random.default_rng(5))
        np.testing.assert_array_equal(got, want)
    edgeless_r, edgeless_p = R.Node2Vec(walks_per_vertex=1), P.Node2Vec(walks_per_vertex=1,
                                                                        device="cpu")
    np.testing.assert_array_equal(
        edgeless_p.generate_walks(P.Graph(3), 4, np.random.default_rng(0)),
        edgeless_r.generate_walks(R.Graph(3), 4, np.random.default_rng(0)))


def _carried(name="deepwalk"):
    """A reference model and a port model, each holding the reference's
    trained tables (models of their own: the cases may train them on)."""
    t = _table(_reference(name)[1])
    ref, port = _initial(R, name), _initial(P, name)
    ref.lookup_table.vertex_vectors = jnp.asarray(t["vertex_vectors"])
    ref.lookup_table.out_weights = jnp.asarray(t["out_weights"])
    load_reference_graph_lookup_table(port, t["vertex_vectors"], t["out_weights"])
    return ref, port


QUERIES = {
    "vectors_and_gradients": lambda m: [m.lookup_table.vectors_and_gradients(a, b)
                                        for a, b in ((0, 5), (3, 30), (19, 20))],
    "calculate_prob": lambda m: [m.lookup_table.calculate_prob(a, b)
                                 for a in (0, 21) for b in range(40)],
    "calculate_score": lambda m: [m.lookup_table.calculate_score(a, b)
                                  for a, b in ((1, 2), (5, 33))],
    "similarity": lambda m: [m.similarity(a, b) for a in (0, 19, 25) for b in (1, 20, 39)],
    "vertices_nearest": lambda m: [m.vertices_nearest(v, 7).tolist() for v in (0, 19, 20, 39)],
    "vectors": lambda m: [m.get_vertex_vector(3), m.lookup_table.get_inner_node_vector(4),
                          m.lookup_table.get_vertex_vectors()],
}


@pytest.mark.parametrize("query", list(QUERIES))
def test_queries_on_carried_tables_give_the_reference_s_answers(query):
    ref, port = _carried()
    got, want = QUERIES[query](port), QUERIES[query](ref)
    if query == "vertices_nearest":
        assert got == want
    elif query == "vectors_and_gradients":
        for (gv, gg), (wv, wg) in zip(got, want):
            for a, b in zip(gv + gg, wv + wg):
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)
    elif query == "vectors":
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_vertices_nearest_breaks_ties_by_index():
    ref, port = _carried()
    vv = _table(ref)["vertex_vectors"].copy()
    vv[[4, 9, 12]] = vv[2] * 3.0      # the same direction: equal similarity
    vv[[30, 31]] = vv[25]
    for m in (ref, port):
        m.lookup_table.set_vertex_vectors(vv)
    for v in (2, 25, 0):
        assert port.vertices_nearest(v, 6).tolist() == ref.vertices_nearest(v, 6).tolist()


def test_f64_fit_and_single_pair_steps():
    """The table in f64 trains in f64 nearer the reference's f32 than 1e-5;
    ``iterate`` is one step of one pair."""
    port = _port("deepwalk", torch.float64)
    assert port.lookup_table.vertex_vectors.dtype == torch.float64
    _, ref = _reference("deepwalk")
    for n, w in _table(ref).items():
        assert np.abs(_table(port)[n] - w).max() <= TOL * np.abs(w).max()
    ref2, port2 = _carried()
    for m in (ref2, port2):
        m.set_learning_rate(0.5)
        m.lookup_table.iterate(3, 17)
    for n, w in _table(ref2).items():
        np.testing.assert_allclose(_table(port2)[n], w, rtol=1e-6, atol=1e-7)


def test_fit_on_given_walks_and_the_builder():
    ref, port = _carried()
    walks = np.random.default_rng(1).integers(0, 40, size=(30, 9))
    ref.fit(walks=walks, epochs=2)
    port.fit(walks=walks, epochs=2)
    for n, w in _table(ref).items():
        assert np.abs(_table(port)[n] - w).max() <= TOL * np.abs(w).max()
    built = (P.DeepWalk.Builder().vector_size(32).window_size(3).learning_rate(0.2)
             .seed(9).device("cpu").build())
    assert (built.get_vector_size(), built.get_window_size(),
            built.get_learning_rate(), built.seed) == (32, 3, 0.2, 9)
    with pytest.raises(RuntimeError, match="not initialized"):
        P.DeepWalk(device="cpu").fit(walks=walks)
    with pytest.raises(ValueError, match="needs a graph"):
        dw = P.DeepWalk(vector_size=4, device="cpu")
        dw.initialize([2, 2, 1])
        dw.fit()


def test_serializer_files_equal_byte_for_byte_read_both_ways(tmp_path):
    ref, port = _carried()
    mine, theirs = str(tmp_path / "port.txt"), str(tmp_path / "ref.txt")
    P.GraphVectorSerializer.write_graph_vectors(port, mine)
    R.GraphVectorSerializer.write_graph_vectors(ref, theirs)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    want = _table(ref)["vertex_vectors"]
    back = P.GraphVectorSerializer.load_txt_vectors(theirs, device="cpu")
    assert back.lookup_table.tree is None and back.lookup_table.vertex_vectors.dtype == torch.float32
    np.testing.assert_array_equal(back.lookup_table.get_vertex_vectors(), want)
    np.testing.assert_array_equal(
        np.asarray(R.GraphVectorSerializer.load_txt_vectors(mine).lookup_table.vertex_vectors),
        want)
    assert (back.num_vertices(), back.get_vector_size()) == (40, 16)
    (tmp_path / "empty.txt").write_text("")
    with pytest.raises(ValueError, match="No vectors"):
        P.GraphVectorSerializer.load_txt_vectors(str(tmp_path / "empty.txt"), device="cpu")


def test_carry_refuses_a_wrong_shape_and_copies_nothing():
    ref, port = _carried()
    t = _table(ref)
    before = _table(port)
    with pytest.raises(ValueError, match="out_weights: shape"):
        load_reference_graph_lookup_table(port, t["vertex_vectors"] * 2, t["out_weights"][:-1])
    with pytest.raises(ValueError, match="vertex_vectors: shape"):
        load_reference_graph_lookup_table(port.lookup_table, t["vertex_vectors"][:, :8],
                                          t["out_weights"])
    for n, w in before.items():
        np.testing.assert_array_equal(_table(port)[n], w)
    with pytest.raises(RuntimeError, match="initialize"):
        load_reference_graph_lookup_table(P.DeepWalk(device="cpu"), t["vertex_vectors"],
                                          t["out_weights"])
