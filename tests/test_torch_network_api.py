"""The networks' remaining API in the port on the CPU against the JAX
package's: ``fit_batches_on_device``, listeners, ``score_examples``,
``set_learning_rate``, ``clone``, ``to_computation_graph``, the getters,
``summary``, ``params_flat``, the ROC and regression evaluators and the
``mini_batch`` setting.

Two small networks, each built by both packages from one configuration
with the JAX network's initial weights carried across: a
``MultiLayerNetwork`` (dense 6, LSTM 5, softmax 4 over [4, 6, 3] sequences,
l2 1e-3, Adam(0.01)) and a two-input ``ComputationGraph`` (dense 5 and
dense 4, merged, softmax 2; the same settings).

Tolerances: after steps, each parameter and updater-state tensor within
1e-5 x its largest entry (2e-5 after ``set_learning_rate``); scores,
outputs and evaluator readings within 1e-5; the window against the
port's own per-batch ``fit``, and a clone against its original, bit for
bit; texts, names, keys and counts equal.
"""

import json

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMulti
from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn import vertices as JV
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.network import MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn import layers as PL
from deeplearning4j_tpu_torch.nn import updaters as PU
from deeplearning4j_tpu_torch.nn import vertices as PV
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    export_updater_state,
    load_reference_params,
)
from deeplearning4j_tpu_torch.zoo.models import TransformerLM

STEP_TOL, LR_TOL, OUT_TOL = 1e-5, 2e-5, 1e-5
N, T, N_GRAPH = 4, 6, 8
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


@pytest.fixture(autouse=True)
def _clean_seams():
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    yield
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()


class Side:
    """One package's names."""

    def __init__(self, nnc, it, layers, upd, vertices, mln, graph, ds, mds):
        self.nnc, self.it, self.L, self.U, self.V = nnc, it, layers, upd, vertices
        self.mln, self.graph, self.ds, self.mds = mln, graph, ds, mds


REF = Side(JNNC, JIT, JL, JU, JV, JaxMLN, JaxGraph, JDataSet, JMulti)
PORT = Side(NeuralNetConfiguration, InputType, PL, PU, PV,
            lambda c: MultiLayerNetwork(c, device="cpu"),
            lambda c: ComputationGraph(c, device="cpu"), DataSet, MultiDataSet)


def mln_conf(s, tbptt=False, dropout=None, mini_batch=True):
    b = s.nnc.builder().seed(7).l2(1e-3).updater(s.U.Adam(0.01))
    if not mini_batch:
        b = b.mini_batch(False)
    b = (b.list()
         .layer(s.L.DenseLayer(n_out=6, activation="tanh", dropout=dropout))
         .layer(s.L.LSTMLayer(n_out=5, activation="tanh"))
         .layer(s.L.RnnOutputLayer(n_out=4, loss="mcxent", activation="softmax"))
         .set_input_type(s.it.recurrent(3)))
    if tbptt:
        b = b.backprop_type("TruncatedBPTT").t_bptt_length(3)
    return b.build()


def graph_conf(s, dropout=None):
    return (s.nnc.builder().seed(9).l2(1e-3).updater(s.U.Adam(0.01)).graph_builder()
            .add_inputs("in_a", "in_b")
            .add_layer("dense_a", s.L.DenseLayer(n_in=3, n_out=5, activation="tanh",
                                                 dropout=dropout), "in_a")
            .add_layer("dense_b", s.L.DenseLayer(n_in=2, n_out=4, activation="relu"),
                       "in_b")
            .add_vertex("merge", s.V.MergeVertex(), "dense_a", "dense_b")
            .add_layer("out", s.L.OutputLayer(n_in=9, n_out=2, activation="softmax",
                                              loss="mcxent"), "merge")
            .set_outputs("out").build())


def net(s, kind, **kw):
    return s.mln(mln_conf(s, **kw)) if kind == "mln" else s.graph(graph_conf(s, **kw))


def pair(kind, **kw):
    """(JAX net, port net with the JAX net's initial weights)."""
    j = net(REF, kind, **kw).init()
    return j, load_reference_params(net(PORT, kind, **kw).init(), to_np(j.params))


def batches(kind, k, seed=0, label_mask=False):
    """``k`` seeded batches as (reference DataSets, port DataSets): [N, T]
    sequences for the network, two inputs for the graph."""
    rng = np.random.default_rng(seed)
    ref, port = [], []
    for _ in range(k):
        if kind == "mln":
            x = rng.normal(size=(N, T, 3)).astype(np.float32)
            y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (N, T))]
            lm = (rng.random((N, T)) > 0.3).astype(np.float32) if label_mask else None
            ref.append(JDataSet(x, y, None, lm))
            port.append(DataSet(x, y, None, lm))
        else:
            a = rng.normal(size=(N_GRAPH, 3)).astype(np.float32)
            b = rng.normal(size=(N_GRAPH, 2)).astype(np.float32)
            y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, N_GRAPH)]
            ref.append(JMulti([a, b], [y]))
            port.append(MultiDataSet([a, b], [y]))
    return ref, port


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def assert_close_tree(got, want, rel, what):
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, f"{what} leaf {i}"
        assert np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1e-30), f"{what} leaf {i}"


def assert_same_state(a, b):
    """Two port networks hold equal parameters, layer and updater states
    and counters, bit for bit."""
    for tree in ("params", "states", "updater_states"):
        la, lb = leaves(getattr(a, tree)), leaves(getattr(b, tree))
        assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb)), tree
    assert torch.equal(a.dropout_generator.get_state(), b.dropout_generator.get_state())


# --------------------------------------------------------------- the window
@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_window_matches_reference_and_per_batch_fit(kind):
    j, p = pair(kind)
    twin = p.clone()
    jb, pb = batches(kind, 3)
    j.fit_batches_on_device(jb)
    p.fit_batches_on_device(pb)
    for ds in pb:
        twin.fit(ds)
    assert_same_state(p, twin)
    assert p.iteration == twin.iteration == j.iteration == 3
    assert p.score_ == twin.score_
    assert_close_tree(export_params(p), to_np(j.params), STEP_TOL, "params")
    assert_close_tree(export_updater_state(p), to_np(j.updater_states), STEP_TOL,
                      "updater state")
    assert abs(p.score_ - j.score_) <= OUT_TOL * abs(j.score_)


@pytest.mark.parametrize("case", ["mln_mask", "mln_tbptt", "graph_mask", "shapes",
                                  "empty"])
def test_window_refusals_as_reference(case):
    kind = "graph" if case == "graph_mask" else "mln"
    kw = {"tbptt": True} if case == "mln_tbptt" else {}
    for s in (REF, PORT):
        n = net(s, kind, **kw).init()
        rng = np.random.default_rng(1)
        if kind == "graph":
            a, b = rng.normal(size=(N_GRAPH, 3)), rng.normal(size=(N_GRAPH, 2))
            window = [s.mds([a, b], [np.eye(2)[rng.integers(0, 2, N_GRAPH)]],
                            None, [np.ones(N_GRAPH)])]
        else:
            x, y = rng.normal(size=(N, T, 3)), np.eye(4)[rng.integers(0, 4, (N, T))]
            window = {"mln_mask": [s.ds(x, y, None, np.ones((N, T)))],
                      "mln_tbptt": [s.ds(x, y)],
                      "shapes": [s.ds(x, y), s.ds(x[:2], y[:2])],
                      "empty": []}[case]
        if case == "empty":
            before = leaves(to_np(n.params) if s is REF else export_params(n))
            n.fit_batches_on_device(window)
            after = leaves(to_np(n.params) if s is REF else export_params(n))
            assert n.iteration == 0
            assert all(np.array_equal(u, v) for u, v in zip(before, after))
        else:
            with pytest.raises(ValueError):
                n.fit_batches_on_device(window)


def test_window_checks_token_ids_once_before_its_steps(monkeypatch):
    """A language model's window reads its ids' range once, over the
    stacked window, and its steps skip the per-step read; an id out of
    range is refused before any step."""
    net = TransformerLM(vocab_size=12, max_length=16, n_layers=1, d_model=8,
                        n_heads=2, d_ff=16, seed=1).init(device="cpu")
    rng = np.random.default_rng(3)
    ids = [rng.integers(0, 12, (2, 8)) for _ in range(3)]
    window = [DataSet(i, np.eye(12, dtype=np.float32)[np.roll(i, -1, 1)]) for i in ids]
    calls, check = [], PL.EmbeddingSequenceLayer.check_ids
    monkeypatch.setattr(PL.EmbeddingSequenceLayer, "check_ids",
                        lambda layer, x: (calls.append(tuple(x.shape)), check(layer, x)))
    net.fit_batches_on_device(window)
    assert calls == [(3, 2, 8)] and net.iteration == 3
    kept = [t.clone() for t in leaves(net.params)]
    window[2].features = np.full((2, 8), 12)
    with pytest.raises(ValueError, match="token ids"):
        net.fit_batches_on_device(window)
    assert net.iteration == 3
    assert all(torch.equal(a, b) for a, b in zip(kept, leaves(net.params)))


# ---------------------------------------------------------------- listeners
class Recorder:
    def __init__(self):
        self.calls = []

    def on_epoch_start(self, model):
        self.calls.append(("on_epoch_start", model.iteration, model.epoch, None))

    def on_epoch_end(self, model):
        self.calls.append(("on_epoch_end", model.iteration, model.epoch, None))

    def iteration_done(self, model, iteration, epoch):
        self.calls.append(("iteration_done", iteration, epoch, model.score_))


@pytest.mark.parametrize("case", ["mln_fit", "mln_tbptt_fit", "mln_window",
                                  "graph_fit", "graph_window"])
def test_listener_sequence_as_reference(case):
    kind = case.split("_")[0]
    j, p = pair(kind, **({"tbptt": True} if "tbptt" in case else {}))
    jb, pb = batches(kind, 2)
    sequences = []
    for n, bs in ((j, jb), (p, pb)):
        rec = Recorder()
        n.set_listeners()
        n.add_listeners(rec)
        if case.endswith("window"):
            n.fit_batches_on_device(bs)
        else:
            n.fit(bs, epochs=2)
        sequences.append(rec.calls)
    want, got = sequences
    assert [c[:3] for c in got] == [c[:3] for c in want]
    assert len(want) == (2 if case.endswith("window") else 8)
    for g, w in zip(got, want):
        if w[3] is not None:
            assert abs(g[3] - w[3]) <= OUT_TOL * abs(w[3])


# --------------------------------------------------------- score_examples
@pytest.mark.parametrize("case", ["mln", "mln_regularized", "mln_label_mask",
                                  "graph", "graph_regularized"])
def test_score_examples_as_reference(case):
    kind = case.split("_")[0]
    j, p = pair(kind)
    jb, pb = batches(kind, 1, seed=4, label_mask=case.endswith("mask"))
    reg = case.endswith("regularized")
    want = np.asarray(j.score_examples(jb[0], add_regularization=reg))
    got = p.score_examples(pb[0], add_regularization=reg)
    assert got.shape == want.shape == (N if kind == "mln" else N_GRAPH,)
    np.testing.assert_allclose(got, want, rtol=OUT_TOL, atol=0)


# ------------------------------------------------------- set_learning_rate
@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_set_learning_rate_then_two_steps(kind):
    j, p = pair(kind)
    jb, pb = batches(kind, 3, seed=2)
    j.fit(jb[0])
    p.fit(pb[0])
    for n in (j, p):
        n.set_learning_rate(0.002)
    for a, b in zip(jb[1:], pb[1:]):
        j.fit(a)
        p.fit(b)
    assert_close_tree(export_params(p), to_np(j.params), LR_TOL, "params")
    assert_close_tree(export_updater_state(p), to_np(j.updater_states), LR_TOL,
                      "updater state")
    updaters = [u for named in p._updaters.values() for u in named.values()]
    assert all(isinstance(u, PU.Adam) and u.learning_rate == 0.002 for u in updaters)
    assert p.conf.global_conf.updater.learning_rate == 0.002


# -------------------------------------------------------------- inspection
def test_network_inspection_as_reference():
    j_conf, p_conf = mln_conf(REF), mln_conf(PORT)
    j, p = REF.mln(j_conf), PORT.mln(p_conf)
    assert p.num_params() == j.num_params() == 288
    j.init()
    load_reference_params(p.init(), to_np(j.params))
    assert p.num_params() == j.num_params()
    assert p.summary() == j.summary()
    np.testing.assert_array_equal(p.params_flat(), np.asarray(j.params_flat()))
    assert p.n_layers == j.n_layers == 3
    assert p.get_layer_names() == j.get_layer_names()
    assert [type(l).__name__ for l in p.get_layers()] == \
        [type(l).__name__ for l in j.get_layers()]
    assert type(p.get_output_layer()).__name__ == type(j.get_output_layer()).__name__
    assert type(p.get_layer(1)).__name__ == "LSTMLayer"
    assert [p.layer_size(i) for i in range(3)] == [j.layer_size(i) for i in range(3)]
    assert sorted(p.param_table()) == sorted(j.param_table())
    x = batches("mln", 1)[1][0].features
    for train in (False, True):
        assert_close_tree([t.numpy() for t in p.feed_forward(x, train=train)],
                          to_np(j.feed_forward(x, train=train)), OUT_TOL, "activations")
    # the flat vector goes back in place, in the reference's order
    flat = p.params_flat()
    ptrs = [t.data_ptr() for t in leaves(p.params)]
    p.set_params_flat(flat * 0.5)
    j.set_params_flat(np.asarray(j.params_flat()) * 0.5)
    assert ptrs == [t.data_ptr() for t in leaves(p.params)]
    assert_close_tree(export_params(p), to_np(j.params), 0.0, "params")
    ptr = p.get_param("1_RW").data_ptr()
    p.set_param("1_RW", np.zeros((5, 20), np.float32))
    assert p.get_param("1_RW").data_ptr() == ptr
    assert not p.get_param("1_RW").any()
    for n in (j, p):
        with pytest.raises(ValueError, match="shape mismatch"):
            n.set_param("1_RW", np.zeros((5, 19), np.float32))


def test_graph_inspection_as_reference():
    j, p = REF.graph(graph_conf(REF)), PORT.graph(graph_conf(PORT))
    assert p.num_params() == j.num_params()
    j.init()
    load_reference_params(p.init(), to_np(j.params))
    assert p.num_params() == j.num_params()
    assert p.summary() == j.summary()
    assert p.topological_sort_order() == j.topological_sort_order()
    assert (p.get_num_layers(), p.get_num_input_arrays(), p.get_num_output_arrays()) == \
        (j.get_num_layers(), j.get_num_input_arrays(), j.get_num_output_arrays())
    assert list(p.get_vertices()) == list(j.get_vertices())
    assert type(p.get_vertex("merge").obj).__name__ == "MergeVertex"
    assert [type(l).__name__ for l in p.get_layers()] == \
        [type(l).__name__ for l in j.get_layers()]
    assert type(p.get_output_layer()).__name__ == "OutputLayer"
    with pytest.raises(KeyError):
        p.get_layer("merge")
    names = ["dense_a", "dense_b", "out"]
    assert [p.layer_size(n) for n in names] == [j.layer_size(n) for n in names]
    assert sorted(p.param_table()) == sorted(j.param_table())
    np.testing.assert_array_equal(p.get_param("dense_a_W").numpy(),
                                  np.asarray(j.get_param("dense_a_W")))
    a, b = batches("graph", 1)[1][0].features
    acts, want = p.feed_forward(a, b), to_np(j.feed_forward(a, b))
    assert set(acts) == set(want)
    assert_close_tree({k: v.numpy() for k, v in acts.items()}, want, OUT_TOL, "acts")
    np.testing.assert_array_equal(p.predict(a, b), j.predict(a, b))
    ptr = p.get_param("dense_b_b").data_ptr()
    p.set_param("dense_b_b", np.ones(4, np.float32))
    assert p.get_param("dense_b_b").data_ptr() == ptr
    for n in (j, p):
        with pytest.raises(ValueError, match="shape mismatch"):
            n.set_param("dense_b_b", np.ones(5, np.float32))
        with pytest.raises(KeyError):
            n.get_param("dense_c_W")


# ------------------------------------------------------------------- clone
@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_clone_is_independent_and_draws_the_same_masks(kind):
    p = net(PORT, kind, dropout=0.5).init()
    _, pb = batches(kind, 2, seed=5)
    p.fit(pb[0])
    c = p.clone()
    assert not {t.data_ptr() for t in leaves(c.params)} & \
        {t.data_ptr() for t in leaves(p.params)}
    assert_same_state(c, p)
    assert (c.iteration, c.epoch) == (p.iteration, p.epoch) == (1, 1)
    p.fit(pb[1])
    c.fit(pb[1])
    assert_same_state(c, p)  # the same dropout masks on both
    kept = [t.clone() for t in leaves(p.params)]
    c.fit(pb[0])
    assert all(torch.equal(a, b) for a, b in zip(kept, leaves(p.params)))
    assert not all(torch.equal(a, b) for a, b in zip(kept, leaves(c.params)))


# ---------------------------------------------------- to_computation_graph
def test_to_computation_graph_as_reference():
    j, p = pair("mln")
    jb, pb = batches("mln", 3, seed=6)
    j.fit(jb[0])
    p.fit(pb[0])
    jg, pg = j.to_computation_graph(), p.to_computation_graph()
    assert pg.summary() == jg.summary()
    assert (pg.iteration, pg.epoch) == (jg.iteration, jg.epoch) == (1, 1)
    assert_close_tree(export_updater_state(pg), to_np(jg.updater_states), STEP_TOL,
                      "carried updater state")
    x = pb[1].features
    out = pg.output(x)
    assert torch.equal(out, p.output(x))
    assert_close_tree(out.numpy(), np.asarray(jg.output(x)), OUT_TOL, "output")
    for a, b in zip(jb[1:], pb[1:]):
        jg.fit(a)
        pg.fit(b)
        p.fit(b)
    assert_close_tree(export_params(pg), to_np(jg.params), STEP_TOL, "params")
    assert_close_tree(export_params(pg), export_params(p), 0.0, "graph against network")


def test_to_computation_graph_carries_preprocessors():
    """A convolution before a dense head needs the network's flatten; the
    graph keeps it (the reference's conversion drops it)."""
    conf = (NeuralNetConfiguration.builder().seed(3).updater(PU.Adam(0.01)).list()
            .layer(PL.ConvolutionLayer(n_out=2, kernel_size=(3, 3), activation="relu"))
            .layer(PL.OutputLayer(n_out=4))
            .set_input_type(InputType.convolutional(6, 6, 1)).build())
    p = PORT.mln(conf).init()
    g = p.to_computation_graph()
    x = np.random.default_rng(0).normal(size=(2, 6, 6, 1)).astype(np.float32)
    assert torch.equal(g.output(x), p.output(x))


# -------------------------------------------------------------- evaluators
@pytest.mark.parametrize("case", ["mln_roc_multi_class", "mln_roc_binary",
                                  "mln_regression", "graph_roc", "graph_roc_binned",
                                  "graph_roc_multi_class", "graph_regression"])
def test_evaluators_as_reference(case):
    kind = case.split("_")[0]
    j, p = pair(kind)
    jb, pb = batches(kind, 2, seed=8, label_mask=True)
    method = "evaluate_" + case.split("_", 1)[1].replace("_binned", "")
    kw = {"threshold_steps": 10} if case.endswith("binned") else {}
    want, got = getattr(j, method)(jb, **kw), getattr(p, method)(pb, **kw)
    assert type(got).__name__ == type(want).__name__
    if method == "evaluate_regression":
        readings = lambda e: [[m(c) for m in (  # noqa: E731
            e.mean_squared_error, e.mean_absolute_error, e.root_mean_squared_error,
            e.r_squared, e.pearson_correlation)] for c in range(e.num_columns())]
    elif method == "evaluate_roc":
        readings = lambda e: [e.calculate_auc(), e.calculate_auc_pr()]  # noqa: E731
    elif method == "evaluate_roc_binary":
        readings = lambda e: [e.calculate_auc(c) for c in range(e.num_labels())]  # noqa: E731
    else:
        readings = lambda e: [e.calculate_auc(c) for c in range(e.num_classes())]  # noqa: E731
    np.testing.assert_allclose(readings(got), readings(want), rtol=0, atol=OUT_TOL)


# -------------------------------------------------------------- mini_batch
@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_mini_batch_false_json_both_ways(direction):
    src, dst_cls = ((PORT, JMLC) if direction == "port_to_reference"
                    else (REF, MultiLayerConfiguration))
    text = mln_conf(src, mini_batch=False).to_json()
    assert json.loads(text)["global"]["mini_batch"] is False
    back = dst_cls.from_json(text)
    assert back.global_conf.mini_batch is False
    assert json.loads(back.to_json())["global"] == json.loads(text)["global"]


class _Loss:
    """A device loss stand-in that counts its reads."""

    def __init__(self, v):
        self.v, self.reads = v, 0

    def __float__(self):
        self.reads += 1
        return self.v


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_score_can_be_set_as_the_reference(kind):
    """C16: ``score_`` takes a float or a 0-dim tensor and reads it back; an
    assigned loss stays unread (no device sync) until ``score_`` is read."""
    j, t = net(REF, kind), net(PORT, kind)
    for a, b in ((1.25, 1.25), (np.float32(0.5), torch.tensor(0.5))):
        j.score_, t.score_ = a, b
        assert t.score_ == j.score_ == float(a)
    loss = _Loss(3.0)
    t.score_ = loss
    assert loss.reads == 0
    assert t.score_ == 3.0 and loss.reads == 1
    t.score_ = None
    assert np.isnan(t.score_) and np.isnan(net(PORT, kind).score_)
