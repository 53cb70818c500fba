"""The port's MultiLayerNetwork on the CPU against the JAX package's: DL4J's
character-modelling LSTM at a small width (2 x LSTM(16), vocabulary 12,
T 20, TBPTT 5, Adam(0.005), l2 1e-4), from the JAX net's weights.

With no lstm helper registered and auto-fused-LSTM on, every LSTM layer of
the port takes the fused seam (``FusedLSTMHelper``: on CPU tensors the
kernel's plain version, differentiated by recomputation), so the kernel
path's arithmetic is what is held to the reference here; the same net with
the auto switch off runs the built-in loop.

Tolerances, those of the JAX package's helper tests
(``tests/test_helpers.py``): outputs rtol 2e-5 / atol 2e-6 (:79);
gradients rtol 1e-4 / atol 1e-6 (:97); after fit steps, params, Adam
moments and scores 2e-5 (:307).
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JIter
from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import GravesLSTMLayer as JGraves
from deeplearning4j_tpu.nn.layers import LSTMLayer as JLSTM
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn import updaters as PU
from deeplearning4j_tpu_torch.nn.conf import (
    InputType,
    ListBuilder,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.network import normalize_backprop_type
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    DenseLayer,
    GravesLSTMLayer,
    LSTMLayer,
    OutputLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    export_updater_state,
    load_reference_params,
    load_reference_updater_state,
)

VOCAB, WIDTH, N, T, TBPTT = 12, 16, 4, 20, 5
RTOL, ATOL = 2e-5, 2e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
STEP_TOL = 2e-5
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


@pytest.fixture(autouse=True)
def _clean_seams():
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    yield
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    thelpers.set_auto_fused_lstm(True)


def _char_conf(builder, lstm, rnn_out, input_type, tbptt=True):
    """DL4J's LSTMCharModellingExample configuration at the small width."""
    b = (builder().seed(12345).l2(1e-4).weight_init("xavier")
         .updater(_adam(builder)).list()
         .layer(lstm(n_out=WIDTH, activation="tanh"))
         .layer(lstm(n_out=WIDTH, activation="tanh"))
         .layer(rnn_out(n_out=VOCAB, loss="mcxent", activation="softmax"))
         .set_input_type(input_type.recurrent(VOCAB)))
    if tbptt:
        b = b.backprop_type("TruncatedBPTT").t_bptt_length(TBPTT)
    return b.build()


def _adam(builder):
    return JU.Adam(0.005) if builder is JNNC.builder else PU.Adam(0.005)


def _pair(graves=False, tbptt=True):
    """(JAX net, port net on the CPU with the JAX net's initial weights)."""
    jl = JGraves if graves else JLSTM
    tl = GravesLSTMLayer if graves else LSTMLayer
    jnet = JaxMLN(_char_conf(JNNC.builder, jl, JRnnOut, JIT, tbptt=tbptt)).init()
    tnet = MultiLayerNetwork(_char_conf(NeuralNetConfiguration.builder, tl,
                                        RnnOutputLayer, InputType, tbptt=tbptt),
                             device="cpu").init()
    return jnet, load_reference_params(tnet, to_np(jnet.params))


def _chars(seed=0, n=N, t=T):
    """One-hot characters and their next characters."""
    ids = np.random.default_rng(seed).integers(0, VOCAB, (n, t + 1))
    eye = np.eye(VOCAB, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


def _assert_tree(got, want, tol, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), f"{what} layer {i}"
        for n in w:
            if isinstance(w[n], dict):
                for s in w[n]:
                    np.testing.assert_allclose(g[n][s], w[n][s], rtol=tol, atol=tol,
                                               err_msg=f"{what} {i}/{n}/{s}")
            else:
                np.testing.assert_allclose(g[n], w[n], rtol=tol, atol=tol,
                                           err_msg=f"{what} {i}/{n}")


# ---------------------------------------------------------------- the conf
def test_list_conf_matches_reference():
    jc = _char_conf(JNNC.builder, JLSTM, JRnnOut, JIT)
    tc = _char_conf(NeuralNetConfiguration.builder, LSTMLayer, RnnOutputLayer,
                    InputType)
    assert isinstance(tc, MultiLayerConfiguration)
    assert (tc.backprop_type, tc.tbptt_fwd_length, tc.tbptt_bwd_length) == (
        jc.backprop_type, jc.tbptt_fwd_length, jc.tbptt_bwd_length) == (
        "truncated_bptt", TBPTT, TBPTT)
    for jl, tl in zip(jc.layers, tc.layers):
        for f in ("n_in", "n_out", "activation", "weight_init", "l1", "l2",
                  "l1_bias", "l2_bias"):
            assert getattr(tl, f) == getattr(jl, f), f
        assert tl.updater.to_dict() == jl.updater.to_dict()
    assert [l.l2 for l in tc.layers] == [1e-4] * 3  # inherited from the builder
    assert tc.layers[0].l2_bias is None
    assert [l.n_in for l in tc.layers] == [VOCAB, WIDTH, WIDTH]
    assert tc.preprocessors == jc.preprocessors == {}
    assert tc.num_params() == jc.num_params()
    assert tc.output_type() == InputType.recurrent(VOCAB)


def test_builder_options():
    assert isinstance(NeuralNetConfiguration.builder().list(), ListBuilder)
    for alias in ("TBPTT", "TruncatedBPTT", "truncated_bptt"):
        assert normalize_backprop_type(alias) == "truncated_bptt"
    assert normalize_backprop_type(None) == "standard"
    with pytest.raises(ValueError, match="unknown backprop_type"):
        normalize_backprop_type("sideways")
    g = (NeuralNetConfiguration.builder().l1(0.1).l2(0.2).l1_bias(0.3)
         .l2_bias(0.4))._g
    assert (g.l1, g.l2, g.l1_bias, g.l2_bias) == (0.1, 0.2, 0.3, 0.4)
    lb = NeuralNetConfiguration.builder().list().layer(DenseLayer(n_in=3, n_out=2))
    with pytest.raises(ValueError, match="in order"):
        lb.layer(DenseLayer(n_out=2), index=5)
    conf = lb.input_pre_processor(0, "cnn_to_ff").build()
    assert sorted(conf.preprocessors) == [0]
    assert conf.input_pre_processors == {0: "cnn_to_ff"}
    with pytest.raises(ValueError, match="no layers"):
        NeuralNetConfiguration.builder().list().build()


# ---------------------------------------------------------------- inference
@pytest.mark.parametrize("auto", [True, False], ids=["fused-seam", "loop"])
def test_output_matches_reference(auto):
    thelpers.set_auto_fused_lstm(auto)
    jnet, tnet = _pair()
    x, _ = _chars(1)
    out = tnet.output(x)
    assert out.shape == (N, T, VOCAB) and out.is_inference()
    np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(x)), rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(out.sum(-1), torch.ones(N, T))
    np.testing.assert_array_equal(tnet.predict(x), np.asarray(jnet.predict(x)))
    # an iterator of DataSets: the batch outputs concatenated
    it_out = tnet.output(ListDataSetIterator(DataSet(x, x), 3))
    torch.testing.assert_close(it_out, out)


def test_rnn_time_step_in_pieces_matches_the_whole_sequence():
    jnet, tnet = _pair()
    x, _ = _chars(2)
    whole = tnet.output(x)
    first = tnet.rnn_time_step(x[:, :7])
    second = tnet.rnn_time_step(x[:, 7:])
    torch.testing.assert_close(torch.cat([first, second], 1), whole, rtol=RTOL,
                               atol=ATOL)
    j_first = np.asarray(jnet.rnn_time_step(x[:, :7]))
    j_second = np.asarray(jnet.rnn_time_step(x[:, 7:]))
    np.testing.assert_allclose(first.numpy(), j_first, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(second.numpy(), j_second, rtol=RTOL, atol=ATOL)
    # one step at a time on [N, C]: the answer is [N, out]
    one = tnet.rnn_time_step(x[:, 0])
    j_one = np.asarray(jnet.rnn_time_step(x[:, 0]))
    assert one.shape == (N, VOCAB)
    np.testing.assert_allclose(one.numpy(), j_one, rtol=RTOL, atol=ATOL)
    h, c = tnet.rnn_get_previous_state(1)
    jh, jc = jnet.rnn_get_previous_state(1)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=RTOL, atol=ATOL)
    assert tnet.rnn_get_previous_state(2) is None
    # restore a stored state (a strided view of a copy) and continue
    saved = [tnet.rnn_get_previous_state(i) for i in range(3)]
    nxt = tnet.rnn_time_step(x[:, 1])
    tnet.rnn_set_previous_state(0, tuple(t.clone().t().contiguous().t() for t in saved[0]))
    tnet.rnn_set_previous_state(1, saved[1])
    torch.testing.assert_close(tnet.rnn_time_step(x[:, 1]), nxt)
    tnet.rnn_clear_previous_state()
    assert tnet.rnn_get_previous_state(0) is None
    with pytest.raises(ValueError, match="call rnn_time_step first"):
        tnet.rnn_set_previous_state(0, saved[0])
    torch.testing.assert_close(tnet.rnn_time_step(x[:, :7]), first)


# ----------------------------------------------------------------- training
@pytest.mark.parametrize("graves", [False, True], ids=["lstm", "graves"])
def test_gradient_and_score_match_reference(graves):
    jnet, tnet = _pair(graves=graves)
    x, y = _chars(3)
    g_j, loss_j = jnet.compute_gradient_and_score(x, y)
    g_t, loss_t = tnet.compute_gradient_and_score(x, y)
    np.testing.assert_allclose(loss_t, loss_j, rtol=RTOL)
    for i, named in enumerate(to_np(g_j)):
        assert set(g_t[i]) == set(named)
        for n, want in named.items():
            np.testing.assert_allclose(g_t[i][n].numpy(), want, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=f"{i}/{n}")
    assert tnet.iteration == 0  # no update


def test_regularization_matches_reference():
    jnet, tnet = _pair()
    reg = tnet._regularization(tnet.params)
    np.testing.assert_allclose(float(reg), float(jnet._regularization(jnet.params)),
                               rtol=1e-6)
    weights = sum(float((p * p).sum()) for d in tnet.params.values()
                  for n, p in d.items() if n != "b")
    np.testing.assert_allclose(float(reg), 0.5 * 1e-4 * weights, rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused"])
def test_three_tbptt_fit_steps_match_reference(fused):
    """3 fit calls on [4, 20] sequences with TBPTT 5: 12 chunk iterations,
    Adam + l2, the recurrent carry handed on detached."""
    jnet, tnet = _pair()
    if fused:
        thelpers.set_helper("updater", ck.FusedUpdaterHelper())
    x, y = _chars(4)
    for _ in range(3):
        jnet.fit(x, y)
        tnet.fit(x, y)
        np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=STEP_TOL,
                                   atol=STEP_TOL)
    assert (tnet.iteration, tnet.epoch, tnet.last_batch_size) == (
        jnet.iteration, jnet.epoch, jnet.last_batch_size) == (12, 3, N)
    _assert_tree(export_params(tnet), to_np(jnet.params), STEP_TOL, "param")
    _assert_tree(export_updater_state(tnet), to_np(jnet.updater_states), STEP_TOL,
                 "state")
    assert tnet.transfer_bytes == jnet.transfer_bytes
    assert not any(p.requires_grad for p in tnet.parameters())


def test_tbptt_takes_one_update_per_chunk():
    calls = []

    class Spy(ck.FusedUpdaterHelper):
        def apply(self, updater, param, grad, state, lr, t):
            calls.append(t)
            return super().apply(updater, param, grad, state, lr, t)

    _, tnet = _pair()
    thelpers.set_helper("updater", Spy())
    tnet.fit(*_chars(5))
    assert calls == [float(t) for t in range(1, 5) for _ in range(8)]


def test_fit_iterator_with_masks_matches_reference():
    """Two epochs over an iterator of masked sequences (a label mask with
    gaps, one sequence of 13 steps), with the fused updater."""
    x, y = _chars(6, n=6)
    mask = np.ones((6, T), np.float32)
    mask[2, 13:] = 0.0
    mask[4, ::3] = 0.0
    jnet, tnet = _pair()
    jnet.fit(JIter(JDataSet(x, y, labels_mask=mask), 4, shuffle=True, seed=3),
             epochs=2)
    thelpers.set_helper("updater", ck.FusedUpdaterHelper())
    tnet.fit(ListDataSetIterator(DataSet(x, y, labels_mask=mask), 4, shuffle=True,
                                 seed=3), epochs=2)
    assert (tnet.iteration, tnet.epoch) == (jnet.iteration, jnet.epoch) == (16, 2)
    np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=STEP_TOL, atol=STEP_TOL)
    _assert_tree(export_params(tnet), to_np(jnet.params), STEP_TOL, "param")
    ds = DataSet(x, y, features_mask=mask)
    np.testing.assert_allclose(tnet.score(ds), jnet.score(JDataSet(x, y, features_mask=mask)),
                               rtol=1e-5)


def test_standard_backprop_fit_matches_reference():
    """The same net without TBPTT: one update over the whole sequence."""
    jnet, tnet = _pair(tbptt=False)
    x, y = _chars(7)
    for _ in range(2):
        jnet.fit(JDataSet(x, y))
        tnet.fit(DataSet(x, y))
    assert tnet.iteration == jnet.iteration == 2
    np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=STEP_TOL, atol=STEP_TOL)
    _assert_tree(export_params(tnet), to_np(jnet.params), STEP_TOL, "param")


def test_resume_from_the_reference_optimizer_state():
    jnet, tnet = _pair()
    x, y = _chars(8)
    jnet.fit(x, y)
    tnet = load_reference_params(tnet, to_np(jnet.params))
    load_reference_updater_state(tnet, to_np(jnet.updater_states))
    tnet.iteration = jnet.iteration
    jnet.fit(x, y)
    tnet.fit(x, y)
    _assert_tree(export_updater_state(tnet), to_np(jnet.updater_states), STEP_TOL,
                 "state")


def test_converter_rejects_mismatches():
    jnet, tnet = _pair()
    params = to_np(jnet.params)
    with pytest.raises(ValueError, match="missing layer 2"):
        load_reference_params(tnet, params[:2])
    bad = [dict(d) for d in params]
    bad[0]["RW"] = bad[0]["RW"][:, :5]
    with pytest.raises(ValueError, match=r"0/RW: shape"):
        load_reference_params(tnet, bad)
    _, graves = _pair(graves=True)
    with pytest.raises(ValueError, match=r"RW: shape"):
        load_reference_params(graves, params)  # 4H vs 4H+3 recurrent columns


def test_score_and_output_need_parameters():
    net = MultiLayerNetwork(_char_conf(NeuralNetConfiguration.builder, LSTMLayer,
                                       RnnOutputLayer, InputType), device="cpu")
    with pytest.raises(RuntimeError, match="init"):
        net.output(np.zeros((1, 2, VOCAB), np.float32))
    assert np.isnan(net.score())
    net.fit(*_chars(9, n=2, t=5))  # fit initializes
    assert net.iteration == 1 and np.isfinite(net.score_)


def test_dense_classifier_without_time_matches_reference(rng):
    """A 2-d MultiLayerNetwork (Dense + Output, standard backprop, l1 on
    the weights and l2 on the biases)."""
    def conf(b, dense, out, it, upd):
        return (b().seed(3).l1(1e-3).l2_bias(1e-2).updater(upd).list()
                .layer(dense(n_out=5, activation="tanh")).layer(out(n_out=3))
                .set_input_type(it.feed_forward(6)).build())

    jnet = JaxMLN(conf(JNNC.builder, JDense, JOut, JIT, JU.Adam(1e-2))).init()
    tnet = load_reference_params(
        MultiLayerNetwork(conf(NeuralNetConfiguration.builder, DenseLayer, OutputLayer,
                               InputType, PU.Adam(1e-2)), device="cpu").init(),
        to_np(jnet.params))
    x = rng.normal(size=(8, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    for _ in range(3):
        jnet.fit(x, y)
        tnet.fit(x, y)
        np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=STEP_TOL)
    _assert_tree(export_params(tnet), to_np(jnet.params), STEP_TOL, "param")


# ------------------------------------------------- a graph with regularization
def _graph_confs(jb, tb):
    jg = jb.graph_builder().add_inputs("in").set_input_types(JIT.feed_forward(6))
    jg.add_layer("h", JDense(n_out=5, activation="tanh"), "in")
    jg.add_layer("out", JOut(n_out=3), "h")
    tg = tb.graph_builder().add_inputs("in").set_input_types(InputType.feed_forward(6))
    tg.add_layer("h", DenseLayer(n_out=5, activation="tanh"), "in")
    tg.add_layer("out", OutputLayer(n_out=3), "h")
    return jg.set_outputs("out").build(), tg.set_outputs("out").build()


def test_graph_with_l2_trains_as_reference(rng):
    jc, tc = _graph_confs(
        JNNC.builder().seed(3).l2(0.05).l1_bias(0.01).updater(JU.Adam(1e-2)),
        NeuralNetConfiguration.builder().seed(3).l2(0.05).l1_bias(0.01)
        .updater(PU.Adam(1e-2)))
    assert tc.vertices["h"].obj.l2 == 0.05 and tc.vertices["out"].obj.l1_bias == 0.01
    jnet = JaxGraph(jc).init()
    tnet = load_reference_params(ComputationGraph(tc, device="cpu").init(),
                                 to_np(jnet.params))
    x = rng.normal(size=(8, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    _, loss_j = jnet.compute_gradient_and_score(x, y)
    _, loss_t = tnet.compute_gradient_and_score(x, y)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-6)
    for _ in range(3):
        jnet.fit(x, y)
        tnet.fit(x, y)
        np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=STEP_TOL)
    want = to_np(jnet.params)
    for v in want:
        for n in want[v]:
            np.testing.assert_allclose(export_params(tnet)[v][n], want[v][n],
                                       rtol=STEP_TOL, atol=STEP_TOL, err_msg=f"{v}/{n}")
