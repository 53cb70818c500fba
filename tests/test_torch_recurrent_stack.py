"""The rest of the recurrent stack in the port against the JAX package, on
the CPU: SimpleRnn, GRU (``reset_after`` both ways), Bidirectional (each
combine mode; the masked reversal of ragged examples), GravesBidirectional
LSTM, LastTimeStep, MaskZeroLayer and ConvLSTM2D with the ``cnn_seq``
input kind and its preprocessors; their configuration JSON, model zips and
DL4J zips read both ways.

Every layer gets the port's initial parameters in both packages. ``forward_seq`` is
held over a whole sequence and over the same sequence in two pieces with
the carry handed on (what TBPTT and ``rnn_time_step`` do with it), with
and without a mask, within 1e-5 x max(1, largest entry): f32 both ways,
XLA and ATen sum in other orders. Gradients within 1e-5 x each tensor's
largest entry. Two networks (a Bidirectional LSTM, whose carry is a pair
of pairs; a MaskZeroLayer over a GRU) are trained by truncated BPTT (Sgd,
so that an update is a multiple of its gradient) and then answer
``rnn_time_step`` in pieces, both within the same limit.
"""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.modelimport import dl4j as jdl4j
from deeplearning4j_tpu.modelimport import dl4j_export as jexport
from deeplearning4j_tpu.modelimport.nd4j_binary import nd4j_array_to_bytes
from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import preprocessors as jpp
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Sgd as JSgd
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.modelimport import dl4j
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tpp
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Sgd
from deeplearning4j_tpu_torch.util import model_serializer as tser
from deeplearning4j_tpu_torch.util.convert import export_params, load_reference_params

TOL = 1e-5
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731

# (layer factory over a package's layers module, input kind)
CASES = {
    "simple_rnn": (lambda L: L.SimpleRnnLayer(n_in=5, n_out=6), "rnn"),
    "gru_reset_after": (lambda L: L.GRULayer(n_in=5, n_out=6), "rnn"),
    "gru_classic": (lambda L: L.GRULayer(n_in=5, n_out=6, reset_after=False), "rnn"),
    "bidi_concat": (lambda L: L.BidirectionalWrapper(layer=L.LSTMLayer(n_in=5, n_out=6)),
                    "rnn"),
    "bidi_add": (lambda L: L.BidirectionalWrapper(layer=L.SimpleRnnLayer(n_in=5, n_out=6),
                                                  mode="add"), "rnn"),
    "bidi_mul": (lambda L: L.BidirectionalWrapper(layer=L.SimpleRnnLayer(n_in=5, n_out=6),
                                                  mode="mul"), "rnn"),
    "bidi_average": (lambda L: L.BidirectionalWrapper(
        layer=L.SimpleRnnLayer(n_in=5, n_out=6), mode="average"), "rnn"),
    "graves_bidi": (lambda L: L.GravesBidirectionalLSTMLayer(n_in=5, n_out=6), "rnn"),
    "mask_zero": (lambda L: L.MaskZeroLayer(layer=L.LSTMLayer(n_in=5, n_out=6)), "rnn"),
    "conv_lstm_same": (lambda L: L.ConvLSTM2DLayer(n_in=2, n_out=3, convolution_mode="same"),
                       "cnn_seq"),
    "conv_lstm_truncate": (lambda L: L.ConvLSTM2DLayer(
        n_in=2, n_out=3, kernel_size=(3, 2), padding=(1, 0)), "cnn_seq"),
}
GRAD_CASES = ["simple_rnn", "gru_reset_after", "gru_classic", "bidi_concat",
              "graves_bidi", "mask_zero", "conv_lstm_same"]


@pytest.fixture(autouse=True)
def _clean_seams():
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    yield
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()


def _pair(case, seed=1):
    """The layer in both packages, shapes inferred (ConvLSTM2D learns its
    output size from ``output_type``), with the port's initial parameters
    carried to the JAX package (its shapes and names checked against the
    reference's)."""
    make, kind = CASES[case]
    jl, tl = make(JL), make(TL)
    if kind == "cnn_seq":
        jl.output_type(JIT.recurrent_convolutional(5, 5, 2, 6))
        tl.output_type(InputType.recurrent_convolutional(5, 5, 2, 6))
    tp = tl.init_params(torch.Generator().manual_seed(seed))
    assert {k: tuple(v.shape) for k, v in tp.items()} == jl.param_shapes()
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    return jl, jp, tl, tp


def _seq(kind, seed=5):
    """x [3,6,5] (or [3,6,5,5,2]), with a step of example 0 all zeros (for
    MaskZeroLayer); a mask with a short example and a gap."""
    rng = np.random.default_rng(seed)
    shape = (3, 6, 5) if kind == "rnn" else (3, 6, 5, 5, 2)
    x = rng.normal(size=shape).astype(np.float32)
    x[0, 4] = 0.0
    mask = np.ones((3, 6), np.float32)
    mask[1, 4:] = 0.0
    mask[2, 2] = 0.0
    return x, mask


def _listed(params):
    """``export_params``'s layers in index order."""
    return [params[i] for i in range(len(params))] if isinstance(params, dict) else params


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    bound = TOL * max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= bound, (what, np.abs(got - want).max())


@pytest.mark.parametrize("with_mask", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_seq_whole_and_in_pieces_matches_reference(case, with_mask):
    jl, jp, tl, tp = _pair(case)
    x, mask = _seq(CASES[case][1])
    m = mask if with_mask else None
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else torch.from_numpy(m)
    y_j, c_j = jl.forward_seq(jp, jnp.asarray(x), mask=jm)
    y_t, c_t = tl.forward_seq(tp, torch.from_numpy(x), mask=tm)
    _close(y_t, y_j, "whole")
    for a, b in zip(_leaves(c_t), _leaves(c_j)):
        _close(a, b, "final carry")
    # the carry handed from the first piece to the second (TBPTT chunks,
    # stateful rnn_time_step)
    cj, ct = None, None
    for s, e in ((0, 3), (3, 6)):
        pj = None if jm is None else jm[:, s:e]
        pt = None if tm is None else tm[:, s:e]
        yj, cj = jl.forward_seq(jp, jnp.asarray(x[:, s:e]), carry=cj, mask=pj)
        yt, ct = tl.forward_seq(tp, torch.from_numpy(x[:, s:e]), carry=ct, mask=pt)
        _close(yt, yj, f"piece {s}:{e}")
    for a, b in zip(_leaves(ct), _leaves(cj)):
        _close(a, b, "carry after the pieces")
    assert len(_leaves(ct)) == len(_leaves(cj))


@pytest.mark.parametrize("case", GRAD_CASES)
def test_gradients_match_reference(case):
    jl, jp, tl, tp = _pair(case)
    kind = CASES[case][1]
    x, mask = _seq(kind)
    m = mask if kind == "rnn" else None
    rng = np.random.default_rng(6)
    y_shape = jl.forward_seq(jp, jnp.asarray(x))[0].shape
    w = rng.normal(size=y_shape).astype(np.float32)

    def jloss(p):
        y, c = jl.forward_seq(p, jnp.asarray(x), mask=None if m is None else jnp.asarray(m))
        return jnp.sum(y * w) + sum(jnp.sum(leaf) for leaf in jax.tree_util.tree_leaves(c))

    want = jax.grad(jloss)(jp)
    live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    y, c = tl.forward_seq(live, torch.from_numpy(x),
                          mask=None if m is None else torch.from_numpy(m))
    loss = (y * torch.from_numpy(w)).sum() + sum(leaf.sum() for leaf in _leaves(c))
    got = torch.autograd.grad(loss, list(live.values()))
    for (name, g) in zip(live, got):
        ref = np.asarray(want[name])
        assert np.abs(g.numpy() - ref).max() <= TOL * np.abs(ref).max(), name


def test_bidirectional_reverses_only_the_valid_prefix_of_ragged_examples():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 6, 3)).astype(np.float32)
    mask = np.zeros((4, 6), np.float32)
    for i, n in enumerate((6, 1, 4, 0)):
        mask[i, :n] = 1.0
    got = TL.BidirectionalWrapper._reverse_masked(torch.from_numpy(x), torch.from_numpy(mask))
    want = JL.BidirectionalWrapper._reverse_masked(jnp.asarray(x), jnp.asarray(mask))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got[2, :4].numpy(), x[2, 3::-1])  # reversed prefix
    assert np.array_equal(got[2, 4:].numpy(), x[2, 4:])     # padding in place
    assert np.array_equal(got[3].numpy(), x[3])
    assert np.array_equal(TL.BidirectionalWrapper._reverse_masked(
        torch.from_numpy(x), None).numpy(), x[:, ::-1])


@pytest.mark.parametrize("inner", ["lstm", "gru"])
@pytest.mark.parametrize("with_mask", [False, True], ids=["no-mask", "mask"])
def test_last_time_step_takes_the_last_unmasked_step(inner, with_mask):
    make = {"lstm": lambda L: L.LastTimeStepWrapper(layer=L.LSTMLayer(n_in=5, n_out=6)),
            "gru": lambda L: L.LastTimeStepWrapper(layer=L.GRULayer(n_in=5, n_out=6))}[inner]
    jl, tl = make(JL), make(TL)
    tp = tl.init_params(torch.Generator().manual_seed(2))
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    assert set(tp) == {"W", "RW", "b"} == set(jl.param_shapes())  # unprefixed
    x, mask = _seq("rnn")
    mask[0] = 0.0  # an example with no valid step answers its first
    m = mask if with_mask else None
    want = jl.forward(jp, jnp.asarray(x), mask=None if m is None else jnp.asarray(m))[0]
    got = tl.forward(tp, torch.from_numpy(x), mask=None if m is None else torch.from_numpy(m))
    assert got.shape == (3, 6)
    _close(got, want)


def test_mask_zero_derives_its_mask_and_multiplies_a_given_one():
    tl = TL.MaskZeroLayer(layer=TL.SimpleRnnLayer(n_in=2, n_out=3), mask_value=-1.0)
    seen = []
    real = tl.layer.forward_seq

    def spy(params, x, carry=None, mask=None, train=False, gen=None):
        seen.append(mask.clone())
        return real(params, x, carry=carry, mask=mask)

    tl.layer.forward_seq = spy
    params = tl.init_params(torch.Generator().manual_seed(0))
    x = torch.zeros(2, 3, 2)
    x[0, 1] = -1.0
    x[1, 2, 0] = -1.0  # one feature only: still a step
    tl.forward_seq(params, x)
    tl.forward_seq(params, x, mask=torch.tensor([[1.0, 1.0, 1.0], [1.0, 0.0, 1.0]]))
    assert seen[0].tolist() == [[1.0, 0.0, 1.0], [1.0, 1.0, 1.0]]
    assert seen[1].tolist() == [[1.0, 0.0, 1.0], [1.0, 0.0, 1.0]]


# ------------------------------------------------------------------ networks
def _net_conf(b, L, it, case, updater):
    layer = {"bidi_lstm": lambda: L.BidirectionalWrapper(layer=L.LSTMLayer(n_out=6)),
             "gru_mask_zero": lambda: L.MaskZeroLayer(layer=L.GRULayer(n_out=6))}[case]()
    return (b().seed(11).updater(updater).list()
            .layer(layer)
            .layer(L.RnnOutputLayer(n_out=4, loss="mcxent", activation="softmax"))
            .set_input_type(it.recurrent(5))
            .backprop_type("TruncatedBPTT").t_bptt_length(3).build())


@pytest.mark.parametrize("case", ["bidi_lstm", "gru_mask_zero"])
def test_tbptt_fit_and_rnn_time_step_match_reference(case):
    rng = np.random.default_rng(12)
    x = rng.normal(size=(3, 6, 5)).astype(np.float32)
    x[1, 5] = 0.0
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (3, 6))]
    jnet = JMLN(_net_conf(JNNC.builder, JL, JIT, case, JSgd(0.1))).init()
    net = load_reference_params(
        MultiLayerNetwork(_net_conf(NeuralNetConfiguration.builder, TL, InputType,
                                    case, Sgd(0.1)), device="cpu").init(),
        to_np(jnet.params))
    jnet.fit(x, y)
    net.fit(x, y)
    assert net.iteration == jnet.iteration == 2  # two chunks of 3 steps
    for i, named in enumerate(to_np(jnet.params)):
        for n, v in named.items():
            _close(net.params[i][n], v, f"{i}/{n}")
    for s, e in ((0, 3), (3, 6)):
        _close(net.rnn_time_step(x[:, s:e]), jnet.rnn_time_step(x[:, s:e]),
               f"rnn_time_step {s}:{e}")
    for a, b in zip(_leaves(net.rnn_get_previous_state(0)),
                    _leaves(jnet.rnn_get_previous_state(0))):
        _close(a, b, "stored carry")


def _video_conf(b, L, it, head):
    """Example 09's ConvLSTM2D classifier (``LastTimeStepWrapper`` over a
    "same" ConvLSTM2D, a dense head after the automatic flatten), or a
    per-step head after the automatic cnn_seq -> rnn flatten."""
    conv = L.ConvLSTM2DLayer(n_out=3, kernel_size=(3, 3), convolution_mode="same")
    lb = b().seed(3).list()
    if head == "last_step":
        lb = lb.layer(L.LastTimeStepWrapper(layer=conv)).layer(L.OutputLayer(n_out=2))
    else:
        lb = lb.layer(conv).layer(L.RnnOutputLayer(n_out=2))
    return lb.set_input_type(it.recurrent_convolutional(6, 6, 1, 4)).build()


@pytest.mark.parametrize("head", ["last_step", "per_step"])
def test_conv_lstm_networks_through_cnn_seq_match_reference(head):
    rng = np.random.default_rng(13)
    x = rng.normal(size=(3, 4, 6, 6, 1)).astype(np.float32)
    y = (np.eye(2, dtype=np.float32)[rng.integers(0, 2, 3)] if head == "last_step"
         else np.eye(2, dtype=np.float32)[rng.integers(0, 2, (3, 4))])
    jnet = JMLN(_video_conf(JNNC.builder, JL, JIT, head))
    conf = _video_conf(NeuralNetConfiguration.builder, TL, InputType, head)
    assert [t.kind for t in conf.layer_input_types] == [
        t.kind for t in jnet.conf.layer_input_types]
    net = MultiLayerNetwork(conf, device="cpu").init()
    jnet.params = [{n: jnp.asarray(v) for n, v in named.items()}
                   for named in _listed(export_params(net))]
    jnet.states = [layer.init_state() for layer in jnet.layers]
    _close(net.output(x), jnet.output(x), "output")
    g_t, l_t = net.compute_gradient_and_score(x, y)
    # the reference's compute_gradient_and_score (value_and_grad of its
    # _loss_fn), jitted
    (l_j, _), g_j = jax.jit(jax.value_and_grad(lambda p: jnet._loss_fn(
        p, jnet.states, jnp.asarray(x), jnp.asarray(y), None, None, None, train=False),
        has_aux=True))(jnet.params)
    l_j = float(l_j)
    assert abs(l_t - l_j) <= TOL * abs(l_j)
    for i, named in enumerate(to_np(g_j)):
        for n, v in named.items():
            assert np.abs(g_t[i][n].numpy() - v).max() <= TOL * np.abs(v).max(), (i, n)


def test_cnn_seq_kind_and_preprocessors_match_reference():
    it, jit_ = InputType.recurrent_convolutional(3, 4, 2, 5), JIT.recurrent_convolutional(3, 4, 2, 5)
    assert it.to_dict() == jit_.to_dict() and it.batch_shape(2) == jit_.batch_shape(2)
    assert InputType.from_dict(jit_.to_dict()) == it and it.flat_size() == 24
    x = np.arange(2 * 5 * 3 * 4 * 2, dtype=np.float32).reshape(2, 5, 3, 4, 2)
    fn, out = it.cnn_seq_to_rnn()
    jfn, jout = jit_.cnn_seq_to_rnn()
    assert out.to_dict() == jout.to_dict()
    assert np.array_equal(fn(torch.from_numpy(x)).numpy(), np.asarray(jfn(x)))
    assert tpp.output_type("reshape:5,3,4,2", InputType.feed_forward(120)).to_dict() == \
        jpp.output_type("reshape:5,3,4,2", JIT.feed_forward(120)).to_dict()
    # DL4J's CnnToRnn / RnnToCnn: each step in C, H, W order, as the
    # reference's closures
    spec = dl4j._convert_dl4j_preprocessor({"cnnToRnn": {}})
    want = jdl4j._convert_dl4j_preprocessor({"cnnToRnn": {}})(x)
    got = tpp.apply(spec, torch.from_numpy(x))
    assert np.array_equal(got.numpy(), np.asarray(want))
    cfg = {"rnnToCnn": {"inputHeight": 3, "inputWidth": 4, "numChannels": 2}}
    back = dl4j._convert_dl4j_preprocessor(cfg)
    assert back == "rnn_to_cnn_seq_nchw:3,4,2"
    assert np.array_equal(tpp.apply(back, got).numpy(),
                          np.asarray(jdl4j._convert_dl4j_preprocessor(cfg)(np.asarray(want))))
    assert np.array_equal(tpp.apply(back, got).numpy(), x)
    assert tpp.output_type(spec, it) == InputType.recurrent(24, 5)
    assert tpp.output_type(back, InputType.recurrent(24, 5)) == it


# --------------------------------------------------------------------- serde
def _stack_conf(b, L, it):
    return (b().seed(4).list()
            .layer(L.BidirectionalWrapper(layer=L.LSTMLayer(n_out=4), mode="add"))
            .layer(L.MaskZeroLayer(layer=L.GRULayer(n_out=4, reset_after=False),
                                   mask_value=-1.0))
            .layer(L.SimpleRnnLayer(n_out=4, activation="relu"))
            .layer(L.GravesBidirectionalLSTMLayer(n_out=4))
            .layer(L.LastTimeStepWrapper(layer=L.LSTMLayer(n_out=4)))
            .layer(L.OutputLayer(n_out=3))
            .set_input_type(it.recurrent(5)).build())


def test_configuration_json_reads_both_ways():
    jc = _stack_conf(JNNC.builder, JL, JIT)
    tc = _stack_conf(NeuralNetConfiguration.builder, TL, InputType)
    assert MultiLayerConfiguration.from_json(jc.to_json()).to_dict() == jc.to_dict()
    assert type(jc).from_json(tc.to_json()).to_dict() == jc.to_dict()
    vc = _video_conf(JNNC.builder, JL, JIT, "last_step")
    assert MultiLayerConfiguration.from_json(vc.to_json()).to_dict() == vc.to_dict()


def test_model_zip_reads_both_ways(tmp_path):
    rng = np.random.default_rng(14)
    x = rng.normal(size=(2, 5, 5)).astype(np.float32)
    jnet = JMLN(_stack_conf(JNNC.builder, JL, JIT)).init()
    jser.write_model(jnet, tmp_path / "ref.zip")
    net = tser.restore_multi_layer_network(tmp_path / "ref.zip", device="cpu")
    _close(net.output(x), jnet.output(x), "the reference's zip in the port")
    net.save(tmp_path / "port.zip")
    back = jser.restore_multi_layer_network(tmp_path / "port.zip")
    for i, named in enumerate(_listed(export_params(net))):
        for n, v in named.items():
            assert np.array_equal(np.asarray(back.params[i][n]), v), (i, n)
    _close(back.output(x), net.output(x), "the port's zip in the reference")


def _dl4j_entry(layer):
    return jexport._layer_entry(layer, None)


def test_dl4j_zips_of_simple_rnn_and_bidirectional_networks(tmp_path):
    """A SimpleRnn network as the JAX package's DL4J exporter writes it; a
    Bidirectional one (which that exporter refuses) as the same exporter's
    LSTM zip rewritten to DL4J's Bidirectional layout: the layer entry
    wrapped as ``{"Bidirectional": {"fwd": ..., "bwd": ..., "mode":
    "CONCAT"}}`` and the forward direction's parameters before the
    backward's in ``coefficients.bin``."""
    rng = np.random.default_rng(15)
    x = rng.normal(size=(2, 6, 5)).astype(np.float32)

    def conf(first, out_in=None):
        return (JNNC.builder().seed(5).list().layer(first)
                .layer(JL.RnnOutputLayer(n_in=out_in or 0, n_out=3))
                .set_input_type(JIT.recurrent(5)).build())

    jsimple = JMLN(conf(JL.SimpleRnnLayer(n_out=4))).init()
    jexport.export_multi_layer_network(jsimple, str(tmp_path / "simple.zip"))
    net = dl4j.restore_multi_layer_network(str(tmp_path / "simple.zip"), device="cpu")
    assert type(net.layers[0]).__name__ == "SimpleRnnLayer"
    _close(net.output(x), jsimple.output(x), "SimpleRnn")

    jbidi = JMLN(conf(JL.BidirectionalWrapper(layer=JL.LSTMLayer(n_out=4)))).init()
    template = JMLN(conf(JL.LSTMLayer(n_out=4), out_in=8)).init()
    jexport.export_multi_layer_network(template, str(tmp_path / "lstm.zip"),
                                       save_updater=False)
    with zipfile.ZipFile(tmp_path / "lstm.zip") as z:
        doc = json.loads(z.read("configuration.json"))
    lstm_entry = doc["confs"][0]["layer"]
    doc["confs"][0]["layer"] = {"Bidirectional": {"fwd": lstm_entry, "bwd": lstm_entry,
                                                  "mode": "CONCAT"}}
    p = to_np(jbidi.params)
    order = (("W", "f"), ("RW", "f"), ("b", "c"))
    segs = [jexport._flatten_segment(jbidi.layers[0].layer, n, o, p[0][d + n])
            for d in ("f_", "b_") for n, o in order]
    segs += [jexport._flatten_segment(jbidi.layers[1], n, o, p[1][n])
             for n, o in (("W", "f"), ("b", "c"))]
    flat = np.concatenate(segs).reshape(1, -1)
    with zipfile.ZipFile(tmp_path / "bidi.zip", "w") as z:
        z.writestr("configuration.json", json.dumps(doc))
        z.writestr("coefficients.bin", nd4j_array_to_bytes(flat, order="c"))
    net = dl4j.restore_multi_layer_network(str(tmp_path / "bidi.zip"), device="cpu")
    assert type(net.layers[0]).__name__ == "BidirectionalWrapper"
    assert type(jdl4j.restore_multi_layer_network_configuration(
        str(tmp_path / "bidi.zip")).layers[0]).__name__ == "BidirectionalWrapper"
    _close(net.output(x), jbidi.output(x), "Bidirectional")


@pytest.mark.parametrize("layer_type", ["gravesBidirectionalLSTM", "SimpleRnn",
                                        "Bidirectional", "MaskZeroLayer"])
def test_dl4j_reader_accepts_the_recurrent_layers(layer_type):
    inner = {"LSTM": {"nin": 5, "nout": 4}}
    cfg = {"gravesBidirectionalLSTM": {"nin": 5, "nout": 4},
           "SimpleRnn": {"nin": 5, "nout": 4},
           "Bidirectional": {"fwd": inner, "bwd": inner, "mode": "ADD"},
           "MaskZeroLayer": {"underlying": inner, "maskingValue": -1.0}}[layer_type]
    doc = {"confs": [{"layer": {layer_type: cfg}},
                     {"layer": {"rnnoutput": {"nin": 4, "nout": 3}}}]}
    got = dl4j.import_dl4j_configuration(json.dumps(doc))
    want = jdl4j.import_dl4j_configuration(json.dumps(doc))
    assert got.to_dict()["layers"] == want.to_dict()["layers"]


def test_unmasked_wrappers_reach_the_lstm_seam_and_masked_ones_do_not(monkeypatch):
    calls = []

    class Spy(ck.FusedLSTMHelper):
        def forward_seq(self, layer, params, x, carry):
            calls.append(tuple(x.shape))
            return super().forward_seq(layer, params, x, carry)

    monkeypatch.setattr(trec, "_AUTO_LSTM", Spy())
    x, mask = _seq("rnn")
    for case in ("bidi_concat", "mask_zero"):
        _, _, tl, tp = _pair(case)
        tl.forward_seq(tp, torch.from_numpy(x))
        tl.forward_seq(tp, torch.from_numpy(x), mask=torch.from_numpy(mask))
    lts = TL.LastTimeStepWrapper(layer=TL.LSTMLayer(n_in=5, n_out=6))
    params = lts.init_params(torch.Generator().manual_seed(0))
    lts.forward(params, torch.from_numpy(x))
    lts.forward(params, torch.from_numpy(x), mask=torch.from_numpy(mask))
    # Bidirectional: one launch a direction unmasked; MaskZeroLayer always
    # passes a mask; LastTimeStep: one unmasked
    assert calls == [(3, 6, 5), (3, 6, 5), (3, 6, 5)]
