"""Mixed precision (``compute_dtype``) in the port against the JAX package.

The cases of the JAX package's ``tests/test_mixed_precision.py`` that do
not use gradient checkpointing, on the port, plus parity with the JAX
package on the same inputs (made with numpy from a seed) and the same
weights (carried across by ``util/convert.py``):

- dtypes: master parameters, their gradients, the loss and BatchNorm's
  running statistics are f32; activations and ``output`` are in the
  compute dtype where the reference's are (``feed_forward`` runs uncast in
  both packages);
- ``compute_dtype="float32"`` twins: the cast and the f32 loss head at the
  f32 twin limits, 3 Adam steps within 2e-5 x each tensor's largest entry
  and the loss within 1e-6 relative;
- bf16 twins (a 2-layer, 64-wide causal ``TransformerLM`` over vocabulary
  1000 at T = 128 fed integer ids, some above 256; a small conv +
  BatchNorm + residual graph): the port's bf16 loss and gradients against
  the common f64 result of the same weights, as a multiple of the JAX
  package's own bf16 distance from it. The common f64 result is the JAX
  package's (under ``jax.enable_x64``); the port's own f64 gradients, loss
  and running statistics are held to it within 1e-10 x each tensor's
  largest entry. bf16 rounds at other places in the
  two frameworks (the port's attention takes the bf16 flash kernel's
  plain version, f32 inside; the reference's einsum path rounds its
  scores and weights to bf16), so neither is the other's oracle. The
  limits: the whole gradient within 2x the reference's distance, each
  tensor within 3x (or within 2% of its f64 gradient's norm, where the
  reference happens to land closer than that), the loss within 3x (or
  within 1e-3 relative). The ratios are printed;
- ``_lowp_moments`` against the reference's on bf16-valued inputs within
  1e-6 relative, f16 at |x| ~ 300 finite, a large-mean channel with a
  positive variance; BatchNorm and LayerNorm on a bf16 stream;
- f16 networks on the plain paths (no kernel seam admits f16);
- configurations (JSON and YAML) and zips of bf16 networks both ways;
- the float-id property of the reference: float token ids are cast with
  every floating input, so bf16 rounds ids above 256 to the nearest
  representable value in BOTH packages (parity, not a fix), while integer
  ids embed exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JListIt
from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.graph_conf import ComputationGraphConfiguration as JGraphConf
from deeplearning4j_tpu.nn.conf.network import MultiLayerConfiguration as JMLConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import BatchNormalizationLayer as JBN
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import GlobalPoolingLayer as JGap
from deeplearning4j_tpu.nn.layers import LayerNormalizationLayer as JLN
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.layers.norm import _lowp_moments as j_lowp_moments
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.nn.vertices import ElementWiseVertex as JAdd
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu.zoo.models import TransformerLM as JTransformerLM
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.network import GlobalConf, MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNormalizationLayer,
    ConvolutionLayer,
    DenseLayer,
    GlobalPoolingLayer,
    LayerNormalizationLayer,
    LSTMLayer,
    OutputLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.norm import _lowp_moments
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.train_step import compute_cast, gradients
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.nn.vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.util import model_serializer as tser
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    export_states,
    load_reference_params,
    load_reference_states,
)
from deeplearning4j_tpu_torch.zoo.models import TransformerLM, lm_labels

STEP_TOL, LOSS_RTOL = 2e-5, 1e-6
WHOLE_RATIO, TENSOR_RATIO, TENSOR_FLOOR = 2.0, 3.0, 2e-2
LOSS_RATIO, LOSS_FLOOR = 3.0, 1e-3
MOMENTS_RTOL = 1e-6
F64_TOL = 1e-10
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


@pytest.fixture(autouse=True)
def _clean_seams():
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    yield
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()


# ------------------------------------------------------------ data, confs
def _data(n=512, seed=0):
    rng = np.random.default_rng(seed)
    y_idx = rng.integers(0, 3, n)
    x = rng.normal(size=(n, 10)).astype(np.float32)
    x[np.arange(n), y_idx] += 2.5
    return x, np.eye(3, dtype=np.float32)[y_idx]


def _dense_conf(builder, dense, out, input_type, compute_dtype, updater=None):
    b = builder().seed(1).compute_dtype(compute_dtype)
    if updater is not None:
        b = b.updater(updater)
    return (b.list()
            .layer(dense(n_out=16, activation="relu"))
            .layer(out(n_out=3))
            .set_input_type(input_type.feed_forward(10)).build())


def _port_dense(cd, updater=None):
    return _dense_conf(NeuralNetConfiguration.builder, DenseLayer, OutputLayer,
                       InputType, cd, updater)


def _jax_dense(cd, updater=None):
    return _dense_conf(JNNC.builder, JDense, JOut, JIT, cd, updater)


def _bn_graph(builder, conv, bn, gap, out, add, input_type, cd, seed=3):
    """conv -> BN(relu) -> conv -> BN, added to the first conv's output
    (a residual), global average pool, softmax output."""
    g = (builder().seed(seed).compute_dtype(cd).graph_builder()
         .add_inputs("in").set_input_types(input_type.convolutional(8, 8, 2)))
    g.add_layer("c1", conv(n_out=4, kernel_size=(3, 3), convolution_mode="same",
                           has_bias=False), "in")
    g.add_layer("bn1", bn(activation="relu"), "c1")
    g.add_layer("c2", conv(n_out=4, kernel_size=(3, 3), convolution_mode="same",
                           has_bias=False), "bn1")
    g.add_layer("bn2", bn(), "c2")
    g.add_vertex("add", add(op="add"), "bn2", "c1")
    g.add_layer("gap", gap(), "add")
    g.add_layer("out", out(n_out=3), "gap")
    return g.set_outputs("out").build()


def _port_bn_graph(cd):
    return _bn_graph(NeuralNetConfiguration.builder, ConvolutionLayer,
                     BatchNormalizationLayer, GlobalPoolingLayer, OutputLayer,
                     ElementWiseVertex, InputType, cd)


def _jax_bn_graph(cd):
    return _bn_graph(JNNC.builder, JConv, JBN, JGap, JOut, JAdd, JIT, cd)


LM_KW = dict(vocab_size=1000, max_length=128, n_layers=2, d_model=64,
             n_heads=1, d_ff=128, seed=7)


def _lm_ids(n=2, t=128, seed=11):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, LM_KW["vocab_size"], size=(n, t))
    ids[:, :4] = [255, 257, 300, 999]  # above bf16's exact-integer range too
    return ids


def _as_f64(conf):
    conf.global_conf.dtype = "float64"
    conf.global_conf.compute_dtype = None
    return conf


# ------------------------------------------------------------------ helpers
def _flat(grads):
    return {f"{k}/{n}": t.detach().double() for k, named in grads.items()
            for n, t in named.items()}


def _jflat(grads):
    return {f"{k}/{n}": torch.from_numpy(np.array(v, np.float64))
            for k, named in _keyed(grads).items() for n, v in named.items()}


def _keyed(tree):
    return tree if isinstance(tree, dict) else dict(enumerate(tree))


def _ratios(port, ref, f64):
    """Per tensor and whole: the port's L2 distance from the f64 gradients
    over the reference's, with the port's distance over the f64 norm."""
    rows, num, den = {}, 0.0, 0.0
    for key, g64 in f64.items():
        dp = (port[key] - g64).norm().item()
        dr = (ref[key] - g64).norm().item()
        rows[key] = (dp / max(dr, 1e-30), dp / max(g64.norm().item(), 1e-30))
        num += dp * dp
        den += dr * dr
    return rows, (num / max(den, 1e-60)) ** 0.5


def _jax64(cls, conf, params):
    """The JAX package's float64 network of ``conf`` with ``params``
    (call under ``jax.enable_x64``)."""
    net = cls(_as_f64(conf)).init()
    net.params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64)), params)
    return net


def _check_f64_twins(what, port, ref, loss_port, loss_ref):
    """The port's float64 gradients and loss against the JAX package's:
    each tensor within F64_TOL x its largest entry."""
    assert abs(loss_port - loss_ref) <= F64_TOL * abs(loss_ref), (what, loss_port, loss_ref)
    assert port.keys() == ref.keys()
    for key, want in ref.items():
        err = (port[key] - want).abs().max().item()
        assert err <= F64_TOL * max(want.abs().max().item(), 1e-30), (what, key, err)


def _check_ratios(what, port, ref, f64, loss_port, loss_ref, loss64):
    rows, whole = _ratios(port, ref, f64)
    worst = max(rows.items(), key=lambda kv: kv[1][0])
    lp, lr = abs(loss_port - loss64), abs(loss_ref - loss64)
    print(f"{what}: whole-gradient ratio {whole:.3f}, worst tensor {worst[0]} "
          f"{worst[1][0]:.3f} ({worst[1][1]:.2e} of its f64 norm); loss "
          f"error port {lp:.3e} reference {lr:.3e}")
    assert whole <= WHOLE_RATIO, (what, whole)
    for key, (ratio, rel) in rows.items():
        assert ratio <= TENSOR_RATIO or rel <= TENSOR_FLOOR, (what, key, ratio, rel)
    assert lp <= max(LOSS_RATIO * lr, LOSS_FLOOR * abs(loss64)), (what, lp, lr)


# ------------------------------------------------------------- configuration
@pytest.mark.parametrize("name,dtype", [(None, None), ("float32", torch.float32),
                                        ("bfloat16", torch.bfloat16),
                                        ("float16", torch.float16)])
def test_torch_compute_dtype_maps_like_the_reference(name, dtype):
    g = GlobalConf(compute_dtype=name)
    assert g.torch_compute_dtype() == dtype
    ref = (JNNC.builder().compute_dtype(name).list()
           .layer(JOut(n_in=2, n_out=2)).build().global_conf.jnp_compute_dtype())
    assert (ref is None) == (dtype is None)
    if dtype is not None:
        assert str(jnp.dtype(ref)) == str(dtype).removeprefix("torch.")


def test_torch_compute_dtype_refuses_what_the_reference_refuses():
    with pytest.raises(KeyError):
        GlobalConf(compute_dtype="float64").torch_compute_dtype()
    with pytest.raises(KeyError):
        JNNC.builder().compute_dtype("float64").list().layer(
            JOut(n_in=2, n_out=2)).build().global_conf.jnp_compute_dtype()


@pytest.mark.parametrize("form", ["json", "yaml"])
@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_compute_dtype_round_trips_both_ways(form, kind):
    if kind == "multilayer":
        port, ref = _port_dense("bfloat16"), _jax_dense("bfloat16")
        p_cls, j_cls = MultiLayerConfiguration, JMLConf
    else:
        port, ref = _port_bn_graph("bfloat16"), _jax_bn_graph("bfloat16")
        p_cls, j_cls = ComputationGraphConfiguration, JGraphConf
    write, read = (("to_json", "from_json") if form == "json"
                   else ("to_yaml", "from_yaml"))
    from_ref = getattr(p_cls, read)(getattr(ref, write)())
    from_port = getattr(j_cls, read)(getattr(port, write)())
    assert from_ref.global_conf.compute_dtype == "bfloat16"
    assert from_port.global_conf.compute_dtype == "bfloat16"
    assert from_ref.global_conf.torch_compute_dtype() == torch.bfloat16
    import yaml
    assert (yaml.safe_load(getattr(from_ref, write)())
            == yaml.safe_load(getattr(ref, write)()))


# ------------------------------------------------------------- the cast
def test_compute_cast_touches_floating_tensors_only():
    f = torch.ones(3)
    i = torch.arange(3)
    assert compute_cast(f, torch.bfloat16).dtype == torch.bfloat16
    assert compute_cast(i, torch.bfloat16) is i
    assert compute_cast(f, None) is f
    assert compute_cast(7, torch.bfloat16) == 7 and compute_cast(None, torch.float16) is None


def test_gradient_through_the_cast_is_f32_for_f32_masters():
    params = {0: {"W": torch.randn(4, 3), "b": torch.zeros(3)}}
    x = torch.randn(2, 4).to(torch.bfloat16)

    def loss_fn(live):
        w = compute_cast(live[0]["W"], torch.bfloat16)
        b = compute_cast(live[0]["b"], torch.bfloat16)
        return (x @ w + b).float().square().sum(), None

    loss, grads, _ = gradients(loss_fn, params)
    assert loss.dtype == torch.float32
    assert grads[0]["W"].dtype == grads[0]["b"].dtype == torch.float32


# -------------------------------------------------- the reference's cases
def test_params_stay_f32_and_training_works():
    """The reference's case, from the reference's initial weights (the
    port's own draws start elsewhere: 0.873 in f32 and bf16 alike)."""
    x, y = _data()
    net = load_reference_params(
        MultiLayerNetwork(_port_dense("bfloat16"), device="cpu").init(),
        to_np(JMLN(_jax_dense("bfloat16")).init().params))
    net.fit(ListDataSetIterator(DataSet(x, y), 128, shuffle=True), epochs=8)
    assert net.params[0]["W"].dtype == torch.float32
    assert net.evaluate(ListDataSetIterator(DataSet(x, y), 256)).accuracy() > 0.9


def test_forward_activation_is_compute_dtype():
    net = MultiLayerNetwork(_port_dense("bfloat16"), device="cpu").init()
    h, _, _ = net._forward_all(net.params, torch.zeros((4, 10)))
    assert h.dtype == torch.bfloat16
    assert net.output(np.zeros((4, 10), np.float32)).dtype == torch.bfloat16
    # feed_forward runs uncast, as the reference's does
    acts = net.feed_forward(np.zeros((4, 10), np.float32))
    jnet = JMLN(_jax_dense("bfloat16")).init()
    jacts = jnet.feed_forward(np.zeros((4, 10), np.float32))
    assert [str(a.dtype).removeprefix("torch.") for a in acts] == [
        str(a.dtype) for a in jacts]
    assert str(jnet.output(np.zeros((4, 10), np.float32)).dtype) == "bfloat16"


def test_matches_f32_training_approximately():
    x, y = _data(256, seed=3)

    def train(cd):
        net = MultiLayerNetwork(_port_dense(cd), device="cpu").init()
        net.fit(ListDataSetIterator(DataSet(x, y), 128, shuffle=True, seed=5),
                epochs=5)
        return net

    assert abs(train(None).score_ - train("bfloat16").score_) < 0.15


def test_graph_mixed_precision():
    g = (NeuralNetConfiguration.builder().seed(1).compute_dtype("bfloat16")
         .graph_builder().add_inputs("in")
         .set_input_types(InputType.feed_forward(10)))
    g.add_layer("d", DenseLayer(n_out=16, activation="relu"), "in")
    g.add_layer("out", OutputLayer(n_out=3), "d")
    net = ComputationGraph(g.set_outputs("out").build(), device="cpu").init()
    x, y = _data(256)
    net.fit(ListDataSetIterator(DataSet(x, y), 128), epochs=5)
    assert net.params["d"]["W"].dtype == torch.float32
    assert net.score_ < 1.2


def _bn_mln_conf(cd):
    return (NeuralNetConfiguration.builder().seed(2).compute_dtype(cd).list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                    convolution_mode="same"))
            .layer(BatchNormalizationLayer(activation="relu"))
            .layer(ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                    convolution_mode="same"))
            .layer(OutputLayer(n_out=2))
            .set_input_type(InputType.convolutional(8, 8, 1)).build())


def test_batchnorm_mln_train_then_infer():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 8, 8, 1)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    net = MultiLayerNetwork(_bn_mln_conf("bfloat16"), device="cpu").init()
    net.fit(x, y, epochs=2)
    out = net.output(x)
    assert out.shape == (8, 2) and torch.isfinite(out.float()).all()
    assert net.states[1]["mean"].dtype == net.states[1]["var"].dtype == torch.float32
    assert (net.states[1]["mean"] != 0).any()


def test_batchnorm_graph_train_then_infer():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 8, 8, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    net = ComputationGraph(_port_bn_graph("bfloat16"), device="cpu").init()
    net.fit(x, y)
    out = net.output(x)
    assert out.shape == (4, 3) and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    assert all(t.dtype == torch.float32 for st in net.states.values()
               for t in st.values())


# ------------------------------------------------------------- dtypes
def test_mixed_precision_dtypes_of_a_step():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 8, 8, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    net = ComputationGraph(_port_bn_graph("bfloat16"), device="cpu").init()
    inputs, labels, _, _ = net._batch(net._wrap(x, y))
    loss, grads, new_states = net._gradients(inputs, labels, train=True)
    assert loss.dtype == torch.float32
    assert all(g.dtype == torch.float32 for named in grads.values()
               for g in named.values())
    assert all(t.dtype == torch.float32 for st in new_states.values()
               for t in st.values())
    acts, _, _ = net._forward_all(net.params, inputs, loss_inputs=True)
    assert acts["bn1"].dtype == acts["add"].dtype == torch.bfloat16
    assert acts["out:in"].dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in acts["out:params"].values())


# --------------------------------------------- compute_dtype="float32" twins
def _twin_fit(jconf, pconf, x, y, fused, steps=3, graph=False):
    if fused:
        thelpers.set_helper("updater", ck.FusedUpdaterHelper())
    jnet = (JGraph(jconf) if graph else JMLN(jconf)).init()
    net = (ComputationGraph(pconf, device="cpu") if graph
           else MultiLayerNetwork(pconf, device="cpu")).init()
    load_reference_params(net, to_np(jnet.params))
    for _ in range(steps):
        jnet.fit(x, y)
        net.fit(x, y)
    assert abs(net.score_ - float(jnet.score_)) <= LOSS_RTOL * abs(float(jnet.score_))
    ref = _keyed(to_np(jnet.params))
    for key, named in _keyed(export_params(net)).items():
        for n, got in named.items():
            want = ref[key][n]
            assert got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=STEP_TOL * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused"])
def test_float32_compute_dtype_multilayer_twin(fused):
    x, y = _data(64, seed=8)
    _twin_fit(_jax_dense("float32", JAdam(1e-2)), _port_dense("float32", Adam(1e-2)),
              x, y, fused)


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused"])
def test_float32_compute_dtype_graph_twin(fused):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 8, 8, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    jconf, pconf = _jax_bn_graph("float32"), _port_bn_graph("float32")
    jconf.global_conf.updater = JAdam(1e-3)
    pconf.global_conf.updater = Adam(1e-3)
    _twin_fit(jconf, pconf, x, y, fused, graph=True)


# -------------------------------------------------------------- bf16 twins
def test_bf16_transformer_lm_against_f64_in_the_reference_ratio():
    ids = _lm_ids()
    labels = lm_labels(ids, LM_KW["vocab_size"])
    jconf = JTransformerLM(**LM_KW).conf()
    jconf.global_conf.compute_dtype = "bfloat16"
    jnet = JGraph(jconf).init()
    params = to_np(jnet.params)
    conf = TransformerLM(**LM_KW).conf()
    conf.global_conf.compute_dtype = "bfloat16"
    net = load_reference_params(ComputationGraph(conf, device="cpu").init(), params)
    net64 = load_reference_params(
        ComputationGraph(_as_f64(TransformerLM(**LM_KW).conf()), device="cpu").init(),
        params)
    before = ck.flash_attention_fwd.launches
    g_port, l_port = net.compute_gradient_and_score(ids, labels)
    g64, l64 = net64.compute_gradient_and_score(ids, labels)
    g_ref, l_ref = jnet.compute_gradient_and_score(ids, labels)
    with jax.enable_x64(True):
        gj64, lj64 = _jax64(JGraph, JTransformerLM(**LM_KW).conf(),
                            params).compute_gradient_and_score(ids, labels)
        gj64, lj64 = _jflat(gj64), float(lj64)
    assert ck.flash_attention_fwd.launches == before  # CPU: the plain version
    assert all(g.dtype == torch.float32 for named in g_port.values()
               for g in named.values())
    _check_f64_twins("TransformerLM", _flat(g64), gj64, l64, lj64)
    _check_ratios("TransformerLM bf16", _flat(g_port), _jflat(g_ref), gj64,
                  l_port, l_ref, lj64)


def test_bf16_transformer_lm_takes_the_bf16_flash_path(monkeypatch):
    seen = []
    real = ck.FlashAttentionFunction.apply

    def spy(q, k, v, causal):
        seen.append(q.dtype)
        return real(q, k, v, causal)

    monkeypatch.setattr(ck.FlashAttentionFunction, "apply", spy)
    conf = TransformerLM(**LM_KW).conf()
    conf.global_conf.compute_dtype = "bfloat16"
    net = ComputationGraph(conf, device="cpu").init()
    ids = _lm_ids()
    net.fit(ids, lm_labels(ids, LM_KW["vocab_size"]))
    assert seen == [torch.bfloat16] * LM_KW["n_layers"]


def test_bf16_conv_batchnorm_residual_against_f64_in_the_reference_ratio():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 8, 8, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    jnet = JGraph(_jax_bn_graph("bfloat16")).init()
    params = to_np(jnet.params)
    net = load_reference_params(
        ComputationGraph(_port_bn_graph("bfloat16"), device="cpu").init(), params)
    net64 = load_reference_params(
        ComputationGraph(_as_f64(_port_bn_graph(None)), device="cpu").init(), params)

    def port_step(n):
        inputs, labels, _, _ = n._batch(n._wrap(x, y))
        loss, grads, states = n._gradients(inputs, labels, train=True)
        return _flat(grads), float(loss), states

    g_port, l_port, st_port = port_step(net)
    g64, l64, st64 = port_step(net64)

    def jstep(n, dtype):
        def jloss(p):
            return n._loss_fn(p, n.states, {"in": jnp.asarray(x, dtype)},
                              [jnp.asarray(y, dtype)], None, None, None, train=True)

        (loss, (states, _)), grads = jax.value_and_grad(jloss, has_aux=True)(n.params)
        return _jflat(grads), float(loss), states

    g_ref, l_ref, st_ref = jstep(jnet, np.float32)
    with jax.enable_x64(True):
        gj64, lj64, stj64 = jstep(_jax64(JGraph, _jax_bn_graph(None), params),
                                  np.float64)
    _check_f64_twins("conv + BatchNorm + residual", g64, gj64, l64, lj64)
    _check_ratios("conv + BatchNorm + residual bf16", g_port, g_ref, gj64,
                  l_port, l_ref, lj64)
    for name in ("bn1", "bn2"):
        for stat in ("mean", "var"):
            got = st_port[name][stat]
            want = torch.from_numpy(np.asarray(stj64[name][stat], np.float64))
            ref = torch.from_numpy(np.asarray(st_ref[name][stat], np.float64))
            assert got.dtype == torch.float32
            assert ((st64[name][stat] - want).abs().max().item()
                    <= F64_TOL * want.abs().max().item()), (name, stat)
            err_p = (got.double() - want).abs().max().item()
            err_r = (ref - want).abs().max().item()
            assert err_p <= max(3 * err_r, 1e-2 * want.abs().max().item()), (
                name, stat, err_p, err_r)


# ---------------------------------------------------------- _lowp_moments
@pytest.mark.parametrize("axes,keepdim", [((0,), False), ((0, 1, 2), False),
                                          ((-1,), True)])
def test_lowp_moments_match_the_reference(axes, keepdim):
    rng = np.random.default_rng(6)
    x = rng.normal(0.5, 2.0, size=(4, 6, 5, 8)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    mean, var = _lowp_moments(xb, axes, keepdim)
    jx = jnp.asarray(xb.float().numpy(), jnp.bfloat16)
    jmean, jvar = j_lowp_moments(jx, axes if len(axes) > 1 else axes[0], keepdims=keepdim)
    assert mean.dtype == var.dtype == torch.float32
    for got, want in ((mean, jmean), (var, jvar)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=MOMENTS_RTOL,
                                   atol=MOMENTS_RTOL * np.abs(want).max())


def test_lowp_moments_gradients_match_the_reference():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32)).to(torch.bfloat16)
    wm, wv = rng.normal(size=8).astype(np.float32), rng.normal(size=8).astype(np.float32)
    leaf = x.clone().requires_grad_(True)
    mean, var = _lowp_moments(leaf, (0,))
    (mean * torch.from_numpy(wm)).sum().add((var * torch.from_numpy(wv)).sum()).backward()

    def f(a):
        m, v = j_lowp_moments(a, (0,))
        return jnp.sum(m * wm) + jnp.sum(v * wv)

    ref = np.asarray(jax.grad(f)(jnp.asarray(x.float().numpy(), jnp.bfloat16)), np.float32)
    assert leaf.grad.dtype == torch.bfloat16
    # each package rounds the f32 gradient to bf16 once or twice
    np.testing.assert_allclose(leaf.grad.float().numpy(), ref, rtol=0,
                               atol=2 ** -7 * np.abs(ref).max())


def test_lowp_moments_f16_no_overflow():
    x = torch.full((4, 8), 300.0, dtype=torch.float16)
    x[:, ::2] = -300.0
    mean, var = _lowp_moments(x, -1, keepdim=True)
    assert torch.isfinite(mean).all() and torch.isfinite(var).all()
    assert torch.allclose(var, torch.full_like(var, 90000.0))
    xb = torch.full((4, 8), 1e10, dtype=torch.bfloat16)
    mean, _ = _lowp_moments(xb, -1, keepdim=True)
    assert torch.isfinite(mean).all()


def test_lowp_moments_large_mean_keeps_a_positive_variance():
    rng = np.random.default_rng(0)
    x32 = (rng.normal(size=(8, 768)) + 100.0).astype(np.float32)
    _, var = _lowp_moments(torch.from_numpy(x32).to(torch.bfloat16), -1, True)
    true_var = x32.var(axis=-1, keepdims=True)
    assert (var > 0).all()
    assert (np.abs(var.numpy() - true_var) / true_var).max() < 0.25


def test_batchnorm_f32_large_mean_stable():
    layer = BatchNormalizationLayer(n_in=4)
    p = layer.init_params(None)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(64, 4)) + 1e4).astype(np.float32))
    y, st = layer.forward_state(p, layer.init_state(), x, train=True)
    assert torch.isfinite(y).all() and 0.5 < y.std().item() < 2.0
    assert (st["var"] * 10 > 0.3).all()


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_on_a_bf16_stream_matches_the_reference(train):
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(6, 5, 5, 4)) * 3 + 40).astype(np.float32)
    x[..., 0] = 1e3  # a held channel keeps a variance of 0
    xb = torch.from_numpy(x).to(torch.bfloat16)
    p = {"gamma": torch.from_numpy(rng.normal(1, 0.2, 4).astype(np.float32)),
         "beta": torch.from_numpy(rng.normal(0, 0.2, 4).astype(np.float32))}
    state = {"mean": torch.full((4,), 30.0), "var": torch.full((4,), 8.0)}
    layer = BatchNormalizationLayer(n_in=4, activation="relu")
    pb = {k: v.to(torch.bfloat16) for k, v in p.items()}
    y, st = layer.forward_state(pb, state, xb, train=train)
    jl = JBN(n_in=4, activation="relu")
    jy, jst = jl.forward({k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
                          for k, v in pb.items()},
                         jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                         state={k: jnp.asarray(v.numpy()) for k, v in state.items()},
                         train=train)
    assert y.dtype == torch.bfloat16 and str(jy.dtype) == "bfloat16"
    jy = np.asarray(jy, np.float32)
    np.testing.assert_allclose(y.float().numpy(), jy, rtol=0,
                               atol=2 ** -7 * max(1.0, np.abs(jy).max()))
    for k in ("mean", "var"):
        assert st[k].dtype == torch.float32
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                   rtol=MOMENTS_RTOL, atol=1e-6)
    if train:
        assert st["var"][0].item() == pytest.approx(0.1 * 0.0 + 0.9 * 8.0)


def test_layernorm_bf16_accumulates_in_f32():
    layer = LayerNormalizationLayer(n_in=768)
    p = layer.init_params(None)
    rng = np.random.default_rng(0)
    x32 = torch.from_numpy((rng.normal(size=(4, 768)) + 5.0).astype(np.float32))
    ref = layer.forward(p, x32)
    out = layer.forward({k: v.to(torch.bfloat16) for k, v in p.items()},
                        x32.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    assert (out.float() - ref).abs().max().item() < 0.05
    jl = JLN(n_in=768)
    jout, _ = jl.forward(jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16), jl.init_params(jax.random.PRNGKey(0))),
        jnp.asarray(x32.numpy(), jnp.bfloat16))
    jout = np.asarray(jout, np.float32)
    np.testing.assert_allclose(out.float().numpy(), jout, rtol=0,
                               atol=2 ** -7 * np.abs(jout).max())


# --------------------------------------------------------------- f16 nets
def test_f16_networks_take_the_plain_paths(monkeypatch):
    taken = []
    monkeypatch.setattr(ck.FlashAttentionFunction, "apply",
                        lambda *a: taken.append("flash"))
    monkeypatch.setattr(ck, "flash_attention_fwd",
                        lambda *a, **k: taken.append("flash_fwd"))
    conf = TransformerLM(**LM_KW).conf()
    conf.global_conf.compute_dtype = "float16"
    net = ComputationGraph(conf, device="cpu").init()
    ids = _lm_ids()
    net.fit(ids, lm_labels(ids, LM_KW["vocab_size"]))
    out = net.output(ids)
    assert taken == [] and out.dtype == torch.float16
    assert np.isfinite(net.score_) and torch.isfinite(out.float()).all()

    lstm_conf = (NeuralNetConfiguration.builder().seed(3).compute_dtype("float16")
                 .list().layer(LSTMLayer(n_out=8, activation="tanh"))
                 .layer(RnnOutputLayer(n_out=5))
                 .set_input_type(InputType.recurrent(5, 6)).build())
    lstm = MultiLayerNetwork(lstm_conf, device="cpu").init()
    before = ck.lstm_sequence.launches
    rng = np.random.default_rng(2)
    xs = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (3, 6))]
    lstm.fit(xs, xs)
    assert lstm.output(xs).dtype == torch.float16
    assert ck.lstm_sequence.launches == before and np.isfinite(lstm.score_)


def test_bf16_lstm_tbptt_promotes_as_the_reference():
    """Under a compute dtype the reference starts TBPTT and rnn_time_step
    from f32 carries (its ``jnp_dtype``), so an LSTM's recurrence promotes
    to f32; the port does the same, and both agree on the carry dtypes."""
    from deeplearning4j_tpu.nn.layers import LSTMLayer as JLSTM
    from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOut

    def conf(b, lstm, out, it):
        return (b().seed(3).compute_dtype("bfloat16").list()
                .layer(lstm(n_out=8, activation="tanh"))
                .layer(out(n_out=5))
                .backprop_type("TruncatedBPTT").t_bptt_length(3)
                .set_input_type(it.recurrent(5, 6)).build())

    jnet = JMLN(conf(JNNC.builder, JLSTM, JRnnOut, JIT)).init()
    net = load_reference_params(
        MultiLayerNetwork(conf(NeuralNetConfiguration.builder, LSTMLayer,
                               RnnOutputLayer, InputType), device="cpu").init(),
        to_np(jnet.params))
    rng = np.random.default_rng(3)
    xs = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (2, 6))]
    jnet.fit(xs, xs)
    net.fit(xs, xs)
    assert abs(net.score_ - float(jnet.score_)) < 1e-2 * abs(float(jnet.score_))
    out, jout = net.rnn_time_step(xs[:, :2]), jnet.rnn_time_step(xs[:, :2])
    assert str(out.dtype).removeprefix("torch.") == str(jout.dtype)
    assert [str(c.dtype).removeprefix("torch.") for c in net.rnn_get_previous_state(0)] == [
        str(c.dtype) for c in jnet.rnn_get_previous_state(0)]


# ------------------------------------------------------------------- zips
def test_bf16_zip_from_the_port_loads_in_the_reference(tmp_path):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 8, 8, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    net = ComputationGraph(_port_bn_graph("bfloat16"), device="cpu").init()
    net.fit(x, y)
    path = tmp_path / "bf16.zip"
    net.save(path)
    jnet = jser.restore_computation_graph(path)
    assert jnet.conf.global_conf.compute_dtype == "bfloat16"
    assert all(np.asarray(v).dtype == np.float32
               for named in jnet.params.values() for v in named.values())
    assert all(np.asarray(v).dtype == np.float32
               for named in jnet.states.values() for v in named.values())
    for name, named in export_params(net).items():
        for n, v in named.items():
            np.testing.assert_array_equal(np.asarray(jnet.params[name][n]), v)
    back = ComputationGraph.load(path, device="cpu")
    assert back.compute_dtype == torch.bfloat16
    assert torch.equal(back.output(x), net.output(x))


def test_bf16_zip_from_the_reference_loads_in_the_port(tmp_path):
    jnet = JMLN(_bn_mln_conf_jax()).init()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 8, 8, 1)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    jnet.fit(x, y)
    path = tmp_path / "ref.zip"
    jser.write_model(jnet, path)
    net = tser.restore_multi_layer_network(path, device="cpu")
    assert net.compute_dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for named in net.params.values()
               for t in named.values())
    for key, named in _keyed(to_np(jnet.states)).items():
        for n, v in named.items():
            np.testing.assert_array_equal(export_states(net)[key][n], v)
    out, jout = net.output(x), np.asarray(jnet.output(x), np.float32)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), jout, rtol=0, atol=2e-2)


def _bn_mln_conf_jax():
    return (JNNC.builder().seed(2).compute_dtype("bfloat16").list()
            .layer(JConv(n_out=4, kernel_size=(3, 3), convolution_mode="same"))
            .layer(JBN(activation="relu"))
            .layer(JConv(n_out=4, kernel_size=(3, 3), convolution_mode="same"))
            .layer(JOut(n_out=2))
            .set_input_type(JIT.convolutional(8, 8, 1)).build())


# ----------------------------------------------------- the float-id property
FLOAT_IDS = [255.0, 257.0, 50000.0, 50256.0]
BF16_ROUNDED = [255, 256, 49920, 50176]  # jnp.bfloat16 of the ids above


def _embed_pair():
    kw = dict(vocab_size=50257, max_length=8, n_layers=1, d_model=8,
              n_heads=1, d_ff=8, seed=3)
    jconf = JTransformerLM(**kw).conf()
    jconf.global_conf.compute_dtype = "bfloat16"
    jnet = JGraph(jconf).init()
    conf = TransformerLM(**kw).conf()
    conf.global_conf.compute_dtype = "bfloat16"
    net = load_reference_params(ComputationGraph(conf, device="cpu").init(),
                                to_np(jnet.params))
    return jnet, net


def _embedded(jnet, net, ids):
    acts, _, _ = net._forward_all(net.params, {"tokens": net._as_tensor(ids)})
    jacts, _, _, _ = jnet._forward_all(jnet.params, jnet.states,
                                       {"tokens": jnp.asarray(ids)}, train=False,
                                       rng=None)
    return acts["embed"].float().numpy(), np.asarray(jacts["embed"], np.float32)


def test_float_ids_round_alike_in_both_packages():
    """A property of the reference, kept: the float ids are cast to bf16
    with every floating input, so both packages embed the SAME rounded
    tokens."""
    jnet, net = _embed_pair()
    ids = np.asarray([FLOAT_IDS], np.float32)
    got, ref = _embedded(jnet, net, ids)
    np.testing.assert_array_equal(got, ref)
    w = net.params["embed"]["W"].to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got[0], w[BF16_ROUNDED])
    assert not np.array_equal(got[0], w[[int(i) for i in FLOAT_IDS]])
    assert [int(v) for v in torch.tensor(FLOAT_IDS).to(torch.bfloat16).float()] == BF16_ROUNDED


def test_integer_ids_embed_exactly_in_both_packages():
    jnet, net = _embed_pair()
    ids = np.asarray([[int(i) for i in FLOAT_IDS]], np.int64)
    got, ref = _embedded(jnet, net, ids)
    np.testing.assert_array_equal(got, ref)
    w = net.params["embed"]["W"].to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got[0], w[ids[0]])


# ------------------------------------------- the f32 head under weight noise
def _noised_head_graph(builder, dense, out, wn, input_type, cd):
    g = (builder().seed(4).compute_dtype(cd).graph_builder().add_inputs("in")
         .set_input_types(input_type.feed_forward(10)))
    g.add_layer("d", dense(n_out=16, activation="tanh"), "in")
    g.add_layer("out", out(n_out=3, weight_noise=wn), "d")
    return g.set_outputs("out").build()


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_weight_noised_loss_head_keeps_f32_masters(monkeypatch, cd):
    """The reference noises a loss layer's cast parameters in its vertex
    loop and its f32 masters again, from the same key, for the f32 loss
    head (``graph.py:266-280``): two draws, the head's in f32. The port
    draws both from one generator state; with the same draws put into both
    packages, the losses and gradients agree (f32: the twin limits; bf16:
    within bf16 rounding)."""
    import sys
    sys.path.insert(0, __import__("os").path.dirname(__file__))
    from torch_putin import PutIn
    from deeplearning4j_tpu.nn.weightnoise import WeightNoise as JWN
    from deeplearning4j_tpu_torch.nn.weightnoise import WeightNoise as PWN

    jnet = JGraph(_noised_head_graph(JNNC.builder, JDense, JOut, JWN(), JIT, cd)).init()
    net = load_reference_params(
        ComputationGraph(_noised_head_graph(NeuralNetConfiguration.builder,
                                            DenseLayer, OutputLayer, PWN(),
                                            InputType, cd), device="cpu").init(),
        to_np(jnet.params))
    x, y = _data(8, seed=12)
    putin = PutIn(monkeypatch, seed=5)
    inputs = {"in": jnp.asarray(x)}

    def jloss(p):
        return jnet._loss_fn(p, jnet.states, inputs, [jnp.asarray(y)],
                             jax.random.PRNGKey(0), None, None, train=True)[0]

    loss_j, g_j = jax.value_and_grad(jloss)(jnet.params)
    kinds = [(a.shape, str(a.dtype)) for _, a in putin.drawn]
    # W (the default noises no bias), in the vertex loop and for the head
    assert kinds == [((16, 3), cd), ((16, 3), "float32")]
    t_in, t_y = {"in": torch.from_numpy(x)}, [torch.from_numpy(y)]
    loss_t, g_t, _ = gradients(
        lambda live: (net._loss_fn(live, t_in, t_y, None, None, train=True,
                                   gen=net.dropout_generator), None), net.params)
    assert putin.port_calls == 2
    tol = 1e-6 if cd == "float32" else 2e-2
    assert abs(float(loss_t) - float(loss_j)) <= tol * abs(float(loss_j))
    for v, named in to_np(g_j).items():
        for n, want in named.items():
            np.testing.assert_allclose(g_t[v][n].numpy(), want, rtol=0,
                                       atol=(1e-5 if cd == "float32" else 5e-2)
                                       * np.abs(want).max(), err_msg=f"{v}/{n}")
