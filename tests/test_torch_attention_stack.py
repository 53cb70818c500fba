"""The rest of the attention stack in the port against the JAX package.

``LearnedSelfAttentionLayer`` (``n_queries`` learned queries over a
fused, head-major ``Wkv``) and ``CrossAttentionLayer`` (separate
``Wq``/``Wk``/``Wv``/``Wo``, ``head_size`` and ``value_size``, inputs in
Keras call order [query, value(, key)]) and the graph's multi-input layer
protocol, on the same weights and inputs (numpy, seeded):

- each layer's forward and its gradients (parameters and inputs, of a
  fixed random projection of the output) within 1e-5 of the
  reference's, with and without masks; the cross layer with tq != tk,
  ``value_size`` != ``head_size`` and 1, 2 and 3 inputs (the key mask is
  the key source's, else the value source's, else the query's);
- graphs of 1, 2 and 3 inputs feeding a ``CrossAttentionLayer`` (as in
  the JAX package's ``tests/test_graph.py``): type inference, ``output``,
  gradients with feature masks, and 3 Adam ``fit`` steps (parameters
  within 2e-5 x each tensor's largest entry). The key bias ``bk`` has an
  analytically zero gradient (softmax ignores a constant added to every
  score of a row): both packages compute rounding noise there (below
  1e-7), which Adam turns into steps of either sign, so it is held by its
  gradient (below KEY_BIAS_GRAD on both sides), not by its steps, as
  ``tests/test_torch_graph_serde.py`` holds ``bqkv``'s K columns;
- with ``FlashAttentionHelper(causal=False)`` registered, a cross request
  with tq != tk (and a learned-query request with n_queries != T) takes
  the plain math: the helper's ``same`` guard keeps it from the kernel,
  and the answer still equals the reference's;
- configuration JSON and the model zip both ways;
- an unstamped zip (no ``qkv_layout``) holding a multi-head
  ``LearnedSelfAttentionLayer`` with Adam state restores with ``Wkv``,
  ``bkv`` and their ``m`` and ``v`` repacked exactly as the reference
  repacks them (the port's repack used to handle only ``Wqkv``/``bqkv``
  and raised ``KeyError`` here).
"""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.graph_conf import ComputationGraphConfiguration as JGraphConf
from deeplearning4j_tpu.nn.conf.network import MultiLayerConfiguration as JMLConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import CrossAttentionLayer as JCross
from deeplearning4j_tpu.nn.layers import LearnedSelfAttentionLayer as JLearned
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.util import model_serializer as jms
from deeplearning4j_tpu_torch.datasets import MultiDataSet
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    CrossAttentionLayer,
    LearnedSelfAttentionLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.attention import repack_legacy_fused_qkv
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.util import model_serializer as ms
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    export_updater_state,
    load_reference_params,
)

TOL, STEP_TOL, KEY_BIAS_GRAD = 1e-5, 2e-5, 1e-6
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


@pytest.fixture(autouse=True)
def _clean_seams():
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    yield
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _mask(n, t, valid):
    m = np.zeros((n, t), np.float32)
    for i, v in enumerate(valid):
        m[i, :v] = 1.0
    return m


def _close(got, want, what, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()), err_msg=what)


def _layer_pair(jlayer, player, xs, masks, multi):
    """The forward and the gradients of ``sum(y * w)`` (``w`` fixed random)
    with respect to the parameters and the inputs, in both packages."""
    p = to_np(jlayer.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)

    def jfwd(params, inputs):
        jm = None if masks is None else [None if m is None else jnp.asarray(m) for m in masks]
        if multi:
            return jlayer.forward_multi(params, inputs, masks=jm)[0]
        return jlayer.forward(params, inputs[0], mask=None if jm is None else jm[0])[0]

    jy = jfwd(jax.tree_util.tree_map(jnp.asarray, p), [jnp.asarray(x) for x in xs])
    w = _rand(rng, *jy.shape)
    jgrads = jax.grad(lambda params, inputs: jnp.sum(jfwd(params, inputs) * w),
                      argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, p),
                                      [jnp.asarray(x) for x in xs])
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in p.items()}
    tx = [torch.from_numpy(x.copy()).requires_grad_(True) for x in xs]
    tm = None if masks is None else [None if m is None else torch.from_numpy(m) for m in masks]
    if multi:
        ty = player.forward_multi(tp, tx, masks=tm)
    else:
        ty = player.forward(tp, tx[0], mask=None if tm is None else tm[0])
    (ty * torch.from_numpy(w)).sum().backward()
    _close(ty, jy, "forward")
    for k, g in jgrads[0].items():
        _close(tp[k].grad, g, f"d{k}")
    for i, g in enumerate(jgrads[1]):
        _close(tx[i].grad, g, f"dx{i}")
    return ty


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_learned_self_attention_forward_and_gradients(masked):
    rng = np.random.default_rng(2)
    kw = dict(n_in=8, n_out=6, n_heads=2, head_size=4, n_queries=3)
    x = _rand(rng, 2, 5, 8)
    masks = [_mask(2, 5, (3, 5))] if masked else None
    y = _layer_pair(JLearned(**kw), LearnedSelfAttentionLayer(**kw), [x], masks, False)
    assert tuple(y.shape) == (2, 3, 6)
    assert LearnedSelfAttentionLayer(**kw).param_shapes() == JLearned(**kw).param_shapes()


@pytest.mark.parametrize("n_inputs", [1, 2, 3])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_cross_attention_forward_and_gradients(n_inputs, masked):
    rng = np.random.default_rng(3 + n_inputs)
    # tq 4, tk 5; q/k 3 wide a head, v 4 (value_size != head_size)
    widths = {1: dict(n_in=6, k_in=6, v_in=6), 2: dict(n_in=6, k_in=7, v_in=7),
              3: dict(n_in=6, k_in=5, v_in=7)}[n_inputs]
    kw = dict(widths, n_out=6, n_heads=2, head_size=3, value_size=4)
    xs = [_rand(rng, 2, 4, 6)]
    if n_inputs > 1:
        xs.append(_rand(rng, 2, 5, 7))
    if n_inputs > 2:
        xs.append(_rand(rng, 2, 5, 5))
    masks = None
    if masked:
        # the key mask: the key source's, else the value source's, else the
        # query's; with 3 inputs the value source's differs, to show which
        masks = [_mask(2, 4, (2, 4)), _mask(2, 5, (5, 3)), _mask(2, 5, (4, 2))][:n_inputs]
    y = _layer_pair(JCross(**kw), CrossAttentionLayer(**kw), xs, masks, True)
    assert tuple(y.shape) == (2, 4, 6)
    assert CrossAttentionLayer(**kw).param_shapes() == JCross(**kw).param_shapes()


def test_cross_attention_single_input_forward_masks_the_keys():
    """The single-input ``forward`` is self-attention over x with the mask
    over its keys (the reference's regression case)."""
    rng = np.random.default_rng(0)
    kw = dict(n_in=8, k_in=8, v_in=8, n_out=8, n_heads=2, head_size=4)
    x = _rand(rng, 2, 5, 8)
    mask = _mask(2, 5, (3, 5))
    y = _layer_pair(JCross(**kw), CrossAttentionLayer(**kw), [x], [mask], False)
    p = {k: torch.from_numpy(np.array(v)) for k, v in to_np(
        JCross(**kw).init_params(jax.random.PRNGKey(0))).items()}
    plain = CrossAttentionLayer(**kw).forward(p, torch.from_numpy(x))
    assert not torch.allclose(y[0, :3], plain[0, :3])
    torch.testing.assert_close(y[1].detach(), plain[1], rtol=0, atol=1e-6)


# ------------------------------------------------------------------- graphs
def _graph_conf(builder, cross, out, it, n_inputs, updater):
    names = ["q", "v", "k"][:n_inputs]
    types = [it.recurrent(6, 4), it.recurrent(7, 5), it.recurrent(5, 5)][:n_inputs]
    g = (builder().seed(3).updater(updater).graph_builder()
         .add_inputs(*names).set_input_types(*types))
    g.add_layer("xatt", cross(n_heads=2, head_size=3, value_size=4), *names)
    g.add_layer("out", out(n_out=3, loss="mse", activation="identity"), "xatt")
    return g.set_outputs("out").build()


def _graph_pair(n_inputs):
    jconf = _graph_conf(JNNC.builder, JCross, JRnnOut, JIT, n_inputs, JU.Adam(1e-2))
    conf = _graph_conf(NeuralNetConfiguration.builder, CrossAttentionLayer,
                       RnnOutputLayer, InputType, n_inputs, Adam(1e-2))
    jnet = JGraph(jconf).init()
    net = load_reference_params(ComputationGraph(conf, device="cpu").init(),
                                to_np(jnet.params))
    rng = np.random.default_rng(10 + n_inputs)
    xs = [_rand(rng, 2, 4, 6), _rand(rng, 2, 5, 7), _rand(rng, 2, 5, 5)][:n_inputs]
    masks = [_mask(2, 4, (4, 3)), _mask(2, 5, (5, 2)), _mask(2, 5, (3, 5))][:n_inputs]
    y = _rand(rng, 2, 4, 3)
    return jnet, net, xs, masks, y


@pytest.mark.parametrize("n_inputs", [1, 2, 3])
def test_cross_attention_graph_matches_the_reference(n_inputs):
    jnet, net, xs, masks, y = _graph_pair(n_inputs)
    xatt, jxatt = net.conf.vertices["xatt"].obj, jnet.conf.vertices["xatt"].obj
    assert (xatt.n_in, xatt.k_in, xatt.v_in, xatt.n_out) == (
        jxatt.n_in, jxatt.k_in, jxatt.v_in, jxatt.n_out)
    assert "xatt" not in net.conf.preprocessors
    _close(net.output(*xs), jnet.output(*xs), "output")
    _close(net.output(*xs, masks=masks), jnet.output(*xs, masks=masks), "masked output")
    inputs, labels, tmasks, lmasks = net._batch(MultiDataSet(xs, [y], masks))
    loss, grads, _ = net._gradients(inputs, labels, tmasks, lmasks)
    jin = {n: jnp.asarray(x) for n, x in zip(jnet.conf.inputs, xs)}
    jm = {n: jnp.asarray(m) for n, m in zip(jnet.conf.inputs, masks)}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jnet._loss_fn(p, jnet.states, jin, [jnp.asarray(y)], None, jm,
                                None, False)[0])(jnet.params)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for v, named in to_np(jgrads).items():
        for n, want in named.items():
            _close(grads[v][n], want, f"grad {v}/{n}")
    # the key bias: an analytically zero gradient, rounding noise both ways
    for g in (grads["xatt"]["bk"].numpy(), np.asarray(jgrads["xatt"]["bk"])):
        assert np.abs(g).max() < KEY_BIAS_GRAD
    for _ in range(3):
        net.fit(MultiDataSet(xs, [y], masks))
        jnet.fit(JMultiDataSet(xs, [y], masks))
        np.testing.assert_allclose(net.score_, float(jnet.score_), rtol=STEP_TOL)
    for v, named in to_np(jnet.params).items():
        for n, want in named.items():
            if (v, n) == ("xatt", "bk"):  # Adam's steps of its noise
                continue
            np.testing.assert_allclose(export_params(net)[v][n], want, rtol=0,
                                       atol=STEP_TOL * np.abs(want).max(),
                                       err_msg=f"{v}/{n}")


def test_multi_input_layer_takes_weight_noise_before_its_forward():
    """Weight noise is drawn for a multi-input layer as for any other: a
    train forward with a generator sees noised weights."""
    from deeplearning4j_tpu_torch.nn.weightnoise import WeightNoise
    from deeplearning4j_tpu_torch.nn.weights import Distribution

    conf = _graph_conf(NeuralNetConfiguration.builder, CrossAttentionLayer,
                       RnnOutputLayer, InputType, 2, Adam(1e-2))
    conf.vertices["xatt"].obj.weight_noise = WeightNoise(
        distribution=Distribution("normal", 0.0, 0.5))
    net = ComputationGraph(conf, device="cpu").init()
    rng = np.random.default_rng(4)
    inputs = {"q": torch.from_numpy(_rand(rng, 2, 4, 6)),
              "v": torch.from_numpy(_rand(rng, 2, 5, 7))}
    clean, _, _ = net._forward_all(net.params, inputs)
    noisy, _, _ = net._forward_all(net.params, inputs, train=True,
                                   gen=net.dropout_generator)
    assert (clean["xatt"] - noisy["xatt"]).abs().max() > 1e-3
    assert torch.equal(clean["q"], noisy["q"])


# ------------------------------------------------------ the attention seam
def test_registered_full_attention_helper_leaves_cross_requests_to_the_plain_math(
        monkeypatch):
    """tq 128 and Dh 64 would be the helper's, but the keys are 256 long:
    q, k, v differ in shape, so the seam's ``same`` guard sends the
    request to the plain math. Likewise a learned-query request (4
    queries over 128 keys). Both equal the reference."""
    helper = ck.FlashAttentionHelper(causal=False)
    attended = []
    monkeypatch.setattr(helper, "attend", lambda *a: attended.append(a))
    thelpers.set_helper("attention", helper)
    rng = np.random.default_rng(5)
    kw = dict(n_in=32, k_in=16, v_in=16, n_out=32, n_heads=2, head_size=64)
    xs = [_rand(rng, 1, 128, 32), _rand(rng, 1, 256, 16)]
    assert helper.supports(None, (1, 2, 128, 64), None, False, causal=False,
                           dtype=torch.float32)
    before = ck.flash_attention_fwd.launches
    _layer_pair(JCross(**kw), CrossAttentionLayer(**kw), xs, None, True)
    lkw = dict(n_in=32, n_out=32, n_heads=2, head_size=64, n_queries=4)
    _layer_pair(JLearned(**lkw), LearnedSelfAttentionLayer(**lkw),
                [_rand(rng, 1, 128, 32)], None, False)
    assert attended == [] and ck.flash_attention_fwd.launches == before


# ------------------------------------------------------- JSON and the zip
def _stack_conf(builder, learned, cross, out, it):
    g = (builder().seed(5).updater(JU.Adam(1e-2) if builder is JNNC.builder
                                   else Adam(1e-2)).graph_builder()
         .add_inputs("q", "kv").set_input_types(it.recurrent(8, 4), it.recurrent(6, 7)))
    g.add_layer("learned", learned(n_out=8, n_heads=2, head_size=4, n_queries=4), "kv")
    g.add_layer("xatt", cross(n_heads=2, head_size=4, value_size=3), "q", "learned")
    g.add_layer("out", out(n_out=3, loss="mse", activation="identity"), "xatt")
    return g.set_outputs("out").build()


def test_configuration_json_reads_both_ways():
    jconf = _stack_conf(JNNC.builder, JLearned, JCross, JRnnOut, JIT)
    conf = _stack_conf(NeuralNetConfiguration.builder, LearnedSelfAttentionLayer,
                       CrossAttentionLayer, RnnOutputLayer, InputType)
    from_ref = ComputationGraphConfiguration.from_json(jconf.to_json())
    from_port = JGraphConf.from_json(conf.to_json())
    assert from_ref.to_dict() == conf.to_dict()
    assert json.loads(from_port.to_json()) == json.loads(jconf.to_json())
    assert from_ref.num_params() == jconf.num_params() == conf.num_params()
    assert isinstance(from_ref.vertices["xatt"].obj, CrossAttentionLayer)
    assert isinstance(from_ref.vertices["learned"].obj, LearnedSelfAttentionLayer)
    mln = (JNNC.builder().seed(1).list()
           .layer(JLearned(n_out=8, n_heads=2, n_queries=2))
           .layer(JRnnOut(n_out=3))
           .set_input_type(JIT.recurrent(6, 5)).build())
    back = MultiLayerConfiguration.from_json(mln.to_json())
    assert back.to_dict() == json.loads(JMLConf.from_json(back.to_json()).to_json())
    assert back.layers[0].n_queries == 2


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_model_zip_both_ways(tmp_path, writer):
    jnet = JGraph(_stack_conf(JNNC.builder, JLearned, JCross, JRnnOut, JIT)).init()
    conf = _stack_conf(NeuralNetConfiguration.builder, LearnedSelfAttentionLayer,
                       CrossAttentionLayer, RnnOutputLayer, InputType)
    net = load_reference_params(ComputationGraph(conf, device="cpu").init(),
                                to_np(jnet.params))
    rng = np.random.default_rng(6)
    xs = [_rand(rng, 2, 4, 8), _rand(rng, 2, 7, 6)]
    y = _rand(rng, 2, 4, 3)
    net.fit(MultiDataSet(xs, [y]))
    jnet.fit(JMultiDataSet(xs, [y]))
    path = tmp_path / "stack.zip"
    if writer == "port":
        ms.write_model(net, path)
        back, src = jms.restore_computation_graph(path), net
        got_p, want_p = to_np(back.params), export_params(net)
        got_s, want_s = to_np(back.updater_states), export_updater_state(net)
        out = np.asarray(back.output(*xs))
    else:
        jms.write_model(jnet, path)
        back, src = ms.restore_computation_graph(path, device="cpu"), jnet
        got_p, want_p = export_params(back), to_np(jnet.params)
        got_s, want_s = export_updater_state(back), to_np(jnet.updater_states)
        out = back.output(*xs).numpy()
    for v, named in want_p.items():
        for n, want in named.items():
            np.testing.assert_array_equal(got_p[v][n], want, err_msg=f"{v}/{n}")
            for s, arr in want_s[v][n].items():
                np.testing.assert_array_equal(got_s[v][n][s], arr, err_msg=f"{v}/{n}/{s}")
    _close(out, np.asarray(src.output(*xs)), "restored output")


def test_unstamped_zip_repacks_learned_attention_as_the_reference(tmp_path):
    conf = (JNNC.builder().seed(3).updater(JU.Adam(1e-2)).list()
            .layer(JLearned(n_out=8, n_heads=2, head_size=4, n_queries=3))
            .layer(JRnnOut(n_out=3))
            .set_input_type(JIT.recurrent(6, 5)).build())
    jnet = JMLN(conf).init()
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 5, 6)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 3))]
    jnet.fit(x, y)
    path = tmp_path / "legacy.zip"
    jms.write_model(jnet, path)
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
    del meta["qkv_layout"]
    ms.replace_zip_entry(path, "meta.json", json.dumps(meta).encode())
    net = ms.restore_multi_layer_network(path, device="cpu")
    ref = jms.restore_multi_layer_network(path)
    got_p, want_p = export_params(net), to_np(ref.params)
    got_s, want_s = export_updater_state(net), to_np(ref.updater_states)
    for i, named in enumerate(want_p):
        for n, want in named.items():
            np.testing.assert_array_equal(got_p[i][n], want, err_msg=f"{i}/{n}")
            for s, arr in want_s[i][n].items():
                np.testing.assert_array_equal(got_s[i][n][s], arr, err_msg=f"{i}/{n}/{s}")
    # Wkv, bkv and their Adam slots moved; the learned queries did not
    for n in ("Wkv", "bkv"):
        assert not np.array_equal(got_p[0][n], np.asarray(jnet.params[0][n]))
        assert not np.array_equal(got_s[0][n]["m"], np.asarray(jnet.updater_states[0][n]["m"]))
    np.testing.assert_array_equal(got_p[0]["Q"], np.asarray(jnet.params[0]["Q"]))


def test_repack_counts_fused_projections_and_skips_absent_ones():
    conf = (NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-2)).list()
            .layer(LearnedSelfAttentionLayer(n_out=8, n_heads=2, head_size=4, n_queries=3))
            .layer(RnnOutputLayer(n_out=3))
            .set_input_type(InputType.recurrent(6, 5)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    w = net.params[0]["Wkv"].clone()
    # Wkv and bkv, each with Adam's m and v; no Wqkv in this layer
    assert repack_legacy_fused_qkv(net) == 6
    cols = w.reshape(6, 2, 2, 4)  # [n_in, parts, H, Dh] -> [n_in, H, parts, Dh]
    torch.testing.assert_close(net.params[0]["Wkv"],
                               cols.transpose(1, 2).reshape(6, 16), rtol=0, atol=0)
