"""``FrozenLayer``, ``TimeDistributedWrapper``, the mixture-of-experts
layer and ``nn/simple.py`` in the port against the JAX package.

``FrozenLayer``: a network whose first dense layer is frozen (Adam(1e-2),
l2 1e-3 on the network, which the wrapper does not inherit) takes 3 steps
from the same weights in both packages: the loss and every trainable
parameter and Adam moment within 1e-5 × its largest entry, the frozen
tensors bit for bit where they started (their gradient is 0, and Adam
moves nothing from a zero state), with and without
``FusedUpdaterHelper``; from a carried non-zero Adam state the frozen
tensors move, as in the reference (the updater runs on the zero
gradients), to the reference's values.

``TimeDistributedWrapper``: over ``cnn_seq`` (a convolution and a global
pool at every step of an image sequence) and over ``rnn`` (a dense layer
at every step, with a step mask that the inner call drops, as the
reference does): the output within 1e-5 and 3 Adam steps within 1e-5 ×
each tensor's largest entry.

``MixtureOfExpertsLayer`` (4 experts, top 2): the forward, the gates and
the gradients of the input and every parameter (``jax.vjp``) within
1e-5; an all-zero row routes to experts 0 and 1 (``lax.top_k``'s order
among equal logits); ``load_balancing_loss``; a network with
``collect_gates`` takes 3 Adam steps as the reference's and keeps the
last batch's gates as its state. ``RankClassificationResult`` and
``BinaryClassificationResult`` give the reference's answers.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import simple as jsimple
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import moe as JM
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import simple as tsimple
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import moe as TM
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    export_states,
    export_updater_state,
    load_reference_params,
    load_reference_updater_state,
)
from test_torch_conv_family import _close, _json, jax_init, to_np

TOL, STEP_TOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _clean_seams():
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    yield
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()


def _twins(conf_fn):
    jnet = jax_init(JMLN, conf_fn(JL, JNNC, JIT, JAdam))
    net = load_reference_params(MultiLayerNetwork(
        conf_fn(L, NeuralNetConfiguration, InputType, Adam), device="cpu").init(),
        to_np(jnet.params))
    return jnet, net


def _check_trees(got, want, what):
    for i, named in enumerate(want):
        for n, w in named.items():
            if isinstance(w, dict):
                _check_trees([got[i][n]], [w], f"{what} {i}/{n}")
                continue
            np.testing.assert_allclose(got[i][n], w, rtol=0,
                                       atol=STEP_TOL * max(np.abs(w).max(), 1e-30),
                                       err_msg=f"{what} {i}/{n}")


def _steps(jnet, net, x, y, steps=3, mask=None):
    for _ in range(steps):
        jnet.fit(x, y, features_mask=mask) if mask is not None else jnet.fit(x, y)
        net.fit(x, y, features_mask=mask)
        assert abs(net.score_ - float(jnet.score_)) <= STEP_TOL * max(1.0, abs(float(jnet.score_)))
    _check_trees(export_params(net), to_np(jnet.params), "params")
    _check_trees(export_updater_state(net), to_np(jnet.updater_states), "updater")


# ------------------------------------------------------------------ frozen
def _frozen_conf(pkg, nnc, it, adam):
    return (nnc.builder().seed(6).updater(adam(1e-2)).l2(1e-3).list()
            .layer(pkg.FrozenLayer(layer=pkg.DenseLayer(n_out=7, activation="tanh")))
            .layer(pkg.DenseLayer(n_out=6, activation="relu"))
            .layer(pkg.OutputLayer(n_out=3, loss="mcxent", activation="softmax"))
            .set_input_type(it.feed_forward(5)).build())


def _ff_data(n=8, d=5, k=3, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            np.eye(k, dtype=np.float32)[rng.integers(0, k, n)])


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused_helper"])
def test_frozen_layer_steps_as_the_reference(fused):
    jnet, net = _twins(_frozen_conf)
    if fused:
        thelpers.set_helper("updater", ck.FusedUpdaterHelper())
    frozen = net.conf.layers[0]
    assert (frozen.l2, frozen.updater) == (None, None) and frozen.layer.l2 == 1e-3
    start = export_params(net)
    x, y = _ff_data()
    _steps(jnet, net, x, y)
    for n, t in export_params(net)[0].items():
        np.testing.assert_array_equal(t, start[0][n])
    assert all(not np.array_equal(t, start[1][n]) for n, t in export_params(net)[1].items())
    assert json.loads(net.conf.to_json()) == json.loads(jnet.conf.to_json())


def test_frozen_layer_moves_from_a_carried_adam_state():
    jnet, net = _twins(_frozen_conf)
    rng = np.random.default_rng(2)
    upd = to_np(jnet.updater_states)
    for n, slots in upd[0].items():
        slots["m"] = (0.1 * rng.standard_normal(slots["m"].shape)).astype(np.float32)
        slots["v"] = (0.01 * rng.random(slots["v"].shape)).astype(np.float32)
    jnet.updater_states = jax.tree_util.tree_map(jnp.asarray, upd)
    load_reference_updater_state(net, upd)
    start = export_params(net)
    x, y = _ff_data()
    _steps(jnet, net, x, y, steps=2)
    assert all(not np.array_equal(t, start[0][n]) for n, t in export_params(net)[0].items())


# -------------------------------------------------------- time distributed
def _td_conf(kind):
    def conf(pkg, nnc, it, adam):
        b = nnc.builder().seed(7).updater(adam(1e-2)).list()
        if kind == "cnn_seq":
            b = (b.layer(pkg.TimeDistributedWrapper(layer=pkg.ConvolutionLayer(
                    n_out=4, kernel_size=(3, 3), convolution_mode="same",
                    activation="tanh")))
                 .layer(pkg.TimeDistributedWrapper(layer=pkg.GlobalPoolingLayer(
                     pooling_type="avg"))))
            it_in = it.recurrent_convolutional(5, 6, 2, 4)
        else:
            b = b.layer(pkg.TimeDistributedWrapper(layer=pkg.DenseLayer(
                n_out=6, activation="tanh")))
            it_in = it.recurrent(5, 4)
        return (b.layer(pkg.RnnOutputLayer(n_out=3, loss="mcxent", activation="softmax"))
                .set_input_type(it_in).build())
    return conf


@pytest.mark.parametrize("kind", ["cnn_seq", "rnn"])
def test_time_distributed_matches_the_reference(kind):
    jnet, net = _twins(_td_conf(kind))
    rng = np.random.default_rng(3)
    shape = (3, 4, 5, 6, 2) if kind == "cnn_seq" else (3, 4, 5)
    x = rng.standard_normal(shape).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (3, 4))]
    mask = None
    if kind == "rnn":
        mask = np.ones((3, 4), np.float32)
        mask[1, 2:] = 0.0
    assert json.loads(net.conf.to_json()) == json.loads(jnet.conf.to_json())
    want = np.asarray(jnet.output(x) if mask is None else jnet.output(x, mask=mask))
    _close(net.output(x, mask=mask), want, TOL)
    assert tuple(net.output(x).shape) == (3, 4, 3)
    _steps(jnet, net, x, y, mask=mask)


def test_time_distributed_output_types_are_the_references():
    for it_j, it_t, inner in (
            (JIT.recurrent_convolutional(8, 9, 3, 5), InputType.recurrent_convolutional(8, 9, 3, 5),
             lambda pkg: pkg.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2))),
            (JIT.recurrent(7, 5), InputType.recurrent(7, 5),
             lambda pkg: pkg.DenseLayer(n_out=4))):
        jl, tl = (JL.TimeDistributedWrapper(layer=inner(JL)),
                  L.TimeDistributedWrapper(layer=inner(L)))
        jl.set_n_in(it_j)
        tl.set_n_in(it_t)
        assert _json(tl.output_type(it_t).to_dict()) == _json(jl.output_type(it_j).to_dict())
    with pytest.raises(ValueError, match="sequence input"):
        L.TimeDistributedWrapper(layer=L.DenseLayer(n_out=2)).set_n_in(
            InputType.feed_forward(3))


# --------------------------------------------------------------------- moe
def _moe_params(n_in=6, n_out=5, e=4, seed=4):
    rng = np.random.default_rng(seed)
    return {"Wg": rng.standard_normal((n_in, e)).astype(np.float32),
            "W": (0.5 * rng.standard_normal((e, n_in, n_out))).astype(np.float32),
            "b": (0.1 * rng.standard_normal((e, n_out))).astype(np.float32)}


def test_moe_forward_gates_and_gradients_match_the_reference():
    kw = dict(n_in=6, n_out=5, n_experts=4, top_k=2, activation="relu")
    jl, tl = JL.MixtureOfExpertsLayer(**kw), L.MixtureOfExpertsLayer(**kw)
    assert tl.param_shapes() == jl.param_shapes()
    params = _moe_params()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 6)).astype(np.float32)
    x[0, 0] = 0.0  # every logit equal: lax.top_k takes experts 0 and 1
    cot = rng.standard_normal((3, 4, 5)).astype(np.float32)

    @jax.jit
    def reference(x_, cot_, p_):
        (out, gates), pull = jax.vjp(
            lambda a, p: JM._moe_apply(p, a, 2, jl.act_fn()), x_, p_)
        return out, gates, pull((cot_, jnp.zeros_like(gates)))

    out, gates, (gx, gp) = reference(x, cot, params)
    leaves = {n: torch.tensor(a, requires_grad=True) for n, a in params.items()}
    xl = torch.tensor(x, requires_grad=True)
    tout, tgates = TM._moe_apply(leaves, xl, 2, tl.act_fn())
    grads = torch.autograd.grad(tout, [xl, *leaves.values()], torch.from_numpy(cot))
    _close(tout, out, TOL)
    _close(tgates, gates, TOL)
    _close(grads[0], gx, TOL)
    for g, n in zip(grads[1:], leaves):
        _close(g, gp[n], TOL)
    np.testing.assert_array_equal(tgates[0, 0].detach().numpy(), [0.5, 0.5, 0.0, 0.0])
    np.testing.assert_array_equal(np.asarray(gates)[0, 0], [0.5, 0.5, 0.0, 0.0])
    assert (tgates > 0).sum(-1).eq(2).all()
    _close(TM.load_balancing_loss(tgates.detach()).reshape(1),
           np.asarray(JM.load_balancing_loss(gates)).reshape(1), TOL)
    uniform = torch.full((8, 4), 0.25)
    assert float(TM.load_balancing_loss(uniform)) == pytest.approx(1.0)


def _moe_conf(pkg, nnc, it, adam):
    return (nnc.builder().seed(8).updater(adam(1e-2)).list()
            .layer(pkg.MixtureOfExpertsLayer(n_out=6, n_experts=4, top_k=2,
                                             collect_gates=True))
            .layer(pkg.OutputLayer(n_out=3, loss="mcxent", activation="softmax"))
            .set_input_type(it.feed_forward(5)).build())


def test_moe_network_steps_and_collects_gates_as_the_reference():
    jnet, net = _twins(_moe_conf)
    assert _json(net.conf.layers[0].output_type(InputType.recurrent(5, 3)).to_dict()) == \
        _json(jnet.conf.layers[0].output_type(JIT.recurrent(5, 3)).to_dict())
    x, y = _ff_data(seed=9)
    x[2] = 0.0
    _close(net.output(x), np.asarray(jnet.output(x)), TOL)
    _steps(jnet, net, x, y)
    gates = export_states(net)[0]["gates"]
    np.testing.assert_allclose(gates, np.asarray(jnet.states[0]["gates"]), rtol=0, atol=TOL)
    assert gates.shape == (8, 4) and (gates > 0).sum(-1).tolist() == [2] * 8


# ------------------------------------------------------------------ simple
def test_simple_results_are_the_references():
    p = np.array([[0.1, 0.6, 0.3], [0.5, 0.2, 0.3], [0.3, 0.3, 0.4]], np.float32)
    for labels in (None, ["cat", "dog", "eel"]):
        mine, ref = (tsimple.RankClassificationResult(p, labels),
                     jsimple.RankClassificationResult(p, labels))
        assert mine.max_outcomes() == ref.max_outcomes()
        assert [mine.ranked_labels_for_row(r) for r in range(3)] == \
            [ref.ranked_labels_for_row(r) for r in range(3)]
        assert mine.probability_for_row(2, 1) == ref.probability_for_row(2, 1)
    assert tsimple.RankClassificationResult(p[0]).max_outcome_for_row(0) == "1"
    with pytest.raises(ValueError):
        tsimple.RankClassificationResult(p, ["a"])
    with pytest.raises(ValueError):
        tsimple.RankClassificationResult(p[None])
    for kw in ({}, {"decision_threshold": 0.3}, {"class_weights": (1.0, 3.0)}):
        for probs in (p[:, 0], p[:, :2]):
            np.testing.assert_array_equal(tsimple.BinaryClassificationResult(**kw).decide(probs),
                                          jsimple.BinaryClassificationResult(**kw).decide(probs))

