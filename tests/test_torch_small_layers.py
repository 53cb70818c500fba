"""The port's activations and small layers against the JAX package's.

Every activation of the reference's registry (23 names), on inputs that
hold the ties (0, each clip bound, the threshold) and with alpha and
theta given as kwargs: the forward within 1e-6 and the gradient within
1e-6 of ``jax.vjp``'s, in f32. The gradient at a tie is the reference's:
``jnp.maximum`` and ``jnp.clip`` split it in half, ``jnp.where`` keeps its
comparison. Relu's own tie (where the port's relu once gave 1, not 0.5)
is held where it bites: a ``DenseLayer`` and a ``ConvolutionLayer`` with
zero bias over inputs with all-zero rows and windows, whose bias
gradients must be the reference's within 1e-6 × max(1, the largest
entry): each is a sum over the positions, in another order.

Then ``MaskLayer``, ``EmbeddingLayer``, ``ElementWiseMultiplicationLayer``,
``PReLULayer`` and the loss layers (``LossLayer``, ``RnnLossLayer``,
``CnnLossLayer``, ``CenterLossOutputLayer``), each on the same numpy
inputs and weights in both packages: the forward (or the loss) within
1e-6 and the gradients within 1e-5 (times max(1, the largest entry)),
the ``output_type`` and the configuration JSON both ways. The ``cnn3d``
and ``cnn1d`` kinds, and a network that starts with the feed-forward
layers and ends in a ``CenterLossOutputLayer`` (each new activation on a
dense layer of its own), whose ``output``, score and 3 Adam steps (in
f64: its f32 steps are ill-conditioned) match the reference's from
the same weights, and a graph that ends in a ``LossLayer``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import activations as jact
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import base as jbase
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.nn.weights import Distribution as JDistribution
from deeplearning4j_tpu_torch.nn import activations as tact
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import base as tbase
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.nn.weights import Distribution
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    export_updater_state,
    load_reference_params,
)
from test_torch_conv_family import _close, _json, check_layer, jax_init, to_np

ACT_TOL, FWD_TOL, GRAD_TOL, STEP_TOL = 1e-6, 1e-6, 1e-5, 1e-5
# in this order each dense layer of the network below passes a gradient
# back: thresholdedrelu (theta 1) follows logsoftmax, whose outputs give
# the next pre-activations a wide spread (after an activation with outputs
# in [0, 1) it would zero its inputs, and every gradient below it)
NEW_ACTIVATIONS = ("relu6", "leakyrelu", "elu", "hardsigmoid", "hardtanh",
                   "rationaltanh", "rectifiedtanh", "logsoftmax", "thresholdedrelu",
                   "softplus", "softsign", "cube", "swish", "mish")


# -------------------------------------------------------------- activations
def _tie_inputs():
    """[4, 16]: the ties (0, ±1, 6, ±2.5 where hardsigmoid's 0.2x + 0.5 is
    exactly 0 and 1, the thresholds 1 and 0.5), a few large values, and
    normal draws."""
    ties = [0.0, -0.0, 1.0, -1.0, 6.0, -2.5, 2.5, 0.5, 10.0, -10.0, 30.0, -30.0]
    x = np.random.default_rng(3).normal(0, 2, (4, 16)).astype(np.float32)
    x[0, :len(ties)] = ties
    x[1, :4] = 0.0
    return x


def _both(jfn, tfn, x, seed=0):
    """Forward and input gradient of both, the reference's op by op: under
    ``jax.jit`` XLA fuses hardsigmoid's ``0.2·x + 0.5`` into one rounding,
    which moves its ties off the bounds."""
    cot = np.random.default_rng(seed).standard_normal(x.shape).astype(np.float32)
    out, pull = jax.vjp(jfn, jnp.asarray(x))
    pull = pull(jnp.asarray(cot))[0]
    leaf = torch.tensor(x, requires_grad=True)
    tout = tfn(leaf)
    (tgrad,) = torch.autograd.grad(tout, leaf, torch.from_numpy(cot))
    return np.asarray(out), tout.detach().numpy(), np.asarray(pull), tgrad.numpy()


ACT_CASES = [(n, None) for n in jact.names()] + [
    ("leakyrelu", {"alpha": 0.2}), ("elu", {"alpha": 0.5}),
    ("thresholdedrelu", {"theta": 0.5}), ("thresholdedrelu", {"theta": 6.0})]


@pytest.mark.parametrize("name,kwargs", ACT_CASES,
                         ids=[n if k is None else f"{n}-{k}" for n, k in ACT_CASES])
def test_activation_matches_the_reference_at_its_ties(name, kwargs):
    spec = name if kwargs is None else (name, kwargs)
    out, tout, grad, tgrad = _both(jact.resolve(spec), tact.resolve(spec), _tie_inputs())
    np.testing.assert_allclose(tout, out, rtol=0, atol=ACT_TOL * max(1, np.abs(out).max()))
    np.testing.assert_allclose(tgrad, grad, rtol=0,
                               atol=ACT_TOL * max(1, np.abs(grad).max()))


def test_registry_is_the_references():
    assert tact.names() == jact.names() and len(tact.names()) == 23
    assert set(NEW_ACTIVATIONS) <= set(tact.names())


def test_tie_gradients_are_the_references():
    """The values ``jax.grad`` gives at the ties, written out."""
    def grad(name, v):
        x = torch.tensor([v], requires_grad=True)
        (g,) = torch.autograd.grad(tact.resolve(name)(x).sum(), x)
        return g.item()
    assert grad("relu", 0.0) == 0.5
    assert grad("relu6", 0.0) == grad("relu6", 6.0) == 0.5
    assert grad("hardtanh", -1.0) == grad("hardtanh", 1.0) == 0.5
    assert grad("hardsigmoid", -2.5) == grad("hardsigmoid", 2.5) == pytest.approx(0.1)
    assert grad("rectifiedtanh", 0.0) == 0.5
    assert grad("leakyrelu", 0.0) == 1.0 and grad("elu", 0.0) == 1.0
    assert grad("thresholdedrelu", 1.0) == 0.0


def _zero_row_input(kind):
    """Inputs with all-zero rows (dense) or all-zero windows (conv: a
    black background with one bright patch)."""
    rng = np.random.default_rng(5)
    if kind == "dense":
        x = rng.standard_normal((6, 5)).astype(np.float32)
        x[[0, 2, 3]] = 0.0
        return x
    x = np.zeros((2, 9, 8, 2), np.float32)
    x[:, 1:4, 2:5] = rng.standard_normal((2, 3, 3, 2))
    return x


@pytest.mark.parametrize("kind", ["dense", "conv"])
def test_relu_bias_gradient_at_exact_zeros(kind):
    """With zero bias, every all-zero row or window gives a
    pre-activation of exactly 0, where relu's gradient is the
    reference's 0.5 (it was 1.0)."""
    if kind == "dense":
        jl, tl = JL.DenseLayer(n_in=5, n_out=4, activation="relu"), \
            L.DenseLayer(n_in=5, n_out=4, activation="relu")
    else:
        kw = dict(n_in=2, n_out=3, kernel_size=(3, 3), convolution_mode="same",
                  activation="relu")
        jl, tl = JL.ConvolutionLayer(**kw), L.ConvolutionLayer(**kw)
    rng = np.random.default_rng(6)
    w = rng.standard_normal(jl.param_shapes()["W"]).astype(np.float32)
    b = np.zeros(jl.param_shapes()["b"], np.float32)
    x = _zero_row_input(kind)
    cot = rng.standard_normal(np.shape(jl.forward({"W": w, "b": b}, x)[0])).astype(np.float32)
    jg = jax.jit(jax.grad(lambda b_: jnp.sum(jl.forward({"W": w, "b": b_}, x)[0] * cot)))(b)
    bt = torch.tensor(b, requires_grad=True)
    (tg,) = torch.autograd.grad(
        (tl.forward({"W": torch.from_numpy(w), "b": bt}, torch.from_numpy(x))
         * torch.from_numpy(cot)).sum(), bt)
    pre = tl._preact({"W": torch.from_numpy(w), "b": torch.from_numpy(b)},
                     torch.from_numpy(x)) if kind == "dense" else None
    if pre is not None:
        assert (pre == 0).sum() >= 12  # the ties are there
    _close(tg, jg, 1e-6)


# ------------------------------------------------------------ core layers
def _ff(n):
    return JIT.feed_forward(n), InputType.feed_forward(n)


@pytest.mark.parametrize("activation", ["sigmoid", ("leakyrelu", {"alpha": 0.3})])
def test_elementwise_multiplication(activation):
    x = np.random.default_rng(1).standard_normal((4, 6)).astype(np.float32)
    check_layer(JL.ElementWiseMultiplicationLayer(activation=activation),
                L.ElementWiseMultiplicationLayer(activation=activation), x, *_ff(6))
    assert torch.equal(L.ElementWiseMultiplicationLayer(n_in=6).init_params(
        torch.Generator())["W"], torch.ones(6))


@pytest.mark.parametrize("shape,shared", [((6,), None), ((5, 4, 3), (1, 2)),
                                          ((5, 4, 3), None)])
def test_prelu(shape, shared):
    x = np.random.default_rng(2).standard_normal((3, *shape)).astype(np.float32)
    x[0] = 0.0  # x >= 0 takes the x branch at the tie
    its = _ff(6) if len(shape) == 1 else (JIT.convolutional(*shape),
                                           InputType.convolutional(*shape))
    check_layer(JL.PReLULayer(shared_axes=shared), L.PReLULayer(shared_axes=shared),
                x, *its)
    layer = L.PReLULayer(shared_axes=shared)
    layer.set_n_in(its[1])
    assert not layer.init_params(torch.Generator())["W"].any()


@pytest.mark.parametrize("has_bias,ids", [(False, "flat"), (True, "column"),
                                          (True, "negative"), (False, "outside")])
def test_embedding(has_bias, ids):
    """``[N]`` and ``[N,1]`` ids, float ids truncated, ids in
    ``[-n_in, 0)`` counted from the end and ids outside ``[-n_in, n_in)``
    a row of NaN, as ``jnp.take`` gives them."""
    n_in, n_out = 7, 4
    x = np.array([0, 3, 6, 2, 5], np.float32) + 0.25
    if ids == "column":
        x = x[:, None]
    elif ids == "negative":
        x = np.array([-7, -1, 0, 6, -3], np.float32)
    elif ids == "outside":
        x = np.array([7, -8, 1, 30], np.float32)
    jl = JL.EmbeddingLayer(n_in=n_in, n_out=n_out, has_bias=has_bias)
    tl = L.EmbeddingLayer(n_in=n_in, n_out=n_out, has_bias=has_bias)
    rng = np.random.default_rng(4)
    p = {n: rng.standard_normal(s).astype(np.float32) for n, s in jl.param_shapes().items()}
    want = np.asarray(jl.forward(p, x)[0])
    got = tl.forward({n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FWD_TOL)
    assert np.isnan(want).any() == (ids == "outside")
    cot = rng.standard_normal(want.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda q: jnp.nansum(jl.forward(q, x)[0] * cot)))(p)
    leaves = {n: torch.tensor(a, requires_grad=True) for n, a in p.items()}
    tg = torch.autograd.grad(torch.nansum(tl.forward(leaves, torch.from_numpy(x))
                                          * torch.from_numpy(cot)), list(leaves.values()))
    for (n, _), g in zip(leaves.items(), tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[n]), rtol=0, atol=GRAD_TOL)
    assert tl.output_type(InputType.feed_forward(1)) == InputType.feed_forward(n_out)
    assert _json(tbase.layer_from_dict(_json(jl.to_dict())).to_dict()) == _json(jl.to_dict())


MASKS = {"full": (3, 4, 5), "steps": (3, 4), "examples_ff": (3,),
         "examples_cnn": (3, 1)}


@pytest.mark.parametrize("kind", list(MASKS))
def test_mask_layer(kind):
    rng = np.random.default_rng(7)
    x_shape = {"full": (3, 4, 5), "steps": (3, 4, 5), "examples_ff": (3, 5),
               "examples_cnn": (3, 4, 2, 5)}[kind]
    x = rng.standard_normal(x_shape).astype(np.float32)
    m = (rng.random(MASKS[kind]) > 0.4).astype(np.float32)
    jl, tl = JL.MaskLayer(), L.MaskLayer()
    out, pull = jax.vjp(lambda a: jl.forward({}, a, mask=jnp.asarray(m))[0], x)
    cot = rng.standard_normal(out.shape).astype(np.float32)
    leaf = torch.tensor(x, requires_grad=True)
    tout = tl.forward({}, leaf, mask=torch.from_numpy(m))
    (tg,) = torch.autograd.grad(tout, leaf, torch.from_numpy(cot))
    _close(tout, out, FWD_TOL)
    _close(tg, pull(jnp.asarray(cot))[0], GRAD_TOL)
    assert torch.equal(tl.forward({}, torch.from_numpy(x)), torch.from_numpy(x))


def test_mask_layer_refuses_what_the_reference_refuses():
    x, m = np.ones((3, 4, 5), np.float32), np.ones((2,), np.float32)
    with pytest.raises(ValueError, match="does not broadcast"):
        JL.MaskLayer().forward({}, x, mask=jnp.asarray(m))
    with pytest.raises(ValueError, match="does not broadcast"):
        L.MaskLayer().forward({}, torch.from_numpy(x), mask=torch.from_numpy(m))


# ----------------------------------------------------------- loss layers
def _loss_case(kind, rng):
    """(reference layer, port layer, x, labels, mask, params)."""
    if kind == "loss_mse":
        x = rng.standard_normal((5, 3)).astype(np.float32)
        y = rng.standard_normal((5, 3)).astype(np.float32)
        return JL.LossLayer(loss="mse"), L.LossLayer(loss="mse"), x, y, None, {}
    if kind == "loss_mcxent":
        x = rng.standard_normal((5, 3)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 5)]
        m = np.array([1, 1, 0, 1, 1], np.float32)
        kw = dict(loss="mcxent", activation="softmax")
        return JL.LossLayer(**kw), L.LossLayer(**kw), x, y, m, {}
    if kind == "rnn_loss":
        x = rng.standard_normal((3, 6, 4)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (3, 6))]
        m = np.ones((3, 6), np.float32)
        m[1, 4:] = 0.0
        kw = dict(loss="mcxent", activation="softmax")
        return JL.RnnLossLayer(**kw), L.RnnLossLayer(**kw), x, y, m, {}
    if kind in ("cnn_loss", "cnn_loss_xent"):
        x = rng.standard_normal((2, 5, 4, 3)).astype(np.float32)
        if kind == "cnn_loss":
            y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 5, 4))]
            kw = dict(loss="mcxent", activation="softmax")
        else:
            y = (rng.random((2, 5, 4, 3)) > 0.5).astype(np.float32)
            kw = dict(loss="xent", activation="sigmoid")
        m = (rng.random((2, 5, 4)) > 0.3).astype(np.float32)
        return JL.CnnLossLayer(**kw), L.CnnLossLayer(**kw), x, y, m, {}
    x = rng.standard_normal((6, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    kw = dict(n_in=5, n_out=3, lambda_=0.3, alpha=0.1)
    jl = JL.CenterLossOutputLayer(**kw)
    p = {n: rng.standard_normal(s).astype(np.float32) for n, s in jl.param_shapes().items()}
    return jl, L.CenterLossOutputLayer(**kw), x, y, None, p


@pytest.mark.parametrize("kind", ["loss_mse", "loss_mcxent", "rnn_loss", "cnn_loss",
                                  "cnn_loss_xent", "center_loss"])
def test_loss_layer(kind):
    rng = np.random.default_rng(9)
    jl, tl, x, y, m, p = _loss_case(kind, rng)
    assert tl.param_shapes() == jl.param_shapes() and tl.has_loss() and jl.has_loss()
    jm = None if m is None else jnp.asarray(m)
    jloss, (jgx, jgp) = jax.jit(jax.value_and_grad(
        lambda x_, p_: jl.compute_loss(p_, x_, jnp.asarray(y), mask=jm), argnums=(0, 1)))(
        jnp.asarray(x), {n: jnp.asarray(a) for n, a in p.items()})
    leaves = {n: torch.tensor(a, requires_grad=True) for n, a in p.items()}
    xt = torch.tensor(x, requires_grad=True)
    tloss = tl.compute_loss(leaves, xt, torch.from_numpy(y),
                            mask=None if m is None else torch.from_numpy(m))
    grads = torch.autograd.grad(tloss, [xt, *leaves.values()])
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=FWD_TOL)
    _close(grads[0], jgx, GRAD_TOL)
    for n, g in zip(leaves, grads[1:]):
        _close(g, jgp[n], GRAD_TOL)
    _close(tl.forward({n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x)),
           jl.forward(p, x)[0], FWD_TOL)
    back = tbase.layer_from_dict(_json(jl.to_dict()))
    assert type(back) is type(tl) and _json(back.to_dict()) == _json(tl.to_dict())
    assert _json(jbase.layer_from_dict(_json(tl.to_dict())).to_dict()) == _json(jl.to_dict())


def test_loss_layer_defaults():
    assert L.LossLayer().activation == JL.LossLayer().activation == "identity"
    assert L.LossLayer().param_shapes() == {}
    c = L.CenterLossOutputLayer(n_in=4, n_out=2)
    assert (c.activation, c.alpha, c.lambda_) == ("softmax", 0.05, 2e-4)
    assert not c.init_params(torch.Generator())["cL"].any()


# ---------------------------------------------------------------- input kinds
def test_cnn3d_and_cnn1d_kinds_are_the_references():
    it, jit_ = InputType.convolutional3d(2, 3, 4, 5), JIT.convolutional3d(2, 3, 4, 5)
    assert _json(it.to_dict()) == _json(jit_.to_dict())
    assert it.flat_size() == jit_.flat_size() == 120
    assert it.batch_shape(7) == jit_.batch_shape(7) == (7, 2, 3, 4, 5)
    assert InputType.from_dict(jit_.to_dict()) == it
    assert InputType.recurrent1d(6, 9) == InputType.recurrent(6, 9)
    assert JIT.recurrent1d(6, 9).to_dict() == InputType.recurrent1d(6, 9).to_dict()
    for t in (InputType(kind="cnn1d"), JIT(kind="cnn1d")):
        with pytest.raises(ValueError):
            t.flat_size()


def _cnn3d_net(pkg_l, nnc, it):
    return (nnc.builder().seed(2).list()
            .layer(pkg_l.DenseLayer(n_out=4, activation="elu"))
            .layer(pkg_l.OutputLayer(n_out=3))
            .set_input_type(it.convolutional3d(2, 3, 4, 2)).build())


def test_dense_flattens_a_cnn3d_input_as_the_reference():
    jconf, conf = _cnn3d_net(JL, JNNC, JIT), _cnn3d_net(L, NeuralNetConfiguration, InputType)
    assert conf.layers[0].n_in == jconf.layers[0].n_in == 48
    jnet = jax_init(JMLN, jconf)
    net = load_reference_params(MultiLayerNetwork(conf, device="cpu").init(),
                                to_np(jnet.params))
    x = np.random.default_rng(1).standard_normal((3, 2, 3, 4, 2)).astype(np.float32)
    _close(net.output(x), jnet.output(x), FWD_TOL)


# --------------------------------------------------------------- networks
def _ff_net(pkg_l, adam, nnc, it, vocab=50, width=12, labels=5):
    """The card phase's feed-forward network at a small width; the
    embedding drawn from N(0, 1) so that the first dense layer sees inputs
    of order 1."""
    dist = (JDistribution if pkg_l is JL else Distribution)("normal", 0.0, 1.0)
    b = (nnc.builder().seed(3).updater(adam(1e-2)).list()
         .layer(pkg_l.EmbeddingLayer(n_in=vocab, n_out=width,
                                     weight_init="distribution", distribution=dist))
         .layer(pkg_l.ElementWiseMultiplicationLayer(activation="identity"))
         .layer(pkg_l.PReLULayer()))
    for name in NEW_ACTIVATIONS:
        b.layer(pkg_l.DenseLayer(n_out=width, activation=name))
    return (b.layer(pkg_l.CenterLossOutputLayer(n_out=labels, lambda_=0.05))
            .set_input_type(it.feed_forward(1)).build())


def _graph_with_loss_vertex(pkg_l, adam, nnc, it):
    return (nnc.builder().seed(3).updater(adam(1e-2)).graph_builder()
            .add_inputs("in").set_input_types(it.convolutional(6, 5, 2))
            .add_layer("conv", pkg_l.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                                       activation="leakyrelu"), "in")
            .add_layer("pool", pkg_l.GlobalPoolingLayer(pooling_type="avg"), "conv")
            .add_layer("loss", pkg_l.LossLayer(loss="mcxent", activation="softmax"), "pool")
            .set_outputs("loss").build())


def _check_steps(jnet, net, x, y):
    start = (lambda t: t if isinstance(t, dict) else dict(enumerate(t)))(
        export_params(net))
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.score_, float(jnet.score_), rtol=STEP_TOL)
    ref, ref_upd = jnet.params, jnet.updater_states
    keyed = (lambda t: t if isinstance(t, dict) else dict(enumerate(t)))  # noqa: E731
    ref, ref_upd = keyed(to_np(ref)), keyed(to_np(ref_upd))
    upd = keyed(export_updater_state(net))
    for k, named in keyed(export_params(net)).items():
        for n, got in named.items():
            want = ref[k][n]
            np.testing.assert_allclose(got, want, rtol=0, err_msg=f"{k}/{n}",
                                       atol=STEP_TOL * np.abs(want).max())
            assert not np.array_equal(got, start[k][n]), f"{k}/{n} took no step"
            for slot, s in upd[k][n].items():
                want_s = np.asarray(ref_upd[k][n][slot])
                np.testing.assert_allclose(s, want_s, rtol=0, err_msg=f"{k}/{n}/{slot}",
                                           atol=STEP_TOL * max(np.abs(want_s).max(), 1e-30))


def test_feed_forward_network_matches_the_reference():
    """Embedding → ElementWiseMultiplication → PReLU → a dense layer for
    each new activation → CenterLossOutputLayer, on integer ids, in f64 (the
    layers' f32 forwards are held above). Its f32 steps are ill-conditioned:
    Adam scales each entry's step by its own gradient, so an entry of
    ``cL`` or a bias whose gradient is a small part of its tensor's largest
    takes a full step from a gradient that f32 rounding moves by a visible
    share, and the two packages' f32 steps part by 1e-4 of an entry."""
    jconf = _ff_net(JL, JAdam, JNNC, JIT)
    conf = _ff_net(L, Adam, NeuralNetConfiguration, InputType)
    assert conf.num_params() == jconf.num_params()
    rng = np.random.default_rng(5)
    x = rng.integers(0, 50, (16, 1))
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 16)]
    with jax.enable_x64(True):
        jconf.global_conf.dtype = conf.global_conf.dtype = "float64"
        jnet = jax_init(JMLN, jconf)
        net = load_reference_params(MultiLayerNetwork(conf, device="cpu").init(),
                                    to_np(jnet.params))
        _close(net.output(x), jnet.output(x), FWD_TOL)
        _check_steps(jnet, net, x, y)


def test_graph_with_a_loss_layer_output_matches_the_reference():
    """A ``LossLayer`` vertex (no parameters) as a graph's output."""
    jconf = _graph_with_loss_vertex(JL, JAdam, JNNC, JIT)
    conf = _graph_with_loss_vertex(L, Adam, NeuralNetConfiguration, InputType)
    jnet = jax_init(JGraph, jconf)
    net = load_reference_params(ComputationGraph(conf, device="cpu").init(),
                                to_np(jnet.params))
    assert net.params["loss"] == {}
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 6, 5, 2)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 4)]
    _close(net.output(x), jnet.output(x), FWD_TOL)
    _check_steps(jnet, net, x, y)
