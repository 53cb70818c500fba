"""BatchNormalization and layer state in the port against the JAX package.

The layer alone, train and inference mode, on NHWC images and ``[N, F]``
rows, with and without ``lock_gamma_beta``: the output and the new
running statistics within 1e-6 (f32 both ways; the moments are summed in
another order). A channel held at 1e3 must keep its variance of 0: a
one-pass ``E[x²] − E[x]²`` loses it to cancellation. Then a small conv →
BN → dense → output ``MultiLayerNetwork`` over 3 Adam steps, with and
without ``FusedUpdaterHelper`` (its kernel's plain version on CPU
tensors): each parameter within 2e-5 × its largest entry, the states
within 1e-6 (the convolution has no bias, as in ResNet: BatchNorm
cancels a bias in front of it, whose gradient is then float noise that
Adam scales up to full steps); its ``output`` and ``feed_forward`` read the running
statistics; its zip carries them both ways.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import BatchNormalizationLayer as JBN
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn import updaters as PU
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNormalizationLayer,
    ConvolutionLayer,
    DenseLayer,
    OutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    export_states,
    load_reference_params,
    load_reference_states,
)

TOL, STEP_TOL = 1e-6, 2e-5
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


@pytest.fixture(autouse=True)
def _clean_seams():
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    yield
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()


def _bn_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(0.5, 2.0, shape)).astype(np.float32)
    params = {"gamma": rng.normal(1.0, 0.3, c).astype(np.float32),
              "beta": rng.normal(0.0, 0.3, c).astype(np.float32)}
    state = {"mean": rng.normal(0.0, 0.5, c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    return x, params, state


def _layers(lock, c, **kw):
    kw = dict(n_in=c, decay=0.8, eps=1e-3, activation="tanh",
              lock_gamma_beta=lock, **kw)
    if lock:
        kw.update(gamma_init=1.5, beta_init=-0.25)
    return JBN(**kw), BatchNormalizationLayer(**kw)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("shape", [(4, 5, 6, 3), (8, 7)], ids=["nhwc", "rows"])
@pytest.mark.parametrize("lock", [False, True], ids=["gamma_beta", "locked"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "inference"])
def test_layer_matches_reference(shape, lock, train):
    x, params, state = _bn_inputs(shape)
    jl, tl = _layers(lock, shape[-1])
    if lock:
        params = {}
        assert tl.param_shapes() == jl.param_shapes() == {}
    y_j, st_j = jl.forward(params, x, state=state, train=train)
    y_t, st_t = tl.forward_state(
        {k: torch.from_numpy(v) for k, v in params.items()},
        {k: torch.from_numpy(v) for k, v in state.items()},
        torch.from_numpy(x), train=train)
    _close(y_t, y_j, what="output")
    assert set(st_t) == set(st_j) == {"mean", "var"}
    for k in st_j:
        assert st_t[k].dtype == torch.float32
        _close(st_t[k], st_j[k], what=k)
    if not train:  # inference reads the state and keeps it
        for k in state:
            np.testing.assert_array_equal(st_t[k].numpy(), state[k])


def test_biased_running_variance_and_decay_direction():
    """The running variance takes the biased batch variance, and decay
    weighs the old value: running = decay * old + (1 - decay) * batch."""
    x, params, state = _bn_inputs((16, 3), seed=4)
    _, tl = _layers(False, 3)
    _, st = tl.forward_state({k: torch.from_numpy(v) for k, v in params.items()},
                             {k: torch.from_numpy(v) for k, v in state.items()},
                             torch.from_numpy(x), train=True)
    want_var = 0.8 * state["var"] + 0.2 * x.astype(np.float64).var(axis=0)
    want_mean = 0.8 * state["mean"] + 0.2 * x.astype(np.float64).mean(axis=0)
    _close(st["var"], want_var, 1e-5)
    _close(st["mean"], want_mean, 1e-5)


def test_constant_large_channel_keeps_zero_variance():
    """A channel held at 1e3: the two-pass variance is 0 there, as the
    reference's; a one-pass E[x^2] - E[x]^2 in f32 is not."""
    x, params, state = _bn_inputs((6, 4, 4, 3), seed=2)
    x[..., 1] = 1e3
    jl, tl = _layers(False, 3)
    y_j, st_j = jl.forward(params, x, state=state, train=True)
    y_t, st_t = tl.forward_state(
        {k: torch.from_numpy(v) for k, v in params.items()},
        {k: torch.from_numpy(v) for k, v in state.items()},
        torch.from_numpy(x), train=True)
    _close(y_t, y_j, what="output")
    _close(st_t["var"], st_j["var"], what="var")
    np.testing.assert_allclose(st_t["var"][1].item(), 0.8 * state["var"][1],
                               rtol=1e-7)
    np.testing.assert_allclose(y_t[..., 1].numpy(), np.tanh(params["beta"][1]),
                               rtol=1e-6)


def _conf(pkg, lock=False):
    jax_side = pkg == "jax"
    b, conv, bn, dense, out, it, adam = (
        (JNNC.builder(), JConv, JBN, JDense, JOut, JIT, JU.Adam) if jax_side else
        (NeuralNetConfiguration.builder(), ConvolutionLayer,
         BatchNormalizationLayer, DenseLayer, OutputLayer, InputType, PU.Adam))
    return (b.seed(7).updater(adam(1e-2)).list()
            .layer(conv(n_out=4, kernel_size=(3, 3), activation="identity",
                        has_bias=False))
            .layer(bn(activation="relu", decay=0.9, lock_gamma_beta=lock))
            .layer(dense(n_out=12, activation="tanh"))
            .layer(out(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(it.convolutional(8, 8, 2)).build())


def _pair(lock=False):
    jnet = JaxMLN(_conf("jax", lock)).init()
    rng = np.random.default_rng(3)
    # move the running statistics off their initial values
    jnet.states[1] = {"mean": rng.normal(0, 0.3, 4).astype(np.float32),
                      "var": rng.uniform(0.5, 1.5, 4).astype(np.float32)}
    tnet = MultiLayerNetwork(_conf("port", lock), device="cpu").init()
    load_reference_params(tnet, to_np(jnet.params))
    load_reference_states(tnet, to_np(jnet.states))
    return jnet, tnet


def _data(seed, n=10):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.2, 1.0, (n, 8, 8, 2)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]


def _assert_params(got, want, what):
    for i, named in enumerate(want):
        assert set(got[i]) == set(named), f"{what} {i}"
        for n, w in named.items():
            scale = max(float(np.abs(w).max()), 1e-30)
            assert np.abs(got[i][n] - w).max() <= STEP_TOL * scale, \
                f"{what} {i}/{n}: {np.abs(got[i][n] - w).max()} vs {scale}"


def test_network_states_and_inference_match_reference():
    jnet, tnet = _pair()
    assert set(tnet.states[1]) == {"mean", "var"}
    assert all(not s for i, s in tnet.states.items() if i != 1)
    assert not any(t.requires_grad for s in tnet.states.values() for t in s.values())
    names = dict(tnet.named_buffers())
    assert names["1/mean"] is tnet.states[1]["mean"]
    x, _ = _data(1)
    _close(tnet.output(x), jnet.output(x), 2e-6, "output")
    for i, (g, w) in enumerate(zip(tnet.feed_forward(x), jnet.feed_forward(x))):
        _close(g, w, 2e-6, f"activation {i}")


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused"])
@pytest.mark.parametrize("lock", [False, True], ids=["gamma_beta", "locked"])
def test_three_adam_steps_match_reference(fused, lock):
    jnet, tnet = _pair(lock)
    if fused:
        thelpers.set_helper("updater", ck.FusedUpdaterHelper())
    before = {k: t.clone() for k, t in tnet.states[1].items()}
    buffers = dict(tnet.states[1])
    for step in range(3):
        x, y = _data(10 + step)
        jnet.fit(x, y)
        tnet.fit(x, y)
        np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=STEP_TOL)
    assert all(tnet.states[1][k] is buffers[k] for k in buffers)  # in place
    assert not torch.equal(tnet.states[1]["mean"], before["mean"])
    _assert_params(export_params(tnet), to_np(jnet.params), "param")
    for k in ("mean", "var"):
        _close(tnet.states[1][k], jnet.states[1][k], what=f"state {k}")
    x, _ = _data(20)
    _close(tnet.output(x), jnet.output(x), 2e-5, "output after fit")
    # score and gradients read the running statistics: no state moves
    snap = {k: t.clone() for k, t in tnet.states[1].items()}
    tnet.compute_gradient_and_score(*_data(21))
    tnet.score(DataSet(*_data(22)))
    for k in snap:
        assert torch.equal(tnet.states[1][k], snap[k])


def test_zip_carries_states_both_ways(tmp_path):
    jnet, tnet = _pair()
    x, y = _data(5)
    jnet.fit(x, y)
    tnet.fit(x, y)
    p_port, p_jax = tmp_path / "port.zip", tmp_path / "jax.zip"
    tnet.save(p_port)
    jser.write_model(jnet, p_jax)
    from_port = jser.restore_multi_layer_network(p_port)
    from_jax = MultiLayerNetwork.load(p_jax, device="cpu")
    for k in ("mean", "var"):
        np.testing.assert_array_equal(np.asarray(from_port.states[1][k]),
                                      tnet.states[1][k].numpy())
        np.testing.assert_array_equal(from_jax.states[1][k].numpy(),
                                      np.asarray(jnet.states[1][k]))
    xq, _ = _data(6)
    _close(np.asarray(from_port.output(xq)), tnet.output(xq), TOL, "jax reads port")
    _close(from_jax.output(xq), np.asarray(jnet.output(xq)), TOL, "port reads jax")
    assert export_states(from_jax)[1].keys() == {"mean", "var"}
