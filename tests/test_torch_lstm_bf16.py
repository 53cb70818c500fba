"""K1-bf16 (the LSTM sequence kernel on bfloat16) and the bf16 LSTM seam of
the port, on the CPU, against the JAX package.

On CPU tensors ``lstm_sequence`` computes ``lstm_sequence_plain``, which
on bf16 tensors rounds every op's result to bf16 where the TPU kernel on a
bf16 ``xw`` rounds it (``_lstm_kernel``, ``pallas_kernels.py:47-48``); the
card holds the kernel to it (``chip_smoke.py`` ``lstm_bf16_kernel``).
Here that plain version is held to the JAX package's Pallas kernel run in
interpret mode on the same bf16 inputs. No torch version reproduces the
JAX kernel bit for bit (JAX's bf16 sigmoid and XLA's fusion round in a few
other places), so the limits are: the largest difference within 2^-5, and
the port's relative Frobenius distance from an f64 recurrence on the same
bf16-rounded inputs within 1.25x the JAX kernel's (about 0.85x measured).
Gradients (``LSTMSequenceFunction`` on bf16 leaves against ``jax.vjp`` of
``lstm_fused`` in bf16) are held in the same form against an f64 VJP.

The seam: bf16 ``x`` and ``RW`` with a None or bf16 carry take the kernel;
a mixed carry (f32 h0/c0 against bf16 ``x``, as TBPTT and
``rnn_time_step`` carry under a bf16 compute dtype) takes the plain loop,
and ``lstm_sequence`` on a mixed-dtype CUDA call raises, as the TPU kernel
raises on one. Networks in bf16 (a small standard-LSTM net and a
Bidirectional + LastTimeStep classifier) are held to the reference's bf16
in the ratio form of ``tests/test_torch_mixed_precision.py``: the port's
loss and gradients against the reference's f64 ones, as a multiple of the
reference's own bf16 distance from them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.pallas_kernels import (
    _lstm_pallas_fwd,
    _lstm_ref_scan,
    lstm_fused,
)
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.convert import export_params

SHAPES = [(16, 4, 32), (64, 8, 64), (128, 4, 128)]  # [T, N, H]
MAX_ABS, F64_RATIO = 2.0 ** -5, 1.25
WHOLE_RATIO, TENSOR_RATIO, TENSOR_FLOOR = 2.0, 3.0, 2e-2
LOSS_RATIO, LOSS_FLOOR = 3.0, 1e-3


@pytest.fixture(autouse=True)
def _clean_seams():
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    yield
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    thelpers.set_auto_fused_lstm(True)


def _inputs(shape, seed=0):
    """bf16-representable xw [T,N,4H], rw [H,4H] (Xavier scale), h0, c0,
    as f32 numpy arrays."""
    t, n, h = shape
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(t, n, 4 * h)),
              rng.normal(size=(h, 4 * h)) * np.sqrt(2.0 / (5 * h)),
              0.5 * rng.normal(size=(n, h)), rng.normal(size=(n, h)))
    return [torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()
            for a in arrays]


def _bf16(arrays, grad=False):
    return [torch.from_numpy(a.copy()).bfloat16().requires_grad_(grad) for a in arrays]


def _cat(outs):
    return np.concatenate([np.asarray(o, np.float64).ravel() for o in outs])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_bf16_recurrence_against_the_pallas_kernel_in_bf16(shape):
    args = _inputs(shape)
    kernel = _lstm_pallas_fwd(*(jnp.asarray(a, jnp.bfloat16) for a in args),
                              interpret=True)
    plain = ck.lstm_sequence_plain(*_bf16(args))
    wrapped = ck.lstm_sequence(*_bf16(args))  # CPU tensors: the plain version
    exact = ck.lstm_sequence_plain(*(torch.from_numpy(a).double() for a in args))
    assert all(o.dtype == torch.bfloat16 for o in plain)
    assert all(str(o.dtype) == "bfloat16" for o in kernel)
    for got, ref in zip(wrapped, plain):
        assert torch.equal(got, ref)
    k, p = _cat(kernel), _cat(o.double().numpy() for o in plain)
    e = _cat(o.numpy() for o in exact)
    assert np.abs(p - k).max() <= MAX_ABS
    d_port, d_jax = _rel(p, e), _rel(k, e)
    print(f"{shape}: max abs {np.abs(p - k).max():.4g}, f64 distance port "
          f"{d_port:.3e} JAX kernel {d_jax:.3e} ({d_port / d_jax:.3f}x)")
    assert d_port <= F64_RATIO * d_jax


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_bf16_function_gradients_against_the_fused_vjp_in_bf16(shape):
    args = _inputs(shape, seed=1)
    t, n, h = shape
    rng = np.random.default_rng(2)
    cts = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16().float().numpy()
           for s in ((t, n, h), (n, h), (n, h))]
    _, vjp = jax.vjp(lambda *a: lstm_fused(*a, True),
                     *(jnp.asarray(a, jnp.bfloat16) for a in args))
    want = vjp(tuple(jnp.asarray(c, jnp.bfloat16) for c in cts))
    with jax.enable_x64(True):
        _, vjp64 = jax.vjp(_lstm_ref_scan, *(jnp.asarray(a, jnp.float64) for a in args))
        exact = [np.asarray(g) for g in vjp64(tuple(jnp.asarray(c, jnp.float64)
                                                    for c in cts))]
    leaves = _bf16(args, grad=True)
    outs = ck.LSTMSequenceFunction.apply(*leaves)
    got = torch.autograd.grad(outs, leaves, [torch.from_numpy(c).bfloat16() for c in cts])
    for g, w, e, name in zip(got, want, exact, ("xw", "rw", "h0", "c0")):
        assert g.dtype == torch.bfloat16
        d_port = _rel(g.double().numpy(), e)
        d_jax = _rel(np.asarray(w, np.float64), e)
        assert d_port <= F64_RATIO * d_jax, (name, d_port, d_jax)


# ------------------------------------------------------------------ the seam
class _Spy(ck.FusedLSTMHelper):
    def __init__(self):
        self.calls = []

    def forward_seq(self, layer, params, x, carry):
        self.calls.append(None if carry is None else carry[0].dtype)
        return super().forward_seq(layer, params, x, carry)


def _bf16_layer(seed=3):
    layer = TL.LSTMLayer(n_in=5, n_out=8, activation="tanh")
    gen = torch.Generator().manual_seed(seed)
    params = layer.init_params(gen, torch.bfloat16)
    x = torch.randn((3, 6, 5), generator=gen).bfloat16()
    return layer, params, x


def test_seam_admits_bf16_with_a_none_or_bf16_carry(monkeypatch):
    spy = _Spy()
    monkeypatch.setattr(trec, "_AUTO_LSTM", spy)
    layer, params, x = _bf16_layer()
    ys, (h, c) = layer.forward_seq(params, x)
    carry = tuple(torch.full((3, 8), 0.25).bfloat16() for _ in range(2))
    ys2, _ = layer.forward_seq(params, x, carry=carry)
    assert spy.calls == [None, torch.bfloat16]
    assert ys.dtype == h.dtype == c.dtype == ys2.dtype == torch.bfloat16
    thelpers.set_auto_fused_lstm(False)  # the loop computes the same on the CPU
    loop, (hl, cl) = layer.forward_seq(params, x)
    assert torch.equal(loop, ys) and torch.equal(hl, h) and torch.equal(cl, c)


def test_seam_declines_a_mixed_carry_for_the_plain_loop(monkeypatch):
    spy = _Spy()
    monkeypatch.setattr(trec, "_AUTO_LSTM", spy)
    layer, params, x = _bf16_layer()
    carry = tuple(torch.full((3, 8), 0.25) for _ in range(2))  # f32, as TBPTT's
    ys, (h, c) = layer.forward_seq(params, x, carry=carry)
    assert spy.calls == []
    assert h.dtype == c.dtype == torch.float32  # promoted, as the reference does
    xws = (x @ params["W"] + params["b"]).transpose(0, 1)
    want_carry, want = layer._scan_seq(params, xws, carry, None)
    assert torch.equal(ys, want.transpose(0, 1))
    assert torch.equal(h, want_carry[0]) and torch.equal(c, want_carry[1])
    # f32 x with bf16 weights: no kernel either
    assert not ck.kernel_dtypes_match(x.float(), params["RW"], None)


def test_mixed_dtypes_raise_in_the_kernel_wrapper(monkeypatch):
    """On CUDA tensors (the CPU check faked off) a mix of dtypes raises
    before any launch: bf16 xw with f32 h0/c0, as the TPU kernel raises on
    it; so does a registered FusedLSTMHelper handed a mixed carry."""
    monkeypatch.setattr(ck, "_on_cpu", lambda name, *ts: False)
    xw, rw, h0, c0 = _bf16(_inputs((4, 2, 8)))
    before = ck.lstm_sequence.launches
    with pytest.raises(ValueError, match="all four of one dtype"):
        ck.lstm_sequence(xw, rw, h0.float(), c0.float())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ck.lstm_sequence(*(a.double() for a in (xw, rw, h0, c0)))
    layer, params, x = _bf16_layer()
    thelpers.set_helper("lstm", ck.FusedLSTMHelper())
    carry = tuple(torch.zeros((3, 8)) for _ in range(2))
    with pytest.raises(ValueError, match="all four of one dtype"):
        layer.forward_seq(params, x, carry=carry)
    assert ck.lstm_sequence.launches == before


def test_launch_counts_by_dtype_reset_together():
    ck.lstm_sequence.launches_by_dtype["bf16"] += 1
    ck.reset_lstm_counts()
    assert ck.lstm_sequence.launches == 0
    assert ck.lstm_sequence.launches_by_plan == {"cluster": 0, "grid": 0}
    assert ck.lstm_sequence.launches_by_dtype == {"f32": 0, "bf16": 0}


# ---------------------------------------------------------- bf16 networks
def _standard(b, L, it):
    return (b().seed(7).compute_dtype("bfloat16").list()
            .layer(L.LSTMLayer(n_out=16, activation="tanh"))
            .layer(L.LSTMLayer(n_out=16, activation="tanh"))
            .layer(L.RnnOutputLayer(n_out=6, loss="mcxent", activation="softmax"))
            .set_input_type(it.recurrent(6)).build())


def _classifier(b, L, it):
    return (b().seed(8).compute_dtype("bfloat16").list()
            .layer(L.BidirectionalWrapper(layer=L.LSTMLayer(n_out=16, activation="tanh")))
            .layer(L.LastTimeStepWrapper(layer=L.LSTMLayer(n_out=16, activation="tanh")))
            .layer(L.OutputLayer(n_out=2, loss="mcxent", activation="softmax"))
            .set_input_type(it.recurrent(6)).build())


def _data(kind, n=4, t=12, seed=9):
    rng = np.random.default_rng(seed)
    x = np.eye(6, dtype=np.float32)[rng.integers(0, 6, (n, t))]
    if kind == "standard":
        return x, np.eye(6, dtype=np.float32)[rng.integers(0, 6, (n, t))]
    return x, np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]


def _as_f64(conf):
    conf.global_conf.dtype = "float64"
    conf.global_conf.compute_dtype = None
    return conf


def _flat(grads):
    return {f"{k}/{n}": t.detach().double() for k, named in grads.items()
            for n, t in named.items()}


def _jax_gradients(conf, params, x, y, dtype):
    """The JAX package's loss and gradients of ``conf`` at ``params`` (the
    port's, by layer index) on one batch: its ``_loss_fn`` under
    ``jax.value_and_grad``, as ``compute_gradient_and_score`` takes it,
    jitted. Flattened as ``{"i/name": float64 tensor}``."""
    net = JMLN(conf)
    net.params = [{n: jnp.asarray(np.asarray(v, dtype)) for n, v in params[i].items()}
                  for i in range(len(net.layers))]
    net.states = [layer.init_state() for layer in net.layers]
    fn = jax.jit(jax.value_and_grad(lambda p: net._loss_fn(
        p, net.states, jnp.asarray(x, dtype), jnp.asarray(y, dtype), None, None,
        None, train=False), has_aux=True))
    (loss, _), grads = fn(net.params)
    return ({f"{i}/{n}": torch.from_numpy(np.array(v, np.float64))
             for i, named in enumerate(grads) for n, v in named.items()}, float(loss))


@pytest.mark.parametrize("kind,conf_fn,launches",
                         [("standard", _standard, 2), ("classifier", _classifier, 3)])
def test_bf16_network_against_f64_in_the_reference_ratio(monkeypatch, kind, conf_fn,
                                                         launches):
    spy = _Spy()
    monkeypatch.setattr(trec, "_AUTO_LSTM", spy)
    x, y = _data(kind)
    net = MultiLayerNetwork(conf_fn(NeuralNetConfiguration.builder, TL, InputType),
                            device="cpu").init()
    params = export_params(net)
    g_port, l_port = net.compute_gradient_and_score(x, y)
    assert spy.calls == [None] * launches  # every LSTM through the K1-bf16 seam
    assert all(g.dtype == torch.float32 for named in g_port.values()
               for g in named.values())
    ref, l_ref = _jax_gradients(conf_fn(JNNC.builder, JL, JIT), params, x, y, np.float32)
    with jax.enable_x64(True):
        g64, l64 = _jax_gradients(_as_f64(conf_fn(JNNC.builder, JL, JIT)), params, x, y,
                                  np.float64)
    port = _flat(g_port)
    rows, num, den = {}, 0.0, 0.0
    for key, want in g64.items():
        dp, dr = (port[key] - want).norm().item(), (ref[key] - want).norm().item()
        rows[key] = (dp / max(dr, 1e-30), dp / max(want.norm().item(), 1e-30))
        num, den = num + dp * dp, den + dr * dr
    whole = (num / max(den, 1e-60)) ** 0.5
    lp, lr = abs(l_port - l64), abs(l_ref - l64)
    print(f"{kind} bf16: whole-gradient ratio {whole:.3f}, worst tensor "
          f"{max(r[0] for r in rows.values()):.3f}; loss error port {lp:.3e} "
          f"reference {lr:.3e}")
    assert whole <= WHOLE_RATIO
    for key, (ratio, rel) in rows.items():
        assert ratio <= TENSOR_RATIO or rel <= TENSOR_FLOOR, (key, ratio, rel)
    assert lp <= max(LOSS_RATIO * lr, LOSS_FLOOR * abs(l64))
    out = net.output(x)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
