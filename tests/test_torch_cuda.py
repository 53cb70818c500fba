"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip without one. They import neither
jax nor the JAX package, so they also run where only the port is
installed; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the forward 1e-4 (max abs): float32 both ways, another
summation order. The fused LSTM sequence 1e-4 relative to the largest
entry of each output (h in [-1, 1]; the recurrence carries each step's
rounding into the next). The backward 1e-4 relative to the largest entry of each
reference gradient (its sums run over up to T products of order 1; the
kernels' 3xTF32 products keep f32 accuracy, as
tests/test_torch_flash_attention.py's emulation of the split shows). The
fused updater 1e-6 absolute on parameters and moments of order 1: the
same float32 coefficients both ways, only the kernel's fused multiply-adds
round differently. Training parity (kernel path against the plain path,
on one small TransformerLM) 2e-5, the twin-net tolerance of the JAX
package's fused-updater tests.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import LSTMLayer, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import AMSGrad, Adam, Nadam
from deeplearning4j_tpu_torch.util.convert import export_params, load_reference_params
from deeplearning4j_tpu_torch.zoo.models import TransformerLM


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    helpers.clear_all_helpers()
    yield torch.device("cuda")
    helpers.clear_all_helpers()
    helpers.set_auto_flash_attention(True)
    helpers.set_auto_fused_lstm(True)


def _qkv(shape, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            for _ in range(n)]


def _close_to_max(got, ref, rel=1e-4):
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=rel * max(1.0, ref.abs().max().item()))


SHAPES = [((2, 4, 256, 64), True), ((2, 4, 256, 128), False),
          ((1, 2, 128, 256), True), ((1, 1, 192, 64), False),
          ((1, 2, 256, 256), False)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", SHAPES[:4])
def test_flash_attention_kernel_matches_plain(card, shape, causal):
    q, k, v = (t.to(card) for t in _qkv(shape))
    before = ck.flash_attention_fwd.launches
    got = ck.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert ck.flash_attention_fwd.launches == before + 1
    torch.testing.assert_close(got, ck.flash_attention_plain(q, k, v, causal),
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", SHAPES)
def test_flash_attention_lse_matches_plain(card, shape, causal):
    q, k, v = (t.to(card) for t in _qkv(shape, seed=1))
    o, lse = ck.flash_attention_fwd(q, k, v, causal, return_lse=True)
    ref_o, ref_lse = ck.flash_attention_plain(q, k, v, causal, return_lse=True)
    assert lse.shape == shape[:3]
    torch.testing.assert_close(o, ref_o, rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)


# the backward kernels' tile plans (128 resident rows at Dh 64 and 128, 64
# at Dh 256): one tile (T = 64), a last block half past T (T = 192), every
# Dh, causal and not, and more blocks than the H100's 132 SMs (N*H = 144)
BWD_SHAPES = SHAPES + [((1, 1, 64, 64), True), ((1, 1, 64, 256), False),
                       ((1, 1, 192, 64), True), ((1, 2, 192, 128), True),
                       ((1, 2, 192, 128), False), ((4, 36, 128, 64), True),
                       ((2, 72, 256, 64), False)]


def _backward_inputs(shape, causal, device, seed=2):
    q, k, v, do = (t.to(device) for t in _qkv(shape, seed=seed, n=4))
    o, lse = ck.flash_attention_fwd(q, k, v, causal, return_lse=True)
    return q, k, v, o, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", BWD_SHAPES)
def test_flash_attention_backward_kernels_match_plain(card, shape, causal):
    q, k, v, o, lse, do = _backward_inputs(shape, causal, card)
    ref_dq, ref_d = ck.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal)
    ref_dk, ref_dv = ck.flash_attention_bwd_dkv_plain(q, k, v, lse, do, ref_d, causal)
    n_dq, n_dkv = ck.flash_attention_bwd_dq.launches, ck.flash_attention_bwd_dkv.launches
    dq, d = ck.flash_attention_bwd_dq(q, k, v, o, lse, do, causal)
    dk, dv = ck.flash_attention_bwd_dkv(q, k, v, lse, do, d, causal)
    torch.cuda.synchronize()
    assert ck.flash_attention_bwd_dq.launches == n_dq + 1
    assert ck.flash_attention_bwd_dkv.launches == n_dkv + 1
    _close_to_max(d, ref_d)
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        _close_to_max(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [((2, 4, 256, 64), True),
                                          ((1, 2, 192, 128), False),
                                          ((1, 2, 128, 256), True)])
def test_flash_attention_backward_kernels_are_deterministic(card, shape, causal):
    """No atomics: each output element has one owner block, so two launches
    on the same inputs give the same bits."""
    q, k, v, o, lse, do = _backward_inputs(shape, causal, card, seed=12)
    runs = []
    for _ in range(2):
        dq, d = ck.flash_attention_bwd_dq(q, k, v, o, lse, do, causal)
        runs.append((dq, d, *ck.flash_attention_bwd_dkv(q, k, v, lse, do, d, causal)))
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_gradients_match_plain_autograd(card, causal):
    q, k, v, do = (t.to(card) for t in _qkv((2, 3, 128, 64), seed=3, n=4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ck.FlashAttentionFunction.apply(*leaves, causal).backward(do)
    refs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ck.flash_attention_plain(*refs, causal).backward(do)
    for got, ref in zip(leaves, refs):
        _close_to_max(got.grad, ref.grad)


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_what_it_does_not_take(card):
    q, k, v = (t.to(card) for t in _qkv((1, 2, 128, 64)))
    with pytest.raises(ValueError, match="T % 64"):
        ck.flash_attention_fwd(q[:, :, :100].contiguous(),
                               k[:, :, :100].contiguous(),
                               v[:, :, :100].contiguous())
    with pytest.raises(ValueError, match="float32"):
        ck.flash_attention_fwd(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        strided = [t.transpose(2, 3).contiguous().transpose(2, 3)
                   for t in (q, k, v)]  # the same shape, not contiguous
        ck.flash_attention_fwd(*strided)
    with pytest.raises(ValueError, match="one CUDA device"):
        ck.flash_attention_fwd(q, k.cpu(), v)
    o, lse = ck.flash_attention_fwd(q, k, v, True, return_lse=True)
    with pytest.raises(ValueError, match=r"\[N,H,T\]"):
        ck.flash_attention_bwd_dq(q, k, v, o, lse[:, :, :64].contiguous(), q, True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,updater", [(ck.ADAM, Adam(3e-4)),
                                          (ck.AMSGRAD, AMSGrad(3e-4)),
                                          (ck.NADAM, Nadam(3e-4))])
@pytest.mark.parametrize("shape", [(1,), (127,), (129, 3), (1000,), "unaligned"])
def test_fused_adam_kernel_matches_plain(card, kind, updater, shape):
    rng = np.random.default_rng(4)
    n = 1001 if shape == "unaligned" else int(np.prod(shape))

    def state():
        a = torch.from_numpy(rng.standard_normal(n + 1, dtype=np.float32)).to(card)
        if shape == "unaligned":
            return a[1:]  # one float into its buffer: not 16-byte aligned
        return a[:n].reshape(shape).clone()

    p, g = state(), state()
    m, v = state().abs() * 0.1, state().abs() * 1e-3
    vh = v.clone() if kind == ck.AMSGRAD else None
    ref = [t.clone() if t is not None else None for t in (p, m, v, vh)]
    for t in (1.0, 2.0, 3.0):
        coef = ck.adam_coefficients(updater, 3e-4, t)
        before = ck.fused_adam.launches
        ck.fused_adam(kind, p, m, v, vh, g, coef)
        torch.cuda.synchronize()
        assert ck.fused_adam.launches == before + 1
        ck.fused_adam_plain(kind, *ref, g, coef)
        for got, want in zip((p, m, v, vh), ref):
            if want is not None:
                torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_fused_adam_refuses_what_it_does_not_take(card):
    p = torch.zeros(64, device=card)
    coef = ck.adam_coefficients(Adam(), 1e-3, 1.0)
    with pytest.raises(ValueError, match="float32"):
        ck.fused_adam(ck.ADAM, p.double(), p.double(), p.double(), None,
                      p.double(), coef)
    with pytest.raises(ValueError, match="contiguous"):
        s = torch.zeros(64, 2, device=card)[:, 0]
        ck.fused_adam(ck.ADAM, s, s, s, None, s, coef)
    with pytest.raises(ValueError, match="one CUDA device"):
        ck.fused_adam(ck.ADAM, p, p, p, None, p.cpu(), coef)
    with pytest.raises(ValueError, match="v_hat"):
        ck.fused_adam(ck.AMSGRAD, p, p, p, None, p, coef)


SMALL = dict(vocab_size=100, max_length=256, n_layers=2, d_model=128,
             n_heads=2, d_ff=256, seed=1)


@pytest.mark.cuda
def test_training_on_the_card_matches_the_plain_path(card):
    """Two small TransformerLMs from one set of weights: the kernels
    (flash forward + backward, fused Adam) against the plain attention and
    the stock Adam, over 3 fit steps."""
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, 100, (2, 128))).to(card)
    labels = torch.nn.functional.one_hot(
        torch.cat([ids[:, 1:], ids[:, -1:]], 1), 100).float()
    kern = TransformerLM(**SMALL).init()
    plain = load_reference_params(TransformerLM(**SMALL).init(),
                                  export_params(kern))
    counts = [ck.flash_attention_fwd.launches, ck.flash_attention_bwd_dq.launches,
              ck.flash_attention_bwd_dkv.launches, ck.fused_adam.launches]
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    for _ in range(3):
        kern.fit(ids.float(), labels)
    helpers.clear_helper("updater")
    assert [ck.flash_attention_fwd.launches - counts[0],
            ck.flash_attention_bwd_dq.launches - counts[1],
            ck.flash_attention_bwd_dkv.launches - counts[2],
            ck.fused_adam.launches - counts[3]] == [6, 6, 6, 3 * 30]
    helpers.set_auto_flash_attention(False)
    for _ in range(3):
        plain.fit(ids.float(), labels)
    helpers.set_auto_flash_attention(True)
    assert abs(kern.score_ - plain.score_) <= 2e-5
    for v, named in plain.params.items():
        for n, t in named.items():
            torch.testing.assert_close(kern.params[v][n], t, rtol=0, atol=2e-5)


# ------------------------------------------------------ K1: LSTM sequence
def _lstm_inputs(shape, device, seed=6):
    """xw [T,N,4H], rw [H,4H] at a Xavier scale, non-zero h0 and c0."""
    t, n, h = shape
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((t, n, 4 * h), dtype=np.float32)
    rw = rng.standard_normal((h, 4 * h), dtype=np.float32) * np.float32(np.sqrt(0.4 / h))
    h0 = rng.standard_normal((n, h), dtype=np.float32) * np.float32(0.5)
    c0 = rng.standard_normal((n, h), dtype=np.float32)
    return [torch.from_numpy(a).to(device) for a in (xw, rw, h0, c0)]


# the chip smoke's shapes: the TBPTT chunk, a whole example, one sampled
# character, the repo's char-RNN width, and a width whose rw does not fit
# in the SMs' shared memory together
LSTM_SHAPES = [(50, 32, 200), (1000, 32, 200), (1, 4, 200), (128, 64, 512),
               (35, 20, 1500)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LSTM_SHAPES)
def test_lstm_sequence_kernel_matches_plain(card, shape):
    args = _lstm_inputs(shape, card)
    before = ck.lstm_sequence.launches
    got = ck.lstm_sequence(*args)
    torch.cuda.synchronize()
    assert ck.lstm_sequence.launches == before + 1
    for g, ref in zip(got, ck.lstm_sequence_plain(*args)):
        _close_to_max(g, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,units", [((9, 5, 37), 1), ((9, 5, 37), 3),
                                         ((6, 3, 512), 128), ((3, 200, 300), 0)])
def test_lstm_sequence_kernel_block_plans(card, shape, units):
    """One unit a block; a ragged last block; a slice of rw too large for
    shared memory (read through L2); more rows than one chunk of h."""
    args = _lstm_inputs(shape, card, seed=7)
    got = ck.lstm_sequence(*args, units_per_block=units)
    for g, ref in zip(got, ck.lstm_sequence_plain(*args)):
        _close_to_max(g, ref)


@pytest.mark.cuda
def test_lstm_sequence_takes_views_and_refuses_the_rest(card):
    xw, rw, h0, c0 = _lstm_inputs((5, 4, 16), card, seed=8)
    ref = ck.lstm_sequence_plain(xw, rw, h0, c0)
    wide = torch.cat([h0, h0], 1)[:, :16]  # a strided carry
    got = ck.lstm_sequence(xw.transpose(0, 1).contiguous().transpose(0, 1),
                           rw, wide, c0)
    for g, r in zip(got, ref):
        _close_to_max(g, r)
    with pytest.raises(ValueError, match="float32"):
        ck.lstm_sequence(xw.double(), rw.double(), h0.double(), c0.double())
    with pytest.raises(ValueError, match="rw must be"):
        ck.lstm_sequence(xw, rw[:8], h0, c0)
    with pytest.raises(ValueError, match="one CUDA device"):
        ck.lstm_sequence(xw, rw, h0.cpu(), c0)


@pytest.mark.cuda
def test_lstm_sequence_refuses_a_grid_that_cannot_be_resident(card):
    args = _lstm_inputs((2, 1, 4096), card, seed=9)
    before = ck.lstm_sequence.launches
    with pytest.raises(RuntimeError, match="cannot be resident"):
        ck.lstm_sequence(*args, units_per_block=1)  # 4096 blocks
    assert ck.lstm_sequence.launches == before
    got = ck.lstm_sequence(*args)  # the default plan still runs
    torch.cuda.synchronize()
    for g, ref in zip(got, ck.lstm_sequence_plain(*args)):
        _close_to_max(g, ref)


@pytest.mark.cuda
def test_lstm_function_gradients_match_plain_autograd(card):
    args = _lstm_inputs((20, 6, 64), card, seed=10)
    leaves = [t.clone().requires_grad_(True) for t in args]
    refs = [t.clone().requires_grad_(True) for t in args]
    outs = ck.LSTMSequenceFunction.apply(*leaves)
    plain = ck.lstm_sequence_plain(*refs)
    cts = [torch.randn_like(o) for o in outs]
    for got, ref in zip(torch.autograd.grad(outs, leaves, cts),
                        torch.autograd.grad(plain, refs, cts)):
        _close_to_max(got, ref)


@pytest.mark.cuda
def test_char_lstm_on_the_card_matches_the_plain_path(card):
    """Two small char LSTMs from one set of weights: K1 (auto) against the
    layers' own loop, over 2 TBPTT fits (8 chunks), with the fused Adam."""
    def net():
        conf = (NeuralNetConfiguration.builder().seed(12345).l2(1e-4)
                .updater(Adam(0.005)).list()
                .layer(LSTMLayer(n_out=32)).layer(LSTMLayer(n_out=32))
                .layer(RnnOutputLayer(n_out=12))
                .set_input_type(InputType.recurrent(12)).t_bptt_length(5).build())
        return MultiLayerNetwork(conf).init()

    rng = np.random.default_rng(11)
    ids = rng.integers(0, 12, (4, 21))
    eye = np.eye(12, dtype=np.float32)
    x, y = eye[ids[:, :-1]], eye[ids[:, 1:]]
    kern = net()
    plain = load_reference_params(net(), export_params(kern))
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    before = ck.lstm_sequence.launches
    for _ in range(2):
        kern.fit(x, y)
    assert ck.lstm_sequence.launches - before == 2 * 8  # two layers, forward only
    helpers.set_auto_fused_lstm(False)
    for _ in range(2):
        plain.fit(x, y)
    assert ck.lstm_sequence.launches - before == 16
    helpers.set_auto_fused_lstm(True)
    assert abs(kern.score_ - plain.score_) <= 2e-5
    for i, named in plain.params.items():
        for n, t in named.items():
            torch.testing.assert_close(kern.params[i][n], t, rtol=0, atol=2e-5)
    out = kern.rnn_time_step(x[:, 0])
    assert out.shape == (4, 12) and ck.lstm_sequence.launches - before == 18
