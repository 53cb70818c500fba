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
on one small TransformerLM, and on LeNet through the fused updater) 2e-5,
the twin-net tolerance of the JAX package's fused-updater tests. A
float64 network on the card takes the plain path at the kernel seams
(the kernels take float32 only) and gives its CPU output within 1e-10
relative; ``tests/test_torch_dtypes.py`` holds that CPU output to the JAX
package's float64 one within 1e-10. Decoding on the card: greedy
``generate_on_device`` and beam 1 give ``generate``'s tokens, the sampled
loop makes no synchronising call (``torch.cuda.set_sync_debug_mode``),
``rnn_time_step`` launches no flash kernel (``output`` does, and the
prefill agrees with it within 1e-5), TBPTT fit launches the fused updater
only, and a graph zip restores on the card bit for bit (on the CPU within
1e-5). A narrow ResNet (the zoo's blocks, BatchNorm with its running
statistics) takes one float64 step on the card within 1e-10 relative of
the same step on the CPU and launches no kernel of the port; the DL4J
convnet fixture restored on the card gives its recorded output within
1e-5 and fits on the fused updater (8 launches a step). The bf16 kernels
also hold their plain versions at full attention at the bf16 encoder's T
128 ([2,2,128,64] and the zoo encoder's [32,12,128,64]), and a small bf16
TransformerEncoder launches them only with FlashAttentionHelper(causal=
False) registered and never on a masked batch. The networks' remaining
API on the card: ``fit_batches_on_device`` launches each kernel as the
per-batch ``fit`` of a clone does and lands within 1e-6 x each tensor's
largest entry of it; ``set_params_flat`` keeps every parameter's storage
(the fused updater still takes them); ``evaluate_roc_multi_class`` over a
bf16 ``output`` equals ``ROCMultiClass`` over that output widened.
Layerwise pretraining and detection: a VAE's pretrain step on the card
(the fused updater, the CPU twin's ε) within 1e-5 of the CPU's (or, where
Adam's per-entry scaling makes the step ill-conditioned, no farther from
an f64 step than 4x the CPU's f32 step), and the YOLOv2 loss and its
gradient within 1e-5 of the CPU's. SameDiff and checkpointing: a SameDiff
LeNet's gradients on the card (TF32 off) within 1e-5 of the CPU's (its
convolution weights within 1e-3: cuDNN's f32 weight-gradient algorithms),
and in f64 within 1e-10; a
checkpointed dropout network's gradients equal to its plain twin's on the
card from one generator state, and within 1e-5 of the CPU's handed the
card's masks. Training utilities: ``Solver`` on a narrowed float64
LeNet gives the CPU's score history within 1e-8 relative for each
algorithm, and ``check_model_gradients`` passes on the card in float64
on the CPU's coordinates (a narrowed LeNet, an LSTM network). The model
registry: a two-version registry (a small TransformerLM in f32 and its
int8 version) serves on the card, each answer within the served-answer
limit of its version's own ``output``, and the int8 version's growth of
the card's allocation is its int8 tensors and scales.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    CausalSelfAttentionLayer,
    EmbeddingSequenceLayer,
    LSTMLayer,
    RnnOutputLayer,
)
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


# ------------------------------------------- K3a on the tensor cores (3xTF32)
# 128-row query blocks (64 at Dh 256): one 64-row tile (T = 64, a half
# block), a last block half past T (T = 192), every Dh, causal and not
K3A_EDGES = [((1, 1, 64, 64), True), ((1, 1, 64, 64), False),
             ((1, 1, 192, 64), True), ((1, 2, 192, 128), True),
             ((1, 2, 192, 128), False), ((1, 1, 192, 256), True),
             ((1, 2, 64, 256), False), ((2, 3, 320, 256), True)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", K3A_EDGES)
def test_flash_attention_forward_tile_edges_match_plain(card, shape, causal):
    q, k, v = (t.to(card) for t in _qkv(shape, seed=13))
    o, lse = ck.flash_attention_fwd(q, k, v, causal, return_lse=True)
    ref_o, ref_lse = ck.flash_attention_plain(q, k, v, causal, return_lse=True)
    torch.testing.assert_close(o, ref_o, rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [((2, 4, 256, 64), True),
                                          ((1, 2, 192, 128), False),
                                          ((1, 2, 128, 256), True)])
def test_flash_attention_forward_is_deterministic(card, shape, causal):
    """One owner block per output row: the same bits run to run."""
    q, k, v = (t.to(card) for t in _qkv(shape, seed=14))
    first = ck.flash_attention_fwd(q, k, v, causal, return_lse=True)
    second = ck.flash_attention_fwd(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [((2, 4, 256, 64), True),
                                          ((1, 2, 192, 128), False),
                                          ((1, 2, 128, 256), True)])
def test_flash_attention_forward_lse_feeds_the_backward(card, shape, causal):
    """K3b on the forward kernel's o and LSE against the plain backward on
    the plain forward's."""
    q, k, v, o, lse, do = _backward_inputs(shape, causal, card, seed=15)
    p_o, p_lse = ck.flash_attention_plain(q, k, v, causal, return_lse=True)
    refs = ck.flash_attention_bwd_plain(q, k, v, p_o, p_lse, do, causal)
    dq, d = ck.flash_attention_bwd_dq(q, k, v, o, lse, do, causal)
    dk, dv = ck.flash_attention_bwd_dkv(q, k, v, lse, do, d, causal)
    for got, ref in zip((dq, dk, dv), refs):
        _close_to_max(got, ref)


# --------------------------------------------------- K1: the two plans
LSTM_MAIN_SHAPES = [(50, 32, 200), (1000, 32, 200), (12, 4, 200), (1, 4, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["cluster", "grid"])
@pytest.mark.parametrize("shape", LSTM_MAIN_SHAPES)
def test_lstm_sequence_both_plans_at_main_path_shapes(card, shape, plan):
    args = _lstm_inputs(shape, card, seed=16)
    before = dict(ck.lstm_sequence.launches_by_plan)
    got = ck.lstm_sequence(*args, plan=plan)
    torch.cuda.synchronize()
    assert ck.lstm_sequence.launches_by_plan[plan] == before[plan] + 1
    for g, ref in zip(got, ck.lstm_sequence_plain(*args)):
        _close_to_max(g, ref)


@pytest.mark.cuda
def test_lstm_main_path_widths_take_the_cluster_plan(card):
    for t, n, h in LSTM_MAIN_SHAPES:
        xw = torch.empty((t, n, 4 * h), device=card)
        plan = ck.lstm_plan_for(xw)
        assert plan["plan"] == "cluster" and plan["S"] == 8, plan
        assert ck.cluster_occupancy(plan, h) >= plan["C"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,size", [((50, 32, 200), 16), ((9, 5, 37), 16),
                                        ((9, 5, 37), 8), ((7, 3, 9), 8),
                                        ((6, 33, 64), 8), ((5, 3, 440), 16)])
def test_lstm_sequence_cluster_sizes_and_ragged_slices(card, shape, size):
    """A forced cluster of 16 CTAs (a non-portable size); units past H
    (H = 37 and 9: CTAs with a partial slice or none) and rows past N in
    the last cluster; the widest H that 16 CTAs hold."""
    args = _lstm_inputs(shape, card, seed=17)
    got = ck.lstm_sequence(*args, plan="cluster", cluster_size=size)
    torch.cuda.synchronize()
    for g, ref in zip(got, ck.lstm_sequence_plain(*args)):
        _close_to_max(g, ref)


@pytest.mark.cuda
def test_lstm_sequence_cluster_plan_refuses_what_one_cluster_cannot_hold(card):
    args = _lstm_inputs((2, 3, 512), card, seed=18)
    before = ck.lstm_sequence.launches
    with pytest.raises(ValueError, match="does not fit"):
        ck.lstm_sequence(*args, plan="cluster")
    with pytest.raises(ValueError, match="grid plan"):
        ck.lstm_sequence(*args, plan="cluster", units_per_block=4)
    assert ck.lstm_sequence.launches == before
    got = ck.lstm_sequence(*args)  # auto: the grid plan
    for g, ref in zip(got, ck.lstm_sequence_plain(*args)):
        _close_to_max(g, ref)


@pytest.mark.cuda
def test_lstm_sequence_counts_launches_by_plan(card):
    args = _lstm_inputs((5, 32, 200), card, seed=19)
    runs = [({}, "cluster"), ({"units_per_block": 13}, "grid"),
            ({"plan": "grid"}, "grid"), ({"plan": "cluster"}, "cluster")]
    for kw, plan in runs:
        total = ck.lstm_sequence.launches
        before = dict(ck.lstm_sequence.launches_by_plan)
        ck.lstm_sequence(*args, **kw)
        after = ck.lstm_sequence.launches_by_plan
        assert ck.lstm_sequence.launches == total + 1
        assert {p: after[p] - before[p] for p in after} == {
            p: int(p == plan) for p in after}


# ------------------------------------------------- K1-bf16: LSTM on bf16
def _lstm_bf16_close(got, ref):
    """K1-bf16 against its plain version (the same rounding points; only
    the f32 sums of h@rw run in another order): each entry within 128
    units of 2^-8 x max(|plain|, 2^-6) and the whole within 5e-3 relative
    Frobenius error, chip_smoke.py's lstm_bf16_kernel limits."""
    assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape
    g, r = got.double(), ref.double()
    units = (g - r).abs() / (2.0 ** -8 * r.abs().clamp_min(2.0 ** -6))
    assert units.max().item() <= 128.0
    assert ((g - r).norm() / r.norm().clamp_min(1e-30)).item() <= 5e-3


def _bf16_inputs(shape, device, seed=30):
    return [a.bfloat16() for a in _lstm_inputs(shape, device, seed)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw", [((128, 64, 512), {}), ((50, 32, 200), {}),
                                      ((12, 4, 200), {}), ((1, 4, 200), {}),
                                      ((9, 5, 37), {"plan": "cluster", "cluster_size": 16}),
                                      ((7, 3, 9), {"plan": "cluster", "cluster_size": 8}),
                                      ((6, 33, 64), {"plan": "grid"}),
                                      ((5, 3, 37), {"plan": "grid"}),
                                      ((5, 300, 200), {}), ((4, 8, 600), {}),
                                      ((3, 2, 72), {"plan": "cluster", "cluster_size": 1})])
def test_lstm_sequence_bf16_matches_plain(card, shape, kw):
    """K1-bf16 on both plans; odd H (units copied one at a time, CTAs with
    a partial slice or none); the cluster plan's tensor-core tiles at an
    odd count of 8-row n-tiles (R 20: 3), with one long K part (H 600: 38
    k-steps) and with more m-tiles than warps (one CTA of 72 units: 18)."""
    args = _bf16_inputs(shape, card)
    before = dict(ck.lstm_sequence.launches_by_dtype)
    got = ck.lstm_sequence(*args, **kw)
    torch.cuda.synchronize()
    assert ck.lstm_sequence.launches_by_dtype == {"f32": before["f32"],
                                                  "bf16": before["bf16"] + 1}
    for g, ref in zip(got, ck.lstm_sequence_plain(*args)):
        _lstm_bf16_close(g, ref)


@pytest.mark.cuda
def test_lstm_sequence_bf16_takes_unaligned_inputs(card):
    """xw and rw starting 2 bytes past a 4-byte boundary: the cluster plan
    copies one element at a time."""
    xw, rw, h0, c0 = _bf16_inputs((8, 6, 40), card, seed=31)
    buf_x = torch.empty(xw.numel() + 1, dtype=torch.bfloat16, device=card)
    buf_r = torch.empty(rw.numel() + 1, dtype=torch.bfloat16, device=card)
    xw_u = buf_x[1:].view(xw.shape).copy_(xw)
    rw_u = buf_r[1:].view(rw.shape).copy_(rw)
    assert xw_u.data_ptr() % 4 == 2 and xw_u.is_contiguous()
    got = ck.lstm_sequence(xw_u, rw_u, h0, c0, plan="cluster")
    for g, ref in zip(got, ck.lstm_sequence_plain(xw, rw, h0, c0)):
        _lstm_bf16_close(g, ref)


@pytest.mark.cuda
def test_lstm_sequence_bf16_plans_and_refusals(card):
    xw = torch.empty((128, 64, 4 * 512), dtype=torch.bfloat16, device=card)
    plan = ck.lstm_plan_for(xw)
    assert plan["plan"] == "cluster" and plan["S"] == 16 and plan["elem"] == 2
    assert ck.cluster_occupancy(plan, 512) >= plan["C"]
    assert ck.lstm_plan_for(xw.float()) == {"plan": "grid"}  # f32 rw fits no cluster
    out = ck.lstm_chain_floor(20, plan, 64, 512)
    torch.cuda.synchronize()
    assert out.shape == (64, 512) and torch.isfinite(out).all()
    xw, rw, h0, c0 = _bf16_inputs((4, 2, 8), card, seed=32)
    before = ck.lstm_sequence.launches
    with pytest.raises(ValueError, match="all four of one dtype"):
        ck.lstm_sequence(xw, rw, h0.float(), c0.float())
    with pytest.raises(ValueError, match="all four of one dtype"):
        ck.lstm_sequence(xw.float(), rw, h0, c0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ck.lstm_sequence(xw.half(), rw.half(), h0.half(), c0.half())
    assert ck.lstm_sequence.launches == before


@pytest.mark.cuda
def test_bf16_lstm_network_takes_k1_bf16_and_a_mixed_carry_takes_the_loop(card):
    """A bf16 standard-LSTM network: 2 K1-bf16 launches in fit and in
    output, none of f32; under TBPTT its carries are f32 (as the
    reference's), so the chunks take the plain loop: no launch."""
    def conf(tbptt):
        b = NeuralNetConfiguration.builder().seed(5).compute_dtype("bfloat16").list()
        b = (b.layer(LSTMLayer(n_out=32, activation="tanh"))
             .layer(LSTMLayer(n_out=32, activation="tanh"))
             .layer(RnnOutputLayer(n_out=7)).set_input_type(InputType.recurrent(7)))
        if tbptt:
            b = b.backprop_type("TruncatedBPTT").t_bptt_length(4)
        return b.build()

    rng = np.random.default_rng(33)
    x = np.eye(7, dtype=np.float32)[rng.integers(0, 7, (4, 12))]
    net = MultiLayerNetwork(conf(False)).init()
    ck.reset_lstm_counts()
    net.fit(x, x)
    out = net.output(x)
    torch.cuda.synchronize()
    assert ck.lstm_sequence.launches_by_dtype == {"f32": 0, "bf16": 4}
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    tb = MultiLayerNetwork(conf(True)).init()
    ck.reset_lstm_counts()
    tb.fit(x, x)
    tb.rnn_time_step(x[:, :3])
    torch.cuda.synchronize()
    assert ck.lstm_sequence.launches == 0 and np.isfinite(tb.score_)


@pytest.mark.cuda
def test_lstm_chain_floor_runs_the_hand_over(card):
    xw = torch.empty((50, 32, 800), device=card)
    plan = ck.lstm_plan_for(xw)
    out = ck.lstm_chain_floor(50, plan, 32, 200)
    torch.cuda.synchronize()
    assert out.shape == (32, 200) and torch.isfinite(out).all()


# K1-bf16's cluster plan multiplies on the tensor cores (mma.sync, rw
# resident in shared memory, K split into parts): chip_smoke.py's
# LSTM_BF16_SHAPES with the plan each takes, one step at the path's width
# and at the char model's, and the f64 form of its limits (the kernel's distance from an f64
# recurrence on the same bf16 inputs within 1.05x the plain version's)
LSTM_BF16_CARD = [((128, 64, 512), "auto"), ((50, 32, 200), "auto"), ((12, 4, 200), "auto"),
                  ((35, 20, 1500), "auto"), ((128, 64, 512), "grid"), ((1, 64, 512), "auto"),
                  ((1, 4, 200), "auto"), ((1, 32, 200), "auto")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,plan", LSTM_BF16_CARD)
def test_lstm_sequence_bf16_holds_the_card_limits(card, shape, plan):
    args = _bf16_inputs(shape, card, seed=31)
    chosen = ck.lstm_plan_for(args[0]) if plan == "auto" else {"plan": "grid"}
    before = dict(ck.lstm_sequence.launches_by_plan)
    got = ck.lstm_sequence(*args, plan=plan)
    torch.cuda.synchronize()
    after = ck.lstm_sequence.launches_by_plan
    assert {p: after[p] - before[p] for p in after} == {
        p: int(p == chosen["plan"]) for p in after}
    assert chosen["plan"] == ("grid" if plan == "grid" or shape[2] == 1500 else "cluster")
    plain = ck.lstm_sequence_plain(*args)
    exact = ck.lstm_sequence_plain(*(a.double() for a in args))
    for g, ref in zip(got, plain):
        _lstm_bf16_close(g, ref)
    cat = lambda xs: torch.cat([x.double().reshape(-1) for x in xs])  # noqa: E731
    g, p, e = cat(got), cat(plain), cat(exact)
    assert (g - e).norm().item() <= 1.05 * (p - e).norm().item()


@pytest.mark.cuda
def test_lstm_sequence_bf16_is_deterministic(card):
    args = _bf16_inputs((128, 64, 512), card, seed=32)
    runs = [ck.lstm_sequence(*args) for _ in range(3)]
    torch.cuda.synchronize()
    for later in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], later))


@pytest.mark.cuda
def test_lstm_chain_floor_runs_the_bf16_hand_over(card):
    xw = torch.empty((128, 64, 2048), dtype=torch.bfloat16, device=card)
    plan = ck.lstm_plan_for(xw)
    assert plan["plan"] == "cluster" and plan["elem"] == 2 and plan["S"] == 16
    out = ck.lstm_chain_floor(128, plan, 64, 512)
    torch.cuda.synchronize()
    assert out.shape == (64, 512) and torch.isfinite(out).all()


# ------------------------------------------- float64 networks (fault C1)
def _f64_char_lstm(device):
    conf = (NeuralNetConfiguration.builder().seed(7).dtype("float64").list()
            .layer(LSTMLayer(n_out=16, activation="tanh"))
            .layer(LSTMLayer(n_out=16, activation="tanh"))
            .layer(RnnOutputLayer(n_out=12, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.recurrent(12)).build())
    return MultiLayerNetwork(conf, device=device).init()


def _f64_causal_graph(device):
    g = (NeuralNetConfiguration.builder().seed(8).dtype("float64")
         .graph_builder().add_inputs("tokens")
         .set_input_types(InputType.recurrent(1, 128)))
    g.add_layer("embed", EmbeddingSequenceLayer(n_in=20, n_out=128), "tokens")
    g.add_layer("att", CausalSelfAttentionLayer(n_in=128, n_out=128, n_heads=2,
                                                head_size=64, max_cache=128), "embed")
    g.add_layer("out", RnnOutputLayer(n_in=128, n_out=20), "att")
    g.set_outputs("out")
    return ComputationGraph(g.build(), device=device).init()


@pytest.mark.cuda
@pytest.mark.parametrize("build,kind", [(_f64_char_lstm, "chars"),
                                        (_f64_causal_graph, "tokens")])
def test_float64_network_takes_the_plain_path_on_the_card(card, build, kind):
    rng = np.random.default_rng(9)
    x = (np.eye(12)[rng.integers(0, 12, (3, 40))] if kind == "chars"
         else rng.integers(0, 20, (2, 128)).astype(np.float64))
    cpu = build("cpu")
    gpu = load_reference_params(build(card), export_params(cpu))
    launches = (ck.flash_attention_fwd.launches, ck.lstm_sequence.launches)
    got = gpu.output(x)
    torch.cuda.synchronize()
    assert (ck.flash_attention_fwd.launches, ck.lstm_sequence.launches) == launches
    ref = cpu.output(x)
    assert got.dtype == ref.dtype == torch.float64
    rel = ((got.cpu() - ref).abs().max() / ref.abs().max()).item()
    assert rel <= 1e-10


@pytest.mark.cuda
def test_lenet_fit_on_the_card_matches_the_stock_updater(card):
    """LeNet (28x28x1, conv 20 and 50, dense 500): 3 fit steps through the
    fused updater (8 launches a step) against a twin on stock Adam."""
    from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer, DenseLayer,
                                                    OutputLayer, SubsamplingLayer)

    def lenet():
        conf = (NeuralNetConfiguration.builder().seed(42).updater(Adam(1e-3)).list()
                .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5), activation="relu"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5), activation="relu"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_out=10, loss="negativeloglikelihood"))
                .set_input_type(InputType.convolutional(28, 28, 1)).build())
        return MultiLayerNetwork(conf).init()

    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(0, 0.3, (32, 28, 28, 1)).astype(np.float32)).to(card)
    y = torch.nn.functional.one_hot(torch.from_numpy(rng.integers(0, 10, 32)), 10)
    y = y.float().to(card)
    kern = lenet()
    twin = load_reference_params(lenet(), export_params(kern))
    torch.backends.cudnn.deterministic = True
    try:
        before = ck.fused_adam.launches
        helpers.set_helper("updater", ck.FusedUpdaterHelper())
        for _ in range(3):
            kern.fit(x, y)
        helpers.clear_helper("updater")
        assert ck.fused_adam.launches - before == 3 * 8
        for _ in range(3):
            twin.fit(x, y)
    finally:
        torch.backends.cudnn.deterministic = False
    assert abs(kern.score_ - twin.score_) <= 2e-5
    for i, named in twin.params.items():
        for n, t in named.items():
            torch.testing.assert_close(kern.params[i][n], t, rtol=0, atol=2e-5)


@pytest.mark.cuda
def test_dropout_draws_on_the_network_device_from_its_own_generator(card):
    """A CUDA net's dropout generator lives on the card; every draw of a
    fit happens there; a CPU generator never draws for a CUDA tensor."""
    from deeplearning4j_tpu_torch.nn import dropout as PD
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer

    conf = (NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-2)).dropout(0.7)
            .list().layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=4)).set_input_type(InputType.feed_forward(8))
            .build())
    net = MultiLayerNetwork(conf).init()
    assert net.dropout_generator.device.type == "cuda"
    devices = []
    bernoulli = PD.bernoulli

    def spy(p, shape, gen, device, dtype=torch.float32):
        devices.append((torch.device(device).type, gen.device.type))
        return bernoulli(p, shape, gen, device, dtype)

    PD.bernoulli = spy
    try:
        x = torch.randn(6, 8, device=card)
        y = torch.nn.functional.one_hot(torch.arange(6) % 4, 4).float().to(card)
        state = net.dropout_generator.get_state()
        net.fit(x, y)
        first = net.score_
        net.dropout_generator.set_state(state)
        net.fit(x, y)
    finally:
        PD.bernoulli = bernoulli
    # one draw a step, the dense layer's input: the output layer's loss
    # starts from its input and draws nothing, as in the reference
    assert devices == [("cuda", "cuda")] * 2
    assert np.isfinite(first) and np.isfinite(net.score_)
    with pytest.raises(ValueError, match="cannot draw"):
        PD.Dropout(0.5).apply(x, torch.Generator(), True)


@pytest.mark.cuda
def test_prefetch_pins_and_copies_on_a_side_stream(card):
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator, MultiDataSet
    from deeplearning4j_tpu_torch.datasets import iterators as PI

    rng = np.random.default_rng(4)
    f = rng.standard_normal((64, 8)).astype(np.float32)
    l = rng.standard_normal((64, 3)).astype(np.float32)
    ds = PI.device_put_batch(DataSet(f, l, np.ones(64, np.float32)), card)
    dc = ds.device_copy
    assert all(h.is_pinned() for h in dc.host) and len(dc.host) == 3
    assert dc.stream.cuda_stream != torch.cuda.default_stream().cuda_stream
    before = dict(PI.COPY_STATS)
    PI.finish_device_put(ds)
    PI.finish_device_put(ds)  # a second finish changes nothing
    assert {k: PI.COPY_STATS[k] - before[k] for k in before} == \
        {"batches": 1, "pinned": 1, "side_stream": 1}
    assert ds.features.is_cuda and torch.equal(ds.features.cpu(), torch.from_numpy(f))
    on_card = torch.zeros(2, device=card)
    mds = PI.device_put_batch(MultiDataSet([f], [on_card]), card)
    assert mds.labels[0] is on_card and len(mds.device_copy.host) == 1
    batches = list(PI.wrap_for_prefetch(ListDataSetIterator(DataSet(f, l), 16), None))
    assert len(batches) == 4 and all(b.features.is_cuda for b in batches)
    assert torch.equal(torch.cat([b.labels for b in batches]).cpu(), torch.from_numpy(l))


@pytest.mark.cuda
def test_fit_with_prefetch_equals_fit_without_on_the_card(card):
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer

    rng = np.random.default_rng(5)
    f = rng.standard_normal((48, 8)).astype(np.float32)
    l = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 48)]
    nets = []
    for depth in (None, 0):
        conf = (NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-2))
                .dropout(0.8).gradient_normalization("clip_l2_per_layer", 0.5)
                .list().layer(DenseLayer(n_out=16, activation="relu"))
                .layer(OutputLayer(n_out=4)).set_input_type(InputType.feed_forward(8))
                .build())
        net = MultiLayerNetwork(conf).init()
        net.fit(ListDataSetIterator(DataSet(f, l), 8, shuffle=True), epochs=3,
                prefetch_depth=depth)
        nets.append(net)
    torch.cuda.synchronize()
    assert nets[0].iteration == nets[1].iteration == 18
    assert nets[0].transfer_bytes == nets[1].transfer_bytes
    for i, named in nets[1].params.items():
        for n, t in named.items():
            torch.testing.assert_close(nets[0].params[i][n], t, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_flash_seam_declines_dropout_on_the_card(card):
    """With attention dropout, fit runs the plain attention (no flash
    launch) and ``output`` the flash forward, one launch a layer."""
    net = TransformerLM(vocab_size=64, max_length=128, n_layers=2, d_model=128,
                        n_heads=2, d_ff=256, attn_dropout=0.1).init()
    ids = np.random.default_rng(6).integers(0, 64, (2, 128))
    labels = torch.nn.functional.one_hot(torch.from_numpy(ids), 64).float().to(card)
    x = torch.from_numpy(ids.astype(np.float32)).to(card)
    counters = (ck.flash_attention_fwd, ck.flash_attention_bwd_dq,
                ck.flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    net.fit(x, labels)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == before and np.isfinite(net.score_)
    net.output(x)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 0, 0]


# ------------------------------------------------------- decode and TBPTT
DECODE_LM = dict(vocab_size=100, max_length=256, n_layers=2, d_model=128,
                 n_heads=2, d_ff=256, seed=1)


def _decode_net(card, **extra):
    return TransformerLM(**dict(DECODE_LM, **extra)).init(device=card)


def _flash_counts():
    return (ck.flash_attention_fwd.launches, ck.flash_attention_bwd_dq.launches,
            ck.flash_attention_bwd_dkv.launches)


@pytest.mark.cuda
def test_generate_on_device_greedy_equals_generate_on_the_card(card):
    from deeplearning4j_tpu_torch.zoo import beam_search, generate, generate_on_device

    net = _decode_net(card)
    prompt = np.random.default_rng(0).integers(0, 100, (3, 128)).astype(np.float32)
    host = generate(net, prompt, 16)
    np.testing.assert_array_equal(generate_on_device(net, prompt, 16), host)
    np.testing.assert_array_equal(beam_search(net, prompt, 16, beam_size=1)[0], host)


@pytest.mark.cuda
def test_decode_loop_makes_no_host_synchronisation(card):
    from deeplearning4j_tpu_torch.zoo import generate_on_device, models

    with pytest.raises(RuntimeError):  # the check catches a synchronising call
        with models._sync_check(True, card):
            torch.ones(1, device=card).item()
    net = _decode_net(card)
    prompt = np.random.default_rng(1).integers(0, 100, (2, 40)).astype(np.float32)
    kw = dict(temperature=0.8, top_k=40, top_p=0.95)
    a = generate_on_device(net, prompt, 24, seed=3, check_no_sync=True, **kw)
    b = generate_on_device(net, prompt, 24, seed=3, check_no_sync=True, **kw)
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < 100)).all()
    np.testing.assert_array_equal(
        generate_on_device(net, prompt, 8, check_no_sync=True),
        generate_on_device(net, prompt, 8))


@pytest.mark.cuda
def test_decode_launches_no_flash_kernel_and_output_does(card):
    net = _decode_net(card)
    ids = np.random.default_rng(2).integers(0, 100, (2, 136)).astype(np.float32)
    before = _flash_counts()
    net.rnn_clear_previous_state()
    steps = [net.rnn_time_step(ids[:, :128, None])]
    for j in range(128, 136):
        steps.append(net.rnn_time_step(ids[:, j:j + 1]))
    torch.cuda.synchronize()
    assert _flash_counts() == before
    full = net.output(ids[:, :128])
    torch.cuda.synchronize()
    assert ck.flash_attention_fwd.launches == before[0] + 2
    torch.testing.assert_close(steps[0], full, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_tbptt_fit_launches_the_fused_updater_only(card):
    net = _decode_net(card)
    conf_net = net.conf
    conf_net.backprop_type, conf_net.tbptt_fwd_length = "truncated_bptt", 64
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    ids = np.random.default_rng(3).integers(0, 100, (2, 256))
    x = ids.astype(np.float32)
    y = np.eye(100, dtype=np.float32)[np.concatenate([ids[:, 1:], ids[:, -1:]], 1)]
    n_tensors = sum(len(named) for named in net.params.values())
    before, k2 = _flash_counts(), ck.fused_adam.launches
    net.fit(x, y)
    torch.cuda.synchronize()
    assert net.iteration == 4 and np.isfinite(net.score_)
    assert _flash_counts() == before
    assert ck.fused_adam.launches - k2 == 4 * n_tensors


@pytest.mark.cuda
def test_graph_zip_restores_on_the_card(card, tmp_path):
    net = _decode_net(card)
    x = np.random.default_rng(4).integers(0, 100, (2, 128)).astype(np.float32)
    net.fit(x, np.eye(100, dtype=np.float32)[x.astype(np.int64)])
    path = tmp_path / "lm.zip"
    net.save(path)
    back = ComputationGraph.load(path)
    assert back.device.type == "cuda" and back.iteration == 1
    torch.testing.assert_close(back.output(x), net.output(x), rtol=0, atol=0)
    for v, named in net.updater_states.items():
        for n, slots in named.items():
            for s, t in slots.items():
                torch.testing.assert_close(back.updater_states[v][n][s], t,
                                           rtol=0, atol=0)
    cpu = ComputationGraph.load(path, device="cpu")
    torch.testing.assert_close(cpu.output(x), net.output(x).cpu(), rtol=0,
                               atol=1e-5)


def _narrow_resnet(device):
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNormalizationLayer, ConvolutionLayer, GlobalPoolingLayer,
        OutputLayer)
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs
    from deeplearning4j_tpu_torch.zoo.helpers import (
        resnet_conv_block, resnet_identity_block)

    g = (NeuralNetConfiguration.builder().seed(2).dtype("float64")
         .updater(Nesterovs(1e-2, 0.9)).l2(5e-5).graph_builder()
         .add_inputs("in").set_input_types(InputType.convolutional(12, 12, 3)))
    g.add_layer("stem", ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                         has_bias=False), "in")
    g.add_layer("stem_bn", BatchNormalizationLayer(activation="relu"), "stem")
    x = resnet_conv_block(g, (3, 3), (4, 4, 16), "2", "a", "stem_bn")
    x = resnet_identity_block(g, (3, 3), (4, 4, 16), "2", "b", x)
    g.add_layer("pool", GlobalPoolingLayer(pooling_type="avg"), x)
    g.add_layer("out", OutputLayer(n_out=3, activation="softmax"), "pool")
    return ComputationGraph(g.set_outputs("out").build(), device=device).init()


@pytest.mark.cuda
def test_narrow_resnet_step_on_the_card_matches_the_cpu(card):
    from deeplearning4j_tpu_torch.util.convert import export_states, load_reference_states

    gpu, cpu = _narrow_resnet(card), _narrow_resnet("cpu")
    load_reference_states(load_reference_params(cpu, export_params(gpu)),
                          export_states(gpu))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 12, 12, 3))
    y = np.eye(3)[rng.integers(0, 3, 6)]
    counters = (ck.fused_adam, ck.lstm_sequence, ck.flash_attention_fwd,
                ck.flash_attention_bwd_dq, ck.flash_attention_bwd_dkv)
    for c in counters:
        c.launches = 0
    gpu.fit(x, y)
    cpu.fit(x, y)
    assert all(c.launches == 0 for c in counters)
    assert abs(gpu.score_ - cpu.score_) <= 1e-10 * abs(cpu.score_)
    for v, named in cpu.params.items():
        for n, t in named.items():
            err = (gpu.params[v][n].cpu() - t).abs().max().item()
            assert err <= 1e-10 * t.abs().max().item(), f"{v}/{n}"
    for v, named in cpu.states.items():
        for n, t in named.items():
            np.testing.assert_allclose(gpu.states[v][n].cpu().numpy(), t.numpy(),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_dl4j_convnet_restores_and_fits_on_the_card(card):
    import os

    from deeplearning4j_tpu_torch.modelimport.dl4j import restore_multi_layer_network

    fixtures = os.path.join(os.path.dirname(__file__), "fixtures")
    exp = np.load(os.path.join(fixtures, "dl4j_checkpoint_convnet_expected.npz"))
    net = restore_multi_layer_network(
        os.path.join(fixtures, "dl4j_checkpoint_convnet.zip"), device="cuda")
    np.testing.assert_allclose(net.output(exp["x"]).cpu().numpy(), exp["out"],
                               rtol=1e-5, atol=1e-6)
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    ck.fused_adam.launches = 0
    rng = np.random.default_rng(0)
    net.fit(rng.normal(size=(4, 8, 8, 1)).astype(np.float32),
            np.eye(3, dtype=np.float32)[[0, 1, 2, 0]])
    assert ck.fused_adam.launches == 8
    assert np.isfinite(net.score_)


# ------------------------------------------ K3a / K3b in bf16 (mixed precision)
# each bf16 kernel against its plain version (the TPU kernel's rounding
# points): o, dq, dk, dv within 1e-2 x max(1, largest entry) (one bf16 ulp
# is 3.9e-3 relative; the kernel rounds P against its running row max and
# sums in another order), the f32 LSE and D within 1e-4. The largest entry
# of a causal o is row 0, so each entry x = sum_j term_j is also held to
# 2^-7 (|plain| + sum_j |term_j|) (each version rounds each bf16 term and
# the result once, at unit roundoff 2^-8) and the whole to 4e-3 relative
# Frobenius error, which a fault in the small late rows fails. dS = P ∘
# (dO·Vᵀ − D) cancels (to 0 in row 0 of a causal head), so its magnitude
# carries 2^-7 of its own terms, P ∘ (|dO|·|V|ᵀ + |D|)
BF16_SHAPES = [((2, 4, 256, 64), True), ((2, 4, 256, 64), False),
               ((1, 2, 128, 128), True), ((1, 2, 192, 128), False),
               ((1, 2, 128, 256), True), ((1, 2, 256, 256), False),
               ((4, 36, 128, 64), True)]


def _bf16_term_sums(q, k, v, lse, do, d, causal):
    """Each output's sum of absolute terms: P·|V|, |dS|·|K|, |dS|ᵀ·|Q|,
    Pᵀ·|dO| (the plain version's f32 P and scaled dS, |dS| with 2^-7 of
    its own terms)."""
    p, ds = ck._p_ds_bf16(q, k, v, lse, do, d, causal)
    a = [t.float().abs() for t in (q, k, v, do)]
    own = p * (torch.einsum("nhqd,nhkd->nhqk", a[3], a[2]) + d.abs()[..., None])
    ds = ds.to(torch.bfloat16).float().abs() + 2 ** -7 * own / q.shape[-1] ** 0.5
    return (torch.einsum("nhqk,nhkd->nhqd", p, a[2]),
            torch.einsum("nhqk,nhkd->nhqd", ds, a[1]),
            torch.einsum("nhqk,nhqd->nhkd", ds, a[0]),
            torch.einsum("nhqk,nhqd->nhkd", p, a[3]))


def _bf16_close(got, ref, terms):
    g, r = got.double(), ref.double()
    _close_to_max(g, r, rel=1e-2)
    diff = (g - r).abs()
    scale = 2 ** -7 * (r.abs() + terms.double())
    assert (diff <= scale).all(), (diff / scale).max().item()
    assert diff.norm() <= 4e-3 * r.norm(), (diff.norm() / r.norm()).item()


def _bf16_heads(shape, device, seed=20, n=4):
    return [t.to(device, torch.bfloat16) for t in _qkv(shape, seed=seed, n=n)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", BF16_SHAPES)
def test_bf16_flash_kernels_match_their_plain_versions(card, shape, causal):
    _bf16_kernels_hold_their_plain_versions(shape, causal, card)


# full attention at the bf16 encoder's T 128: a small twin's heads and the
# zoo TransformerEncoder's own [32, 12, 128, 64] at batch 32
ENCODER_BF16_SHAPES = [((2, 2, 128, 64), False), ((32, 12, 128, 64), False)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", ENCODER_BF16_SHAPES)
def test_bf16_full_attention_kernels_at_the_encoder_shapes(card, shape, causal):
    _bf16_kernels_hold_their_plain_versions(shape, causal, card)


def _bf16_kernels_hold_their_plain_versions(shape, causal, card):
    """The three bf16 kernels at ``shape``: one launch each, counted as
    bf16, then o, dq, dk, dv against their plain versions and the f32
    LSE and D within 1e-4."""
    q, k, v, do = _bf16_heads(shape, card)
    counts = [(w.launches, w.launches_bf16) for w in
              (ck.flash_attention_fwd, ck.flash_attention_bwd_dq,
               ck.flash_attention_bwd_dkv)]
    o, lse = ck.flash_attention_fwd(q, k, v, causal, return_lse=True)
    dq, d = ck.flash_attention_bwd_dq(q, k, v, o, lse, do, causal)
    dk, dv = ck.flash_attention_bwd_dkv(q, k, v, lse, do, d, causal)
    torch.cuda.synchronize()
    assert [(w.launches, w.launches_bf16) for w in
            (ck.flash_attention_fwd, ck.flash_attention_bwd_dq,
             ck.flash_attention_bwd_dkv)] == [(a + 1, b + 1) for a, b in counts]
    assert all(t.dtype == torch.bfloat16 for t in (o, dq, dk, dv))
    assert lse.dtype == d.dtype == torch.float32
    p_o, p_lse = ck.flash_attention_plain(q, k, v, causal, return_lse=True)
    p_dq, p_d = ck.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal)
    p_dk, p_dv = ck.flash_attention_bwd_dkv_plain(q, k, v, lse, do, d, causal)
    torch.testing.assert_close(lse, p_lse, rtol=0, atol=1e-4)
    torch.testing.assert_close(d, p_d, rtol=0, atol=1e-4)
    terms = _bf16_term_sums(q, k, v, lse, do, d, causal)
    for got, ref, a in zip((o, dq, dk, dv), (p_o, p_dq, p_dk, p_dv), terms):
        _bf16_close(got, ref, a)


@pytest.mark.cuda
def test_bf16_flash_kernels_are_deterministic(card):
    q, k, v, do = _bf16_heads((2, 4, 256, 64), card, seed=21)
    runs = []
    for _ in range(2):
        o, lse = ck.flash_attention_fwd(q, k, v, True, return_lse=True)
        dq, d = ck.flash_attention_bwd_dq(q, k, v, o, lse, do, True)
        runs.append((o, lse, dq, d, *ck.flash_attention_bwd_dkv(q, k, v, lse, do, d, True)))
    torch.cuda.synchronize()
    for first, second in zip(*runs):
        assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_flash_function_gradients_match_the_plain_backward(card, causal):
    q, k, v, do = _bf16_heads((2, 3, 128, 64), card, seed=22)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ck.FlashAttentionFunction.apply(*leaves, causal).backward(do)
    o, lse = ck.flash_attention_fwd(q, k, v, causal, return_lse=True)
    dq, d = ck.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal)
    dk, dv = ck.flash_attention_bwd_dkv_plain(q, k, v, lse, do, d, causal)
    terms = _bf16_term_sums(q, k, v, lse, do, d, causal)[1:]
    for leaf, ref, a in zip(leaves, (dq, dk, dv), terms):
        assert leaf.grad.dtype == torch.bfloat16
        _bf16_close(leaf.grad, ref, a)


@pytest.mark.cuda
def test_bf16_flash_kernels_refuse_what_they_do_not_take(card):
    q, k, v = _bf16_heads((1, 2, 128, 64), card, n=3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ck.flash_attention_fwd(q, k.float(), v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ck.flash_attention_fwd(q.half(), k.half(), v.half())
    o, lse = ck.flash_attention_fwd(q, k, v, True, return_lse=True)
    with pytest.raises(ValueError, match="float32 row statistics"):
        ck.flash_attention_bwd_dq(q, k, v, o, lse.to(torch.bfloat16), q, True)
    with pytest.raises(ValueError, match="T % 64"):
        ck.flash_attention_fwd(*(t[:, :, :96].contiguous() for t in (q, k, v)))


@pytest.mark.cuda
def test_bf16_training_on_the_card_takes_the_bf16_kernels(card):
    """A small TransformerLM in bf16 (compute_dtype) with the fused
    updater: every attention layer launches the bf16 kernels (none of the
    f32 ones), the masters and their updates stay f32 (K2), the loss is
    finite and falls over 5 steps on one batch."""
    rng = np.random.default_rng(6)
    ids = torch.from_numpy(rng.integers(0, 100, (2, 128))).to(card)
    labels = torch.nn.functional.one_hot(
        torch.cat([ids[:, 1:], ids[:, -1:]], 1), 100).float()
    zoo = TransformerLM(**SMALL)
    conf = zoo.conf()
    conf.global_conf.compute_dtype = "bfloat16"
    net = ComputationGraph(conf).init()
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    wrappers = (ck.flash_attention_fwd, ck.flash_attention_bwd_dq,
                ck.flash_attention_bwd_dkv)
    before = [(w.launches, w.launches_bf16) for w in wrappers]
    adam = ck.fused_adam.launches
    losses = []
    for _ in range(5):
        net.fit(ids, labels)
        losses.append(net.score_)
    n_layers = SMALL["n_layers"]
    assert [(w.launches - a, w.launches_bf16 - b) for w, (a, b)
            in zip(wrappers, before)] == [(5 * n_layers, 5 * n_layers)] * 3
    assert ck.fused_adam.launches - adam == 5 * sum(len(p) for p in net.params.values())
    assert all(t.dtype == torch.float32 for p in net.params.values() for t in p.values())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert net.output(ids).dtype == torch.bfloat16


@pytest.mark.cuda
def test_bf16_encoder_takes_the_full_attention_kernels_only_when_registered(card):
    """A 2-layer bf16 TransformerEncoder (Dh 64, T 128) with the fused
    updater: with no attention helper a fit step launches K2 once a tensor
    and no flash kernel (full attention has no automatic kernel); with
    FlashAttentionHelper(causal=False) registered each attention layer
    launches the three bf16 kernels in fit and K3a-bf16 in ``output``; a
    masked batch takes the plain path."""
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.zoo.models import TransformerEncoder

    conf = TransformerEncoder(num_labels=2, seed=4, vocab_size=100, max_length=128,
                              n_layers=2, d_model=128, n_heads=2, d_ff=256).conf()
    conf.global_conf.compute_dtype = "bfloat16"
    net = ComputationGraph(conf).init()
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    rng = np.random.default_rng(8)
    ids = torch.from_numpy(rng.integers(0, 100, (4, 128))).to(card)
    labels = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, 2, 4)).to(card), 2).float()
    wrappers = (ck.flash_attention_fwd, ck.flash_attention_bwd_dq,
                ck.flash_attention_bwd_dkv)
    n_tensors = sum(len(p) for p in net.params.values())

    def counted(fn):
        before = [(w.launches, w.launches_bf16) for w in wrappers]
        adam = ck.fused_adam.launches
        fn()
        torch.cuda.synchronize()
        return ([(w.launches - a, w.launches_bf16 - b)
                 for w, (a, b) in zip(wrappers, before)], ck.fused_adam.launches - adam)

    assert counted(lambda: net.fit(ids, labels)) == ([(0, 0)] * 3, n_tensors)
    helpers.set_helper("attention", ck.FlashAttentionHelper(causal=False))
    assert counted(lambda: net.fit(ids, labels)) == ([(2, 2)] * 3, n_tensors)
    assert counted(lambda: net.output(ids)) == ([(2, 2), (0, 0), (0, 0)], 0)
    mask = torch.ones((4, 128), device=card)
    mask[:, 100:] = 0
    assert counted(lambda: net.fit(MultiDataSet([ids], [labels], [mask]))) == (
        [(0, 0)] * 3, n_tensors)
    assert np.isfinite(net.score_)


# The bf16 forward, dq and dk/dv kernels at the edges of their tiles, for
# the Hopper design (Dh 64: persistent blocks of 128 rows, key tiles of 128
# (forward) and 64 (dq), query tiles of 64 (dk/dv)) and the mma.sync one
# (Dh 128, 256): one tile (T 64), the diagonal tile alone (128), a last
# block of 64 rows (192), the path's T (1024) and a long one (4096); N*H 1
# and 97 (not a multiple of the 132 SMs that the persistent grid covers)
TILE_EDGE_SHAPES = (
    [((1, 12, t, 64), c) for t in (64, 128, 192, 1024, 4096) for c in (True, False)]
    + [((1, 1, 192, dh), c) for dh in (64, 128, 256) for c in (True, False)]
    + [((1, 97, 192, dh), c) for dh in (64, 128, 256) for c in (True, False)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", TILE_EDGE_SHAPES)
def test_bf16_kernels_hold_their_plain_versions_at_the_tile_edges(card, shape, causal):
    """o and the LSE, and dk and dv fed by the dq kernel's D, within the
    bf16 limits of their plain versions; three calls give the same bits."""
    q, k, v, do = _bf16_heads(shape, card, seed=23)
    runs = []
    for _ in range(3):
        o, lse = ck.flash_attention_fwd(q, k, v, causal, return_lse=True)
        _, d = ck.flash_attention_bwd_dq(q, k, v, o, lse, do, causal)
        runs.append((o, lse, d, *ck.flash_attention_bwd_dkv(q, k, v, lse, do, d, causal)))
    torch.cuda.synchronize()
    for later in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], later))
    o, lse, d, dk, dv = runs[0]
    p_o, p_lse = ck.flash_attention_plain(q, k, v, causal, return_lse=True)
    p_dk, p_dv = ck.flash_attention_bwd_dkv_plain(q, k, v, lse, do, d, causal)
    torch.testing.assert_close(lse, p_lse, rtol=0, atol=1e-4)
    t_o, _, t_dk, t_dv = _bf16_term_sums(q, k, v, lse, do, d, causal)
    for got, ref, a in ((o, p_o, t_o), (dk, p_dk, t_dk), (dv, p_dv, t_dv)):
        _bf16_close(got, ref, a)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", TILE_EDGE_SHAPES)
def test_bf16_dq_kernel_holds_its_plain_version_at_the_tile_edges(card, shape, causal):
    """dq and D (the wgmma kernel at Dh 64: blocks of 128 query rows, two
    consumers of 64, key tiles of 64; the mma.sync one at Dh 128, 256)
    within the bf16 limits of their plain versions, fed by the forward
    kernel's o and LSE; three calls give the same bits."""
    q, k, v, do = _bf16_heads(shape, card, seed=27)
    o, lse = ck.flash_attention_fwd(q, k, v, causal, return_lse=True)
    runs = [ck.flash_attention_bwd_dq(q, k, v, o, lse, do, causal) for _ in range(3)]
    torch.cuda.synchronize()
    for later in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], later))
    dq, d = runs[0]
    p_dq, p_d = ck.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal)
    torch.testing.assert_close(d, p_d, rtol=0, atol=1e-4)
    _bf16_close(dq, p_dq, _bf16_term_sums(q, k, v, lse, do, d, causal)[1])


@pytest.mark.cuda
def test_bf16_dq_kernel_raises_when_the_tensor_map_is_refused(card):
    """dq's TMA maps: a head tensor 2 bytes off a 16-byte boundary is
    refused, and the wrapper raises (nothing falls back)."""
    shape = (1, 2, 128, 64)
    q, k, v, do = _bf16_heads(shape, card, seed=28)
    o, lse = ck.flash_attention_fwd(q, k, v, True, return_lse=True)
    off = torch.empty(q.numel() + 8, dtype=torch.bfloat16, device=card)[1:q.numel() + 1]
    off = off.view(shape)
    off.copy_(o)
    assert off.is_contiguous() and off.data_ptr() % 16 == 2
    before = ck.flash_attention_bwd_dq.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        ck.flash_attention_bwd_dq(q, k, v, off, lse, do, True)
    assert ck.flash_attention_bwd_dq.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_function_gradients_at_a_last_block_of_64_rows(card, causal):
    q, k, v, do = _bf16_heads((1, 4, 192, 64), card, seed=24)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ck.FlashAttentionFunction.apply(*leaves, causal).backward(do)
    o, lse = ck.flash_attention_fwd(q, k, v, causal, return_lse=True)
    dq, d = ck.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal)
    dk, dv = ck.flash_attention_bwd_dkv_plain(q, k, v, lse, do, d, causal)
    terms = _bf16_term_sums(q, k, v, lse, do, d, causal)[1:]
    for leaf, ref, a in zip(leaves, (dq, dk, dv), terms):
        _bf16_close(leaf.grad, ref, a)


@pytest.mark.cuda
def test_bf16_tiles_table_is_what_the_library_was_built_with(card):
    for kernel, by_dh in ck.FLASH_BF16_TILES.items():
        for dh, want in by_dh.items():
            assert ck.flash_bf16_tiles(kernel, dh) == want
    with pytest.raises(ValueError, match="Dh 96"):
        ck.flash_bf16_tiles("fwd", 96)


@pytest.mark.cuda
def test_bf16_hopper_kernels_raise_when_the_tensor_map_is_refused(card):
    """A contiguous head tensor 2 bytes off a 16-byte boundary:
    cuTensorMapEncodeTiled refuses its TMA map, and the wrapper raises
    (nothing falls back)."""
    shape = (1, 2, 128, 64)
    q, k, v, do = _bf16_heads(shape, card, seed=25)
    n = q.numel()
    off = torch.empty(n + 8, dtype=torch.bfloat16, device=card)[1:n + 1].view(shape)
    off.copy_(q)
    assert off.is_contiguous() and off.data_ptr() % 16 == 2
    before = ck.flash_attention_fwd.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        ck.flash_attention_fwd(off, k, v, True)
    assert ck.flash_attention_fwd.launches == before
    o, lse = ck.flash_attention_fwd(q, k, v, True, return_lse=True)
    _, d = ck.flash_attention_bwd_dq(q, k, v, o, lse, do, True)
    with pytest.raises(RuntimeError, match="cudaError"):
        ck.flash_attention_bwd_dkv(off, k, v, lse, do, d, True)


@pytest.mark.cuda
def test_bf16_hopper_kernels_refuse_shapes_they_do_not_take(card):
    q, k, v, do = _bf16_heads((1, 2, 128, 64), card, seed=26)
    o, lse = ck.flash_attention_fwd(q, k, v, True, return_lse=True)
    _, d = ck.flash_attention_bwd_dq(q, k, v, o, lse, do, True)
    cut = [t[..., :96, :].contiguous() for t in (q, k, v, do)]
    with pytest.raises(ValueError, match="T % 64"):
        ck.flash_attention_fwd(*cut[:3], True)
    with pytest.raises(ValueError):
        ck.flash_attention_bwd_dkv(cut[0], cut[1], cut[2], lse[..., :96].contiguous(),
                                   cut[3], d[..., :96].contiguous(), True)
    narrow = [t[..., :32].contiguous() for t in (q, k, v)]
    with pytest.raises(ValueError, match="Dh in"):
        ck.flash_attention_fwd(*narrow, True)


# ------------------------------------------------- the networks' remaining API
def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.cuda
def test_window_on_the_card_matches_a_clone_s_per_batch_fit(card):
    """fit_batches_on_device over 3 batches of a small TransformerLM with
    the fused updater against its clone's 3 fit calls: each kernel
    launched as per-batch fit launches it (2 / 2 / 2 flash and 30 fused
    Adam a step), parameters and Adam state within 1e-6 x each tensor's
    largest entry, the dropout generators equal."""
    rng = np.random.default_rng(40)
    ids = [torch.from_numpy(rng.integers(0, 100, (2, 128))).to(card) for _ in range(3)]
    labels = [torch.nn.functional.one_hot(torch.roll(i, -1, 1), 100).float() for i in ids]
    net = TransformerLM(**SMALL).init()
    twin = net.clone()
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    kernels = (ck.flash_attention_fwd, ck.flash_attention_bwd_dq,
               ck.flash_attention_bwd_dkv, ck.fused_adam)
    launched = []
    for run in (lambda: net.fit_batches_on_device(
                    [DataSet(i, y) for i, y in zip(ids, labels)]),
                lambda: [twin.fit(i, y) for i, y in zip(ids, labels)]):
        before = [k.launches for k in kernels]
        run()
        torch.cuda.synchronize()
        launched.append([k.launches - b for k, b in zip(kernels, before)])
    assert launched == [[6, 6, 6, 90]] * 2
    assert net.iteration == twin.iteration == 3
    for tree in ("params", "updater_states"):
        for a, b in zip(_leaves(getattr(net, tree)), _leaves(getattr(twin, tree))):
            _close_to_max(a, b, 1e-6)
    assert torch.equal(net.dropout_generator.get_state(),
                       twin.dropout_generator.get_state())


@pytest.mark.cuda
def test_set_params_flat_keeps_the_tensors_the_fused_updater_takes(card):
    """params_flat -> set_params_flat is bit for bit and keeps every
    parameter's storage; the fused updater then still takes every tensor."""
    net = MultiLayerNetwork(
        NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-3)).list()
        .layer(LSTMLayer(n_out=16, activation="tanh"))
        .layer(RnnOutputLayer(n_out=7)).set_input_type(InputType.recurrent(7))
        .build()).init()
    ptrs = [t.data_ptr() for t in _leaves(net.params)]
    flat = net.params_flat()
    net.set_params_flat(flat)
    assert [t.data_ptr() for t in _leaves(net.params)] == ptrs
    np.testing.assert_array_equal(net.params_flat(), flat)
    x = np.eye(7, dtype=np.float32)[np.random.default_rng(41).integers(0, 7, (4, 12))]
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    before = ck.fused_adam.launches
    net.fit(x, x)
    torch.cuda.synchronize()
    assert ck.fused_adam.launches - before == len(ptrs)
    assert [t.data_ptr() for t in _leaves(net.params)] == ptrs
    assert not np.array_equal(net.params_flat(), flat)


@pytest.mark.cuda
def test_evaluate_roc_on_a_bf16_output(card):
    """A bf16 LSTM network's evaluate_roc_multi_class (its output widened
    to f32 on the host) equals ROCMultiClass over that same output, label
    mask and all."""
    from deeplearning4j_tpu_torch.eval import ROCMultiClass
    from deeplearning4j_tpu_torch.nn.train_step import to_host

    net = MultiLayerNetwork(
        NeuralNetConfiguration.builder().seed(5).compute_dtype("bfloat16").list()
        .layer(LSTMLayer(n_out=32, activation="tanh"))
        .layer(RnnOutputLayer(n_out=7)).set_input_type(InputType.recurrent(7))
        .build()).init()
    rng = np.random.default_rng(42)
    x = np.eye(7, dtype=np.float32)[rng.integers(0, 7, (6, 12))]
    mask = (rng.random((6, 12)) > 0.25).astype(np.float32)
    ds = DataSet(x, x, None, mask)
    out = net.output(x)
    assert out.dtype == torch.bfloat16
    want = ROCMultiClass()
    want.eval(x, to_host(out), mask=mask)
    got = net.evaluate_roc_multi_class(ds)
    assert [got.calculate_auc(c) for c in range(7)] == \
        [want.calculate_auc(c) for c in range(7)]


def _vae_conf(dtype="float32"):
    from deeplearning4j_tpu_torch.nn.layers import VariationalAutoencoderLayer

    conf = (NeuralNetConfiguration.builder().seed(9).updater(Adam(1e-3)).l2(1e-4).list()
            .layer(VariationalAutoencoderLayer(n_out=8, encoder_layer_sizes=(32, 32),
                                               decoder_layer_sizes=(32, 32), num_samples=2))
            .set_input_type(InputType.feed_forward(64)).build())
    conf.global_conf.dtype = dtype
    return conf


@pytest.mark.cuda
def test_vae_pretrain_step_on_the_card_matches_the_cpu(card, monkeypatch):
    """A VAE's pretrain step on the card (fused updater: 14 launches) from
    the CPU twin's weights and with its ε: the loss within 1e-5 relative,
    each parameter and Adam slot within 1e-5 x its largest entry of the
    CPU f32 step's, or (Adam's per-entry scaling of a near-zero gradient)
    no farther from the CPU's f64 step than 4x the CPU f32 step is."""
    from deeplearning4j_tpu_torch.nn import dropout as d
    from deeplearning4j_tpu_torch.util.convert import export_params, load_reference_params

    gen = torch.Generator().manual_seed(3)
    eps = [torch.randn((16, 8), generator=gen) for _ in range(2)]
    calls = []

    def handed(shape, g, device, dtype=torch.float32):
        calls.append(tuple(shape))
        return eps[(len(calls) - 1) % 2].to(device, dtype)

    monkeypatch.setattr(d, "normal", handed)
    x = (torch.rand((16, 64), generator=gen) < 0.3).float()
    cpu32 = MultiLayerNetwork(_vae_conf(), device="cpu").init()
    weights = export_params(cpu32)
    cpu64 = load_reference_params(MultiLayerNetwork(_vae_conf("float64"), device="cpu")
                                  .init(), weights)
    net = load_reference_params(MultiLayerNetwork(_vae_conf()).init(), weights)
    helpers.set_helper("updater", ck.FusedUpdaterHelper())
    before = ck.fused_adam.launches
    net.pretrain_layer(0, x.cuda())
    torch.cuda.synchronize()
    assert ck.fused_adam.launches - before == 14  # 4 encoder, 4 latent, 4 decoder, 2 head
    cpu32.pretrain_layer(0, x)
    cpu64.pretrain_layer(0, x.double())
    assert calls == [(16, 8)] * 6
    assert abs(net.score_ - cpu32.score_) <= 1e-5 * abs(cpu32.score_)
    for tree in ("params", "updater_states"):
        def leaves(n):
            t = getattr(n, tree)[0]
            return {f"{k}/{s}": v for k, sl in t.items()
                    for s, v in (sl.items() if isinstance(sl, dict) else [("", sl)])}
        got, want, ref = leaves(net), leaves(cpu32), leaves(cpu64)
        for k, w in want.items():
            g, r = got[k].cpu().double(), ref[k]
            scale = max(w.abs().max().item(), 1e-30)
            if (g - w.double()).abs().max().item() <= 1e-5 * scale:
                continue
            assert (g - r).abs().max().item() <= 4 * (w.double() - r).abs().max().item(), k


@pytest.mark.cuda
@pytest.mark.parametrize("given_target", [False, True])
def test_yolo2_loss_gradients_on_the_card_match_the_cpu(card, given_target):
    """The YOLOv2 loss and its input gradient on the card within 1e-5 x
    max(1, the largest entry) of the CPU's, on the same scores and labels
    (boxes in absolute grid units), with the IoU or a given confidence
    target."""
    from deeplearning4j_tpu_torch.nn.layers import Yolo2OutputLayer

    layer = Yolo2OutputLayer(boxes=((1.0, 1.2), (2.0, 1.5), (0.6, 0.8)), n_classes=4)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((3, 7, 6, 3 * 9), generator=gen)
    lab = torch.zeros((3, 7, 6, 9))
    obj = torch.rand((3, 7, 6), generator=gen) < 0.3
    for i, yy, xx in obj.nonzero().tolist():
        lab[i, yy, xx, :5] = torch.tensor([xx + 0.5, yy + 0.25, 1.5, 0.8, 1.0])
        lab[i, yy, xx, 5 + (i + yy + xx) % 4] = 1.0
    target = torch.rand((3, 7, 6, 3), generator=gen) if given_target else None
    out = {}
    for dev in ("cpu", "cuda"):
        leaf = x.to(dev).requires_grad_(True)
        loss = layer.compute_loss({}, leaf, lab.to(dev),
                                  conf_target=None if target is None else target.to(dev))
        (g,) = torch.autograd.grad(loss, leaf)
        out[dev] = (loss.item(), g.cpu())
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * max(1.0, abs(out["cpu"][0]))
    want = out["cpu"][1]
    assert (out["cuda"][1] - want).abs().max() <= 1e-5 * max(1.0, want.abs().max().item())


def _sd_lenet(device):
    """The zoo LeNet's widths in SameDiff ops, narrowed (8 and 16
    channels, dense 64) for a test, from a seeded generator."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff

    gen = np.random.default_rng(5)
    sd = SameDiff.create(device)
    x = sd.place_holder("input", shape=(None, 28, 28, 1))
    y = sd.place_holder("label", shape=(None, 10))

    def var(name, *shape):
        fan = float(np.prod(shape[:-1]))
        return sd.var(name, value=gen.normal(0, 1 / np.sqrt(fan), shape).astype(np.float32))

    h = sd.nn.conv2d(x, var("w0", 5, 5, 1, 8), stride=(1, 1), padding="SAME") + var("b0", 8)
    h = sd.nn.max_pooling2d(h, size=(2, 2), stride=(2, 2))
    h = sd.nn.conv2d(h, var("w1", 5, 5, 8, 16), stride=(1, 1), padding="SAME") + var("b1", 16)
    h = sd.nn.max_pooling2d(h, size=(2, 2), stride=(2, 2)).reshape(-1, 7 * 7 * 16)
    h = sd.nn.relu(sd.nn.linear(h, var("w2", 7 * 7 * 16, 64), var("b2", 64)))
    logits = sd.nn.linear(h, var("w3", 64, 10), var("b3", 10))
    sd.loss.softmax_cross_entropy(y, logits, name="loss")
    sd.set_loss_variables("loss")
    return sd


def _sd_gradients_f64(sd, feed, device="cpu"):
    """The gradients of ``sd``'s loss in f64 on ``device``, through its
    lowered function (``SameDiff`` itself takes data in f32)."""
    fn = sd._build_fn(sd._loss_variables)
    live = {k: v.to(device, torch.float64).requires_grad_(True)
            for k, v in sd.variables_map.items()}
    ph = {k: torch.from_numpy(v).to(device, torch.float64) for k, v in feed.items()}
    consts = {k: v.to(device, torch.float64) for k, v in sd.constants_map.items()}
    grads = torch.autograd.grad(sum(o.sum() for o in fn(live, ph, consts)), list(live.values()))
    return {k: g.cpu().numpy() for k, g in zip(live, grads)}


# cuDNN's f32 weight-gradient algorithm for these convolutions (8 and 16
# channels, batch 16) sums in reduced precision: 4.4e-4 (w0) of the
# largest entry from the f64 gradient on an H100, TF32 off, where the
# CPU's f32 lies 4e-7 from it (this test's printed reading, ROADMAP §C);
# at the zoo LeNet's widths and batch 128 the card's lie 4e-7 from f64
# too (chip_smoke.py's samediff line, gradients_from_f64)
SD_CONV_WGRAD_TOL = 1e-3


@pytest.mark.cuda
def test_samediff_lenet_gradients_on_the_card_match_the_cpu(card):
    """A SameDiff LeNet's ``calculate_gradients`` on the card (f32, TF32
    off) against the CPU's: each variable within 1e-5 x its largest
    gradient entry, the convolution weights within SD_CONV_WGRAD_TOL; and
    the same lowered graph in f64 on the card within 1e-10 of the CPU's
    f64 gradients (the port's ops, exact there)."""
    gen = np.random.default_rng(6)
    x = gen.normal(size=(16, 28, 28, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[gen.integers(0, 10, 16)]
    feed = {"input": x, "label": y}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sd = _sd_lenet(None)
        got, got64 = sd.calculate_gradients(feed), _sd_gradients_f64(sd, feed, "cuda")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu = _sd_lenet("cpu")
    want, want64 = cpu.calculate_gradients(feed), _sd_gradients_f64(cpu, feed)
    assert set(got) == set(want) == {"w0", "b0", "w1", "b1", "w2", "b2", "w3", "b3"}
    # each f32 gradient's distance from the f64 one (``-s`` shows it)
    print({k: {src: float(np.abs(g[k] - want64[k]).max() / np.abs(want64[k]).max())
               for src, g in (("card_f32", got), ("cpu_f32", want))} for k in want})
    for k, w in want.items():
        tol = SD_CONV_WGRAD_TOL if k in ("w0", "w1") else 1e-5
        assert np.abs(got[k] - w).max() <= tol * np.abs(w).max(), k
        assert np.abs(got64[k] - want64[k]).max() <= 1e-10 * np.abs(want64[k]).max(), k


@pytest.mark.cuda
def test_checkpointed_dropout_gradients_on_the_card_match_the_cpu(card):
    """A checkpointed network with dropout: its gradients on the card equal
    its plain twin's there from the same generator state (the recompute
    replays the masks), and are within 1e-5 x each tensor's largest entry
    of the CPU's when the card's masks are handed to the CPU."""
    from deeplearning4j_tpu_torch.nn import dropout as d
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.train_step import gradients

    def conf(remat):
        return (NeuralNetConfiguration.builder().seed(2).dropout(0.7)
                .gradient_checkpointing(remat).list()
                .layer(DenseLayer(n_out=64, activation="tanh"))
                .layer(DenseLayer(n_out=64, activation="relu"))
                .layer(OutputLayer(n_out=5))
                .set_input_type(InputType.feed_forward(32)).build())

    gen = np.random.default_rng(7)
    x = torch.from_numpy(gen.normal(size=(24, 32)).astype(np.float32))
    y = torch.from_numpy(np.eye(5, dtype=np.float32)[gen.integers(0, 5, 24)])
    net = MultiLayerNetwork(conf(True)).init()
    weights = export_params(net)
    plain = load_reference_params(MultiLayerNetwork(conf(False)).init(), weights)
    plain.dropout_generator.set_state(net.dropout_generator.get_state())
    masks = []
    bernoulli = d.bernoulli

    def recorded(*args, **kw):
        masks.append(bernoulli(*args, **kw))
        return masks[-1]

    def grads(n, xs, ys):
        return gradients(lambda live: (n._loss_fn(live, xs, ys, None, None, train=True,
                                                  gen=n.dropout_generator)[0], None),
                         n.params)[1]

    d.bernoulli = recorded
    try:
        g_ck = grads(net, x.cuda(), y.cuda())
    finally:
        d.bernoulli = bernoulli
    g_plain = grads(plain, x.cuda(), y.cuda())
    for k in g_ck:
        for n in g_ck[k]:
            assert torch.equal(g_ck[k][n], g_plain[k][n]), (k, n)
    drawn = masks[:2]  # the first forward's masks; the recompute drew again
    assert len(masks) == 4 and all(torch.equal(a, b) for a, b in zip(drawn, masks[2:][::-1]))
    cpu = load_reference_params(MultiLayerNetwork(conf(True), device="cpu").init(), weights)
    handed = iter(m.cpu() for m in drawn + drawn[::-1])
    d.bernoulli = lambda *a, **k: next(handed)
    try:
        g_cpu = grads(cpu, x, y)
    finally:
        d.bernoulli = bernoulli
    for k in g_cpu:
        for n, w in g_cpu[k].items():
            assert (g_ck[k][n].cpu() - w).abs().max() <= 1e-5 * w.abs().max(), (k, n)


def _narrow_lenet(dtype):
    """The zoo LeNet's structure ("same" 5x5 convolutions with max pools, a
    relu dense layer, a softmax output), narrowed: 4 and 6 channels, dense
    16, 12x12 inputs."""
    from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer, DenseLayer,
                                                    OutputLayer, SubsamplingLayer)

    return (NeuralNetConfiguration.builder().seed(9).dtype(dtype).activation("identity")
            .optimization_algo("lbfgs").list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(5, 5), convolution_mode="same"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2), pooling_type="max"))
            .layer(ConvolutionLayer(n_out=6, kernel_size=(5, 5), convolution_mode="same"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2), pooling_type="max"))
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=10, loss="mcxent", activation="softmax"))
            .set_input_type(InputType.convolutional(12, 12, 1)).build())


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["stochastic_gradient_descent", "line_gradient_descent",
                                  "conjugate_gradient", "lbfgs"])
def test_solver_f64_history_on_the_card_matches_the_cpu(card, algo):
    """``Solver`` on a narrowed LeNet in float64: the card's score history
    within 1e-8 relative of the CPU's, entry by entry, with the same
    iteration count; no kernel of the port runs."""
    from deeplearning4j_tpu_torch.optimize import Solver

    rng = np.random.default_rng(3)
    y = rng.integers(0, 10, 64)
    x = rng.normal(0, 0.3, (64, 12, 12, 1))
    x[np.arange(64), 1 + y % 10, :, 0] += 2.0
    ds = DataSet(x, np.eye(10)[y])
    cpu = MultiLayerNetwork(_narrow_lenet("float64"), device="cpu").init()
    gpu = load_reference_params(MultiLayerNetwork(_narrow_lenet("float64")).init(),
                                export_params(cpu))
    launches = ck.fused_adam.launches
    hists = []
    for net in (cpu, gpu):
        s = Solver(net, algo, max_iterations=8)
        s.optimize(ds)
        hists.append(s.score_history)
    assert ck.fused_adam.launches == launches
    assert len(hists[0]) == len(hists[1]) > 2
    np.testing.assert_allclose(hists[1], hists[0], rtol=1e-8, atol=0)
    assert hists[1][-1] < hists[1][0]


@pytest.mark.cuda
def test_gradient_checks_pass_on_the_card_in_f64(card):
    """``check_model_gradients`` at the reference's defaults on the card: a
    narrowed LeNet and an LSTM network pass, on the coordinates the CPU
    checks, with a worst significant relative error (the reference's
    reading: errors above 1e-8 absolute) within 1e-6 of the CPU's."""
    from deeplearning4j_tpu_torch.util.gradient_check import check_model_gradients

    rng = np.random.default_rng(5)
    lstm_conf = (NeuralNetConfiguration.builder().seed(3).list()
                 .layer(LSTMLayer(n_out=8, activation="tanh"))
                 .layer(RnnOutputLayer(n_out=5, activation="softmax", loss="mcxent"))
                 .set_input_type(InputType.recurrent(4)).build())
    cases = [(_narrow_lenet("float32"), rng.normal(size=(4, 12, 12, 1)),
              np.eye(10)[rng.integers(0, 10, 4)]),
             (lstm_conf, rng.normal(size=(3, 6, 4)), np.eye(5)[rng.integers(0, 5, (3, 6))])]
    for conf, x, y in cases:
        cpu = MultiLayerNetwork(conf, device="cpu").init()
        gpu = load_reference_params(MultiLayerNetwork(conf).init(), export_params(cpu))
        reports = [{}, {}]
        for net, report in zip((cpu, gpu), reports):
            assert check_model_gradients(net, x, y, report=report)
        assert reports[1]["coordinates"] == reports[0]["coordinates"]
        assert abs(reports[1]["max_rel_error"] - reports[0]["max_rel_error"]) <= 1e-6


@pytest.mark.cuda
def test_two_version_registry_serves_on_the_card_with_int8_bytes(card):
    """A two-version registry on the card at a small size (a 2-layer, d 128,
    T 128 TransformerLM: the causal layers take K3a): v1 f32 and v2 its
    int8 version. The int8 version grows the card's allocation by its
    int8 tensors and scales (its ``param_nbytes`` less the 1-d float
    parameters it shares with v1, which it does not copy), each block
    rounded up to the caching allocator's 512 bytes; each answer
    equals its version's own ``output`` within the served-answer limit
    (rtol 1e-4, atol 1e-8); each forward launches K3a once a layer."""
    from deeplearning4j_tpu_torch.serving import ModelRegistry
    from deeplearning4j_tpu_torch.serving.quantize import QTensor

    net = TransformerLM(vocab_size=100, max_length=128, n_layers=2, d_model=128,
                        n_heads=2, d_ff=256, seed=3).init()
    rng = np.random.default_rng(0)
    x = rng.integers(0, 100, (2, 128)).astype(np.float32)
    reg = ModelRegistry(max_batch_size=2, buckets=(1, 2))
    try:
        reg.register("lm", net, input_shape=(128,))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        v = reg.register("lm", net, dtype_policy="int8", sample_input=x, activate=False)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - before
        qm = reg.get("lm").versions[v].model
        quantized = [t for named in qm.qparams.values() for t in named.values()
                     if isinstance(t, QTensor)]
        assert quantized and all(t.q.dtype == torch.int8 and t.q.is_cuda for t in quantized)
        # the caching allocator rounds each block up to 512 bytes
        int8_bytes = sum(t.nbytes for t in quantized)
        assert 0 <= grown - int8_bytes <= 512 * 2 * len(quantized)
        assert int8_bytes < qm.param_nbytes
        for version in (1, v):
            launches = ck.flash_attention_fwd.launches
            out, served = reg.predict_versioned("lm", x, version=version)
            assert served == version
            assert ck.flash_attention_fwd.launches - launches == 2
            ref = reg.get("lm").versions[version].model.output(x).cpu().numpy()
            assert np.all(np.abs(out - ref) <= 1e-8 + 1e-4 * np.abs(ref))
    finally:
        reg.shutdown()
