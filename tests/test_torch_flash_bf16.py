"""The bf16 flash-attention kernels' plain versions, wrappers and seam, on the CPU.

The plain versions (what the wrappers compute for CPU tensors, and what
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the bf16 kernels
to on the card) keep the TPU kernel's rounding points (jax 0.9.0's
``jax/experimental/pallas/ops/tpu/flash_attention.py``): products of bf16
operands accumulated in f32; the softmax statistics, the LSE and D in
f32; P rounded to bf16 before P·V and before dV = Pᵀ·dO, dS (scaled)
rounded to bf16 before dQ = dS·K and dK = dSᵀ·Q; O, dQ, dK and dV written
in bf16. Each is held to a float64 evaluation with the same rounding
points: the f32 quantities within 1e-5 relative to their largest entry
(f32 sums against f64 ones), the bf16 outputs within one bf16 ulp of
their largest entry (2^-8: a value on a rounding boundary may round
either way), causal and full, Dh 64, 128 and 256. Then: the wrappers
count nothing on the CPU; the autograd function's gradients are the plain
backward's; the seam sends f32 and bf16 requests to a registered flash
helper and never f16 or f64; ``_check_attention`` takes bf16 heads and
refuses bf16 row statistics.
"""

import math

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers
from deeplearning4j_tpu_torch.nn.layers import attention

BF = torch.bfloat16
F32_RTOL = 1e-5
ULP = 2.0 ** -8
CASES = [(64, True), (64, False), (128, True), (128, False), (256, True),
         (256, False)]


@pytest.fixture(autouse=True)
def _clean_seams():
    helpers.clear_all_helpers()
    yield
    helpers.clear_all_helpers()
    helpers.set_auto_flash_attention(True)


def _heads(dh, n=4, shape=(1, 2, 128), seed=0):
    rng = np.random.default_rng(seed + dh)
    return [torch.from_numpy(rng.standard_normal(shape + (dh,), dtype=np.float32)).to(BF)
            for _ in range(n)]


def _ref_scores(q, k, causal):
    """S·scale in f64 from the bf16 operands, -inf above the diagonal."""
    s = torch.einsum("nhqd,nhkd->nhqk", q.double(), k.double()) / math.sqrt(q.shape[-1])
    if causal:
        t = q.shape[-2]
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), float("-inf"))
    return s


def _rnd(x):
    """x rounded to bf16, back in f64: a rounding point."""
    return x.to(BF).double()


def _close(got, want, rel):
    scale = max(1.0, want.abs().max().item())
    err = (got.double() - want).abs().max().item()
    assert err <= rel * scale, (err, rel * scale)


@pytest.mark.parametrize("dh,causal", CASES)
def test_forward_plain_matches_f64_with_the_rounding_points(dh, causal):
    q, k, v = _heads(dh, 3)
    o, lse = ck.flash_attention_plain(q, k, v, causal, return_lse=True)
    assert o.dtype == BF and lse.dtype == torch.float32
    s = _ref_scores(q, k, causal)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    o_ref = torch.einsum("nhqk,nhkd->nhqd", _rnd(e), v.double()) / l
    _close(lse, (m + torch.log(l)).squeeze(-1), F32_RTOL)
    _close(o, o_ref, ULP)


@pytest.mark.parametrize("dh,causal", CASES)
def test_backward_plain_matches_f64_with_the_rounding_points(dh, causal):
    q, k, v, do = _heads(dh, 4, seed=1)
    o, lse = ck.flash_attention_plain(q, k, v, causal, return_lse=True)
    dq, d = ck.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal)
    dk, dv = ck.flash_attention_bwd_dkv_plain(q, k, v, lse, do, d, causal)
    assert d.dtype == torch.float32 and all(t.dtype == BF for t in (dq, dk, dv))
    d_ref = (do.double() * o.double()).sum(-1)
    _close(d, d_ref, F32_RTOL)
    p = torch.exp(_ref_scores(q, k, causal) - lse.double()[..., None])
    dp = torch.einsum("nhqd,nhkd->nhqk", do.double(), v.double())
    ds = p * (dp - d_ref[..., None]) / math.sqrt(dh)
    _close(dq, torch.einsum("nhqk,nhkd->nhqd", _rnd(ds), k.double()), ULP)
    _close(dk, torch.einsum("nhqk,nhqd->nhkd", _rnd(ds), q.double()), ULP)
    _close(dv, torch.einsum("nhqk,nhqd->nhkd", _rnd(p), do.double()), ULP)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_plain_stays_near_the_exact_attention(causal):
    """The rounding points cost bf16 accuracy, not more: against f64
    attention of the same bf16 inputs, within a few bf16 ulps."""
    q, k, v = _heads(64, 3, seed=2)
    o = ck.flash_attention_plain(q, k, v, causal)
    exact = ck.flash_attention_plain(q.double(), k.double(), v.double(), causal)
    _close(o, exact, 4 * ULP)


@pytest.mark.parametrize("causal", [True, False])
def test_wrappers_on_cpu_compute_the_plain_versions_and_count_nothing(causal):
    q, k, v, do = _heads(64, 4, seed=3)
    counts = [(w.launches, w.launches_bf16) for w in
              (ck.flash_attention_fwd, ck.flash_attention_bwd_dq,
               ck.flash_attention_bwd_dkv)]
    o, lse = ck.flash_attention_fwd(q, k, v, causal, return_lse=True)
    dq, d = ck.flash_attention_bwd_dq(q, k, v, o, lse, do, causal)
    dk, dv = ck.flash_attention_bwd_dkv(q, k, v, lse, do, d, causal)
    assert counts == [(w.launches, w.launches_bf16) for w in
                      (ck.flash_attention_fwd, ck.flash_attention_bwd_dq,
                       ck.flash_attention_bwd_dkv)]
    p_o, p_lse = ck.flash_attention_plain(q, k, v, causal, return_lse=True)
    assert torch.equal(o, p_o) and torch.equal(lse, p_lse)
    assert torch.equal(dq, ck.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal)[0])
    assert torch.equal(dk, ck.flash_attention_bwd_dkv_plain(q, k, v, lse, do, d, causal)[0])


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_gives_the_plain_backward(causal):
    q, k, v, do = _heads(64, 4, seed=4)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ck.FlashAttentionFunction.apply(*leaves, causal)
    out.backward(do)
    o, lse = ck.flash_attention_plain(q, k, v, causal, return_lse=True)
    assert torch.equal(out.detach(), o)
    dq, d = ck.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal)
    dk, dv = ck.flash_attention_bwd_dkv_plain(q, k, v, lse, do, d, causal)
    for leaf, want in zip(leaves, (dq, dk, dv)):
        assert leaf.grad.dtype == BF and torch.equal(leaf.grad, want)


class _Spy(ck.FlashAttentionHelper):
    """The flash helper, registered: records what it attends."""

    def __init__(self):
        super().__init__(causal=True)
        self.seen = []

    def attend(self, q, k, v):
        self.seen.append(q.dtype)
        return super().attend(q, k, v)


@pytest.mark.parametrize("dtype,taken", [(torch.float32, True), (BF, True),
                                         (torch.float16, False),
                                         (torch.float64, False)], ids=str)
def test_seam_sends_f32_and_bf16_to_a_registered_flash_helper(dtype, taken):
    spy = _Spy()
    helpers.set_helper("attention", spy)
    q, k, v = (t.to(dtype) for t in _heads(64, 3, seed=5))
    out = attention.dot_product_attention(q, k, v, causal=True)
    assert spy.seen == ([dtype] if taken else [])
    assert out.dtype == dtype
    exact = ck.flash_attention_plain(q.double(), k.double(), v.double(), True)
    _close(out, exact, 4 * ULP)


@pytest.mark.parametrize("dtype,taken", [(torch.float32, True), (BF, True),
                                         (torch.float16, False),
                                         (torch.float64, False)], ids=str)
def test_auto_flash_takes_f32_and_bf16_causal_requests(monkeypatch, dtype, taken):
    seen = []
    real = ck.FlashAttentionFunction.apply

    def spy(q, k, v, causal):
        seen.append(q.dtype)
        return real(q, k, v, causal)

    monkeypatch.setattr(ck.FlashAttentionFunction, "apply", spy)
    q, k, v = (t.to(dtype).requires_grad_(True) for t in _heads(64, 3, seed=6))
    attention.dot_product_attention(q, k, v, causal=True).sum().backward()
    assert seen == ([dtype] if taken else [])
    assert q.grad.dtype == dtype


def test_flash_helper_supports_tests_the_type():
    h = ck.FlashAttentionHelper(causal=True)
    shape = (1, 2, 128, 64)
    assert h.supports(None, shape, None, False, causal=True, dtype=BF)
    assert h.supports(None, shape, None, False, causal=True, dtype=torch.float32)
    with pytest.raises(TypeError):  # the type is always given
        h.supports(None, shape, None, False, causal=True)
    assert not h.supports(None, shape, None, False, causal=True, dtype=torch.float16)
    assert not h.supports(None, shape, None, False, causal=True, dtype=torch.float64)


def test_check_attention_takes_bf16_heads_with_f32_rows():
    q, k, v = _heads(64, 3)
    lse = torch.zeros(q.shape[:3])
    ck._check_attention("t", (q, k, v), (lse, lse))


@pytest.mark.parametrize("which", ["lse", "d"])
def test_check_attention_refuses_bf16_row_statistics(which):
    q, k, v = _heads(64, 3)
    lse, d = torch.zeros(q.shape[:3]), torch.zeros(q.shape[:3])
    bad = {"lse": (lse.to(BF), d), "d": (lse, d.to(BF))}[which]
    with pytest.raises(ValueError, match="float32 row statistics"):
        ck._check_attention("t", (q, k, v), bad)


def test_check_attention_refuses_mixed_or_other_head_types():
    q, k, v = _heads(64, 3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ck._check_attention("t", (q, k.float(), v))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ck._check_attention("t", (q.half(), k.half(), v.half()))
