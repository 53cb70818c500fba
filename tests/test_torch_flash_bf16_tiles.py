"""The bf16 flash kernels' tile order, emulated on the CPU.

The bf16 forward and dk/dv kernels (``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_bwd.cu``) compute in tiles: the forward keeps a
running row max over key tiles of BC keys, rounds P = exp2(S·scale·log2e −
m) to bf16 against that running max before P·V, sums each tile's P·V from
zero and rescales O in f32; the dk/dv kernel walks query tiles of BC rows,
forms each tile's Pᵀ and dSᵀ in f32 and rounds them to bf16 only as the
operands of dV += Pᵀ·dO and dK += dSᵀ·Q. These tests emulate both in torch
at the tile sizes of ``cuda_kernels.FLASH_BF16_TILES`` (a card test holds
that table to the built library) and hold each emulation

* to the plain version (what the kernels are held to on the card) within
  ``chip_smoke.py``'s limits: the max-abs limit 1e-2 × max(1, largest
  entry), each entry within 2^-7 × (|plain| + its sum of absolute terms),
  the whole within 4e-3 relative Frobenius error; and
* to an f64 attention of the same bf16 inputs no farther (Frobenius) than
  1.05× the plain version's distance: rounding P against the running max
  instead of the final one costs no accuracy.

Dh 64, 128 and 256, causal and full, T = 64, 192 and 256 (192 is a last
block of 64 rows at BR = 128), inputs from numpy with a seed.
"""

import math

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BF = torch.bfloat16
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# chip_smoke.py's limits for the bf16 kernels against their plain versions
BF16_TOL, BF16_ELEM_TOL, BF16_FROB_TOL = 1e-2, 2 ** -7, 4e-3
F64_RATIO = 1.05
CASES = [(dh, t, causal) for dh in (64, 128, 256) for t in (64, 192, 256)
         for causal in (True, False)]


def _heads(dh, t, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, 2, t, dh), dtype=np.float32)).to(BF)
            for _ in range(4)]


def _causal_mask(t_q, t_k, q0=0, k0=0):
    """True where key k0 + j lies after query q0 + i."""
    return (torch.arange(k0, k0 + t_k)[None, :] > torch.arange(q0, q0 + t_q)[:, None])


def emulate_forward(q, k, v, causal, bc, rescale=True):
    """The forward kernel's arithmetic in tile order: key tiles of ``bc``,
    the running max and f32 sum, P rounded to bf16 against the running max,
    each tile's P·V from zero, O rescaled in f32. Returns (o bf16, lse f32).
    ``rescale=False`` is a fault: earlier tiles' O is not rescaled when the
    running max grows."""
    qf, kf, vf = q.float(), k.float(), v.float()
    t, dh = q.shape[-2], q.shape[-1]
    scale_log2 = torch.tensor(LOG2E / math.sqrt(dh), dtype=torch.float32)
    m = torch.full(q.shape[:-1], float("-inf"))
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for k0 in range(0, t, bc):
        s = torch.einsum("nhqd,nhkd->nhqk", qf, kf[..., k0:k0 + bc, :]) * scale_log2
        if causal:
            s = s.masked_fill(_causal_mask(t, s.shape[-1], 0, k0), float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        share = torch.einsum("nhqk,nhkd->nhqd", p.to(BF).float(), vf[..., k0:k0 + bc, :])
        acc = (acc * alpha[..., None] if rescale else acc) + share
        m = m_new
    return (acc / l[..., None]).to(BF), (m + torch.log2(l)) * LN2


def emulate_dq(q, k, v, o, lse, do, causal, bc, fault=None):
    """The dq kernel's arithmetic in tile order: D = rowsum(f32(dO) ∘
    f32(O)); key tiles of ``bc``, P = exp2(S·scale·log2e − LSE·log2e) and
    dS = P ∘ (dP − D)·scale in f32, dS rounded to bf16 only as the operand
    of each tile's share dS·K, which is summed from zero and added to dQ in
    f32. Returns (dq bf16, D f32). Faults: ``"diagonal"`` leaves the tile on
    a row's diagonal unmasked (only whole tiles past it are), ``"d_row"``
    takes each row's D from its neighbouring row."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    t, dh = q.shape[-2], q.shape[-1]
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
    scale_log2 = scale * LOG2E
    d = (dof * o.float()).sum(-1)
    d_used = d.roll(1, -1) if fault == "d_row" else d
    dq = torch.zeros(q.shape)
    for k0 in range(0, t, bc):
        ks, vs = kf[..., k0:k0 + bc, :], vf[..., k0:k0 + bc, :]
        s = torch.einsum("nhqd,nhkd->nhqk", qf, ks)
        p = torch.exp2(s * scale_log2 - (lse * LOG2E)[..., None])
        if causal:
            mask = _causal_mask(t, ks.shape[-2], 0, k0)
            if fault == "diagonal":  # only tiles wholly past the row's diagonal tile
                keys = torch.arange(k0, k0 + ks.shape[-2])[None, :]
                mask = keys >= (torch.arange(t)[:, None] // bc + 1) * bc
            p = p.masked_fill(mask, 0.0)
        dp = torch.einsum("nhqd,nhkd->nhqk", dof, vs)
        ds = p * (dp - d_used[..., None]) * scale
        dq = dq + torch.einsum("nhqk,nhkd->nhqd", ds.to(BF).float(), ks)
    return dq.to(BF), d


def emulate_dkv(q, k, v, lse, do, d, causal, bc):
    """The dk/dv kernel's arithmetic in tile order: query tiles of ``bc``,
    Pᵀ = exp2(Sᵀ·scale·log2e − LSE·log2e) and dSᵀ = Pᵀ ∘ (dPᵀ − D)·scale in
    f32, rounded to bf16 only as operands, dK and dV summed in f32."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    t, dh = q.shape[-2], q.shape[-1]
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
    scale_log2 = scale * LOG2E
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    for q0 in range(0, t, bc):
        qs, dos = qf[..., q0:q0 + bc, :], dof[..., q0:q0 + bc, :]
        s_t = torch.einsum("nhkd,nhqd->nhkq", kf, qs)
        p_t = torch.exp2(s_t * scale_log2 - (lse[..., q0:q0 + bc] * LOG2E)[..., None, :])
        if causal:
            p_t = p_t.masked_fill(_causal_mask(qs.shape[-2], t, q0, 0).T, 0.0)
        dp_t = torch.einsum("nhkd,nhqd->nhkq", vf, dos)
        ds_t = p_t * (dp_t - d[..., q0:q0 + bc][..., None, :]) * scale
        dv = dv + torch.einsum("nhkq,nhqd->nhkd", p_t.to(BF).float(), dos)
        dk = dk + torch.einsum("nhkq,nhqd->nhkd", ds_t.to(BF).float(), qs)
    return dk.to(BF), dv.to(BF)


def _exact(q, k, v, do, causal):
    """o, dk, dv (and dq) of attention in f64 on the bf16 inputs, no
    rounding."""
    qd, kd, vd, dod = (x.double() for x in (q, k, v, do))
    s = torch.einsum("nhqd,nhkd->nhqk", qd, kd) / math.sqrt(q.shape[-1])
    if causal:
        t = q.shape[-2]
        s = s.masked_fill(_causal_mask(t, t), float("-inf"))
    p = torch.softmax(s, -1)
    o = torch.einsum("nhqk,nhkd->nhqd", p, vd)
    dp = torch.einsum("nhqd,nhkd->nhqk", dod, vd)
    ds = p * (dp - (dod * o).sum(-1, keepdim=True))
    dk = torch.einsum("nhqk,nhqd->nhkd", ds, qd) / math.sqrt(q.shape[-1])
    dq = torch.einsum("nhqk,nhkd->nhqd", ds, kd) / math.sqrt(q.shape[-1])
    return o, dk, torch.einsum("nhqk,nhqd->nhkd", p, dod), dq


def _term_sums(q, k, v, lse, do, d, causal):
    """chip_smoke.py's sums of absolute terms for o, dq, dk, dv: P·|V|,
    |dS|·|K|, |dS|ᵀ·|Q| (|dS| with 2^-7 of its own terms), Pᵀ·|dO|."""
    p, ds = ck._p_ds_bf16(q, k, v, lse, do, d, causal)
    own = torch.einsum("nhqd,nhkd->nhqk", do.float().abs(), v.float().abs())
    own = p * (own + d.abs()[..., None]) / math.sqrt(q.shape[-1])
    ds = ds.to(BF).float().abs() + BF16_ELEM_TOL * own
    return {"o": torch.einsum("nhqk,nhkd->nhqd", p, v.float().abs()),
            "dq": torch.einsum("nhqk,nhkd->nhqd", ds, k.float().abs()),
            "dk": torch.einsum("nhqk,nhqd->nhkd", ds, q.float().abs()),
            "dv": torch.einsum("nhqk,nhqd->nhkd", p, do.float().abs())}


def _hold(name, got, plain, terms, exact):
    g, r = got.double(), plain.double()
    diff = (g - r).abs()
    assert diff.max() <= BF16_TOL * max(1.0, r.abs().max().item()), name
    ratio = (diff / (BF16_ELEM_TOL * (r.abs() + terms.double())).clamp_min(1e-30)).max()
    assert ratio <= 1.0, (name, ratio.item())
    assert diff.norm() <= BF16_FROB_TOL * r.norm(), (name, (diff.norm() / r.norm()).item())
    emu, pln = (g - exact).norm().item(), (r - exact).norm().item()
    assert emu <= F64_RATIO * pln, (name, emu, pln)


def test_tiles_cover_every_head_width():
    for kernel in ("fwd", "dq", "dkv"):
        assert set(ck.FLASH_BF16_TILES[kernel]) == {64, 128, 256}
        for design, br, bc in ck.FLASH_BF16_TILES[kernel].values():
            assert design in ("wgmma", "mma.sync")
            assert br in (64, 128) and bc in (32, 64, 128)
    # the forward's Hopper design stops at the diagonal tile: BR = BC; the
    # dq kernel's two consumers own BR / 2 = BC rows each, so each has one
    # diagonal tile
    _, br, bc = ck.FLASH_BF16_TILES["fwd"][64]
    assert br == bc
    _, br, bc = ck.FLASH_BF16_TILES["dq"][64]
    assert br == 2 * bc


@pytest.mark.parametrize("dh,t,causal", CASES)
def test_forward_tile_order_matches_the_plain_version(dh, t, causal):
    q, k, v, do = _heads(dh, t, seed=dh + t + causal)
    _, _, bc = ck.FLASH_BF16_TILES["fwd"][dh]
    o, lse = emulate_forward(q, k, v, causal, bc)
    p_o, p_lse = ck.flash_attention_plain_bf16(q, k, v, causal, return_lse=True)
    assert (lse - p_lse).abs().max() <= 1e-4
    terms = _term_sums(q, k, v, p_lse, do, torch.zeros(p_lse.shape), causal)
    exact_o = _exact(q, k, v, do, causal)[0]
    _hold("o", o, p_o, terms["o"], exact_o)


@pytest.mark.parametrize("dh,t,causal", CASES)
def test_dkv_tile_order_matches_the_plain_version(dh, t, causal):
    q, k, v, do = _heads(dh, t, seed=dh + t + causal + 7)
    _, _, bc = ck.FLASH_BF16_TILES["dkv"][dh]
    o, lse = ck.flash_attention_plain_bf16(q, k, v, causal, return_lse=True)
    _, d = ck.flash_attention_bwd_dq_plain_bf16(q, k, v, o, lse, do, causal)
    dk, dv = emulate_dkv(q, k, v, lse, do, d, causal, bc)
    p_dk, p_dv = ck.flash_attention_bwd_dkv_plain_bf16(q, k, v, lse, do, d, causal)
    terms = _term_sums(q, k, v, lse, do, d, causal)
    _, exact_dk, exact_dv, _ = _exact(q, k, v, do, causal)
    _hold("dk", dk, p_dk, terms["dk"], exact_dk)
    _hold("dv", dv, p_dv, terms["dv"], exact_dv)


def test_forward_emulation_rounds_p_against_the_running_max():
    """With two key tiles whose maxima differ, rounding P against the
    running max is not rounding it against the final one: the emulation
    differs from the plain version in the low bits, within the limits; a
    copy that skips the rescale of O fails them."""
    q, k, v, do = _heads(64, 256, seed=3)
    k = k.clone()
    k[..., 128:, :] *= 3  # the second tile's scores are larger
    p_o, p_lse = ck.flash_attention_plain_bf16(q, k, v, False, return_lse=True)
    terms = _term_sums(q, k, v, p_lse, do, torch.zeros(p_lse.shape), False)
    exact_o = _exact(q, k, v, do, False)[0]
    o, _ = emulate_forward(q, k, v, False, 128)
    assert not torch.equal(o, p_o)
    _hold("o", o, p_o, terms["o"], exact_o)
    bad, _ = emulate_forward(q, k, v, False, 128, rescale=False)
    with pytest.raises(AssertionError):
        _hold("o", bad, p_o, terms["o"], exact_o)


@pytest.mark.parametrize("dh,t,causal", CASES)
def test_dq_tile_order_matches_the_plain_version(dh, t, causal):
    q, k, v, do = _heads(dh, t, seed=dh + t + causal + 11)
    _, _, bc = ck.FLASH_BF16_TILES["dq"][dh]
    o, lse = ck.flash_attention_plain_bf16(q, k, v, causal, return_lse=True)
    dq, d = emulate_dq(q, k, v, o, lse, do, causal, bc)
    p_dq, p_d = ck.flash_attention_bwd_dq_plain_bf16(q, k, v, o, lse, do, causal)
    assert (d - p_d).abs().max() <= 1e-4
    terms = _term_sums(q, k, v, lse, do, p_d, causal)
    _hold("dq", dq, p_dq, terms["dq"], _exact(q, k, v, do, causal)[3])


@pytest.mark.parametrize("fault", ["diagonal", "d_row"])
def test_dq_emulation_faults_fail_the_limits(fault):
    """A dq kernel that leaves its diagonal tile unmasked, or takes D from
    the neighbouring row, fails the card's limits."""
    q, k, v, do = _heads(64, 256, seed=5)
    _, _, bc = ck.FLASH_BF16_TILES["dq"][64]
    o, lse = ck.flash_attention_plain_bf16(q, k, v, True, return_lse=True)
    p_dq, p_d = ck.flash_attention_bwd_dq_plain_bf16(q, k, v, o, lse, do, True)
    terms = _term_sums(q, k, v, lse, do, p_d, True)
    exact_dq = _exact(q, k, v, do, True)[3]
    _hold("dq", emulate_dq(q, k, v, o, lse, do, True, bc)[0], p_dq, terms["dq"], exact_dq)
    bad, _ = emulate_dq(q, k, v, o, lse, do, True, bc, fault=fault)
    with pytest.raises(AssertionError):
        _hold("dq", bad, p_dq, terms["dq"], exact_dq)
