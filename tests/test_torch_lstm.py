"""The fused LSTM sequence (K1) and the LSTM layers of the port, on the CPU,
against the JAX package.

On CPU tensors ``lstm_sequence`` computes its plain version
(``lstm_sequence_plain``), which is what the kernel is held to on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); here that arithmetic is
held to the JAX package's Pallas kernel run in interpret mode
(``_lstm_pallas_fwd(..., interpret=True)``) and to its plain scan
(``_lstm_ref_scan``), and the gradients of ``LSTMSequenceFunction`` to
``jax.vjp`` of ``lstm_fused``.

The kernel's cluster plan is checked here where the CPU can check it: the
choice of plan (``lstm_plan``, from the shapes and the device's limits),
its ownership of rows and units, its shared-memory bytes, and a torch
emulation of its partition and parity-buffered hand-over of h, held to
the plain recurrence and to the JAX package within 1e-5.

Tolerances, those of the JAX package's own helper tests
(``tests/test_helpers.py``): outputs rtol 2e-5 / atol 2e-6 (:79);
gradients rtol 1e-4 / atol 1e-6 (:97). Float32 both ways; XLA and ATen
sum the recurrent products in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.nn.layers import GravesLSTMLayer as JGraves
from deeplearning4j_tpu.nn.layers import LSTMLayer as JLSTM
from deeplearning4j_tpu.nn.pallas_kernels import (
    _lstm_pallas_fwd,
    _lstm_ref_scan,
    lstm_fused,
)
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn.layers import GravesLSTMLayer, LSTMLayer
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec

RTOL, ATOL = 2e-5, 2e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
SHAPES = [(12, 8, 24), (1, 4, 16), (7, 3, 20)]  # [T, N, H]


@pytest.fixture(autouse=True)
def _clean_seams():
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    yield
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    thelpers.set_auto_fused_lstm(True)


def _inputs(shape, seed=0):
    """xw [T,N,4H], rw [H,4H] (scaled as a Xavier init), non-zero h0, c0."""
    t, n, h = shape
    rng = np.random.default_rng(seed)
    xw = rng.normal(size=(t, n, 4 * h)).astype(np.float32)
    rw = (rng.normal(size=(h, 4 * h)) * np.sqrt(2.0 / (5 * h))).astype(np.float32)
    h0 = (0.5 * rng.normal(size=(n, h))).astype(np.float32)
    c0 = rng.normal(size=(n, h)).astype(np.float32)
    return xw, rw, h0, c0


def _torch(*arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_recurrence_matches_the_pallas_kernel_and_scan(shape):
    args = _inputs(shape)
    kernel = _lstm_pallas_fwd(*map(jnp.asarray, args), interpret=True)
    scan = _lstm_ref_scan(*map(jnp.asarray, args))
    plain = ck.lstm_sequence_plain(*_torch(*args))
    wrapped = ck.lstm_sequence(*_torch(*args))  # CPU tensors: the plain version
    assert ck.lstm_sequence.launches == 0
    for want in (kernel, scan):
        for got, ref, name in zip(plain, want, ("ys", "hN", "cN")):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                       atol=ATOL, err_msg=name)
    for got, ref in zip(wrapped, plain):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert plain[0].shape == shape


@pytest.mark.parametrize("shape", SHAPES)
def test_function_gradients_match_the_fused_vjp(shape):
    args = _inputs(shape, seed=1)
    rng = np.random.default_rng(2)
    t, n, h = shape
    cts = [rng.normal(size=s).astype(np.float32) for s in ((t, n, h), (n, h), (n, h))]
    _, vjp = jax.vjp(lambda *a: lstm_fused(*a, True), *map(jnp.asarray, args))
    want = vjp(tuple(map(jnp.asarray, cts)))
    leaves = _torch(*args, grad=True)
    outs = ck.LSTMSequenceFunction.apply(*leaves)
    got = torch.autograd.grad(outs, leaves, [torch.from_numpy(c) for c in cts])
    for g, w, name in zip(got, want, ("xw", "rw", "h0", "c0")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_function_skips_gradients_nobody_wants():
    xw, rw, h0, c0 = _inputs((4, 2, 8), seed=3)
    leaves = _torch(xw, rw, grad=True) + _torch(h0, c0)
    ys, _, _ = ck.LSTMSequenceFunction.apply(*leaves)
    ys.sum().backward()
    assert leaves[0].grad is not None and leaves[1].grad is not None
    assert leaves[2].grad is None and leaves[3].grad is None


# ------------------------------------------------------------------ layers
def _layer_pair(cls_j, cls_t, n_in=5, n_out=8, seed=4):
    """The same LSTM in both packages, with the JAX layer's initial
    parameters (forget-gate bias included) carried to the port."""
    jl, tl = cls_j(n_in=n_in, n_out=n_out), cls_t(n_in=n_in, n_out=n_out)
    jp = jl.init_params(jax.random.PRNGKey(seed))
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}
    assert {k: tuple(v.shape) for k, v in tp.items()} == tl.param_shapes()
    return jl, jp, tl, tp


def _seq(n=3, t=6, c=5, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, t, c)).astype(np.float32)
    carry = tuple((0.5 * rng.normal(size=(n, 8))).astype(np.float32) for _ in range(2))
    mask = np.ones((n, t), np.float32)
    mask[1, 4:] = 0.0  # a shorter sequence
    mask[2, 2] = 0.0   # and a gap
    return x, carry, mask


@pytest.mark.parametrize("cls_j,cls_t", [(JLSTM, LSTMLayer), (JGraves, GravesLSTMLayer)],
                         ids=["lstm", "graves"])
@pytest.mark.parametrize("with_carry", [False, True], ids=["zero-carry", "carry"])
@pytest.mark.parametrize("with_mask", [False, True], ids=["no-mask", "mask"])
def test_forward_seq_matches_reference(cls_j, cls_t, with_carry, with_mask):
    jl, jp, tl, tp = _layer_pair(cls_j, cls_t)
    x, carry, mask = _seq()
    c_j = tuple(map(jnp.asarray, carry)) if with_carry else None
    c_t = tuple(torch.from_numpy(c) for c in carry) if with_carry else None
    m = mask if with_mask else None
    y_j, (h_j, cc_j) = jl.forward_seq(jp, jnp.asarray(x), carry=c_j,
                                      mask=None if m is None else jnp.asarray(m))
    y_t, (h_t, cc_t) = tl.forward_seq(tp, torch.from_numpy(x), carry=c_t,
                                      mask=None if m is None else torch.from_numpy(m))
    for got, want in ((y_t, y_j), (h_t, h_j), (cc_t, cc_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # forward() is the sequence pass from a zero carry
    y_f, _ = jl.forward(jp, jnp.asarray(x))
    np.testing.assert_allclose(tl.forward(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(y_f), rtol=RTOL, atol=ATOL)


def test_init_params_match_reference_layouts():
    jl, jp, tl, _ = _layer_pair(JGraves, GravesLSTMLayer, n_in=3, n_out=4)
    gen = torch.Generator().manual_seed(0)
    tp = tl.init_params(gen)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape
    np.testing.assert_array_equal(tp["b"].numpy(), np.asarray(jp["b"]))  # IFOG forget bias
    assert tp["b"][4:8].tolist() == [1.0] * 4 and float(tp["b"].abs().sum()) == 4.0
    h, c = tl.init_carry(2)
    assert h.shape == c.shape == (2, 4) and not h.any() and not c.any()


def test_supports_gating():
    h = ck.FusedLSTMHelper()
    std = LSTMLayer(n_in=4, n_out=8)
    assert h.supports(std, None)
    assert not h.supports(std, torch.ones(2, 3))  # masked: the built-in path
    assert not h.supports(GravesLSTMLayer(n_in=4, n_out=8), None)  # peepholes
    assert not h.supports(LSTMLayer(n_in=4, n_out=8, gate_activation="tanh"), None)
    assert not h.supports(LSTMLayer(n_in=4, n_out=8, activation="relu"), None)


class _Spy(ck.FusedLSTMHelper):
    def __init__(self):
        self.calls = 0

    def forward_seq(self, layer, params, x, carry):
        self.calls += 1
        return super().forward_seq(layer, params, x, carry)


def test_auto_gate_on_off_and_version(monkeypatch):
    spy = _Spy()
    monkeypatch.setattr(trec, "_AUTO_LSTM", spy)
    _, _, tl, tp = _layer_pair(JLSTM, LSTMLayer)
    x, carry, mask = _seq()
    xt = torch.from_numpy(x)
    assert thelpers.auto_fused_lstm_enabled()
    fused, _ = tl.forward_seq(tp, xt)
    assert spy.calls == 1  # auto on, no helper: the fused path
    tl.forward_seq(tp, xt, mask=torch.from_numpy(mask))
    assert spy.calls == 1  # a mask: the built-in loop
    _, _, gl, gp = _layer_pair(JGraves, GravesLSTMLayer)
    gl.forward_seq(gp, xt)
    assert spy.calls == 1  # peepholes: the built-in loop
    v0 = thelpers.version()
    thelpers.set_auto_fused_lstm(False)
    assert thelpers.version() == v0 + 1 and not thelpers.auto_fused_lstm_enabled()
    thelpers.set_auto_fused_lstm(False)
    assert thelpers.version() == v0 + 1  # no change, no bump
    plain, _ = tl.forward_seq(tp, xt)
    assert spy.calls == 1  # auto off: the built-in loop
    torch.testing.assert_close(fused, plain, rtol=RTOL, atol=ATOL)
    thelpers.set_auto_fused_lstm(True)
    assert thelpers.version() == v0 + 2


def test_registered_helper_takes_precedence_and_clears(monkeypatch):
    auto = _Spy()
    monkeypatch.setattr(trec, "_AUTO_LSTM", auto)
    reg = _Spy()
    _, _, tl, tp = _layer_pair(JLSTM, LSTMLayer)
    xt = torch.from_numpy(_seq()[0])
    thelpers.set_helper("lstm", reg)
    tl.forward_seq(tp, xt)
    assert (reg.calls, auto.calls) == (1, 0)
    thelpers.clear_helper("lstm")
    tl.forward_seq(tp, xt)
    assert (reg.calls, auto.calls) == (1, 1)


def test_fused_layer_gradients_match_the_loop():
    """The layer's gradient through the seam (the kernel's autograd
    function, its backward the plain recurrence) equals the gradient
    through the built-in loop."""
    _, _, tl, tp = _layer_pair(JLSTM, LSTMLayer)
    x, carry, _ = _seq()
    grads = []
    for auto in (True, False):
        thelpers.set_auto_fused_lstm(auto)
        live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        y, (h, c) = tl.forward_seq(live, torch.from_numpy(x),
                                   carry=tuple(torch.from_numpy(a) for a in carry))
        (y.square().sum() + h.sum() + 2 * c.sum()).backward()
        grads.append({k: v.grad for k, v in live.items()})
    for k in tp:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


# ------------------------------------- K1's cluster plan, checked on the CPU
# lstm_plan chooses the kernel's plan from the shapes and the device's
# limits alone, so its choice is tested here; the H100's: 132 SMs, 227 KB
# of opt-in shared memory a block, clusters of up to 16 CTAs.
H100 = dict(sms=132, smem_per_block=232448, max_cluster=16)


@pytest.mark.parametrize("t,n,h", [(50, 32, 200), (1000, 32, 200), (12, 4, 200),
                                   (1, 4, 200)])
def test_main_path_shapes_take_the_cluster_plan(t, n, h):
    plan = ck.lstm_plan(n, h, **H100)
    assert plan["plan"] == "cluster" and plan["S"] == 8 and plan["U"] == 25
    assert plan["C"] <= H100["sms"] // plan["S"]  # every cluster resident at once
    assert plan["R"] == (2 if n == 32 else 1)


@pytest.mark.parametrize("n,h", [(64, 512), (20, 1500)])
def test_widths_whose_rw_does_not_fit_a_cluster_take_the_grid_plan(n, h):
    assert ck.lstm_plan(n, h, **H100) == {"plan": "grid"}
    # 16 CTAs of 227 KB hold rw up to H of about 450; 8 up to about 330
    assert ck.lstm_plan(n, 440, **H100)["S"] == 16
    assert ck.lstm_plan(n, 320, **H100)["S"] == 8
    assert ck.lstm_plan(n, 440, **dict(H100, max_cluster=8)) == {"plan": "grid"}


@pytest.mark.parametrize("n,h,kw", [(5, 37, {}), (5, 37, {"cluster_size": 16}),
                                    (5, 37, {"sms": 16}), (32, 200, {}),
                                    (32, 200, {"cluster_size": 16}), (1, 9, {}),
                                    (300, 200, {}), (7, 450, {"cluster_size": 16}),
                                    (33, 64, {"clusters": 5})])
def test_cluster_plan_owns_every_row_and_unit_once(n, h, kw):
    limits = dict(H100, **{k: v for k, v in kw.items() if k in H100})
    plan = ck.lstm_plan(n, h, limits["sms"], limits["smem_per_block"],
                        limits["max_cluster"], kw.get("cluster_size", 0),
                        kw.get("clusters", 0))
    assert plan["plan"] == "cluster"
    s, u, r, c = plan["S"], plan["U"], plan["R"], plan["C"]
    rows = np.zeros(n, int)
    for cl in range(c):
        rows[cl * r:min(n, cl * r + r)] += 1
    units = np.zeros(h, int)
    for rank in range(s):
        units[rank * u:min(h, rank * u + u)] += 1
    assert (rows == 1).all() and (units == 1).all()
    assert (c - 1) * r < n  # no cluster without a row


@pytest.mark.parametrize("smem", [232448, 100_000, 48 * 1024, 20_000])
@pytest.mark.parametrize("n,h", [(32, 200), (4, 200), (300, 128), (5, 37)])
def test_cluster_plan_fits_the_shared_memory_it_is_given(smem, n, h):
    plan = ck.lstm_plan(n, h, 132, smem, 16)
    if plan["plan"] == "grid":  # only when rw alone overflows 16 CTAs
        assert 4 * h * 4 * -(-h // 16) > smem
        return
    assert plan["smem"] <= smem
    assert plan["smem"] == ck._cluster_bytes(h, plan["S"], plan["R"])
    # the largest R that fits: one more row would not
    if plan["R"] < -(-n // (132 // plan["S"])):
        assert ck._cluster_bytes(h, plan["S"], plan["R"] + 1) > smem


def _bf16_mma_sums(hb, rw_cols, h, plan, fault=None):
    """``hb @ rw_cols`` (f32) in K1-bf16's tensor-core order
    (``ck._cluster_mma``): the CTA's rw slice as the A operand [kp, mp] and
    its h buffer as B [np, kp], both zero past H, past the real columns and
    past the real rows; each K part's k-steps of 16 chained in an f32
    accumulator from zero; the parts added in f32. ``fault="h_padding"``
    leaves the h buffer's K padding holding non-finite bits (shared memory
    not zeroed), which the zero padding of rw cannot cancel: 0 x inf is
    NaN."""
    g = ck._cluster_mma(h, plan["S"], plan["R"])
    rows, m = hb.shape[0], rw_cols.shape[1]
    a = torch.zeros(g["kp"], g["mp"])
    a[:h, :m] = rw_cols.float()
    b = torch.zeros(g["np"], g["kp"])
    b[:rows, :h] = hb.float()
    if fault == "h_padding":
        b[:, h:] = float("inf")
    d = torch.zeros(g["np"], g["mp"])
    for part in range(g["ksplit"]):
        acc = torch.zeros(g["np"], g["mp"])
        for kk in range(part * g["kc"], min(g["kt"], (part + 1) * g["kc"])):
            acc = acc + b[:, 16 * kk:16 * kk + 16] @ a[16 * kk:16 * kk + 16]
        d = d + acc
    return d[:rows, :m]


def _cluster_emulation(xw, rw, h0, c0, plan, fault=None):
    """The cluster plan's partition and hand-over in torch: one cluster per
    slice of R rows, CTA s computing the gate columns of units [sU, sU+U)
    from ITS OWN copy of h_{t-1}, then writing its units of h_t into buffer
    (t+1)&1 of every CTA of the cluster. Buffer t&1 is never written during
    step t (asserted), which is what one barrier a step relies on. On f32
    inputs each column is a sum of the P slices of the H products, as the
    kernel's threads split them. On bf16 inputs (K1-bf16) the products run
    in the tensor-core order of :func:`_bf16_mma_sums` (``fault`` passes
    to it), are rounded once before ``xw`` is added, and every later op
    rounds to bf16, as the kernel's ``cell_bf16`` does."""
    t_len, n, h4 = xw.shape
    h = h4 // 4
    s, u, r = plan["S"], plan["U"], plan["R"]
    cols = 4 * u
    p = 1 if cols >= ck.CLUSTER_THREADS else ck.CLUSTER_THREADS // cols
    hs = -(-h // 4) * 4
    ks = -(-(-(-hs // p)) // 4) * 4
    slices = [(k0, min(h, k0 + ks)) for k0 in range(0, p * ks, ks) if k0 < h]
    ys = torch.zeros(t_len, n, h, dtype=xw.dtype)
    hn, cn = torch.zeros(n, h, dtype=xw.dtype), torch.zeros(n, h, dtype=xw.dtype)
    for row0 in range(0, n, r):
        rows = slice(row0, min(n, row0 + r))
        hbuf = [[h0[rows].clone(), torch.zeros_like(h0[rows])] for _ in range(s)]
        cst = [c0[rows, rank * u:min(h, rank * u + u)].clone() for rank in range(s)]
        for t in range(t_len):
            reading = [hbuf[rank][t & 1].clone() for rank in range(s)]
            for rank in range(s):
                u0, uc = rank * u, max(0, min(u, h - rank * u))
                if uc == 0:
                    continue
                idx = torch.tensor([g * h + u0 + k for g in range(4) for k in range(uc)])
                hb = hbuf[rank][t & 1]
                if xw.dtype == torch.bfloat16:  # the f32 sums, rounded once
                    d = _bf16_mma_sums(hb, rw[:, idx], h, plan, fault)
                    z = xw[t, rows][:, idx] + d.bfloat16()
                else:
                    z = xw[t, rows][:, idx].clone()
                    for k0, k1 in slices:
                        z += hb[:, k0:k1] @ rw[k0:k1][:, idx]
                i, f, o, g = (z[:, j * uc:(j + 1) * uc] for j in range(4))
                c = torch.sigmoid(f) * cst[rank] + torch.sigmoid(i) * torch.tanh(g)
                hv = torch.sigmoid(o) * torch.tanh(c)
                cst[rank] = c
                ys[t, rows, u0:u0 + uc] = hv
                for peer in range(s):  # distributed shared memory
                    hbuf[peer][(t + 1) & 1][:, u0:u0 + uc] = hv
            for rank in range(s):  # bit for bit (a NaN too)
                bits = torch.int16 if xw.dtype == torch.bfloat16 else torch.int32
                assert torch.equal(hbuf[rank][t & 1].view(bits), reading[rank].view(bits))
        for rank in range(s):
            u0, uc = rank * u, max(0, min(u, h - rank * u))
            hn[rows, u0:u0 + uc] = ys[-1, rows, u0:u0 + uc]
            cn[rows, u0:u0 + uc] = cst[rank]
    return ys, hn, cn


@pytest.mark.parametrize("shape,kw", [((12, 5, 37), {"sms": 16}),
                                      ((12, 5, 37), {"cluster_size": 16}),
                                      ((9, 4, 40), {}), ((6, 3, 9), {})])
def test_cluster_partition_emulation_matches_plain_and_reference(shape, kw):
    t, n, h = shape
    plan = ck.lstm_plan(n, h, kw.get("sms", 132), 232448, 16, kw.get("cluster_size", 0))
    assert plan["plan"] == "cluster"
    args = _inputs(shape, seed=11)
    got = _cluster_emulation(*_torch(*args), plan)
    plain = ck.lstm_sequence_plain(*_torch(*args))
    scan = _lstm_ref_scan(*map(jnp.asarray, args))
    fused = lstm_fused(*map(jnp.asarray, args), True)  # the Pallas kernel, interpreted
    for ref in (plain, scan, fused):
        for g, want, name in zip(got, ref, ("ys", "hN", "cN")):
            want = np.asarray(want)
            bound = 1e-5 * max(1.0, float(np.abs(want).max()))
            assert np.abs(g.numpy() - want).max() <= bound, name


# ------------------------------------------ K1-bf16's cluster plan, on the CPU
@pytest.mark.parametrize("t,n,h,s_want,u_want", [(128, 64, 512, 16, 32), (50, 32, 200, 8, 26),
                                                 (12, 4, 200, 8, 26), (5, 7, 37, 8, 6),
                                                 (3, 5, 9, 8, 2)])
def test_bf16_plans_count_bytes_by_element_size(t, n, h, s_want, u_want):
    """bf16 rw, h and xw take 2 bytes (the partial sums stay f32): H = 512
    fits a cluster of 16 in bf16 where the f32 rw fits none; a bf16 CTA
    owns an even number of units; the plan's bytes are ClusterLayout's and
    the largest R that fits."""
    plan = ck.lstm_plan(n, h, elem=2, **H100)
    assert plan["plan"] == "cluster" and plan["elem"] == 2
    assert (plan["S"], plan["U"]) == (s_want, u_want) and plan["U"] % 2 == 0
    assert plan["smem"] == ck._cluster_bytes(h, plan["S"], plan["R"], 2) <= H100["smem_per_block"]
    if plan["R"] < -(-n // (H100["sms"] // plan["S"])):
        assert ck._cluster_bytes(h, plan["S"], plan["R"] + 1, 2) > H100["smem_per_block"]
    units = np.zeros(h, int)
    for rank in range(plan["S"]):
        units[rank * plan["U"]:min(h, rank * plan["U"] + plan["U"])] += 1
    assert (units == 1).all()
    if h == 512:
        assert ck.lstm_plan(n, h, **H100) == {"plan": "grid"}
    # the tensor-core layout: rw [kp][mp + 8], two h buffers [np][kp + 8]
    # (2 bytes), the K parts' sums [ksplit][np][mp + 4] (f32), then the xw
    # buffers, c and h_t as before
    g = ck._cluster_mma(h, plan["S"], plan["R"])
    r, cols = plan["R"], 4 * plan["U"]
    assert (g["mp"], g["kp"], g["np"]) == (-(-cols // 16) * 16, -(-h // 16) * 16,
                                            -(-r // 8) * 8)
    assert g["mt"] * g["ksplit"] <= 16 and g["ksplit"] * g["kc"] >= g["kt"]
    assert plan["smem"] == (2 * (g["kp"] * (g["mp"] + 8) + 2 * g["np"] * (g["kp"] + 8)
                                 + 2 * r * cols)
                            + 4 * (g["ksplit"] * g["np"] * (g["mp"] + 4) + 2 * r * plan["U"]))
    # f32's count is 4 bytes an element throughout, as before bf16
    assert ck._cluster_bytes(h, 8, 3) == ck._cluster_bytes(h, 8, 3, 4)


def test_bf16_path_plan_on_the_card():
    """[128, 64, 512] with the 7 clusters of 16 the H100 holds: R = 10, 8
    m-tiles of 16 gate columns, two K parts of 16 k-steps (every warp of the
    CTA busy), 197,120 bytes a CTA."""
    plan = ck.lstm_plan(64, 512, clusters=7, elem=2, **H100)
    assert (plan["S"], plan["U"], plan["R"], plan["C"]) == (16, 32, 10, 7)
    assert ck._cluster_mma(512, 16, 10) == {"mp": 128, "kp": 512, "np": 16, "mt": 8,
                                            "kt": 32, "ksplit": 2, "kc": 16}
    assert plan["smem"] == 197120


@pytest.mark.parametrize("shape,kw", [((12, 5, 37), {"sms": 16}), ((9, 4, 40), {}),
                                      ((6, 3, 9), {}), ((7, 6, 64), {"cluster_size": 16})])
def test_bf16_cluster_partition_emulation_matches_plain_and_reference(shape, kw):
    """The bf16 plan's partition and hand-over (even U, the slices' f32
    sums rounded once) against the plain bf16 recurrence at the card's
    limits (each entry within 128 units of 2^-8 x max(|plain|, 2^-6), the
    whole within 5e-3 relative Frobenius) and the JAX package's Pallas
    kernel on bf16 within 2^-5."""
    t, n, h = shape
    plan = ck.lstm_plan(n, h, kw.get("sms", 132), 232448, 16, kw.get("cluster_size", 0),
                        elem=2)
    assert plan["plan"] == "cluster" and plan["U"] % 2 == 0
    args = [torch.from_numpy(a).bfloat16() for a in _inputs(shape, seed=12)]
    got = _cluster_emulation(*args, plan)
    plain = ck.lstm_sequence_plain(*args)
    kernel = _lstm_pallas_fwd(*(jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in args),
                              interpret=True)
    for g, p, k, name in zip(got, plain, kernel, ("ys", "hN", "cN")):
        assert g.dtype == torch.bfloat16, name
        gd, pd = g.double(), p.double()
        units = (gd - pd).abs() / (2.0 ** -8 * pd.abs().clamp_min(2.0 ** -6))
        assert units.max().item() <= 128.0, name
        assert ((gd - pd).norm() / pd.norm()).item() <= 5e-3, name
        assert np.abs(gd.numpy() - np.asarray(k, np.float64)).max() <= 2.0 ** -5, name


# K1-bf16's tensor-core products at the card's geometry: the clusters the
# H100 holds at once (the card's readings: 15 of 8 CTAs at H = 200, 7 of 16 at
# H = 512) give R = 3 at [50, 32, 200] and [8, 16, 512], R = 1 at [12, 4, 200]
LSTM_BF16_ELEM_TOL, LSTM_BF16_FROB_TOL, LSTM_BF16_F64_RATIO = 128.0, 5e-3, 1.05
CARD_CLUSTERS = {200: 15, 512: 7}


def _bf16_tensor_core_run(shape, fault=None):
    t, n, h = shape
    plan = ck.lstm_plan(n, h, clusters=CARD_CLUSTERS[h], elem=2, **H100)
    assert plan["plan"] == "cluster"
    args = [torch.from_numpy(a).bfloat16() for a in _inputs(shape, seed=13)]
    got = _cluster_emulation(*args, plan, fault=fault)
    return args, plan, got


def _hold_bf16(got, plain, exact):
    """chip_smoke.py's K1-bf16 limits, over ys, hN and cN together."""
    g = torch.cat([x.double().reshape(-1) for x in got])
    p = torch.cat([x.double().reshape(-1) for x in plain])
    e = torch.cat([x.reshape(-1) for x in exact])
    units = (g - p).abs() / (2.0 ** -8 * p.abs().clamp_min(2.0 ** -6))
    assert units.max().item() <= LSTM_BF16_ELEM_TOL, units.max().item()
    assert ((g - p).norm() / p.norm()).item() <= LSTM_BF16_FROB_TOL
    ratio = ((g - e).norm() / (p - e).norm().clamp_min(1e-30)).item()
    assert ratio <= LSTM_BF16_F64_RATIO, ratio


@pytest.mark.parametrize("shape", [(50, 32, 200), (12, 4, 200), (8, 16, 512)])
def test_bf16_tensor_core_order_matches_plain_and_reference(shape):
    """The recurrent products as K1-bf16's cluster plan runs them on the
    tensor cores (padded M, N, K with zeros, k-steps of 16 chained in f32,
    K parts added in f32; [50, 32, 200] pads M 104 -> 112, N 3 -> 8 and K
    200 -> 208) against the plain bf16 recurrence within the card's limits
    and the JAX package's Pallas kernel on bf16 within 2^-5."""
    args, plan, got = _bf16_tensor_core_run(shape)
    g = ck._cluster_mma(shape[2], plan["S"], plan["R"])
    if shape[2] == 200:
        assert (g["mp"], g["kp"], g["np"]) == (112, 208, 8)
    plain = ck.lstm_sequence_plain(*args)
    exact = ck.lstm_sequence_plain(*(a.double() for a in args))
    _hold_bf16(got, plain, exact)
    kernel = _lstm_pallas_fwd(*(jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in args),
                              interpret=True)
    for x, k, name in zip(got, kernel, ("ys", "hN", "cN")):
        assert np.abs(x.double().numpy() - np.asarray(k, np.float64)).max() <= 2.0 ** -5, name


def test_bf16_tensor_core_order_rejects_an_unzeroed_h_buffer():
    """A copy that leaves the h buffer's K padding (columns H..kp) holding
    whatever shared memory held (here inf) fails the limits: the zeros of
    rw's padding cannot cancel it."""
    args, _, got = _bf16_tensor_core_run((12, 4, 200), fault="h_padding")
    plain = ck.lstm_sequence_plain(*args)
    exact = ck.lstm_sequence_plain(*(a.double() for a in args))
    with pytest.raises(AssertionError):
        _hold_bf16(got, plain, exact)
