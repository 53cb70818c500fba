"""K3a, the flash-attention forward: its plain version, its seam gate and
its wrapper on CPU tensors (the CUDA kernel itself is tested on the card
by tests/test_torch_cuda.py).

The plain version is held against the reference's
``dot_product_attention`` einsum path (no helper registered; the JAX
package runs it on the CPU as its own tests do) at 5e-5, the f32
tolerance BASELINE.md records for flash vs einsum attention.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.nn.layers.attention import dot_product_attention as j_dpa
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn.layers.attention import dot_product_attention as t_dpa

TOL = 5e-5
F32 = torch.float32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_seams():
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    yield
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    thelpers.set_auto_flash_attention(True)


def _qkv(rng, shape):
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("dh", [64, 128])
def test_plain_matches_reference_einsum(causal, t, dh, rng):
    q, k, v = _qkv(rng, (2, 2, t, dh))
    ref = np.asarray(j_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal))
    got = ck.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), causal)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_supports_gating_mirrors_reference():
    """tests/test_helpers.py's gate table, without the TPU-backend veto."""
    h = ck.FlashAttentionHelper()
    assert h.supports(None, (2, 8, 256, 64), None, False, dtype=F32)
    assert not h.supports(None, (2, 8, 200, 64), None, False, dtype=F32)  # T % 128
    assert not h.supports(None, (2, 8, 256, 48), None, False, dtype=F32)  # dh
    assert not h.supports(None, (2, 8, 256, 64), np.ones((2, 256)), False, dtype=F32)
    assert not h.supports(None, (2, 8, 256, 64), None, True, dtype=F32)  # dropout
    hc = ck.FlashAttentionHelper(causal=True)
    assert hc.supports(None, (2, 8, 256, 64), None, False, causal=True, dtype=F32)
    # a causal kernel never serves a bidirectional request, nor vice versa
    assert not hc.supports(None, (2, 8, 256, 64), None, False, dtype=F32)
    assert not h.supports(None, (2, 8, 256, 64), None, False, causal=True, dtype=F32)
    for dh in (64, 128, 256):
        assert hc.supports(None, (1, 1, 384, dh), None, False, causal=True, dtype=F32)


@pytest.mark.parametrize("causal", [False, True])
def test_wrapper_on_cpu_returns_plain_and_counts_nothing(causal, rng):
    q, k, v = map(torch.from_numpy, _qkv(rng, (1, 2, 128, 64)))
    before = ck.flash_attention_fwd.launches
    got = ck.flash_attention_fwd(q, k, v, causal)
    assert ck.flash_attention_fwd.launches == before == 0
    torch.testing.assert_close(got, ck.flash_attention_plain(q, k, v, causal),
                               rtol=0, atol=0)


def test_seam_order_registered_helper_first(rng):
    """A registered helper is consulted before auto-flash and the plain
    math; unsupported requests fall through to the plain math."""
    calls = []

    class Spy(thelpers.AttentionHelper):
        def supports(self, layer, q_shape, mask, dropout_active, causal=False,
                     dtype=None):
            return q_shape[-2] == 128

        def attend(self, q, k, v):
            calls.append(q.shape)
            return torch.zeros_like(q)

    thelpers.set_helper("attention", Spy())
    q, k, v = map(torch.from_numpy, _qkv(rng, (1, 1, 128, 64)))
    assert t_dpa(q, k, v, causal=True).abs().max() == 0 and len(calls) == 1
    q2, k2, v2 = map(torch.from_numpy, _qkv(rng, (1, 1, 64, 64)))
    ref = np.asarray(j_dpa(*(jnp.asarray(a.numpy()) for a in (q2, k2, v2)),
                           causal=True))
    np.testing.assert_allclose(t_dpa(q2, k2, v2, causal=True).numpy(), ref,
                               rtol=TOL, atol=TOL)
    assert len(calls) == 1


def test_auto_flash_takes_causal_requests_and_opts_out(rng, monkeypatch):
    seen = []
    real = ck.flash_attention_fwd

    def spy(q, k, v, causal=False):
        seen.append((tuple(q.shape), causal))
        return real(q, k, v, causal)

    monkeypatch.setattr(ck, "flash_attention_fwd", spy)
    q, k, v = map(torch.from_numpy, _qkv(rng, (1, 2, 128, 64)))
    t_dpa(q, k, v, causal=True)
    assert seen == [((1, 2, 128, 64), True)]  # no v5e threshold on T
    t_dpa(q, k, v, causal=False)  # bidirectional: not the causal kernel
    v0 = thelpers.version()
    thelpers.set_auto_flash_attention(False)
    assert thelpers.version() == v0 + 1
    t_dpa(q, k, v, causal=True)
    assert len(seen) == 1


def test_seam_registry_api():
    assert thelpers.KINDS == jhelpers.KINDS
    with pytest.raises(ValueError, match="unknown helper kind"):
        thelpers.set_helper("nope", object())
    v0 = thelpers.version()
    h = ck.FlashAttentionHelper(causal=True)
    thelpers.set_helper("attention", h)
    assert thelpers.get_helper("attention") is h and thelpers.version() == v0 + 1
    thelpers.clear_helper("attention")
    assert thelpers.get_helper("attention") is None
    assert thelpers.version() == v0 + 2


def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    q = torch.zeros(1, 1, 128, 64)
    meta = torch.zeros(1, 1, 128, 64, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        ck.flash_attention_fwd(meta, meta, meta)
    with pytest.raises(ValueError, match="one CUDA device"):
        ck.flash_attention_fwd(q, q, meta)


def test_import_needs_no_nvcc():
    """Importing the kernel module compiles nothing and finds no nvcc."""
    code = ("import os, sys; os.environ['PATH'] = '/nonexistent'; "
            "import deeplearning4j_tpu_torch.nn.cuda_kernels as ck; "
            "import deeplearning4j_tpu_torch.nn.layers.attention; "
            "assert ck._libs == {}; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------- K3b: the backward, on the CPU
@pytest.mark.parametrize("shape,causal", [((2, 2, 128, 64), True),
                                          ((1, 2, 256, 128), False)])
def test_autograd_function_matches_jax_vjp(shape, causal, rng):
    """dq, dk, dv of FlashAttentionFunction (the plain versions of the
    forward with LSE and of both backward kernels, on CPU tensors) against
    jax.vjp of the reference's einsum path."""
    q, k, v, do = _qkv(rng, shape) + [rng.normal(size=shape).astype(np.float32)]
    _, vjp = jax.vjp(lambda a, b, c: j_dpa(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    ck.FlashAttentionFunction.apply(*leaves, causal).backward(torch.from_numpy(do))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    o, lse = ck.flash_attention_fwd(*t, causal, return_lse=True)
    whole = ck.flash_attention_bwd_plain(*t, o, lse, torch.from_numpy(do), causal)
    for name, got, plain, ref in zip("qkv", leaves, whole, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   rtol=TOL, atol=TOL, err_msg=f"d{name}")
        np.testing.assert_allclose(plain.numpy(), np.asarray(ref),
                                   rtol=TOL, atol=TOL, err_msg=f"plain d{name}")
    assert ck.flash_attention_bwd_dq.launches == 0
    assert ck.flash_attention_bwd_dkv.launches == 0


@pytest.mark.parametrize("causal", [False, True])
def test_lse_matches_torch_logsumexp(causal, rng):
    q, k, v = map(torch.from_numpy, _qkv(rng, (2, 2, 128, 64)))
    o, lse = ck.flash_attention_fwd(q, k, v, causal, return_lse=True)
    s = q @ k.transpose(-1, -2) / 8.0
    if causal:
        s = s.masked_fill(~torch.ones(128, 128, dtype=torch.bool).tril(),
                          float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(o, ck.flash_attention_plain(q, k, v, causal),
                               rtol=0, atol=0)


def test_attend_writes_lse_only_when_a_gradient_is_wanted(rng, monkeypatch):
    seen = []
    real = ck.flash_attention_fwd

    def spy(q, k, v, causal=False, return_lse=False):
        seen.append(return_lse)
        return real(q, k, v, causal, return_lse)

    monkeypatch.setattr(ck, "flash_attention_fwd", spy)
    h = ck.FlashAttentionHelper(causal=True)
    q, k, v = map(torch.from_numpy, _qkv(rng, (1, 2, 128, 64)))
    with torch.no_grad():
        h.attend(q, k, v)
    h.attend(q, k, v)  # nothing requires grad
    qg = q.clone().requires_grad_(True)
    h.attend(qg, k, v).sum().backward()
    assert seen == [False, False, True] and qg.grad is not None


def test_seam_gradients_flash_path_equal_plain_path(rng):
    """Through the layer-level dot_product_attention: auto-flash (the
    autograd Function) and the plain autograd math give one gradient."""
    q, k, v, do = (torch.from_numpy(a) for a in
                   _qkv(rng, (2, 2, 128, 64)) + [rng.normal(size=(2, 2, 128, 64))
                                                 .astype(np.float32)])
    grads = []
    for auto in (True, False):
        thelpers.set_auto_flash_attention(auto)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        t_dpa(*leaves, causal=True).backward(do)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


# ------------------------------- K3b's 3xTF32 products, emulated on the CPU
# The backward kernels multiply on the tensor cores in TF32 (a 10-bit
# mantissa) and keep f32 accuracy by splitting every operand x into
# big = cvt.rna.tf32.f32(x) and small = cvt.rna.tf32.f32(x - big), and
# summing small.big + big.small + big.big in f32 (small.small dropped).
# These tests emulate that arithmetic to show why it meets the card's
# tolerance (BWD_TOL = 1e-4 x the largest entry in chip_smoke.py).
def _tf32_rna(x):
    """cvt.rna.tf32.f32 on the int32 view of f32: round to a 10-bit
    mantissa, to nearest, ties away from zero; the low 13 bits are 0."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    big = _tf32_rna(x)
    return big, _tf32_rna(x - big)


def _product_3xtf32(a, b):
    """a @ b in f32 as the kernels form it: small terms first."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    acc = as_ @ bb
    acc += ab @ bs
    acc += ab @ bb
    return acc


def test_tf32_split_reconstructs_f32(rng):
    x = (rng.standard_normal(100_000)
         * 10.0 ** rng.uniform(-6, 6, 100_000)).astype(np.float32)
    big, small = _split(x)
    for part in (big, small):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    err = np.abs(x.astype(np.float64) - big.astype(np.float64) - small.astype(np.float64))
    assert (err <= 2.0 ** -21 * np.abs(x.astype(np.float64))).all()
    # to nearest, ties away from zero, in both signs
    tie = np.array([0x3F801000, 0xBF801000, 0x3F800FFF], dtype=np.uint32).view(np.float32)
    assert _tf32_rna(tie).view(np.uint32).tolist() == [0x3F802000, 0xBF802000, 0x3F800000]


def test_backward_products_at_3xtf32_keep_f32_accuracy():
    """The five products of the backward (S = Q K^T, dP = dO V^T,
    dV = P^T dO, dK = dS^T Q, dQ = dS K) at 2x2x128x64, causal, as
    three-term split sums in f32: within 1e-5 (a tenth of the card's
    tolerance) of the f64 result, relative to its largest entry. One TF32
    pass alone (big.big) misses that bound."""
    rng = np.random.default_rng(7)
    n, h, t, dh = 2, 2, 128, 64
    q, k, v, do = (rng.standard_normal((n, h, t, dh)).astype(np.float32)
                   for _ in range(4))
    f64 = [a.astype(np.float64) for a in (q, k, v, do)]
    s = f64[0] @ f64[1].swapaxes(-1, -2) / np.sqrt(dh)
    s = np.where(np.tri(t, dtype=bool), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    d = ((p @ f64[2]) * f64[3]).sum(-1, keepdims=True)
    ds = p * (f64[3] @ f64[2].swapaxes(-1, -2) - d)
    p32, ds32 = p.astype(np.float32), ds.astype(np.float32)
    products = {"S": (q, k.swapaxes(-1, -2)), "dP": (do, v.swapaxes(-1, -2)),
                "dV": (p32.swapaxes(-1, -2), do), "dK": (ds32.swapaxes(-1, -2), q),
                "dQ": (ds32, k)}
    for name, (a, b) in products.items():
        a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
        ref = a.astype(np.float64) @ b.astype(np.float64)
        bound = 1e-5 * np.abs(ref).max()
        got = _product_3xtf32(a, b)
        assert np.abs(got - ref).max() <= bound, name
        one_pass = _tf32_rna(a) @ _tf32_rna(b)
        assert np.abs(one_pass - ref).max() > bound, name


def _forward_tiles(q, k, v, causal, product, bc=64):
    """K3a's forward in its tile order, in f32: over K/V tiles of ``bc``
    keys, S = product(Q, K_tileᵀ) in base-2 units, the causal mask, the
    online softmax (running max, rescaled running sum), and each tile's
    share of P·V computed from zero by ``product`` and added to the
    rescaled O in f32. Returns (O, LSE) of one head [T, Dh]."""
    t, dh = q.shape
    scale_log2 = np.float32(np.log2(np.e) / np.sqrt(dh))
    m = np.full(t, -np.inf, np.float32)
    l = np.zeros(t, np.float32)
    o = np.zeros((t, dh), np.float32)
    rows = np.arange(t)[:, None]
    for k0 in range(0, t, bc):
        s = product(q, np.ascontiguousarray(k[k0:k0 + bc].T)) * scale_log2
        if causal:
            s = np.where(k0 + np.arange(bc)[None, :] > rows, np.float32(-np.inf), s)
        m_new = np.maximum(m, s.max(1))
        alpha = np.exp2(m - m_new)
        p = np.exp2(s - m_new[:, None]).astype(np.float32)
        l = l * alpha + p.sum(1, dtype=np.float32)
        o = o * alpha[:, None] + product(p, np.ascontiguousarray(v[k0:k0 + bc]))
        m = m_new
    return o / l[:, None], (m + np.log2(l)) * np.float32(np.log(2.0))


def test_forward_at_3xtf32_keeps_f32_accuracy():
    """K3a's products as 3xTF32 in its tile order, at T = 1024, Dh = 64,
    causal (the served shape's head): O and LSE within 1e-5 of float64,
    where one TF32 pass (big.big) misses."""
    rng = np.random.default_rng(8)
    t, dh = 1024, 64
    q, k, v = (rng.standard_normal((t, dh)).astype(np.float32) for _ in range(3))
    s = (q.astype(np.float64) @ k.astype(np.float64).T) / np.sqrt(dh)
    s = np.where(np.tri(t, dtype=bool), s, -np.inf)
    lse64 = np.log(np.exp(s - s.max(1, keepdims=True)).sum(1)) + s.max(1)
    o64 = np.exp(s - lse64[:, None]) @ v.astype(np.float64)
    o, lse = _forward_tiles(q, k, v, True, _product_3xtf32)
    assert np.abs(o - o64).max() <= 1e-5
    assert np.abs(lse - lse64).max() <= 1e-5
    one_pass = _forward_tiles(q, k, v, True, lambda a, b: _tf32_rna(a) @ _tf32_rna(b))
    assert np.abs(one_pass[0] - o64).max() > 1e-5


def test_library_path_hashes_the_headers_a_source_includes(tmp_path):
    """An edit of csrc/tf32_mma.cuh builds new attention libraries (both
    sources include it) and leaves the others' paths alone."""
    csrc = tmp_path / "csrc"
    shutil.copytree(ck.CSRC_DIR, csrc)
    before = {s: ck._lib_path(s, str(csrc)) for s in ck.SOURCES}
    assert before == {s: ck._lib_path(s) for s in ck.SOURCES}
    with open(csrc / "tf32_mma.cuh", "a") as f:
        f.write("// an edit\n")
    after = {s: ck._lib_path(s, str(csrc)) for s in ck.SOURCES}
    changed = {s for s in ck.SOURCES if before[s] != after[s]}
    assert changed == {"flash_attention_fwd.cu", "flash_attention_bwd.cu"}
    with open(csrc / "lstm_sequence.cu", "a") as f:
        f.write("// an edit\n")
    assert ck._lib_path("lstm_sequence.cu", str(csrc)) != after["lstm_sequence.cu"]
