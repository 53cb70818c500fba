"""Hand-written CUDA kernels for Hopper, and their plain PyTorch versions.

Counterpart of ``deeplearning4j_tpu/nn/pallas_kernels.py``. Ported so far:

- K3a, the causal/bidirectional flash-attention forward
  (``PallasFlashAttentionHelper.attend``, ``pallas_kernels.py:359``):
  ``csrc/flash_attention_fwd.cu``, wrapped by :func:`flash_attention_fwd`,
  which can also return the row LSE the backward needs. Like K3b it
  multiplies on the tensor cores at f32 accuracy for f32 heads (3xTF32,
  the helpers of ``csrc/tf32_mma.cuh``), and has a bf16 kernel beside it
  for the mixed-precision path (bf16 products with f32 accumulation; the
  LSE and D stay f32): at Dh 64 the forward, the dq and the dk/dv kernel
  are persistent, warp-specialized ``wgmma`` kernels fed by TMA
  (``csrc/hopper_sm90.cuh``), otherwise ``mma.sync`` ones
  (``csrc/bf16_mma.cuh``); :data:`FLASH_BF16_TILES` names each. Each
  wrapper counts every launch in ``launches`` and its bf16 launches in
  ``launches_bf16``; each bf16 kernel's plain version keeps the TPU
  kernel's rounding points (``flash_attention_plain_bf16`` and the
  ``_bf16`` backward versions).
- K3b, its backward (the bundled kernel's custom VJP): two kernels in
  ``csrc/flash_attention_bwd.cu``, :func:`flash_attention_bwd_dq` (dQ and
  D = rowsum(dO * O)) and :func:`flash_attention_bwd_dkv` (dK, dV).
  :class:`FlashAttentionFunction` ties K3a and K3b into one autograd
  function; :class:`FlashAttentionHelper` serves it at the "attention"
  seam.
- K2, the fused Adam / AMSGrad / Nadam update (``_fused_update_rows``,
  ``pallas_kernels.py:218``, via ``PallasUpdaterHelper.apply`` :280):
  ``csrc/fused_adam.cu``, wrapped by :func:`fused_adam` and served at the
  "updater" seam by :class:`FusedUpdaterHelper`.
- K1, the fused LSTM sequence forward (``_lstm_pallas_fwd``,
  ``pallas_kernels.py:66``, via ``PallasLSTMHelper.forward_seq`` :153):
  ``csrc/lstm_sequence.cu``, wrapped by :func:`lstm_sequence`, in one of
  two plans that :func:`lstm_plan` chooses (thread-block clusters where rw
  fits one cluster's shared memory, else one cooperative grid), for f32
  and, as K1-bf16, for bf16 inputs (the TPU kernel on a bf16 ``xw``; its
  plain version is :func:`lstm_sequence_plain` on bf16 tensors);
  :class:`LSTMSequenceFunction` differentiates it by recomputing the plain
  recurrence (the reference's ``_fused_bwd`` takes the VJP of its plain
  scan: no backward kernel exists in either package), and
  :class:`FusedLSTMHelper` serves it at the "lstm" seam.

Each kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``build/`` beside ``csrc/``
(named by a hash of the source, the headers it includes and the flags),
and loaded with ``ctypes``. Importing this module runs no compiler. A
wrapper launches its kernel for CUDA tensors (or raises: nothing falls
back) and computes the plain version for CPU tensors, which is what the
CPU tests run. Each wrapper's ``launches`` attribute counts its kernel
launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.helpers import (
    AttentionHelper,
    LSTMHelper,
    UpdaterHelper,
)
from deeplearning4j_tpu_torch.nn.updaters import (
    AMSGrad,
    Adam,
    Nadam,
    _adam_alpha,
    _pow1m,
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_build_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _source_bytes(source: str, csrc_dir: str, seen: set) -> bytes:
    """The bytes of ``csrc_dir/source`` followed by those of every header it
    includes with quotes (found beside it), recursively, each once."""
    if source in seen:
        return b""
    seen.add(source)
    with open(os.path.join(csrc_dir, source), "rb") as f:
        text = f.read()
    return text + b"".join(_source_bytes(h.decode(), csrc_dir, seen)
                           for h in _INCLUDE.findall(text))


def _lib_path(source: str, csrc_dir: str = CSRC_DIR) -> str:
    """``build/lib<stem>-<hash>.so``: the hash covers the source, every
    header it includes from ``csrc/`` and the compiler flags, so an edit of
    any of them builds a new library."""
    digest = hashlib.sha256(_source_bytes(source, csrc_dir, set())
                            + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:12]}.so")


def build(source: str) -> str:
    """Compile ``csrc/<source>`` into ``build/`` unless a library built
    from the same source and flags is there. Returns the library path; the
    compiler's report (registers, shared memory, spills) is kept beside it
    as ``<library>.log``. Raises on any failure."""
    out = _lib_path(source)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        with open(out + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load(source: str, symbol: str, argtypes):
    with _build_lock:
        fn = _libs.get(symbol)
        if fn is None:
            lib = ctypes.CDLL(build(source))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[symbol] = fn
    return fn


def build_all() -> float:
    """Build every kernel library now (each ``nvcc`` in its own process,
    all started together); returns the seconds it took."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as ex:
        for fut in [ex.submit(build, s) for s in SOURCES]:
            fut.result()
    return time.perf_counter() - t0


def _on_cpu(name: str, *tensors) -> bool:
    """True when every tensor lies on the CPU (the wrapper then computes
    the plain version); False when all lie on one CUDA device; raises
    otherwise."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors must lie on one CUDA device (or all "
                         f"on the CPU); got {[str(t.device) for t in tensors]}")
    return False


def _launched(err: int, wrapper, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    with _count_lock:
        wrapper.launches += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_device(index: int):
    """``torch.cuda.device(index)``, or nothing to enter when ``index`` is
    already the current device (the common case, and a T = 1 launch's
    host time counts)."""
    if torch.cuda.current_device() == index:
        return contextlib.nullcontext()
    return torch.cuda.device(index)


# --------------------------------------------------- K3: flash attention
_FWD_SRC = "flash_attention_fwd.cu"
_BWD_SRC = "flash_attention_bwd.cu"
_ADAM_SRC = "fused_adam.cu"
_LSTM_SRC = "lstm_sequence.cu"
SOURCES = (_FWD_SRC, _BWD_SRC, _ADAM_SRC, _LSTM_SRC)
_FWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


#: the head types the flash kernels take (the TPU kernel's f32 and bf16)
FLASH_DTYPES = (torch.float32, torch.bfloat16)
_FLASH_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

#: The design and tiles of the bf16 forward ("fwd"), dq ("dq") and dk/dv
#: ("dkv") kernels at each head width, as the C functions choose them:
#: (design, BR resident rows a block, BC streamed rows a tile). "wgmma" is
#: the Hopper design (TMA, mbarriers, warp-specialized wgmma; hopper_sm90.cuh),
#: "mma.sync" the first bf16 kernels' (bf16_mma.cuh). The CPU tests emulate
#: each kernel's tile order from this table; :func:`flash_bf16_tiles` reads
#: the library's own, which a card test holds to it.
FLASH_BF16_TILES = {
    "fwd": {64: ("wgmma", 128, 128), 128: ("mma.sync", 64, 32),
            256: ("mma.sync", 64, 32)},
    "dq": {64: ("wgmma", 128, 64), 128: ("mma.sync", 64, 32),
           256: ("mma.sync", 64, 32)},
    "dkv": {64: ("wgmma", 128, 64), 128: ("mma.sync", 64, 32),
            256: ("mma.sync", 64, 32)},
}
_DESIGNS = ("mma.sync", "wgmma")
_TILE_SYMBOLS = {"fwd": (_FWD_SRC, "dl4j_flash_attention_fwd_bf16_tiles"),
                 "dq": (_BWD_SRC, "dl4j_flash_attention_bwd_dq_bf16_tiles"),
                 "dkv": (_BWD_SRC, "dl4j_flash_attention_bwd_dkv_bf16_tiles")}


def flash_bf16_tiles(kernel: str, dh: int):
    """``(design, BR, BC)`` of the built bf16 ``kernel`` ("fwd", "dq" or "dkv")
    at head width ``dh``, from the library (builds it; needs nvcc)."""
    fn = _load(_TILE_SYMBOLS[kernel][0], _TILE_SYMBOLS[kernel][1],
               [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3)
    design, br, bc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = fn(dh, ctypes.byref(design), ctypes.byref(br), ctypes.byref(bc))
    if err != 0:
        raise ValueError(f"flash_bf16_tiles: no bf16 {kernel} kernel at Dh {dh}")
    return _DESIGNS[design.value], br.value, bc.value


def _check_attention(name: str, heads, rows=()) -> None:
    """Raise unless ``heads`` are contiguous [N,H,T,Dh] tensors of one
    shape and one type the kernels take (f32 or bf16) and ``rows``
    contiguous f32 [N,H,T] ones (the LSE and D are f32 in either case, as
    the TPU kernel's ``l`` and ``m`` are)."""
    dtype = heads[0].dtype
    if dtype not in FLASH_DTYPES or any(t.dtype != dtype for t in heads):
        raise ValueError(f"{name} takes float32 or bfloat16 heads of one type; got "
                         f"{[t.dtype for t in heads]}")
    if any(t.dtype != torch.float32 for t in rows):
        raise ValueError(f"{name} takes float32 row statistics; got "
                         f"{[t.dtype for t in rows]}")
    shape = heads[0].shape
    if heads[0].ndim != 4 or any(t.shape != shape for t in heads):
        raise ValueError(f"{name}: q, k, v (and o, dO) must share one "
                         f"[N,H,T,Dh] shape; got {[tuple(t.shape) for t in heads]}")
    if any(t.shape != shape[:3] for t in rows):
        raise ValueError(f"{name}: row statistics must be [N,H,T] = "
                         f"{tuple(shape[:3])}; got {[tuple(t.shape) for t in rows]}")
    n, h, t, dh = shape
    if dh not in (64, 128, 256) or t % 64 or t == 0 or t // 64 > 65535:
        raise ValueError(f"{name} takes T % 64 == 0 and Dh in (64, 128, 256); "
                         f"got T={t}, Dh={dh}")
    if not all(x.is_contiguous() for x in (*heads, *rows)):
        raise ValueError(f"{name} takes contiguous tensors")
    if n * h > 2 ** 31 - 1:
        raise ValueError(f"N*H = {n * h} exceeds the kernel's grid")


def _counted(wrapper, dtype) -> None:
    """Counts a bf16 launch of ``wrapper``'s kernel apart, in
    ``launches_bf16`` (``launches`` counts every launch)."""
    if dtype == torch.bfloat16:
        with _count_lock:
            wrapper.launches_bf16 += 1


def _scores(q, k, causal):
    """Scaled scores, with the reference einsum path's ``finfo.min`` fill
    (``deeplearning4j_tpu/nn/layers/attention.py:69-83``) above the
    diagonal when causal."""
    scores = torch.einsum("nhqd,nhkd->nhqk", q, k) * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        t_q, t_k = q.shape[-2], k.shape[-2]
        tri = torch.ones((t_q, t_k), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~tri, torch.finfo(scores.dtype).min)
    return scores


def flash_attention_plain(q, k, v, causal: bool = False,
                          return_lse: bool = False):
    """Plain PyTorch version of the forward kernel: ``softmax(q kᵀ / √Dh) v``
    over [N,H,T,Dh]; with ``return_lse`` also the row logsumexp [N,H,T]
    of the scaled, masked scores. bf16 heads take
    :func:`flash_attention_plain_bf16`."""
    if q.dtype == torch.bfloat16:
        return flash_attention_plain_bf16(q, k, v, causal, return_lse)
    scores = _scores(q, k, causal)
    o = torch.einsum("nhqk,nhkd->nhqd", torch.softmax(scores, dim=-1), v)
    return (o, torch.logsumexp(scores, dim=-1)) if return_lse else o


def flash_attention_plain_bf16(q, k, v, causal: bool = False,
                               return_lse: bool = False):
    """The bf16 forward at the TPU kernel's rounding points: S = Q·Kᵀ of the
    bf16 operands in f32, scaled; the softmax statistics in f32; P =
    exp(S − rowmax) rounded to bf16 before P·V, which is accumulated in f32
    and divided by the f32 row sum; O written in bf16, the LSE in f32."""
    s = _scores(q.float(), k.float(), causal)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = (torch.einsum("nhqk,nhkd->nhqd", e.to(torch.bfloat16).float(), v.float())
         / l).to(torch.bfloat16)
    return (o, (m + torch.log(l)).squeeze(-1)) if return_lse else o


def flash_attention_fwd(q, k, v, causal: bool = False,
                        return_lse: bool = False):
    """Flash-attention forward over contiguous f32 or bf16 [N,H,T,Dh]
    tensors; returns ``o`` (in the heads' type), or ``(o, lse)`` with
    ``return_lse`` (the LSE always f32).

    CUDA tensors launch the kernel of their type (T % 64 == 0, Dh in
    {64, 128, 256}) and anything it does not take raises; CPU tensors get
    :func:`flash_attention_plain`."""
    if _on_cpu("flash_attention_fwd", q, k, v):
        return flash_attention_plain(q, k, v, causal, return_lse)
    _check_attention("flash_attention_fwd", (q, k, v))
    n, h, t, dh = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty((n, h, t), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if n * h:
        fn = _load(_FWD_SRC, f"dl4j_flash_attention_fwd_{_FLASH_SUFFIX[q.dtype]}",
                   _FWD_ARGS)
        with _on_device(q.device.index):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     None if lse is None else lse.data_ptr(),
                     n * h, t, dh, int(bool(causal)), _stream(q))
        _launched(err, flash_attention_fwd, "flash_attention_fwd")
        _counted(flash_attention_fwd, q.dtype)
    return (o, lse) if return_lse else o


def _p_ds(q, k, v, lse, do, d, causal):
    """``P = exp(S·scale − LSE)`` (0 above the diagonal when causal: the
    ``finfo.min`` fill underflows) and ``dS = P ∘ (dO Vᵀ − D)``."""
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    return p, p * (torch.einsum("nhqd,nhkd->nhqk", do, v) - d[..., None])


def flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal: bool = False):
    """Plain version of the dq kernel: ``(dQ, D)`` with ``D = rowsum(dO·O)``.
    bf16 heads take :func:`flash_attention_bwd_dq_plain_bf16`."""
    if q.dtype == torch.bfloat16:
        return flash_attention_bwd_dq_plain_bf16(q, k, v, o, lse, do, causal)
    d = torch.sum(do * o, dim=-1)
    _, ds = _p_ds(q, k, v, lse, do, d, causal)
    return torch.einsum("nhqk,nhkd->nhqd", ds, k) * (1.0 / math.sqrt(q.shape[-1])), d


def flash_attention_bwd_dkv_plain(q, k, v, lse, do, d, causal: bool = False):
    """Plain version of the dk/dv kernel: ``(dK, dV)``. bf16 heads take
    :func:`flash_attention_bwd_dkv_plain_bf16`."""
    if q.dtype == torch.bfloat16:
        return flash_attention_bwd_dkv_plain_bf16(q, k, v, lse, do, d, causal)
    p, ds = _p_ds(q, k, v, lse, do, d, causal)
    return (torch.einsum("nhqk,nhqd->nhkd", ds, q) * (1.0 / math.sqrt(q.shape[-1])),
            torch.einsum("nhqk,nhqd->nhkd", p, do))


def _p_ds_bf16(q, k, v, lse, do, d, causal):
    """The bf16 backward's f32 ``P = exp(S·scale − LSE)`` and its ``dS = P ∘
    (dO·Vᵀ − D)·scale`` (scaled before any rounding, as the TPU kernel's),
    from the bf16 operands in f32."""
    p = torch.exp(_scores(q.float(), k.float(), causal) - lse[..., None])
    dp = torch.einsum("nhqd,nhkd->nhqk", do.float(), v.float())
    return p, p * (dp - d[..., None]) * (1.0 / math.sqrt(q.shape[-1]))


def flash_attention_bwd_dq_plain_bf16(q, k, v, o, lse, do, causal: bool = False):
    """The bf16 dq kernel at the TPU kernel's rounding points: ``D =
    rowsum(f32(dO) ∘ f32(O))`` (f32), dS rounded to bf16 before ``dQ =
    dS·K``, which is accumulated in f32 and written in bf16."""
    d = torch.sum(do.float() * o.float(), dim=-1)
    _, ds = _p_ds_bf16(q, k, v, lse, do, d, causal)
    dq = torch.einsum("nhqk,nhkd->nhqd", ds.to(torch.bfloat16).float(), k.float())
    return dq.to(torch.bfloat16), d


def flash_attention_bwd_dkv_plain_bf16(q, k, v, lse, do, d, causal: bool = False):
    """The bf16 dk/dv kernel at the TPU kernel's rounding points: ``dK =
    bf16(dS)ᵀ·Q`` and ``dV = bf16(P)ᵀ·dO``, accumulated in f32 and written
    in bf16."""
    p, ds = _p_ds_bf16(q, k, v, lse, do, d, causal)
    bf = torch.bfloat16
    dk = torch.einsum("nhqk,nhqd->nhkd", ds.to(bf).float(), q.float())
    dv = torch.einsum("nhqk,nhqd->nhkd", p.to(bf).float(), do.float())
    return dk.to(bf), dv.to(bf)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = False):
    """Plain version of the backward: ``(dQ, dK, dV)`` of ``o = attention(q,
    k, v)`` for the upstream gradient ``do``, recomputing
    ``P = exp(S·scale − LSE)`` as the kernels do."""
    dq, d = flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal)
    return (dq, *flash_attention_bwd_dkv_plain(q, k, v, lse, do, d, causal))


def flash_attention_bwd_dq(q, k, v, o, lse, do, causal: bool = False):
    """The dq kernel: ``(dQ, D)``, with D = rowsum(dO·O) [N,H,T] (f32) for
    :func:`flash_attention_bwd_dkv`; f32 or bf16 heads, each type on its
    kernel. Runs on CUDA tensors (or raises); CPU tensors get
    :func:`flash_attention_bwd_dq_plain`."""
    if _on_cpu("flash_attention_bwd_dq", q, k, v, o, lse, do):
        return flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal)
    _check_attention("flash_attention_bwd_dq", (q, k, v, o, do), (lse,))
    n, h, t, dh = q.shape
    dq = torch.empty_like(q)
    d = torch.empty_like(lse)  # f32, as the LSE
    if n * h:
        fn = _load(_BWD_SRC, f"dl4j_flash_attention_bwd_dq_{_FLASH_SUFFIX[q.dtype]}",
                   _BWD_ARGS)
        with _on_device(q.device.index):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), do.data_ptr(), dq.data_ptr(), d.data_ptr(),
                     n * h, t, dh, int(bool(causal)), _stream(q))
        _launched(err, flash_attention_bwd_dq, "flash_attention_bwd_dq")
        _counted(flash_attention_bwd_dq, q.dtype)
    return dq, d


def flash_attention_bwd_dkv(q, k, v, lse, do, d, causal: bool = False):
    """The dk/dv kernel: ``(dK, dV)`` from the LSE of the forward and the
    ``D`` that :func:`flash_attention_bwd_dq` returned. Runs on CUDA
    tensors (or raises); CPU tensors get
    :func:`flash_attention_bwd_dkv_plain`."""
    if _on_cpu("flash_attention_bwd_dkv", q, k, v, lse, do, d):
        return flash_attention_bwd_dkv_plain(q, k, v, lse, do, d, causal)
    _check_attention("flash_attention_bwd_dkv", (q, k, v, do), (lse, d))
    n, h, t, dh = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if n * h:
        fn = _load(_BWD_SRC, f"dl4j_flash_attention_bwd_dkv_{_FLASH_SUFFIX[q.dtype]}",
                   _BWD_ARGS)
        with _on_device(q.device.index):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(),
                     do.data_ptr(), d.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     n * h, t, dh, int(bool(causal)), _stream(q))
        _launched(err, flash_attention_bwd_dkv, "flash_attention_bwd_dkv")
        _counted(flash_attention_bwd_dkv, q.dtype)
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_fwd.launches_bf16 = 0
flash_attention_bwd_dq.launches_bf16 = 0
flash_attention_bwd_dkv.launches_bf16 = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention over contiguous f32 or bf16
    [N,H,T,Dh] tensors: the forward kernel of their type (with its f32 LSE
    saved) and the two backward kernels; on CPU tensors their plain
    versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        # the dq kernel first: it also writes D = rowsum(dO * O) for dk/dv
        dq, d = flash_attention_bwd_dq(q, k, v, o, lse, do, ctx.causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, lse, do, d, ctx.causal)
        return dq, dk, dv, None


class FlashAttentionHelper(AttentionHelper):
    """The "attention" seam's flash kernel, counterpart of
    ``PallasFlashAttentionHelper``. ``supports`` is the reference's gate
    (no mask, no attention dropout, the requested causality, T % 128 == 0,
    Dh in {64, 128, 256}) without its TPU-backend test, plus the kernels'
    types: f32 and bf16 (the TPU kernel's), never f16 or f64. ``attend``
    calls the forward kernel alone when no gradient is wanted (no LSE is
    written), else :class:`FlashAttentionFunction`."""

    def __init__(self, causal: bool = False):
        self.causal = causal

    def supports(self, layer, q_shape, mask, dropout_active,
                 causal=False, *, dtype) -> bool:
        if causal != self.causal:
            # a causal kernel must not serve a bidirectional request and
            # vice versa
            return False
        if mask is not None or dropout_active:
            return False
        if dtype not in FLASH_DTYPES:
            return False
        t, dh = q_shape[-2], q_shape[-1]
        return t % 128 == 0 and dh in (64, 128, 256)

    def attend(self, q, k, v):
        # the layer's QKV split leaves q, k, v as strided views
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttentionFunction.apply(q, k, v, self.causal)
        return flash_attention_fwd(q, k, v, causal=self.causal)


# ------------------------------------------------------ K2: fused Adam
ADAM, AMSGRAD, NADAM = 0, 1, 2
_KINDS = {Adam: ADAM, AMSGrad: AMSGRAD, Nadam: NADAM}
_ADAM_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int]
              + [ctypes.c_float] * 8 + [ctypes.c_void_p])


def adam_coefficients(updater, lr, t):
    """The kernel's scalar arguments ``(b1, b2, 1-b1, 1-b2, eps, c, om1,
    om2)`` in float32, computed on the host in the stock path's order:
    ``c`` is ``alpha = lr·√(1−b2ᵗ)/(1−b1ᵗ)`` for Adam and AMSGrad and
    ``lr`` for Nadam; ``om1 = 1−b1ᵗ``, ``om2 = 1−b2ᵗ``."""
    f32 = np.float32
    b1, b2 = updater.beta1, updater.beta2
    c = (f32(lr) if type(updater) is Nadam
         else _adam_alpha(lr, b1, b2, t))
    return tuple(float(f32(x)) for x in (b1, b2, 1 - b1, 1 - b2,
                                         updater.epsilon, c,
                                         _pow1m(b1, t), _pow1m(b2, t)))


def fused_adam_plain(kind: int, p, m, v, v_hat, g, coef) -> None:
    """Plain version of the kernel, in place on ``p``, ``m``, ``v`` (and
    ``v_hat``): the stock updaters' math (``nn/updaters.py``) on the
    kernel's coefficients."""
    b1, b2, omb1, omb2, eps, c, om1, om2 = coef
    m_new = b1 * m + omb1 * g
    v_new = b2 * v + omb2 * g * g
    if kind == NADAM:
        m_bar = b1 * (m_new / om1) + omb1 * g / om1
        p_new = p - c * m_bar / (torch.sqrt(v_new / om2) + eps)
    else:
        denom = v_new
        if kind == AMSGRAD:
            denom = torch.maximum(v_hat, v_new)
            v_hat.copy_(denom)
        p_new = p - c * m_new / (torch.sqrt(denom) + eps)
    p.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)


def fused_adam(kind: int, p, m, v, v_hat, g, coef) -> None:
    """One fused Adam (``kind`` ADAM), AMSGrad or Nadam step, in place on
    the contiguous f32 tensors ``p``, ``m``, ``v`` (and ``v_hat`` for
    AMSGrad, else None) with gradient ``g``; ``coef`` from
    :func:`adam_coefficients`. CUDA tensors launch the kernel (or raise);
    CPU tensors get :func:`fused_adam_plain`."""
    if kind not in (ADAM, AMSGRAD, NADAM):
        raise ValueError(f"fused_adam: unknown kind {kind!r}")
    if (v_hat is None) != (kind != AMSGRAD):
        raise ValueError("fused_adam: v_hat is AMSGrad's state, and only its")
    ts = (p, m, v, g) if v_hat is None else (p, m, v, g, v_hat)
    if _on_cpu("fused_adam", *ts):
        return fused_adam_plain(kind, p, m, v, v_hat, g, coef)
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"fused_adam takes float32; got {[t.dtype for t in ts]}")
    if any(t.shape != p.shape for t in ts):
        raise ValueError(f"fused_adam: tensors must share one shape; got "
                         f"{[tuple(t.shape) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("fused_adam takes contiguous tensors")
    if p.numel() == 0:
        return None
    fn = _load(_ADAM_SRC, "dl4j_fused_adam_f32", _ADAM_ARGS)
    with torch.cuda.device(p.device):
        err = fn(p.data_ptr(), m.data_ptr(), v.data_ptr(),
                 None if v_hat is None else v_hat.data_ptr(), g.data_ptr(),
                 p.numel(), kind, *coef, _stream(p))
    _launched(err, fused_adam, "fused_adam")
    return None


fused_adam.launches = 0


class FusedUpdaterHelper(UpdaterHelper):
    """The "updater" seam's fused kernel, counterpart of
    ``PallasUpdaterHelper``: one :func:`fused_adam` launch per parameter
    tensor writes the new parameter and moments in place. ``supports`` is
    the reference's gate: exact types Adam, Nadam and AMSGrad (a subclass
    may change the math), float32, ``grad.shape == param.shape``, at least
    one element. Register it with ``helpers.set_helper("updater",
    FusedUpdaterHelper())``."""

    def supports(self, updater, param, grad) -> bool:
        if type(updater) not in _KINDS:
            return False
        return (param.dtype == torch.float32
                and tuple(getattr(grad, "shape", ())) == tuple(param.shape)
                and param.numel() > 0)

    def apply(self, updater, param, grad, state, lr, t):
        kind = _KINDS[type(updater)]
        fused_adam(kind, param, state["m"], state["v"], state.get("v_hat"),
                   grad.to(param.dtype).contiguous(),
                   adam_coefficients(updater, lr, t))
        return param, state


# --------------------------------------------------- K1: fused LSTM sequence
_LSTM_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_LSTM_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}  # K1's, by symbol suffix
_LSTM_CLUSTER_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_CHAIN_ARGS = [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_INT_P = ctypes.POINTER(ctypes.c_int)
_COOPERATIVE_LAUNCH_TOO_LARGE = 720  # cudaErrorCooperativeLaunchTooLarge (CUDA >= 10.1)
LSTM_PLANS = ("auto", "cluster", "grid")
CLUSTER_THREADS = 512  # threads of a CTA of the cluster plan (CTHREADS in the .cu)
PORTABLE_CLUSTER = 8   # the largest cluster every sm_90 launch may take


def _cluster_units(h: int, s: int, elem: int = 4) -> int:
    """U, the hidden units a CTA of the cluster plan owns: ceil(h / s),
    rounded up to even for 2-byte elements (a bf16 CTA copies its xw and
    rw columns two units, 4 bytes, at a time)."""
    u = -(-h // s)
    return u + (u & 1) if elem == 2 else u


def _cluster_mma(h: int, s: int, r: int) -> dict:
    """The bf16 cluster plan's tensor-core geometry (``ClusterLayout`` for
    2-byte elements): the product dᵀ = rw_sliceᵀ·hᵀ has M = 4U gate
    columns padded to ``mp`` (a multiple of 16), N = R rows padded to
    ``np`` (a multiple of 8: n-tiles of 8) and K = H padded to ``kp``
    (a multiple of 16); ``mt`` m-tiles and ``kt`` k-steps of 16; K is split
    into ``ksplit`` parts of ``kc`` k-steps where the m-tiles alone leave
    warps idle (warp w: m-tile w % mt, part w // mt)."""
    mp, kp, np_ = -(-4 * _cluster_units(h, s, 2) // 16) * 16, -(-h // 16) * 16, -(-r // 8) * 8
    mt, kt = mp // 16, kp // 16
    warps = CLUSTER_THREADS // 32
    ksplit = 1 if mt >= warps else warps // mt
    return {"mp": mp, "kp": kp, "np": np_, "mt": mt, "kt": kt, "ksplit": ksplit,
            "kc": -(-kt // ksplit)}


def _cluster_bytes(h: int, s: int, r: int, elem: int = 4) -> int:
    """Bytes of shared memory a CTA of the cluster plan uses (the
    ``ClusterLayout`` of ``csrc/lstm_sequence.cu``, whose launcher refuses
    a plan that gives it fewer bytes), for rw, h and xw elements of
    ``elem`` bytes (4: f32, 2: bf16).

    f32: its slice of rw [hs, 4U]; two h buffers [rp, hs]; the P partial
    sums [P, rp, 4U] f32; two xw buffers [R, 4U]; c and h_t [R, U] in f32.
    ``hs`` is H rounded up to 4, ``rp`` R rounded up to its register block
    (R up to 4 rows, else 4) and P the slices of the H products (threads /
    4U).

    bf16 (tensor-core products, :func:`_cluster_mma`): the slice of rw
    [kp, mp + 8] (each row skewed by 8 for ldmatrix); two h buffers [np, kp
    + 8]; the K parts' partial sums [ksplit, np, mp + 4] f32; two xw
    buffers [R, 4U]; c and h_t [R, U] in f32."""
    u = _cluster_units(h, s, elem)
    cols = 4 * u
    if elem == 2:
        g = _cluster_mma(h, s, r)
        return (2 * (g["kp"] * (g["mp"] + 8) + 2 * g["np"] * (g["kp"] + 8) + 2 * r * cols)
                + 4 * (g["ksplit"] * g["np"] * (g["mp"] + 4) + 2 * r * u))
    hs = -(-h // 4) * 4
    rb = min(r, 4)
    rp = -(-r // rb) * rb
    p = 1 if cols >= CLUSTER_THREADS else CLUSTER_THREADS // cols
    return (elem * (hs * cols + 2 * rp * hs + 2 * r * cols)
            + 4 * (p * rp * cols + 2 * r * u))


def lstm_plan(n: int, h: int, sms: int, smem_per_block: int,
              max_cluster: int = PORTABLE_CLUSTER, cluster_size: int = 0,
              clusters: int = 0, elem: int = 4) -> dict:
    """The plan of the LSTM sequence kernel for ``n`` batch rows at width
    ``h`` on a device with ``sms`` SMs and ``smem_per_block`` bytes of
    opt-in shared memory a block, for elements of ``elem`` bytes (4: the
    f32 kernel, 2: K1-bf16); the single place the choice is made, from the
    shapes and the device's limits alone.

    The cluster plan when one cluster's shared memory holds all of rw: S
    CTAs a cluster (8, or 16 when 8 cannot hold it and ``max_cluster``
    allows; ``cluster_size`` forces one), CTA s owning hidden units [sU,
    sU+U), U = ceil(h/S) (even for bf16), and R batch rows a cluster, R =
    ceil(n / C0) for C0 = ``clusters`` (the clusters that can be resident
    at once, when known) or ``sms // S``, shrunk until the CTA's bytes fit.
    Returns ``{"plan": "cluster", "S", "U", "R", "C", "smem", "elem"}``
    with C = ceil(n/R) clusters and ``smem`` bytes a CTA; else ``{"plan":
    "grid"}`` (the cooperative grid plan, which sizes itself in the
    kernel)."""
    sizes = (cluster_size,) if cluster_size else (8, 16)
    for s in sizes:
        if s < 1 or s > max_cluster or s > 16:
            continue
        resident = clusters or max(1, sms // s)
        r = -(-n // resident)
        while r >= 1 and _cluster_bytes(h, s, r, elem) > smem_per_block:
            r -= 1
        if r >= 1:
            return {"plan": "cluster", "S": s, "U": _cluster_units(h, s, elem),
                    "R": r, "C": -(-n // r), "smem": _cluster_bytes(h, s, r, elem),
                    "elem": elem}
    return {"plan": "grid"}


def lstm_sequence_plain(xw, rw, h0, c0):
    """Plain PyTorch version of the kernel, the counterpart of
    ``_lstm_ref_scan`` (``pallas_kernels.py:98``): over ``xw`` [T,N,4H]
    (``x@W+b``, IFOG blocks), ``rw`` [H,4H] and the carry ``h0``, ``c0``
    [N,H], each step ``z = xw_t + h@rw``, sigmoid i/f/o, tanh g,
    ``c = f·c + i·g``, ``h = o·tanh(c)``. Returns ``(ys [T,N,H], hN, cN)``.

    On bf16 tensors this is the plain version of K1-bf16: each op rounds
    its result to bf16 where the TPU kernel on a bf16 ``xw`` rounds it
    (``_lstm_kernel``, ``pallas_kernels.py:47-48``): ``h@rw`` accumulated
    in f32 and rounded once, ``xw_t +`` that rounded, each gate rounded,
    ``f·c``, ``i·g``, their sum, ``tanh(c)`` and ``o·tanh(c)`` each
    rounded; h and c are carried in bf16."""
    hidden = rw.shape[0]
    h, c = h0, c0
    ys = []
    for xw_t in xw:
        z = xw_t + h @ rw
        i = torch.sigmoid(z[:, :hidden])
        f = torch.sigmoid(z[:, hidden:2 * hidden])
        o = torch.sigmoid(z[:, 2 * hidden:3 * hidden])
        g = torch.tanh(z[:, 3 * hidden:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
    if not ys:
        return xw.new_zeros((0,) + tuple(h0.shape)), h, c
    return torch.stack(ys), h, c


_lstm_limits: dict = {}  # device index -> (sms, smem per block, max cluster)
_lstm_plans: dict = {}   # (device index, n, h, plan, cluster size) -> plan


def _device_lstm_limits(index: int):
    lim = _lstm_limits.get(index)
    if lim is None:
        fn = _load(_LSTM_SRC, "dl4j_lstm_device_limits", [_INT_P] * 3)
        vals = [ctypes.c_int() for _ in range(3)]
        with torch.cuda.device(index):
            err = fn(*(ctypes.byref(v) for v in vals))
        if err != 0:
            raise RuntimeError(f"lstm_sequence: device limits: cudaError {err}")
        lim = _lstm_limits[index] = tuple(v.value for v in vals)
    return lim


def cluster_occupancy(plan: dict, h: int, device=None) -> int:
    """How many clusters of a cluster ``plan`` at width ``h`` can be
    resident at once on ``device`` (``cudaOccupancyMaxActiveClusters``, for
    the kernel of the plan's element size); raises when none can."""
    dev = torch.device(device if device is not None else "cuda")
    fn = _load(_LSTM_SRC, "dl4j_lstm_cluster_occupancy",
               [ctypes.c_int] * 5 + [_INT_P])
    out = ctypes.c_int()
    with torch.cuda.device(dev):
        err = fn(h, plan["S"], plan["R"], plan["smem"], plan["elem"], ctypes.byref(out))
    if err != 0 or out.value < 1:
        raise RuntimeError(f"lstm_sequence: no cluster of {plan['S']} CTAs with "
                           f"{plan['smem']} bytes of shared memory can be scheduled "
                           f"(cudaError {err}, {out.value} clusters)")
    return out.value


def _plan_for(index: int, n: int, h: int, plan: str, cluster_size: int,
              elem: int = 4) -> dict:
    key = (index, n, h, plan, cluster_size, elem)
    got = _lstm_plans.get(key)
    if got is not None:
        return got
    sms, smem, max_cluster = _device_lstm_limits(index)
    got = ({"plan": "grid"} if plan == "grid" else
           lstm_plan(n, h, sms, smem, max_cluster, cluster_size, elem=elem))
    if got["plan"] == "cluster":
        # R from the clusters the card can really hold at once
        resident = cluster_occupancy(got, h, index)
        if resident < got["C"] and got["R"] < n:
            got = lstm_plan(n, h, sms, smem, max_cluster, got["S"], resident, elem)
            cluster_occupancy(got, h, index)
    elif plan == "cluster":
        raise ValueError(f"lstm_sequence: rw [{h},{4 * h}] does not fit the shared "
                         f"memory of one cluster ({smem} bytes a CTA, clusters of "
                         f"{cluster_size or 'up to ' + str(max_cluster)}): take "
                         f"plan='grid'")
    _lstm_plans[key] = got
    return got


def lstm_sequence(xw, rw, h0, c0, units_per_block: int = 0, plan: str = "auto",
                  cluster_size: int = 0):
    """The whole LSTM recurrence in one launch: ``(ys [T,N,H], hN, cN)``
    from ``xw`` [T,N,4H], ``rw`` [H,4H], ``h0``, ``c0`` [N,H], all four
    float32 (K1) or all four bfloat16 (K1-bf16: the TPU kernel on a bf16
    ``xw``, rounding where :func:`lstm_sequence_plain` on bf16 tensors
    rounds; the outputs are bf16). A mix of dtypes raises, bf16 ``xw`` with
    f32 ``h0``/``c0`` included, as the TPU kernel raises on it.

    CUDA tensors launch the kernel and raise on what it does not take.
    ``plan``: "cluster" (thread-block clusters, rw resident in their shared
    memory, h handed over through distributed shared memory; raises where
    rw does not fit), "grid" (one cooperative launch, one grid barrier a
    step; ``units_per_block`` hidden units a block, 0 to spread H over the
    SMs) or "auto" (:func:`lstm_plan`'s choice; the grid plan whenever
    ``units_per_block`` is set). ``cluster_size`` forces S. A refused
    launch raises; nothing retries with the other plan. Inputs that are
    views (a carry sliced from a sequence, an ``RW`` slice) are copied to
    contiguous memory first. CPU tensors get :func:`lstm_sequence_plain`.
    ``lstm_sequence.launches`` counts launches,
    ``lstm_sequence.launches_by_plan`` the same by plan and
    ``lstm_sequence.launches_by_dtype`` by dtype ("f32", "bf16")."""
    if _on_cpu("lstm_sequence", xw, rw, h0, c0):
        return lstm_sequence_plain(xw, rw, h0, c0)
    # checks that cost little: a sampling step launches this for T = 1
    suffix = _LSTM_DTYPES.get(xw.dtype)
    if suffix is None or not (xw.dtype == rw.dtype == h0.dtype == c0.dtype):
        raise ValueError(f"lstm_sequence takes float32 or bfloat16, all four of one "
                         f"dtype; got {[x.dtype for x in (xw, rw, h0, c0)]}")
    if xw.ndim != 3 or xw.shape[2] % 4:
        raise ValueError(f"lstm_sequence: xw must be [T,N,4H]; got {tuple(xw.shape)}")
    t, n, h4 = xw.shape
    hidden = h4 // 4
    if rw.shape != (hidden, h4) or h0.shape != (n, hidden) or c0.shape != (n, hidden):
        raise ValueError(f"lstm_sequence: with xw {tuple(xw.shape)}, rw must be "
                         f"[{hidden},{h4}] and h0, c0 [{n},{hidden}]; got "
                         f"{tuple(rw.shape)}, {tuple(h0.shape)}, {tuple(c0.shape)}")
    if plan not in LSTM_PLANS:
        raise ValueError(f"lstm_sequence: plan must be one of {LSTM_PLANS}; got {plan!r}")
    if units_per_block < 0 or cluster_size < 0:
        raise ValueError("lstm_sequence: units_per_block and cluster_size must be >= 0")
    if units_per_block and plan == "cluster":
        raise ValueError("lstm_sequence: units_per_block drives the grid plan")
    if max(t, n, hidden) > 2 ** 31 - 1:
        raise ValueError("lstm_sequence: T, N and H must fit the kernel's int arguments")
    xw, rw, h0, c0 = xw.contiguous(), rw.contiguous(), h0.contiguous(), c0.contiguous()
    ys = torch.empty((t, n, hidden), dtype=xw.dtype, device=xw.device)
    if t == 0 or n == 0 or hidden == 0:
        return ys, h0.clone(), c0.clone()
    hn, cn = torch.empty_like(h0), torch.empty_like(c0)
    index = xw.device.index
    if index is None:
        index = torch.cuda.current_device()
    chosen = _plan_for(index, n, hidden, "grid" if units_per_block else plan, cluster_size,
                       xw.element_size())
    ptrs = (xw.data_ptr(), rw.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            ys.data_ptr(), hn.data_ptr(), cn.data_ptr())
    with _on_device(index):
        stream = torch.cuda.current_stream().cuda_stream
        if chosen["plan"] == "cluster":
            fn = _load(_LSTM_SRC, f"dl4j_lstm_sequence_cluster_{suffix}", _LSTM_CLUSTER_ARGS)
            err = fn(*ptrs, t, n, hidden, chosen["S"], chosen["R"], chosen["smem"], stream)
        else:
            fn = _load(_LSTM_SRC, f"dl4j_lstm_sequence_{suffix}", _LSTM_ARGS)
            err = fn(*ptrs, t, n, hidden, int(units_per_block), stream)
    if err == _COOPERATIVE_LAUNCH_TOO_LARGE:
        raise RuntimeError(
            f"lstm_sequence: the grid for H={hidden} at {units_per_block or 'the default'} "
            f"units per block cannot be resident at once "
            f"(cudaErrorCooperativeLaunchTooLarge)")
    _launched(err, lstm_sequence, f"lstm_sequence ({suffix}, {chosen['plan']} plan)")
    with _count_lock:
        lstm_sequence.launches_by_plan[chosen["plan"]] += 1
        lstm_sequence.launches_by_dtype[suffix] += 1
    return ys, hn, cn


def reset_lstm_counts() -> None:
    """Set :func:`lstm_sequence`'s launch counts (total, by plan, by dtype)
    to 0."""
    with _count_lock:
        lstm_sequence.launches = 0
        lstm_sequence.launches_by_plan = {"cluster": 0, "grid": 0}
        lstm_sequence.launches_by_dtype = {"f32": 0, "bf16": 0}


reset_lstm_counts()


def lstm_plan_for(xw, cluster_size: int = 0) -> dict:
    """The plan ``lstm_sequence(xw, ...)`` takes with ``plan="auto"`` on
    ``xw``'s CUDA device (with the card's resident-cluster count) and
    dtype."""
    t, n, h4 = xw.shape
    index = xw.device.index if xw.device.index is not None else torch.cuda.current_device()
    return dict(_plan_for(index, n, h4 // 4, "auto", cluster_size, xw.element_size()))


def lstm_chain_floor(t: int, plan: dict, n: int, h: int, device=None) -> torch.Tensor:
    """Launches the chain-floor kernel of a cluster ``plan``: ``t`` steps of
    the hand-over of h through distributed shared memory and the cluster
    barrier, no products and no cell (the least time ``t`` recurrent steps
    can take on that geometry, with h buffers of the plan's element size).
    Returns its [n, h] output (f32)."""
    if plan.get("plan") != "cluster":
        raise ValueError("lstm_chain_floor times the cluster plan")
    dev = torch.device(device if device is not None else "cuda")
    out = torch.empty((n, h), dtype=torch.float32, device=dev)
    suffix = "bf16" if plan["elem"] == 2 else "f32"
    fn = _load(_LSTM_SRC, f"dl4j_lstm_chain_floor_{suffix}", _CHAIN_ARGS)
    with torch.cuda.device(dev):
        err = fn(out.data_ptr(), t, n, h, plan["S"], plan["R"], plan["smem"],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_chain_floor launch failed: cudaError {err}")
    return out


class LSTMSequenceFunction(torch.autograd.Function):
    """Differentiable :func:`lstm_sequence`: the kernel forward; the
    backward recomputes :func:`lstm_sequence_plain` from the saved inputs
    and differentiates it, as the reference's ``_fused_bwd`` takes the VJP
    of ``_lstm_ref_scan`` (``pallas_kernels.py:128-131``); on bf16 leaves
    that is the VJP of the bf16 recurrence, as the reference takes it."""

    @staticmethod
    def forward(ctx, xw, rw, h0, c0):
        ys, hn, cn = lstm_sequence(xw, rw, h0, c0)
        ctx.save_for_backward(xw, rw, h0, c0)
        return ys, hn, cn

    @staticmethod
    def backward(ctx, dys, dhn, dcn):
        saved = ctx.saved_tensors
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        wanted = [t for t in leaves if t.requires_grad]
        with torch.enable_grad():
            outs = lstm_sequence_plain(*leaves)
            got = iter(torch.autograd.grad(outs, wanted, (dys, dhn, dcn),
                                           allow_unused=True,
                                           materialize_grads=True))
        return tuple(next(got) if t.requires_grad else None for t in leaves)


class FusedLSTMHelper(LSTMHelper):
    """The "lstm" seam's fused kernel, counterpart of ``PallasLSTMHelper``.
    ``supports`` is the reference's gate (:147-151): no mask, no peepholes,
    sigmoid gates, tanh cell; and a float32 or bfloat16 layer (the
    kernel's types). ``forward_seq`` hoists ``x@W+b`` into one
    product, runs the recurrence through :func:`lstm_sequence` (through
    :class:`LSTMSequenceFunction` when a gradient is wanted) and returns
    ``(ys [N,T,H], (hN, cN))``. Registered explicitly, it hands a mixed
    carry (f32 h0, c0 against a bf16 ``x``) to the kernel, which raises on
    CUDA tensors, as the reference's registered helper does; the auto seam
    (``nn/layers/recurrent.py``) sends such a carry to the plain loop
    instead (:func:`kernel_dtypes_match`)."""

    def supports(self, layer, mask) -> bool:
        return (mask is None
                and getattr(layer, "dtype", None) in (None, "float32", "bfloat16")
                and not getattr(layer, "peephole", False)
                and layer.gate_activation == "sigmoid"
                and layer.activation in ("tanh",))

    def forward_seq(self, layer, params, x, carry):
        n = x.shape[0]
        if carry is None:
            carry = layer.init_carry(n, x.dtype, x.device)
        h0, c0 = carry
        xw = (x @ params["W"] + params["b"]).transpose(0, 1)  # [T,N,4H]
        rw = params["RW"][:, :4 * layer.n_out]
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (xw, rw, h0, c0)):
            ys, hn, cn = LSTMSequenceFunction.apply(xw, rw, h0, c0)
        else:
            ys, hn, cn = lstm_sequence(xw, rw, h0, c0)
        return ys.transpose(0, 1), (hn, cn)


def kernel_dtypes_match(x, rw, carry) -> bool:
    """Whether K1 (f32) or K1-bf16 takes this LSTM's sequence: ``x`` and
    the recurrent weights ``rw`` share a kernel dtype, and the carry is
    None or of that dtype too. A mixed carry (an f32 TBPTT or
    ``rnn_time_step`` carry under a bf16 compute dtype) takes the plain
    loop, as the reference computes it off the TPU (its TPU kernel raises
    on one)."""
    if x.dtype not in _LSTM_DTYPES or rw.dtype != x.dtype:
        return False
    return carry is None or all(c.dtype == x.dtype for c in carry)
