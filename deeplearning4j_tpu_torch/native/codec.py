"""Python face of the native threshold codec, with numpy fallback.

Same selection/sign semantics as the JAX package's on-device codec
(``parallel/compression.py``), packed as signed 1-based
indices (one int32 per element) — the reference's
``thresholdEncode/thresholdDecode`` message layout for the host/DCN wire.

The port's copy of the JAX package's jax-free ``native/codec.py``: the same
threshold codec and fallbacks.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np


def _as_f32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32).reshape(-1))


def encode_threshold(residual, threshold: float,
                     capacity: Optional[int] = None) -> Optional[np.ndarray]:
    """Encode: returns int32 signed-index message, or None if more than
    ``capacity`` elements pass the threshold (caller sends dense)."""
    from deeplearning4j_tpu_torch import native as _n

    flat = _as_f32(residual)
    cap = len(flat) if capacity is None else int(capacity)
    lib = _n._load()
    if lib is not None:
        out = np.empty(cap, dtype=np.int32)
        count = lib.threshold_encode(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(flat),
            ctypes.c_float(threshold),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        if count < 0:
            return None
        return out[:count].copy()
    # numpy fallback
    idx = np.nonzero(np.abs(flat) >= threshold)[0]
    if len(idx) > cap:
        return None
    return ((idx + 1) * np.sign(flat[idx])).astype(np.int32)


def decode_threshold(message: np.ndarray, threshold: float, size: int,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
    """Apply a message additively onto a dense float32 vector of ``size``.

    When ``out`` is provided it is mutated in place and must be a contiguous
    float32 array (a silent copy would lose the updates). Out-of-range
    indices are dropped on both the native and numpy paths.
    """
    from deeplearning4j_tpu_torch import native as _n

    if out is None:
        out = np.zeros(size, dtype=np.float32)
    elif (not isinstance(out, np.ndarray) or out.dtype != np.float32
          or not out.flags["C_CONTIGUOUS"]):
        raise ValueError("out must be a C-contiguous float32 ndarray "
                         "(in-place application cannot survive a copy)")
    msg = np.ascontiguousarray(message, dtype=np.int32)
    lib = _n._load()
    if lib is not None:
        lib.threshold_decode(
            msg.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(msg),
            ctypes.c_float(threshold),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), size)
        return out
    idx = np.abs(msg) - 1
    ok = (idx >= 0) & (idx < size)  # drop out-of-range like the native path
    np.add.at(out, idx[ok], np.sign(msg[ok]).astype(np.float32) * threshold)
    return out


def extract_threshold(residual: np.ndarray, threshold: float,
                      message: np.ndarray) -> np.ndarray:
    """Subtract an encoded message from the residual in place
    (post-encode bookkeeping: residual -= quantized)."""
    from deeplearning4j_tpu_torch import native as _n

    if (not isinstance(residual, np.ndarray) or residual.dtype != np.float32
            or not residual.flags["C_CONTIGUOUS"]):
        raise ValueError("residual must be a C-contiguous float32 ndarray")
    msg = np.ascontiguousarray(message, dtype=np.int32)
    flat = residual.reshape(-1)
    lib = _n._load()
    if lib is not None:
        lib.threshold_extract(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(flat),
            ctypes.c_float(threshold),
            msg.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(msg))
        return residual
    idx = np.abs(msg) - 1
    ok = (idx >= 0) & (idx < len(flat))
    np.subtract.at(flat, idx[ok],
                   np.sign(msg[ok]).astype(np.float32) * threshold)
    return residual


def count_threshold(values, threshold: float, n_threads: int = 4) -> int:
    """Number of elements that would be encoded — the capacity-sizing pass
    (EncodedGradientsAccumulator.getOptimalBufferSize role)."""
    from deeplearning4j_tpu_torch import native as _n

    flat = _as_f32(values)
    lib = _n._load()
    if lib is not None:
        return int(lib.threshold_count(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(flat),
            ctypes.c_float(threshold), n_threads))
    return int(np.sum(np.abs(flat) >= threshold))
