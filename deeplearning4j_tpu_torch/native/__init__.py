"""Native (C++) runtime components, bound via ctypes.

The reference reaches native code for its ETL and gradient-compression hot
paths (libnd4j threshold kernels, DataVec/JavaCPP loaders — SURVEY.md §2.a).
This package holds the TPU framework's equivalents, compiled from
``src/*.cpp`` with g++ on first use (cached under ``build/``) and loaded with
ctypes — no pybind11 dependency. Every entry point has a pure-Python/numpy
fallback so the framework works without a compiler; ``native_available()``
reports which path is live.

The port's copy of the JAX package's jax-free ``native/__init__.py``: the
same ctypes bindings and numpy fallbacks; the library builds into the port's
gitignored ``build/native/``.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

log = logging.getLogger(__name__)

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
# the port's gitignored build directory, beside the CUDA kernels' libraries
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "build",
                          "native")
_LIB_BASENAME = "libdl4jtpu_native.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _compile() -> Optional[str]:
    sources = [os.path.join(_SRC_DIR, f) for f in sorted(os.listdir(_SRC_DIR))
               if f.endswith(".cpp")]
    if not sources:
        return None
    os.makedirs(_BUILD_DIR, exist_ok=True)
    out = os.path.join(_BUILD_DIR, _LIB_BASENAME)
    stamp = os.path.join(_BUILD_DIR, ".stamp")
    newest_src = max(os.path.getmtime(s) for s in sources)
    if os.path.exists(out) and os.path.exists(stamp) \
            and os.path.getmtime(stamp) >= newest_src:
        return out
    # built under a name of this process's own, then renamed into place:
    # processes that build at once (test workers) never load a half-written
    # library
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-o", tmp] + sources
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        log.warning("native build failed, using Python fallbacks: %s",
                    detail.strip()[:500])
        return None
    os.replace(tmp, out)
    with open(stamp, "w"):
        pass
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _compile()
        if path is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(path)
        c_long = ctypes.c_long
        c_float = ctypes.c_float
        c_void = ctypes.c_void_p
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)

        lib.threshold_encode.restype = c_long
        lib.threshold_encode.argtypes = [fp, c_long, c_float, ip, c_long]
        lib.threshold_decode.restype = None
        lib.threshold_decode.argtypes = [ip, c_long, c_float, fp, c_long]
        lib.threshold_extract.restype = None
        lib.threshold_extract.argtypes = [fp, c_long, c_float, ip, c_long]
        lib.threshold_count.restype = c_long
        lib.threshold_count.argtypes = [fp, c_long, c_float, ctypes.c_int]

        lib.loader_create_mem.restype = c_void
        lib.loader_create_mem.argtypes = [fp, fp, c_long, c_long, c_long,
                                          c_long, ctypes.c_int, ctypes.c_uint,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int]
        lib.loader_create_idx.restype = c_void
        lib.loader_create_idx.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                          ctypes.c_int, c_long, ctypes.c_int,
                                          ctypes.c_uint, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int]
        lib.loader_next.restype = c_long
        lib.loader_next.argtypes = [c_void, fp, fp]
        for name in ("loader_num_examples", "loader_x_elems",
                     "loader_y_elems", "loader_batch"):
            getattr(lib, name).restype = c_long
            getattr(lib, name).argtypes = [c_void]
        lib.loader_reset.restype = None
        lib.loader_reset.argtypes = [c_void]
        lib.loader_rewind.restype = None
        lib.loader_rewind.argtypes = [c_void]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [c_void]

        llp = ctypes.POINTER(ctypes.c_longlong)
        lib.corpus_scan_file.restype = c_void
        lib.corpus_scan_file.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                         ctypes.c_int, llp]
        lib.corpus_scan_fill.restype = None
        lib.corpus_scan_fill.argtypes = [c_void, ctypes.c_char_p, llp]
        lib.corpus_scan_free.restype = None
        lib.corpus_scan_free.argtypes = [c_void]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


from deeplearning4j_tpu_torch.native.codec import (  # noqa: E402,F401
    count_threshold,
    decode_threshold,
    encode_threshold,
    extract_threshold,
)
from deeplearning4j_tpu_torch.native.loader import NativeDataSetIterator  # noqa: E402,F401
