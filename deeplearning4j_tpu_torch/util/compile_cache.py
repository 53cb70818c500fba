"""Persistent kernel build cache — restarts serve hot from disk.

Counterpart of the JAX package's ``util/compile_cache.py``, which points
JAX's persistent XLA compilation cache at a directory so an identical
compile in a later process loads from disk. The port has no XLA: the
compile it pays at run time is the ``nvcc`` build of a kernel library at
its first use (``nn/cuda_kernels.py`` ``build``), kept in a build directory
and named by a hash of its sources and flags. So the cache here is that
build directory: one call points it at ``cache_dir``, every library not yet
loaded is then built into, or loaded from, there, and a later process
pointed at the same directory (a serving restart, a rollback on the same
sources) loads the built libraries instead of running ``nvcc`` again.
Libraries this process has already loaded stay loaded.
"""

from __future__ import annotations

import os
from typing import Optional

from deeplearning4j_tpu_torch.nn import cuda_kernels


def enable_persistent_compile_cache(cache_dir: str) -> str:
    """Point the kernel build directory at ``cache_dir`` (created if
    missing). Idempotent; returns the directory. Raises ``ValueError`` if a
    DIFFERENT directory is already active — the choice is process-wide and
    silently retargeting it would split the built libraries across two
    directories."""
    cache_dir = os.path.abspath(str(cache_dir))
    active = persistent_compile_cache_dir()
    if active is not None and active != cache_dir:
        raise ValueError(f"persistent compile cache already active at {active}"
                         f"; cannot retarget to {cache_dir}")
    os.makedirs(cache_dir, exist_ok=True)
    cuda_kernels.set_build_dir(cache_dir)
    return cache_dir


def persistent_compile_cache_dir() -> Optional[str]:
    """The active cache directory, or None when not enabled."""
    return cuda_kernels._build_dir
