"""Kernel build attribution: each ``nvcc`` build becomes a ``kernel_build`` span.

The port's counterpart of the JAX package's ``observe/jaxhook.py``. The
reference turns XLA's compile events (``jax.monitoring``) into
``xla_compile`` spans; the port has no XLA, and the compile it pays at run
time is the ``nvcc`` build of a kernel library at its first use
(``nn/cuda_kernels.py`` ``build``). Registering one process-wide listener
there turns each real build (never a library found already built) into a
span on the ACTIVE tracer, parented by whatever span is current on the
building thread — a library built inside ``batch_execute`` nests under the
batch that paid for it, and the cost ledger excludes its seconds from the
batch's requests (``Tracer.thread_compile_seconds``).

The listener is installed once per process and is a no-op while no tracer
is active (install is one-way, as the reference's).
"""

from __future__ import annotations

import threading

from deeplearning4j_tpu_torch.observe import trace as _trace

#: the span name a real build is recorded under
BUILD_SPAN = "kernel_build"

_installed = False
_install_lock = threading.Lock()


def _on_build(source: str, duration_s: float) -> None:
    tracer = _trace.get_active_tracer()
    if tracer is None:
        return
    try:
        tracer.note_compile_event(BUILD_SPAN, duration_s)
    except Exception:  # noqa: BLE001 — observability must never break compute
        pass


def install_build_hook() -> bool:
    """Register the build listener with ``nn/cuda_kernels.py`` (idempotent).
    Returns True once installed."""
    global _installed
    with _install_lock:
        if _installed:
            return True
        from deeplearning4j_tpu_torch.nn import cuda_kernels
        cuda_kernels.add_build_listener(_on_build)
        _installed = True
        return True


def hook_installed() -> bool:
    return _installed
