"""The training tick that scheduled regularizers read.

Counterpart of ``schedule_tick`` and ``current_schedule_tick`` in
``deeplearning4j_tpu/nn/tick.py``. The fit loops run each step inside
``schedule_tick(iteration, epoch)``; a dropout whose probability is a
``Schedule`` evaluates it at that tick (``nn/dropout.py``). The port's
step runs eagerly, so the tick holds plain host numbers: the reference's
device-resident tick (``device_tick``/``store_tick``), which keeps a
jitted step from re-placing scalars, has no counterpart.
"""

from __future__ import annotations

import contextlib
import threading

_TLS = threading.local()


@contextlib.contextmanager
def schedule_tick(it, ep):
    """Make ``(iteration, epoch)`` visible to schedule-bearing
    configurations while one train step runs. Thread-local, and nested
    ticks restore the outer one."""
    prev = getattr(_TLS, "tick", None)
    _TLS.tick = (float(it), float(ep))
    try:
        yield
    finally:
        _TLS.tick = prev


def current_schedule_tick():
    """``(iteration, epoch)`` of the running train step, or ``(0.0, 0.0)``
    outside one (a scheduled value then takes its initial point)."""
    t = getattr(_TLS, "tick", None)
    return t if t is not None else (0.0, 0.0)
