"""Admission control: bounded in-flight work, deadlines, graceful drain.

The backpressure seam between the HTTP threads and the batching dispatcher.
Every accepted request holds a slot until its response is written; when all
slots are taken the request is REJECTED immediately with a retry hint (the
429 + ``Retry-After`` path) instead of queueing unboundedly — load sheds at
the front door, so the dispatcher queue can stay small and latency bounded
(the classic admission-control argument: past saturation, added queueing
only converts throughput into latency).

Drain mode is the graceful-shutdown half: new work is refused (503 /
``/readyz`` flips) while in-flight requests finish, then the server can stop
listening with zero dropped responses.

A copy of the JAX package's stdlib-only ``serving/admission.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class AdmissionRejected(RuntimeError):
    """Over capacity — shed with a retry hint (HTTP 429)."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class Draining(RuntimeError):
    """Shutting down — no new work (HTTP 503)."""


class AdmissionController:
    """Counting-semaphore admission with drain support.

    ``max_inflight`` bounds concurrently admitted requests;
    ``retry_after_s`` is the hint handed back on overflow (a fraction of the
    typical batch window is a sane default — the queue turns over quickly).
    """

    def __init__(self, max_inflight: int = 64, *, retry_after_s: float = 1.0,
                 metrics=None):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.max_inflight = int(max_inflight)
        self.retry_after_s = float(retry_after_s)
        self._inflight = 0
        self._draining = False
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._m_inflight = self._m_rejected = None
        if metrics is not None:
            self._m_inflight = metrics.gauge(
                "serving_inflight_requests",
                "Requests admitted and not yet answered")
            self._m_rejected = metrics.counter(
                "serving_admission_rejections_total",
                "Requests shed at admission", ("reason",))

    # ------------------------------------------------------------ admission
    def admit(self) -> "_Slot":
        """Take a slot or raise ``AdmissionRejected`` / ``Draining``.
        Use as a context manager: ``with ctrl.admit(): ...``."""
        with self._lock:
            if self._draining:
                if self._m_rejected is not None:
                    self._m_rejected.inc(reason="draining")
                raise Draining("server is draining")
            if self._inflight >= self.max_inflight:
                if self._m_rejected is not None:
                    self._m_rejected.inc(reason="overflow")
                raise AdmissionRejected(
                    f"{self._inflight} requests in flight "
                    f"(limit {self.max_inflight})", self.retry_after_s)
            self._inflight += 1
            if self._m_inflight is not None:
                self._m_inflight.set(self._inflight)
        return _Slot(self)

    def _release(self) -> None:
        with self._lock:
            self._inflight -= 1
            if self._m_inflight is not None:
                self._m_inflight.set(self._inflight)
            if self._inflight == 0:
                self._idle.notify_all()

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def record_rejection(self, reason: str) -> None:
        """Count a shed decision made OUTSIDE the slot machinery (the
        brownout controller rejects at the front door without ever
        taking a slot) in the same rejection series."""
        if self._m_rejected is not None:
            self._m_rejected.inc(reason=reason)

    # -------------------------------------------------------------- drain
    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def begin_drain(self) -> None:
        with self._lock:
            self._draining = True

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted request released its slot."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._inflight > 0:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._idle.wait(remaining)
            return True


class _Slot:
    """RAII handle for one admitted request."""

    __slots__ = ("_ctrl", "_released")

    def __init__(self, ctrl: AdmissionController):
        self._ctrl = ctrl
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._ctrl._release()

    def __enter__(self) -> "_Slot":
        return self

    def __exit__(self, *exc) -> None:
        self.release()
