"""Per-version circuit breaker — quarantine for a crashing forward.

A model version whose forward keeps crashing the batching dispatcher must
not be allowed to take its siblings down with it: every crash costs a
dispatcher restart (shared by ALL versions of the name), so a crash-looping
canary would burn the restart budget that its healthy predecessor needs.
The breaker is the standard three-state machine, one instance per
registered version:

- **closed** — traffic flows to the version normally. Forward crashes
  (``DispatcherCrashed`` with ``dispatched=True`` — the request was in the
  dying batch) are counted in a rolling window; reaching
  ``failure_threshold`` crashes within ``window_s`` trips the breaker.
- **open** — the version is quarantined: no request reaches its forward.
  The registry fails un-pinned traffic over to the fallback chain
  (``ModelRegistry.set_fallback``) while the breaker cools down for
  ``cooldown_s``.
- **half-open** — after the cooldown, exactly ONE probe request at a time
  is allowed through to the real forward; ``half_open_probes`` consecutive
  probe successes close the breaker, any probe failure re-opens it for
  another cooldown. Non-probe traffic keeps failing over the whole time,
  so a still-broken version costs at most one request per cooldown.

Time comes from an injectable ``parallel.time_source.TimeSource``
(``ManualTimeSource`` in tests — every transition is exercised without
sleeping). State is exported as ``serving_breaker_state{model,version}``
(0 closed, 1 open, 2 half-open) by the registry, and every transition is
kept in a bounded in-memory log (and structured-logged when a log hub is
active).

A copy of the JAX package's stdlib-only ``serving/breaker.py``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from deeplearning4j_tpu_torch.observe import log as _slog

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
#: Prometheus encoding of the state (the ``serving_breaker_state`` gauge)
STATE_CODES = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

#: routing verdicts handed to the registry
ALLOW, PROBE, FALLBACK = "allow", "probe", "fallback"


class CircuitBreaker:
    """One version's breaker. Thread-safe; all waits are on the injected
    clock (no sleeps — ``allow()`` only *reads* time)."""

    def __init__(self, *, failure_threshold: int = 3, window_s: float = 30.0,
                 cooldown_s: float = 5.0, half_open_probes: int = 1,
                 time_source=None, name: str = "", max_transitions: int = 64):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if half_open_probes < 1:
            raise ValueError("half_open_probes must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self.half_open_probes = int(half_open_probes)
        self._time_source = time_source
        self.name = name  # "model:version", for logs
        self.state = CLOSED
        self.opened_total = 0  # trips, including half-open re-opens
        self._failures: "deque[float]" = deque()
        self._open_until = 0.0
        self._probe_inflight = False
        self._probe_successes = 0
        self.transitions: "deque[dict]" = deque(maxlen=int(max_transitions))
        self._lock = threading.Lock()
        self._log = _slog.get_logger("serving.breaker")

    # ---------------------------------------------------------------- clock
    def _now(self) -> float:
        if self._time_source is not None:
            return self._time_source.current_time_millis() / 1e3
        return time.monotonic()

    # ------------------------------------------------------------- routing
    def allow(self) -> str:
        """Routing verdict for one request: ``"allow"`` (closed — primary
        path), ``"probe"`` (this request IS the half-open probe; report
        its outcome via ``record_success``/``record_failure``/
        ``abort_probe``) or ``"fallback"`` (quarantined)."""
        with self._lock:
            if self.state == CLOSED:
                return ALLOW
            now = self._now()
            if self.state == OPEN:
                if now < self._open_until:
                    return FALLBACK
                self._transition(HALF_OPEN, "cooldown elapsed", now)
                self._probe_successes = 0
                self._probe_inflight = True
                return PROBE
            # half-open: one probe in flight at a time
            if not self._probe_inflight:
                self._probe_inflight = True
                return PROBE
            return FALLBACK

    # ------------------------------------------------------------ verdicts
    def record_success(self, probe: bool = False) -> None:
        with self._lock:
            if self.state == CLOSED:
                # deliberately NOT clearing the failure window: every
                # crash burns a shared dispatcher restart, so a version
                # crashing on 1-in-N requests (poison input) must still
                # trip once the window accumulates the threshold —
                # interleaved successes age failures out only via time
                return
            if self.state == HALF_OPEN and probe:
                self._probe_inflight = False
                self._probe_successes += 1
                if self._probe_successes >= self.half_open_probes:
                    self._transition(
                        CLOSED,
                        f"{self._probe_successes} probe success(es)",
                        self._now())
                    self._failures.clear()

    def record_failure(self, probe: bool = False) -> None:
        """A real forward crash of this version (the caller filters:
        only ``dispatched`` crashes count — a fast-fail while the
        dispatcher restarts never saw the forward)."""
        with self._lock:
            now = self._now()
            if self.state == HALF_OPEN:
                if probe:
                    self._probe_inflight = False
                self._open(now, "probe failed")
                return
            if self.state == OPEN:
                return  # quarantined already; nothing new learned
            self._failures.append(now)
            while self._failures and \
                    now - self._failures[0] > self.window_s:
                self._failures.popleft()
            if len(self._failures) >= self.failure_threshold:
                self._open(now,
                           f"{len(self._failures)} forward crash(es) "
                           f"within {self.window_s:g}s")

    def abort_probe(self) -> None:
        """The probe never reached the forward (dispatcher restart still
        pending) — release the probe slot without a verdict, so the next
        request can try again."""
        with self._lock:
            if self.state == HALF_OPEN:
                self._probe_inflight = False

    # ------------------------------------------------------------ internals
    def _open(self, now: float, reason: str) -> None:
        self._transition(OPEN, reason, now)
        self._open_until = now + self.cooldown_s
        self.opened_total += 1
        self._failures.clear()

    def _transition(self, to: str, reason: str, now: float) -> None:
        self.transitions.append(
            {"at": now, "from": self.state, "to": to, "reason": reason})
        if _slog.get_active_hub() is not None:
            self._log.warning(
                f"circuit breaker {self.name or 'unnamed'}: "
                f"{self.state} -> {to} ({reason})",
                breaker=self.name, from_state=self.state, to_state=to,
                reason=reason)
        self.state = to

    # -------------------------------------------------------------- queries
    @property
    def code(self) -> int:
        return STATE_CODES[self.state]

    def retry_after_s(self) -> Optional[float]:
        """Seconds until the quarantine could lift (None unless open) —
        the ``Retry-After`` hint when no fallback exists."""
        with self._lock:
            if self.state != OPEN:
                return None
            return max(0.0, self._open_until - self._now())

    def describe(self) -> dict:
        with self._lock:
            return {"state": self.state,
                    "failures_in_window": len(self._failures),
                    "failure_threshold": self.failure_threshold,
                    "opened_total": self.opened_total,
                    "transitions": list(self.transitions)}
