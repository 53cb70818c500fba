"""Brownout degradation: shed the cheapest traffic first, serve the rest
on a cheaper version, recover automatically.

The load-shedding / graceful-degradation pattern (SRE Workbook "Managing
Load"): when the serving tier saturates, failing a uniform random slice of
traffic is the WORST policy — better to (1) shed the lowest-priority
requests outright at the front door and (2) degrade what still serves
(route un-pinned predicts to the registry's fallback chain — typically the
previous or int8-quantized version) until pressure clears. Both halves are
driven by this controller; the :class:`~.server.ModelServer` consults it
once per request (cheap: two counter reads, no locks beyond the
controller's own).

Pressure signals, OR-ed:

- **admission saturation**: in-flight slots at or above ``saturation`` of
  ``max_inflight``;
- **firing alert rules**: any rule named in ``watch_rules`` currently
  firing on the attached ``AlertManager`` — this is how a latency
  burn-rate rule (the SLO machinery from round 8) triggers brownout
  *before* the queue is visibly full.

Hysteresis: pressure must hold for ``enter_after_s`` before the brownout
engages, and must stay clear for ``exit_after_s`` before it lifts —
flapping load cannot flap the policy. Time comes from an injectable
``parallel.time_source.TimeSource`` (tests use ``ManualTimeSource``).

Request priorities ride the ``X-Priority`` header: ``0`` = batch /
best-effort, ``1`` = standard (the default), ``2`` = interactive. While
the brownout is active, requests with priority <= ``shed_below`` are shed
with 429 + ``Retry-After``; everything else serves (degraded when
``degrade=True`` and the registry designates a fallback).

State is exported as ``serving_brownout_active`` (gauge) and every
transition is structured-logged; shed/degraded requests land in
``serving_admission_rejections_total{reason="brownout"}`` and
``serving_degraded_requests_total{model,reason="brownout"}``.

The port's copy of the JAX package's stdlib-only ``serving/brownout.py``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional, Sequence

from deeplearning4j_tpu_torch.observe import log as _slog

#: X-Priority conventions (any int is accepted; these name the contract)
PRIORITY_BATCH, PRIORITY_STANDARD, PRIORITY_INTERACTIVE = 0, 1, 2


class BrownoutController:
    """Saturation/alert-driven degradation state machine."""

    def __init__(self, *, admission=None, alerts=None,
                 watch_rules: Sequence[str] = (),
                 saturation: float = 0.9,
                 enter_after_s: float = 1.0, exit_after_s: float = 5.0,
                 shed_below: int = PRIORITY_BATCH,
                 degrade: bool = True,
                 retry_after_s: float = 0.25,
                 time_source=None, metrics=None,
                 max_transitions: int = 64):
        if not 0.0 < float(saturation) <= 1.0:
            raise ValueError(f"saturation must be in (0, 1], "
                             f"got {saturation}")
        self.admission = admission
        self.alerts = alerts
        self.watch_rules = tuple(watch_rules)
        self.saturation = float(saturation)
        self.enter_after_s = float(enter_after_s)
        self.exit_after_s = float(exit_after_s)
        self.shed_below = int(shed_below)
        self.degrade = bool(degrade)
        self.retry_after_s = float(retry_after_s)
        self._time_source = time_source
        self.active = False
        self._pressure_since: Optional[float] = None
        self._clear_since: Optional[float] = None
        self._last_reason = ""
        self.transitions: "deque[dict]" = deque(maxlen=int(max_transitions))
        self._lock = threading.Lock()
        self._log = _slog.get_logger("serving.brownout")
        self._m_active = None
        if metrics is not None:
            self._m_active = metrics.gauge(
                "serving_brownout_active",
                "1 while brownout degradation (priority shedding + "
                "fallback routing) is engaged")
            self._m_active.set(0)

    # ---------------------------------------------------------------- clock
    def _now(self) -> float:
        if self._time_source is not None:
            return self._time_source.current_time_millis() / 1e3
        return time.monotonic()

    # ------------------------------------------------------------- pressure
    def _pressure(self) -> Optional[str]:
        """The firing pressure signal's name, or None when clear."""
        if self.admission is not None and self.admission.max_inflight > 0:
            inflight = self.admission.inflight
            if inflight >= self.saturation * self.admission.max_inflight:
                return (f"admission saturation "
                        f"{inflight}/{self.admission.max_inflight}")
        if self.alerts is not None and self.watch_rules:
            firing = set(self.alerts.firing())
            hit = sorted(firing.intersection(self.watch_rules))
            if hit:
                return f"alert rule(s) firing: {', '.join(hit)}"
        return None

    def observe(self) -> bool:
        """Advance the state machine against the current signals; returns
        whether the brownout is active. Called once per request by the
        server (and directly by tests)."""
        reason = self._pressure()
        with self._lock:
            now = self._now()
            if reason is not None:
                self._clear_since = None
                if self._pressure_since is None:
                    self._pressure_since = now
                if (not self.active
                        and now - self._pressure_since
                        >= self.enter_after_s):
                    self._transition(True, reason, now)
            else:
                self._pressure_since = None
                if self.active:
                    if self._clear_since is None:
                        self._clear_since = now
                    if now - self._clear_since >= self.exit_after_s:
                        self._transition(
                            False, "pressure clear "
                            f"for {self.exit_after_s:g}s", now)
            return self.active

    def _transition(self, active: bool, reason: str, now: float) -> None:
        self.transitions.append({"at": now, "active": active,
                                 "reason": reason})
        self._last_reason = reason
        if _slog.get_active_hub() is not None:
            self._log.warning(
                f"brownout {'ENGAGED' if active else 'lifted'}: {reason}",
                active=active, reason=reason)
        self.active = active
        if self._m_active is not None:
            self._m_active.set(1 if active else 0)

    # --------------------------------------------------------------- policy
    def should_shed(self, priority: int) -> bool:
        """Shed this request at the door? (Only while active.)"""
        return self.active and priority <= self.shed_below

    def describe(self) -> dict:
        with self._lock:
            return {"active": self.active,
                    "last_reason": self._last_reason,
                    "shed_below": self.shed_below,
                    "degrade": self.degrade,
                    "transitions": list(self.transitions)}
