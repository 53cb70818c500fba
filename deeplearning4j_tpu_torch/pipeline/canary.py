"""Canary controller: ramp candidate traffic, watch the signals, decide.

The CANARY stage of the pipeline.  The controller drives the registry's
two canary capabilities (``serving/registry.py``):

- **weighted routing** — each schedule step gives the candidate version a
  traffic fraction (deterministic smooth weighted round-robin inside
  ``predict``), held for ``hold_s`` on the injected ``TimeSource``;
- **shadow mode** — before any fraction is applied, a sample of live
  requests is duplicated to the candidate off the response path and the
  output divergence is counted (``shadow_divergence_total{model}``) and
  logged (bounded).

Signals that roll the canary back, checked every :meth:`tick`:

- an attached ``AlertManager`` rule firing (``abort_on_alerts`` names a
  subset; ``None`` watches every firing rule — the SLO burn-rate rules
  the serving tier already evaluates);
- shadow divergences exceeding ``max_divergences`` (``None`` disables);
- an explicit :meth:`report_alarm` (the trainer watchdog's alarms, an
  operator abort).

When every schedule step has held cleanly the decision is ``"promote"``.
The controller is clockless-loop friendly: drive ``tick()`` manually
under a ``ManualTimeSource`` for deterministic tests, or call
:meth:`run` to poll on the real clock.  It never touches model versions
itself — clearing the split/shadow is its only registry write on
decision; the PROMOTE/ROLLBACK registry action belongs to the pipeline
runner so it lands inside the journaled terminal stage.

The port's copy of the JAX package's jax-free ``pipeline/canary.py``, on
the port's ``parallel/time_source.py``.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, List, Optional, Sequence

from deeplearning4j_tpu_torch.parallel.time_source import (TimeSource,
                                                     get_time_source)


@dataclasses.dataclass
class CanaryStep:
    """One ramp step: give the candidate ``fraction`` of live traffic and
    hold it for ``hold_s`` seconds before the next step."""

    fraction: float
    hold_s: float

    def __post_init__(self):
        if not 0.0 < float(self.fraction) <= 1.0:
            raise ValueError(
                f"canary fraction must be in (0, 1], got {self.fraction}")
        if float(self.hold_s) < 0:
            raise ValueError(f"hold_s must be >= 0, got {self.hold_s}")


def parse_schedule(spec: Sequence) -> List[CanaryStep]:
    """``[{"fraction": f, "hold_s": s}, ...]`` (or CanaryStep instances)
    → validated, strictly-increasing ramp."""
    steps = [s if isinstance(s, CanaryStep)
             else CanaryStep(float(s["fraction"]), float(s["hold_s"]))
             for s in spec]
    if not steps:
        raise ValueError("canary schedule must have at least one step")
    for a, b in zip(steps, steps[1:]):
        if b.fraction <= a.fraction:
            raise ValueError(
                f"canary fractions must strictly increase "
                f"({a.fraction} -> {b.fraction})")
    return steps


class CanaryController:
    """Ramp ``candidate_version`` of ``name`` through ``schedule``.

    Lifecycle: :meth:`start` applies shadow mode + the first fraction;
    :meth:`tick` advances (returns ``None`` while undecided, else
    ``"promote"``/``"rollback"``); :attr:`decision`/:attr:`reason` carry
    the outcome.  ``on_event(kind, detail)`` observes ramp/decision
    events (the runner journals them as notes).
    """

    def __init__(self, registry, name: str, candidate_version: int, *,
                 schedule: Sequence, time_source: Optional[TimeSource] = None,
                 alerts=None, abort_on_alerts: Optional[Sequence[str]] = None,
                 shadow_sample: float = 0.0,
                 divergence_threshold: float = 1e-3,
                 max_divergences: Optional[int] = None,
                 on_event: Optional[Callable[[str, dict], None]] = None):
        self.registry = registry
        self.name = name
        self.candidate_version = int(candidate_version)
        self.schedule = parse_schedule(schedule)
        self.time_source = (time_source if time_source is not None
                            else get_time_source())
        self.alerts = alerts
        self.abort_on_alerts = (None if abort_on_alerts is None
                                else set(abort_on_alerts))
        self.shadow_sample = float(shadow_sample)
        self.divergence_threshold = float(divergence_threshold)
        self.max_divergences = max_divergences
        self.on_event = on_event
        self.step_index: Optional[int] = None
        self.step_started_ms: Optional[int] = None
        self.decision: Optional[str] = None
        self.reason: Optional[str] = None
        self.shadow_final: Optional[dict] = None  # snapshot at decision
        self._alarm: Optional[str] = None

    # ------------------------------------------------------------- helpers
    def _now_ms(self) -> int:
        return self.time_source.current_time_millis()

    def _event(self, kind: str, **detail) -> None:
        if self.on_event is not None:
            self.on_event(kind, detail)

    def _apply_step(self, index: int) -> None:
        step = self.schedule[index]
        self.registry.set_traffic_split(
            self.name, {self.candidate_version: step.fraction})
        self.step_index = index
        self.step_started_ms = self._now_ms()
        self._event("ramp", step=index, fraction=step.fraction,
                    hold_s=step.hold_s)

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "CanaryController":
        """Arm shadow mode (if sampled) then apply the first fraction.
        The registry refuses a cold candidate (warm-gated split), so a
        canary can never put an uncompiled version in front of traffic."""
        if self.shadow_sample > 0:
            self.registry.set_shadow(
                self.name, self.candidate_version,
                sample=self.shadow_sample,
                divergence_threshold=self.divergence_threshold)
            self._event("shadow", sample=self.shadow_sample)
        self._apply_step(0)
        return self

    def report_alarm(self, reason: str) -> None:
        """Push an external abort signal (trainer watchdog alarm, operator
        stop); the next :meth:`tick` rolls back."""
        self._alarm = str(reason)

    def _bad_signal(self) -> Optional[str]:
        if self._alarm is not None:
            return f"alarm: {self._alarm}"
        if self.alerts is not None:
            firing = set(self.alerts.firing())
            watched = (firing if self.abort_on_alerts is None
                       else firing & self.abort_on_alerts)
            if watched:
                return f"alert(s) firing: {sorted(watched)}"
        if self.max_divergences is not None:
            state = self.registry.shadow_state(self.name)
            if state and state.get("divergences", 0) > self.max_divergences:
                return (f"shadow divergences {state['divergences']} exceed "
                        f"budget {self.max_divergences}")
        return None

    def _decide(self, decision: str, reason: str) -> str:
        # pull the candidate out of the traffic path before reporting;
        # the journaled PROMOTE/ROLLBACK happens in the runner afterwards
        if self.shadow_sample > 0:
            self.registry.drain_shadow(timeout_s=5.0)
            self.shadow_final = self.registry.shadow_state(self.name)
        self.registry.clear_traffic_split(self.name)
        if self.shadow_sample > 0:
            self.registry.clear_shadow(self.name)
        self.decision, self.reason = decision, reason
        self._event("decision", decision=decision, reason=reason)
        return decision

    def tick(self) -> Optional[str]:
        """Advance the state: check abort signals, ramp when the hold
        elapsed, decide at the end.  ``None`` while still canarying."""
        if self.decision is not None:
            return self.decision
        if self.step_index is None:
            raise RuntimeError("canary not started (call start() first)")
        bad = self._bad_signal()
        if bad is not None:
            return self._decide("rollback", bad)
        step = self.schedule[self.step_index]
        held_s = (self._now_ms() - self.step_started_ms) / 1e3
        if held_s < step.hold_s:
            return None
        if self.step_index + 1 < len(self.schedule):
            self._apply_step(self.step_index + 1)
            return None
        return self._decide(
            "promote",
            f"all {len(self.schedule)} ramp step(s) held cleanly "
            f"(final fraction {step.fraction})")

    def run(self, *, poll_s: float = 1.0,
            wait: Optional[Callable[[float], None]] = None) -> str:
        """Poll :meth:`tick` until decided. ``wait`` is the between-tick
        hook (default: real ``time.sleep``) — deterministic callers
        advance a ``ManualTimeSource`` and drive traffic there."""
        wait = _time.sleep if wait is None else wait
        if self.step_index is None:
            self.start()
        while True:
            decision = self.tick()
            if decision is not None:
                return decision
            wait(poll_s)
