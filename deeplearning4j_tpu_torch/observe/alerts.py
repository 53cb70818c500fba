"""Alerting: a rule engine over any ``MetricsRegistry`` exposition.

The action half of the observability loop — signals the metrics core
already exports become firing/resolved alerts routed to sinks. The engine
deliberately reads metrics THROUGH the Prometheus text exposition
(``parse_prometheus_text(registry.exposition())``): the rules see exactly
what an external Prometheus would scrape, so the exposition format is the
contract (and the tests lock it).

Rule types:

- :class:`ThresholdRule` — instantaneous comparison of a series sum
  (label-subset matched) against a bound, with an optional ``for_s``
  pending duration;
- :class:`AbsenceRule` — the metric stopped being exported (a dead
  exporter looks exactly like a healthy zero without this);
- :class:`RateOfChangeRule` — per-second derivative over a lookback
  window (counter resets clamp to 0, the ``rate()`` convention);
- :class:`BurnRateRule` — multiwindow SLO burn-rate alerting (Google SRE
  Workbook ch. 5): for an SLO objective like "99% of requests succeed",
  burn rate = (error ratio in window) / (error budget); the rule fires
  when BOTH a long and a short window exceed the factor — the long window
  gives significance, the short one fast detection AND fast resolution.

:class:`AlertManager` evaluates rules against a sample history, runs the
``ok → pending → firing → resolved`` state machine (each transition
notifies every sink exactly once — dedup by construction), and can run as
a background evaluator. The clock is an injectable
``parallel.time_source.TimeSource`` so every transition is unit-testable
deterministically (``ManualTimeSource`` + ``evaluate_once``).

Rules load from JSON (``load_rules``) so the ``--alerts rules.json`` CLI
flag and ``tools/validate_alert_rules.py`` share one schema.

The port's copy of the JAX package's stdlib-only ``observe/alerts.py``:
the same rules, states, notifications and JSON schema.
"""

from __future__ import annotations

import json
import logging
import operator
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.observe import log as _slog
from deeplearning4j_tpu_torch.observe.metrics import (MetricsRegistry,
                                                parse_prometheus_text)
from deeplearning4j_tpu_torch.parallel.time_source import (TimeSource,
                                                     get_time_source)

log = logging.getLogger(__name__)

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": operator.gt, ">=": operator.ge, "<": operator.lt,
    "<=": operator.le, "==": operator.eq, "!=": operator.ne,
}

Sample = Dict[str, Dict[Tuple[Tuple[str, str], ...], float]]


def series_sum(sample: Sample, metric: str,
               labels: Optional[Dict[str, str]] = None) -> Optional[float]:
    """Sum every series of ``metric`` whose labels INCLUDE ``labels``
    (subset match, the PromQL selector shape); ``None`` when no series
    matches — absence is distinct from zero."""
    series = sample.get(metric)
    if not series:
        return None
    want = set((str(k), str(v)) for k, v in (labels or {}).items())
    vals = [v for key, v in series.items() if want <= set(key)]
    return sum(vals) if vals else None


class SampleHistory:
    """Bounded ring of ``(t_seconds, parsed exposition)`` samples — the
    lookback store windowed rules read. Old samples age out past
    ``max_age_s`` (sized for the longest burn-rate window)."""

    def __init__(self, max_age_s: float = 2 * 3600.0,
                 max_samples: int = 4096):
        self.max_age_s = float(max_age_s)
        self._samples: "deque[Tuple[float, Sample]]" = deque(
            maxlen=int(max_samples))

    def add(self, t: float, sample: Sample) -> None:
        self._samples.append((float(t), sample))
        while self._samples and self._samples[0][0] < t - self.max_age_s:
            self._samples.popleft()

    def latest(self) -> Optional[Tuple[float, Sample]]:
        return self._samples[-1] if self._samples else None

    def oldest(self) -> Optional[Tuple[float, Sample]]:
        return self._samples[0] if self._samples else None

    def at_or_before(self, t: float) -> Optional[Tuple[float, Sample]]:
        """The NEWEST sample not newer than ``t`` (None when every sample
        is newer)."""
        best = None
        for ts, sample in self._samples:
            if ts <= t:
                best = (ts, sample)
            else:
                break
        return best

    def __len__(self) -> int:
        return len(self._samples)


class RuleResult:
    """One evaluation: is the condition met right now, with evidence."""

    __slots__ = ("active", "value", "detail")

    def __init__(self, active: bool, value: Optional[float], detail: str):
        self.active = bool(active)
        self.value = value
        self.detail = detail


class AlertRule:
    """Base: a named condition over the sample history. ``for_s`` is the
    pending duration the condition must hold before firing (0 = fire on
    the first evaluation that matches)."""

    def __init__(self, name: str, *, severity: str = "warning",
                 for_s: float = 0.0):
        if not name:
            raise ValueError("alert rule needs a name")
        self.name = name
        self.severity = severity
        self.for_s = float(for_s)

    def evaluate(self, history: SampleHistory,
                 now: float) -> RuleResult:  # pragma: no cover - interface
        raise NotImplementedError

    def describe(self) -> Dict[str, Any]:
        return {"name": self.name, "type": type(self).__name__,
                "severity": self.severity, "for_s": self.for_s}


class ThresholdRule(AlertRule):
    """``sum(metric{labels}) <op> value``."""

    def __init__(self, name: str, metric: str, op: str, value: float, *,
                 labels: Optional[Dict[str, str]] = None, **kw):
        super().__init__(name, **kw)
        if op not in _OPS:
            raise ValueError(f"unknown op {op!r} (one of {sorted(_OPS)})")
        self.metric = metric
        self.op = op
        self.value = float(value)
        self.labels = dict(labels or {})

    def evaluate(self, history: SampleHistory, now: float) -> RuleResult:
        latest = history.latest()
        v = (series_sum(latest[1], self.metric, self.labels)
             if latest is not None else None)
        if v is None:
            return RuleResult(False, None,
                              f"{self.metric} absent (threshold not judged)")
        active = _OPS[self.op](v, self.value)
        return RuleResult(active, v,
                          f"{self.metric}={v:g} {self.op} {self.value:g}")


class AbsenceRule(AlertRule):
    """Fires when the metric exports NO matching series — a crashed
    exporter/listener is indistinguishable from "all quiet" otherwise."""

    def __init__(self, name: str, metric: str, *,
                 labels: Optional[Dict[str, str]] = None, **kw):
        super().__init__(name, **kw)
        self.metric = metric
        self.labels = dict(labels or {})

    def evaluate(self, history: SampleHistory, now: float) -> RuleResult:
        latest = history.latest()
        v = (series_sum(latest[1], self.metric, self.labels)
             if latest is not None else None)
        if v is None:
            return RuleResult(True, None, f"{self.metric} is absent")
        return RuleResult(False, v, f"{self.metric} present ({v:g})")


class RateOfChangeRule(AlertRule):
    """``rate(metric[window_s]) <op> value`` (per-second, counter resets
    clamped to 0). Inactive until the history spans the window."""

    def __init__(self, name: str, metric: str, op: str, value: float,
                 window_s: float, *,
                 labels: Optional[Dict[str, str]] = None, **kw):
        super().__init__(name, **kw)
        if op not in _OPS:
            raise ValueError(f"unknown op {op!r} (one of {sorted(_OPS)})")
        if window_s <= 0:
            raise ValueError("window_s must be positive")
        self.metric = metric
        self.op = op
        self.value = float(value)
        self.window_s = float(window_s)
        self.labels = dict(labels or {})

    def evaluate(self, history: SampleHistory, now: float) -> RuleResult:
        latest = history.latest()
        past = history.at_or_before(now - self.window_s)
        if latest is None or past is None or past[0] >= latest[0]:
            return RuleResult(False, None,
                              f"history does not span {self.window_s:g}s")
        v1 = series_sum(latest[1], self.metric, self.labels)
        if v1 is None:
            return RuleResult(False, None, f"{self.metric} absent")
        v0 = series_sum(past[1], self.metric, self.labels) or 0.0
        rate = max(0.0, v1 - v0) / (latest[0] - past[0])
        active = _OPS[self.op](rate, self.value)
        return RuleResult(
            active, rate,
            f"rate({self.metric}[{self.window_s:g}s])={rate:g} "
            f"{self.op} {self.value:g}")


class SLOSpec:
    """An availability SLO over a counter: ``objective`` (e.g. 0.99) of
    events matched by ``labels`` must NOT match ``error_labels``.
    Error budget = ``1 - objective``."""

    def __init__(self, metric: str, error_labels: Dict[str, str], *,
                 labels: Optional[Dict[str, str]] = None,
                 objective: float = 0.99):
        if not 0.0 < objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        if not error_labels:
            raise ValueError("slo needs error_labels selecting the errors")
        self.metric = metric
        self.labels = dict(labels or {})
        self.error_labels = {**self.labels, **dict(error_labels)}
        self.objective = float(objective)

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    def describe(self) -> Dict[str, Any]:
        return {"metric": self.metric, "labels": self.labels,
                "error_labels": self.error_labels,
                "objective": self.objective}


class BurnRateRule(AlertRule):
    """Multiwindow burn rate over an :class:`SLOSpec`.

    ``windows`` is a list of ``(long_s, short_s, factor)``: the rule is
    active when for ANY entry both the long- and short-window burn rates
    reach ``factor`` (e.g. the SRE Workbook's 1h/5m at 14.4x paging pair).
    When the history is shorter than a window, the available span is used
    (burn rate is an event RATIO, so a short span is just fewer events —
    the conservative start-up behaviour)."""

    def __init__(self, name: str, slo: SLOSpec,
                 windows: List[Tuple[float, float, float]], **base_kw):
        super().__init__(name, **base_kw)
        if not windows:
            raise ValueError("burn_rate rule needs at least one window")
        self.slo = slo
        self.windows = [(float(l), float(s), float(f))
                        for l, s, f in windows]
        for l, s, f in self.windows:
            if s > l:
                raise ValueError(f"short window {s:g}s exceeds long {l:g}s")
            if f <= 0:
                raise ValueError("burn-rate factor must be positive")

    def _burn(self, history: SampleHistory, now: float,
              window_s: float) -> Optional[float]:
        latest = history.latest()
        if latest is None:
            return None
        past = history.at_or_before(now - window_s) or history.oldest()
        d_total = ((series_sum(latest[1], self.slo.metric, self.slo.labels)
                    or 0.0)
                   - (series_sum(past[1], self.slo.metric, self.slo.labels)
                      or 0.0))
        d_err = ((series_sum(latest[1], self.slo.metric,
                             self.slo.error_labels) or 0.0)
                 - (series_sum(past[1], self.slo.metric,
                               self.slo.error_labels) or 0.0))
        if d_total <= 0:
            return 0.0
        ratio = max(0.0, d_err) / d_total
        return ratio / self.slo.budget

    def evaluate(self, history: SampleHistory, now: float) -> RuleResult:
        parts = []
        active = False
        worst: Optional[float] = None
        for long_s, short_s, factor in self.windows:
            b_long = self._burn(history, now, long_s)
            b_short = self._burn(history, now, short_s)
            if b_long is None or b_short is None:
                parts.append(f"{long_s:g}s/{short_s:g}s: no data")
                continue
            hit = b_long >= factor and b_short >= factor
            active = active or hit
            worst = max(worst or 0.0, min(b_long, b_short))
            parts.append(f"{long_s:g}s={b_long:.2f}x/"
                         f"{short_s:g}s={b_short:.2f}x (>= {factor:g}x)")
        return RuleResult(active, worst, "burn " + "; ".join(parts))

    def describe(self) -> Dict[str, Any]:
        d = super().describe()
        d["slo"] = self.slo.describe()
        d["windows"] = [list(w) for w in self.windows]
        return d


# ---------------------------------------------------------------------------
# notification sinks
# ---------------------------------------------------------------------------

class Notification:
    """One deduped state transition: ``state`` is ``firing`` or
    ``resolved``."""

    __slots__ = ("rule", "severity", "state", "value", "detail", "ts")

    def __init__(self, rule: str, severity: str, state: str,
                 value: Optional[float], detail: str, ts: float):
        self.rule = rule
        self.severity = severity
        self.state = state
        self.value = value
        self.detail = detail
        self.ts = ts

    def to_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "severity": self.severity,
                "state": self.state, "value": self.value,
                "detail": self.detail, "ts": self.ts}

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Notification({self.rule}, {self.state})"


class LogSink:
    """Routes notifications into the structured log stream (falling back
    to stdlib logging when no hub is active)."""

    def __init__(self):
        self._slog = _slog.get_logger("observe.alerts")

    def notify(self, n: Notification) -> None:
        if _slog.get_active_hub() is not None:
            self._slog.log(
                logging.ERROR if n.state == "firing" else logging.INFO,
                f"alert {n.rule} {n.state}", rule=n.rule, state=n.state,
                severity=n.severity, value=n.value, detail=n.detail)
        else:
            log.log(logging.ERROR if n.state == "firing" else logging.INFO,
                    "[alert:%s] %s (%s)", n.rule, n.state, n.detail)


class CallbackSink:
    """Hands each notification to a callable."""

    def __init__(self, fn: Callable[[Notification], None]):
        self.fn = fn

    def notify(self, n: Notification) -> None:
        self.fn(n)


class WebhookSink:
    """POSTs each notification as JSON with bounded retry + exponential
    backoff. ``post`` and ``sleep`` are injectable for tests; delivery
    failures are counted (``failed``) and never raise into the evaluator."""

    def __init__(self, url: str, *, retries: int = 3,
                 backoff_s: float = 0.5, timeout_s: float = 5.0,
                 post: Optional[Callable[[str, bytes], int]] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.url = url
        self.retries = max(0, int(retries))
        self.backoff_s = float(backoff_s)
        self.timeout_s = float(timeout_s)
        self._post = post if post is not None else self._http_post
        self._sleep = sleep
        self.delivered = 0
        self.failed = 0
        self.last_error: Optional[str] = None

    def _http_post(self, url: str, body: bytes) -> int:
        from urllib.request import Request, urlopen
        req = Request(url, data=body,
                      headers={"Content-Type": "application/json"})
        with urlopen(req, timeout=self.timeout_s) as resp:
            return resp.status

    def notify(self, n: Notification) -> None:
        body = json.dumps(n.to_dict()).encode()
        delay = self.backoff_s
        for attempt in range(self.retries + 1):
            try:
                status = self._post(self.url, body)
                if 200 <= status < 300:
                    self.delivered += 1
                    self.last_error = None
                    return
                self.last_error = f"HTTP {status}"
            except Exception as e:  # noqa: BLE001 - delivery must not raise
                self.last_error = f"{type(e).__name__}: {e}"
            if attempt < self.retries:
                self._sleep(delay)
                delay *= 2
        self.failed += 1
        log.warning("webhook %s dropped %s notification after %d attempts "
                    "(%s)", self.url, n.rule, self.retries + 1,
                    self.last_error)


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

class _RuleState:
    __slots__ = ("state", "since", "fired_at", "value", "detail")

    def __init__(self):
        self.state = "ok"          # ok | pending | firing
        self.since: Optional[float] = None
        self.fired_at: Optional[float] = None
        self.value: Optional[float] = None
        self.detail = ""


class AlertManager:
    """Evaluates rules against a registry's exposition; routes deduped
    firing/resolved notifications to sinks.

    ``time_source`` (``parallel.time_source.TimeSource``) stamps every
    sample and transition — inject a ``ManualTimeSource`` and drive
    :meth:`evaluate_once` for deterministic tests; :meth:`start` runs a
    background daemon evaluating every ``interval_s`` wall seconds.

    The manager exports its own state through the SAME registry it
    samples: ``alerts_firing{rule}`` and
    ``alert_notifications_total{rule,state}``.
    """

    def __init__(self, metrics: MetricsRegistry, rules: List[AlertRule],
                 sinks: Optional[List[Any]] = None, *,
                 interval_s: float = 15.0,
                 time_source: Optional[TimeSource] = None,
                 history_max_age_s: float = 2 * 3600.0):
        names = [r.name for r in rules]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate rule names {sorted(dupes)}")
        self.metrics = metrics
        self.rules = list(rules)
        self.sinks = list(sinks) if sinks is not None else [LogSink()]
        self.interval_s = float(interval_s)
        self.time_source = (time_source if time_source is not None
                            else get_time_source())
        self.history = SampleHistory(max_age_s=history_max_age_s)
        self._states: Dict[str, _RuleState] = {r.name: _RuleState()
                                               for r in self.rules}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._m_firing = metrics.gauge(
            "alerts_firing", "1 while the rule is firing", ("rule",))
        self._m_notifications = metrics.counter(
            "alert_notifications_total",
            "Alert state transitions notified to sinks", ("rule", "state"))
        self.evaluations = 0

    # ------------------------------------------------------------ evaluate
    def _now(self) -> float:
        return self.time_source.current_time_millis() / 1e3

    def _notify(self, n: Notification) -> None:
        self._m_notifications.inc(rule=n.rule, state=n.state)
        for sink in self.sinks:
            try:
                sink.notify(n)
            except Exception as e:  # noqa: BLE001 - sinks are contained
                log.warning("alert sink %r failed for %s: %s",
                            type(sink).__name__, n.rule, e)

    def evaluate_once(self, now: Optional[float] = None
                      ) -> List[Notification]:
        """One evaluation round: scrape, append to history, run every
        rule's state machine. Returns the notifications emitted this round
        (each transition exactly once)."""
        with self._lock:
            if now is None:
                now = self._now()
            sample = parse_prometheus_text(self.metrics.exposition())
            self.history.add(now, sample)
            self.evaluations += 1
            out: List[Notification] = []
            for rule in self.rules:
                st = self._states[rule.name]
                try:
                    res = rule.evaluate(self.history, now)
                except Exception as e:  # noqa: BLE001 - bad rule contained
                    log.warning("alert rule %s failed to evaluate: %s",
                                rule.name, e)
                    # state is kept (a broken rule must not flap
                    # firing→resolved) but the error is surfaced in
                    # /alerts instead of pinning the old detail silently
                    st.detail = f"evaluation error: {type(e).__name__}: {e}"
                    continue
                st.value, st.detail = res.value, res.detail
                if res.active:
                    if st.state == "ok":
                        st.since = now
                        st.state = ("pending" if rule.for_s > 0
                                    else "firing")
                    elif (st.state == "pending"
                          and now - st.since >= rule.for_s):
                        st.state = "firing"
                    if st.state == "firing" and st.fired_at is None:
                        st.fired_at = now
                        self._m_firing.set(1, rule=rule.name)
                        out.append(Notification(rule.name, rule.severity,
                                                "firing", res.value,
                                                res.detail, now))
                else:
                    if st.state == "firing":
                        self._m_firing.set(0, rule=rule.name)
                        out.append(Notification(rule.name, rule.severity,
                                                "resolved", res.value,
                                                res.detail, now))
                    st.state, st.since, st.fired_at = "ok", None, None
        # sinks run OUTSIDE the manager lock: a slow webhook (seconds of
        # retry/backoff) must not block /alerts or firing(), and a callback
        # sink that queries the manager must not deadlock. Transitions were
        # already recorded above, so delivery stays exactly-once.
        for n in out:
            self._notify(n)
        return out

    # ------------------------------------------------------------- queries
    def firing(self) -> List[str]:
        with self._lock:
            return sorted(n for n, s in self._states.items()
                          if s.state == "firing")

    def describe(self) -> Dict[str, Any]:
        """The ``/alerts`` endpoint payload."""
        with self._lock:
            rules = []
            for rule in self.rules:
                st = self._states[rule.name]
                d = rule.describe()
                d.update(state=st.state, since=st.since,
                         fired_at=st.fired_at, value=st.value,
                         detail=st.detail)
                rules.append(d)
            return {"firing": sorted(n for n, s in self._states.items()
                                     if s.state == "firing"),
                    "evaluations": self.evaluations,
                    "rules": rules}

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "AlertManager":
        """Run the background evaluator (daemon; ``stop()`` is prompt)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.is_set():
                try:
                    self.evaluate_once()
                except Exception:  # noqa: BLE001 - the loop must survive
                    log.exception("alert evaluation round failed")
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="alert-manager")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


# ---------------------------------------------------------------------------
# JSON rule loading — the --alerts rules.json / validator schema
# ---------------------------------------------------------------------------

def _build_threshold(c: dict) -> AlertRule:
    return ThresholdRule(c["name"], c["metric"], c["op"], c["value"],
                         labels=c.get("labels"),
                         severity=c.get("severity", "warning"),
                         for_s=c.get("for_s", 0.0))


def _build_absence(c: dict) -> AlertRule:
    return AbsenceRule(c["name"], c["metric"], labels=c.get("labels"),
                       severity=c.get("severity", "warning"),
                       for_s=c.get("for_s", 0.0))


def _build_rate(c: dict) -> AlertRule:
    return RateOfChangeRule(c["name"], c["metric"], c["op"], c["value"],
                            c["window_s"], labels=c.get("labels"),
                            severity=c.get("severity", "warning"),
                            for_s=c.get("for_s", 0.0))


def _build_burn(c: dict) -> AlertRule:
    slo_c = c["slo"]
    slo = SLOSpec(slo_c["metric"], slo_c["error_labels"],
                  labels=slo_c.get("labels"),
                  objective=slo_c.get("objective", 0.99))
    windows = [(w["long_s"], w["short_s"], w["factor"])
               for w in c["windows"]]
    return BurnRateRule(c["name"], slo, windows,
                        severity=c.get("severity", "warning"),
                        for_s=c.get("for_s", 0.0))


RULE_BUILDERS: Dict[str, Callable[[dict], AlertRule]] = {
    "threshold": _build_threshold,
    "absence": _build_absence,
    "rate_of_change": _build_rate,
    "burn_rate": _build_burn,
}


def load_rules(spec) -> List[AlertRule]:
    """Build rules from a spec: a path to a JSON file, a JSON string, or
    an already-parsed ``{"rules": [...]}`` dict. Raises ``ValueError``
    with the offending rule index/name on any schema problem."""
    if isinstance(spec, (str, bytes)) and not str(spec).lstrip().startswith(
            ("{", "[")):
        with open(spec, "r", encoding="utf-8") as fh:
            spec = json.load(fh)
    elif isinstance(spec, (str, bytes)):
        spec = json.loads(spec)
    if isinstance(spec, list):
        spec = {"rules": spec}
    if not isinstance(spec, dict) or not isinstance(spec.get("rules"), list):
        raise ValueError("alert rules spec must be {'rules': [...]}")
    rules: List[AlertRule] = []
    for i, c in enumerate(spec["rules"]):
        if not isinstance(c, dict):
            raise ValueError(f"rules[{i}]: not an object")
        rtype = c.get("type")
        builder = RULE_BUILDERS.get(rtype)
        if builder is None:
            raise ValueError(
                f"rules[{i}] ({c.get('name', '?')}): unknown type {rtype!r} "
                f"(one of {sorted(RULE_BUILDERS)})")
        try:
            rules.append(builder(c))
        except KeyError as e:
            raise ValueError(
                f"rules[{i}] ({c.get('name', '?')}): missing field {e}"
            ) from e
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"rules[{i}] ({c.get('name', '?')}): {e}") from e
    names = [r.name for r in rules]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(f"duplicate rule names {sorted(dupes)}")
    return rules
