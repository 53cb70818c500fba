"""Declarative SLOs over the Prometheus exposition contract.

``alerts.py`` gives the mechanism (burn-rate rules, the state machine);
this module gives the POLICY object: an :class:`SLO` names an objective
("99% of bench predictions under 250 ms", "99.9% of requests succeed"),
reads ANY registry through ``parse_prometheus_text`` — the same contract
the alert engine and fleet federation use — and derives everything else:

- **compliance**: the good/total event ratio right now (for the ``/slo``
  endpoint);
- **burn rates**: multiwindow error-budget burn (SRE Workbook ch. 5),
  long window for significance, short for fast detection AND resolution;
- **alert rules**: each SLO auto-generates exactly one burn-rate rule
  for the existing :class:`~.alerts.AlertManager` — availability SLOs
  reuse :class:`~.alerts.BurnRateRule` verbatim via an
  :class:`~.alerts.SLOSpec`; latency SLOs use
  :class:`LatencyBurnRateRule`, which counts "good" events from the
  histogram's cumulative buckets (the count at the largest ``le`` not
  above the threshold) so no separate error counter is needed.

The latency SLI deliberately judges against BUCKET BOUNDS, not exact
latencies: a threshold below the lowest bucket makes every request a
violation (good = 0), which is exactly the deterministic knob the chaos
example and bench use to drive a burn without wall-clock sleeps.

SLOs load from JSON (``load_slos``) so ``serve --slo slo.json`` and
``tools/validate_slo_config.py`` share one schema::

    {"slos": [{"name": "bench-latency", "sli": "latency",
               "metric": "serving_request_latency_seconds",
               "threshold_ms": 250, "objective": 0.99,
               "labels": {"model": "bench"},
               "windows": [{"long_s": 3600, "short_s": 300,
                            "factor": 14.4}]},
              {"name": "bench-availability", "sli": "availability",
               "metric": "serving_requests_total",
               "error_labels": {"status": "error"},
               "objective": 0.999}]}

The port's copy of the JAX package's stdlib-only ``observe/slo.py``.
"""

from __future__ import annotations

import json
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.observe.alerts import (AlertRule, BurnRateRule,
                                               SampleHistory, SLOSpec,
                                               series_sum)
from deeplearning4j_tpu_torch.observe.metrics import parse_prometheus_text

# SRE Workbook ch. 5 defaults: the paging pair (1h/5m at 14.4x) plus the
# ticket pair (6h/30m at 6x)
DEFAULT_WINDOWS: Tuple[Tuple[float, float, float], ...] = (
    (3600.0, 300.0, 14.4), (21600.0, 1800.0, 6.0))

# threshold_ms is converted into the histogram's native unit
_UNIT_DIVISOR = {"s": 1e3, "ms": 1.0}


def latency_counts(sample, metric: str, threshold_s: float,
                   labels: Optional[Dict[str, str]] = None
                   ) -> Optional[Tuple[float, float]]:
    """``(good, total)`` from a histogram's cumulative buckets.

    ``good`` is the count at the largest ``le`` not above the threshold
    (0 when no bucket qualifies — a sub-bucket threshold makes every
    event a violation, deliberately); ``total`` the ``+Inf`` count.
    Series are label-subset matched and summed; ``None`` when the metric
    has no bucket series at all (absence is distinct from zero)."""
    want = set((str(k), str(v)) for k, v in (labels or {}).items())
    groups: Dict[Tuple[Tuple[str, str], ...], Dict[float, float]] = {}
    for key, v in sample.get(metric + "_bucket", {}).items():
        kd = [(k, val) for k, val in key if k != "le"]
        le = dict(key).get("le")
        if le is None or not want <= set(kd):
            continue
        try:
            le_v = float(le)          # float("+Inf") == math.inf
        except ValueError:
            continue
        groups.setdefault(tuple(kd), {})[le_v] = v
    if not groups:
        return None
    good = total = 0.0
    for series in groups.values():
        bounds = sorted(series)
        total += series.get(math.inf, series[bounds[-1]])
        eligible = [b for b in bounds
                    if b <= threshold_s * (1 + 1e-9) + 1e-12]
        if eligible:
            good += series[eligible[-1]]
    return good, total


class SLO:
    """One declarative objective; ``sli`` is ``latency`` (histogram
    threshold) or ``availability`` (error-labelled counter)."""

    def __init__(self, name: str, *, sli: str, metric: str,
                 objective: float = 0.99,
                 threshold_ms: Optional[float] = None,
                 unit: str = "s",
                 labels: Optional[Dict[str, str]] = None,
                 error_labels: Optional[Dict[str, str]] = None,
                 windows: Optional[Sequence[Sequence[float]]] = None,
                 severity: str = "warning", for_s: float = 0.0):
        if not name:
            raise ValueError("slo needs a name")
        if sli not in ("latency", "availability"):
            raise ValueError(
                f"unknown sli {sli!r} (one of ['availability', 'latency'])")
        if not 0.0 < float(objective) < 1.0:
            raise ValueError("objective must be in (0, 1)")
        if unit not in _UNIT_DIVISOR:
            raise ValueError(f"unknown unit {unit!r} (one of ['ms', 's'])")
        self.name = name
        self.sli = sli
        self.metric = metric
        self.objective = float(objective)
        self.unit = unit
        self.labels = dict(labels or {})
        self.error_labels = dict(error_labels or {})
        self.severity = severity
        self.for_s = float(for_s)
        self.windows = [tuple(float(x) for x in w)
                        for w in (windows if windows else DEFAULT_WINDOWS)]
        if sli == "latency":
            if threshold_ms is None:
                raise ValueError("latency slo needs threshold_ms")
            self.threshold_ms = float(threshold_ms)
            if self.threshold_ms <= 0:
                raise ValueError("threshold_ms must be positive")
        else:
            if not self.error_labels:
                raise ValueError("availability slo needs error_labels")
            self.threshold_ms = None
        # construction validates windows/objective eagerly (load-time
        # schema errors, not evaluation-time surprises)
        self._rule = self._build_rule()

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    @property
    def rule_name(self) -> str:
        return f"slo_burn:{self.name}"

    # ---------------------------------------------------------------- SLI
    def good_total(self, sample) -> Optional[Tuple[float, float]]:
        """``(good, total)`` event counts from one parsed sample, or
        ``None`` when the underlying metric is absent."""
        if self.sli == "latency":
            thr = self.threshold_ms / _UNIT_DIVISOR[self.unit]
            return latency_counts(sample, self.metric, thr, self.labels)
        total = series_sum(sample, self.metric, self.labels)
        if total is None:
            return None
        err = series_sum(sample, self.metric,
                         {**self.labels, **self.error_labels}) or 0.0
        return max(total - err, 0.0), total

    def compliance(self, sample) -> Dict[str, Any]:
        """The instantaneous good/total ratio (lifetime-to-date, the
        ``/slo`` headline number)."""
        gt = self.good_total(sample)
        if gt is None:
            return {"good": None, "total": None, "ratio": None,
                    "met": None, "detail": f"{self.metric} absent"}
        good, total = gt
        ratio = (good / total) if total > 0 else None
        met = None if ratio is None else ratio >= self.objective
        return {"good": good, "total": total, "ratio": ratio, "met": met}

    # -------------------------------------------------------------- rules
    def _build_rule(self) -> AlertRule:
        if self.sli == "availability":
            spec = SLOSpec(self.metric, self.error_labels,
                           labels=self.labels, objective=self.objective)
            return BurnRateRule(self.rule_name, spec, list(self.windows),
                                severity=self.severity, for_s=self.for_s)
        return LatencyBurnRateRule(self.rule_name, self, list(self.windows),
                                   severity=self.severity, for_s=self.for_s)

    def rule(self) -> AlertRule:
        """The auto-generated burn-rate rule for ``AlertManager``."""
        return self._rule

    def describe(self) -> Dict[str, Any]:
        d = {"name": self.name, "sli": self.sli, "metric": self.metric,
             "objective": self.objective, "labels": self.labels,
             "windows": [list(w) for w in self.windows],
             "rule": self.rule_name}
        if self.sli == "latency":
            d["threshold_ms"] = self.threshold_ms
            d["unit"] = self.unit
        else:
            d["error_labels"] = self.error_labels
        return d


class LatencyBurnRateRule(BurnRateRule):
    """Burn rate where "error" means "served above the threshold":
    good/total deltas come from the histogram's cumulative buckets, so a
    latency SLO needs no separate error counter.  Reuses the base class's
    multiwindow ``evaluate`` and the manager's state machine verbatim —
    only the per-window burn computation differs."""

    def _burn(self, history: SampleHistory, now: float,
              window_s: float) -> Optional[float]:
        latest = history.latest()
        if latest is None:
            return None
        past = history.at_or_before(now - window_s) or history.oldest()
        gt1 = self.slo.good_total(latest[1]) or (0.0, 0.0)
        gt0 = self.slo.good_total(past[1]) or (0.0, 0.0)
        d_total = gt1[1] - gt0[1]
        d_good = gt1[0] - gt0[0]
        if d_total <= 0:
            return 0.0
        ratio = min(max(1.0 - max(d_good, 0.0) / d_total, 0.0), 1.0)
        return ratio / self.slo.budget


class SLOSet:
    """The loaded config: iterable SLOs + their generated rules + the
    ``/slo`` endpoint payload."""

    def __init__(self, slos: Sequence[SLO]):
        names = [s.name for s in slos]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate slo names {sorted(dupes)}")
        self.slos = list(slos)

    def __len__(self) -> int:
        return len(self.slos)

    def __iter__(self):
        return iter(self.slos)

    def rules(self) -> List[AlertRule]:
        """One burn-rate rule per SLO, for ``AlertManager(rules=...)``."""
        return [s.rule() for s in self.slos]

    def status(self, *, metrics=None, alerts=None, sample=None,
               now: Optional[float] = None) -> Dict[str, Any]:
        """The ``/slo`` payload: per-SLO compliance, per-window burn
        rates, and (when an ``alerts`` manager is attached) the generated
        rule's live state.  Burn rates read the manager's sample history
        when available; otherwise a single fresh scrape (burn 0 — one
        sample has no deltas)."""
        history: Optional[SampleHistory] = None
        if alerts is not None:
            if now is None:
                now = alerts.time_source.current_time_millis() / 1e3
            history = alerts.history
            if sample is None and len(history):
                sample = history.latest()[1]
        if sample is None and metrics is not None:
            sample = parse_prometheus_text(metrics.exposition())
        if now is None:
            now = time.time()
        if history is None or not len(history):
            history = SampleHistory()
            if sample is not None:
                history.add(now, sample)
        alert_states: Dict[str, dict] = {}
        if alerts is not None:
            alert_states = {d["name"]: d
                            for d in alerts.describe()["rules"]}
        out: Dict[str, Any] = {"now": now, "slos": []}
        for slo in self.slos:
            rule = slo.rule()
            entry = slo.describe()
            entry["compliance"] = (slo.compliance(sample)
                                   if sample is not None else None)
            burns = []
            for long_s, short_s, factor in rule.windows:
                b_long = rule._burn(history, now, long_s)
                b_short = rule._burn(history, now, short_s)
                burns.append({
                    "long_s": long_s, "short_s": short_s, "factor": factor,
                    "long": b_long, "short": b_short,
                    "active": (b_long is not None and b_short is not None
                               and b_long >= factor and b_short >= factor)})
            entry["burn"] = burns
            st = alert_states.get(rule.name)
            entry["alert"] = (
                {"rule": rule.name, "state": st["state"],
                 "detail": st["detail"]} if st is not None
                else {"rule": rule.name, "state": "unmanaged"})
            out["slos"].append(entry)
        return out

    def describe(self) -> List[Dict[str, Any]]:
        return [s.describe() for s in self.slos]


def load_slos(spec) -> SLOSet:
    """Build an :class:`SLOSet` from a spec: a path to a JSON file, a
    JSON string, or an already-parsed ``{"slos": [...]}`` dict.  Raises
    ``ValueError`` naming the offending entry on any schema problem (the
    ``load_rules`` convention, shared with the validator)."""
    if isinstance(spec, (str, bytes)) and not str(spec).lstrip().startswith(
            ("{", "[")):
        with open(spec, "r", encoding="utf-8") as fh:
            spec = json.load(fh)
    elif isinstance(spec, (str, bytes)):
        spec = json.loads(spec)
    if isinstance(spec, list):
        spec = {"slos": spec}
    if not isinstance(spec, dict) or not isinstance(spec.get("slos"), list):
        raise ValueError("slo spec must be {'slos': [...]}")
    slos: List[SLO] = []
    for i, c in enumerate(spec["slos"]):
        if not isinstance(c, dict):
            raise ValueError(f"slos[{i}]: not an object")
        windows = None
        if "windows" in c:
            if not isinstance(c["windows"], list) or not c["windows"]:
                raise ValueError(
                    f"slos[{i}] ({c.get('name', '?')}): windows must be a "
                    f"non-empty list")
            try:
                windows = [(w["long_s"], w["short_s"], w["factor"])
                           for w in c["windows"]]
            except (KeyError, TypeError) as e:
                raise ValueError(
                    f"slos[{i}] ({c.get('name', '?')}): window entries "
                    f"need long_s/short_s/factor ({e})") from e
        try:
            slos.append(SLO(
                c["name"], sli=c["sli"], metric=c["metric"],
                objective=c.get("objective", 0.99),
                threshold_ms=c.get("threshold_ms"),
                unit=c.get("unit", "s"),
                labels=c.get("labels"), error_labels=c.get("error_labels"),
                windows=windows, severity=c.get("severity", "warning"),
                for_s=c.get("for_s", 0.0)))
        except KeyError as e:
            raise ValueError(
                f"slos[{i}] ({c.get('name', '?')}): missing field {e}"
            ) from e
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"slos[{i}] ({c.get('name', '?')}): {e}") from e
    return SLOSet(slos)
