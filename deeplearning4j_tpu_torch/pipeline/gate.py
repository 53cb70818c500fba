"""Eval gate: the candidate must beat (or stay within margins of) the
serving version on a held-out eval set before any traffic touches it.

The EVAL stage of the pipeline.  Two metrics:

- ``"loss"`` (default): mean loss on the eval set, lower is better —
  candidate passes when
  ``cand <= base * (1 + rel_margin) + abs_margin``;
- ``"accuracy"``: top-1 classification accuracy via the evaluation
  surface, higher is better — candidate passes when
  ``cand >= base * (1 - rel_margin) - abs_margin``.

The full :class:`GateResult` (both measurements, margins, verdict) is
what the pipeline runner records in the journal's EVAL commit, so every
promote/rollback decision is auditable after the fact.

The port's copy of the JAX package's jax-free ``pipeline/gate.py``:
``measure`` runs the network's ``score`` or ``evaluate`` on the
network's device.
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, ListDataSetIterator

GATE_METRICS = ("loss", "accuracy")


class GateResult:
    """One gate evaluation: the candidate and baseline measurements and
    the pass/fail verdict with its reasoning."""

    __slots__ = ("passed", "metric", "candidate", "baseline", "threshold",
                 "detail")

    def __init__(self, passed: bool, metric: str, candidate: float,
                 baseline: float, threshold: float, detail: str):
        self.passed = bool(passed)
        self.metric = metric
        self.candidate = float(candidate)
        self.baseline = float(baseline)
        self.threshold = float(threshold)
        self.detail = detail

    def to_dict(self) -> dict:
        return {"passed": self.passed, "metric": self.metric,
                "candidate": self.candidate, "baseline": self.baseline,
                "threshold": self.threshold, "detail": self.detail}

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"GateResult({'PASS' if self.passed else 'FAIL'} "
                f"{self.metric}: cand={self.candidate:.6g} vs "
                f"base={self.baseline:.6g}, thr={self.threshold:.6g})")


class EvalGate:
    """Held-out comparison gate between a candidate and the live model.

    ``eval_set`` is a ``DataSet``; margins are relative and absolute
    slack on the baseline's measurement (both default 0 — the candidate
    must strictly meet the serving model).  ``batch_size`` only matters
    for the accuracy metric's iterator.
    """

    def __init__(self, eval_set: DataSet, *, metric: str = "loss",
                 rel_margin: float = 0.0, abs_margin: float = 0.0,
                 batch_size: int = 64):
        if metric not in GATE_METRICS:
            raise ValueError(f"unknown gate metric {metric!r} "
                             f"(one of {GATE_METRICS})")
        if rel_margin < 0 or abs_margin < 0:
            raise ValueError("gate margins must be >= 0")
        self.eval_set = eval_set
        self.metric = metric
        self.rel_margin = float(rel_margin)
        self.abs_margin = float(abs_margin)
        self.batch_size = int(batch_size)

    # ------------------------------------------------------------ measure
    def measure(self, model) -> float:
        if self.metric == "loss":
            return float(model.score(self.eval_set))
        it = ListDataSetIterator(self.eval_set, self.batch_size)
        return float(model.evaluate(it).accuracy())

    def evaluate(self, candidate, baseline,
                 baseline_value: Optional[float] = None) -> GateResult:
        """Gate ``candidate`` against ``baseline`` (or a pre-measured
        ``baseline_value`` — e.g. the journaled measurement of the
        serving version, so a resumed EVAL compares against the same
        number)."""
        base = (self.measure(baseline) if baseline_value is None
                else float(baseline_value))
        cand = self.measure(candidate)
        if self.metric == "loss":
            threshold = base * (1.0 + self.rel_margin) + self.abs_margin
            passed = cand <= threshold
            cmp = "<="
        else:
            threshold = base * (1.0 - self.rel_margin) - self.abs_margin
            passed = cand >= threshold
            cmp = ">="
        return GateResult(
            passed, self.metric, cand, base, threshold,
            f"candidate {self.metric} {cand:.6g} {cmp} {threshold:.6g} "
            f"(baseline {base:.6g}, rel_margin={self.rel_margin}, "
            f"abs_margin={self.abs_margin}): "
            f"{'PASS' if passed else 'FAIL'}")
