"""Per-output binary evaluation (DL4J ``eval/EvaluationBinary.java``):
independent accuracy/precision/recall/F1 per output column at threshold 0.5.

The port's own copy of ``deeplearning4j_tpu/eval/binary.py`` (importing that
package would import jax), numpy only, on host arrays."""

from __future__ import annotations

from typing import Optional

import numpy as np


class EvaluationBinary:
    def __init__(self, decision_threshold: float = 0.5):
        self.threshold = decision_threshold
        self.tp = None
        self.fp = None
        self.tn = None
        self.fn = None

    def eval(self, labels, predictions, mask: Optional[np.ndarray] = None) -> None:
        labels = np.asarray(labels) > 0.5
        preds = np.asarray(predictions) > self.threshold
        if labels.ndim == 1:
            labels = labels[:, None]
            preds = preds[:, None]
        if mask is not None:
            m = np.asarray(mask).astype(bool)
            if m.ndim == 1:
                m = m[:, None]
            valid = np.broadcast_to(m, labels.shape)
        else:
            valid = np.ones_like(labels, bool)
        c = labels.shape[-1]
        if self.tp is None:
            self.tp = np.zeros(c, np.int64)
            self.fp = np.zeros(c, np.int64)
            self.tn = np.zeros(c, np.int64)
            self.fn = np.zeros(c, np.int64)
        self.tp += np.sum(valid & labels & preds, axis=0)
        self.fp += np.sum(valid & ~labels & preds, axis=0)
        self.tn += np.sum(valid & ~labels & ~preds, axis=0)
        self.fn += np.sum(valid & labels & ~preds, axis=0)

    def merge(self, other: "EvaluationBinary") -> "EvaluationBinary":
        """Distributed merge (``BaseEvaluation.merge``): count addition."""
        if other.tp is None:
            return self
        if self.tp is None:
            self.tp, self.fp = other.tp.copy(), other.fp.copy()
            self.tn, self.fn = other.tn.copy(), other.fn.copy()
            return self
        self.tp += other.tp
        self.fp += other.fp
        self.tn += other.tn
        self.fn += other.fn
        return self

    def accuracy(self, col: int = 0) -> float:
        total = self.tp[col] + self.fp[col] + self.tn[col] + self.fn[col]
        return float(self.tp[col] + self.tn[col]) / max(total, 1)

    def precision(self, col: int = 0) -> float:
        d = self.tp[col] + self.fp[col]
        return float(self.tp[col]) / d if d else 0.0

    def recall(self, col: int = 0) -> float:
        d = self.tp[col] + self.fn[col]
        return float(self.tp[col]) / d if d else 0.0

    def f1(self, col: int = 0) -> float:
        p, r = self.precision(col), self.recall(col)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def stats(self, labels=None) -> str:
        """Per-output table (``EvaluationBinary.stats()``)."""
        if self.tp is None:
            raise ValueError("No evaluation data; call eval() first")
        n = len(self.tp)
        labels = labels or [f"label_{i}" for i in range(n)]
        width = max(len(str(l)) for l in labels)
        lines = ["================== Evaluation (binary) ==================",
                 f" {'':<{width}}  {'acc':>7} {'prec':>7} {'rec':>7} "
                 f"{'f1':>7} {'tp':>6} {'fp':>6} {'tn':>6} {'fn':>6}"]
        for i in range(n):
            lines.append(
                f" {labels[i]:<{width}}  {self.accuracy(i):7.4f} "
                f"{self.precision(i):7.4f} {self.recall(i):7.4f} "
                f"{self.f1(i):7.4f} {int(self.tp[i]):6d} "
                f"{int(self.fp[i]):6d} {int(self.tn[i]):6d} "
                f"{int(self.fn[i]):6d}")
        return "\n".join(lines)
