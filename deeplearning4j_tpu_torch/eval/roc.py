"""ROC / AUC evaluation (DL4J ``eval/ROC.java``, ``ROCBinary``, ``ROCMultiClass``).

The port's own copy of ``deeplearning4j_tpu/eval/roc.py`` (importing that
package would import jax), numpy only, on host arrays.

Two modes, matching ``ROC.java:61-85``:

- ``threshold_steps=0`` (default): EXACT mode — scores are retained and
  AUROC/AUPRC computed by sorting (threshold-free).
- ``threshold_steps=N > 0``: BINNED mode — fixed thresholds ``i/N`` for
  ``i in 0..N``; only (TP, FP) counts per threshold plus the actual
  positive/negative totals are kept. This is the mode built for batched /
  distributed evaluation: state is O(N) regardless of dataset size and
  ``merge`` is count addition, so shards evaluate independently and merge
  without ever holding the score set in one host's memory. (Reference
  caveat applies: with very skewed score distributions the thresholded
  approach can underestimate the true area.)

Counting semantics match the reference's CompareAndSet pair
(``ROC.java:268-280``): predicted-positive at threshold t iff score >= t,
except at t == 1.0 where nothing is predicted positive — giving the curve
its (0,0) endpoint.
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _auc_roc(labels: np.ndarray, scores: np.ndarray) -> float:
    pos = labels > 0.5
    n_pos = int(pos.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.0
    order = np.argsort(scores)
    ranks = np.empty(len(scores), dtype=np.float64)
    # average ranks for ties
    sorted_scores = scores[order]
    ranks[order] = np.arange(1, len(scores) + 1)
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            avg = (i + j) / 2 + 1
            ranks[order[i:j + 1]] = avg
        i = j + 1
    sum_pos_ranks = ranks[pos].sum()
    return float((sum_pos_ranks - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def _auc_pr(labels: np.ndarray, scores: np.ndarray) -> float:
    order = np.argsort(-scores)
    l = labels[order] > 0.5
    tp = np.cumsum(l)
    fp = np.cumsum(~l)
    n_pos = int(l.sum())
    if n_pos == 0:
        return 0.0
    precision = tp / np.maximum(tp + fp, 1)
    recall = tp / n_pos
    # step-wise integration
    prev_r = 0.0
    area = 0.0
    for p, r in zip(precision, recall):
        area += p * (r - prev_r)
        prev_r = r
    return float(area)


class ROC:
    """Binary ROC: labels [N] or [N,2] (prob of class 1 scored)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = int(threshold_steps)
        self.is_exact = self.threshold_steps <= 0
        self.labels = []
        self.scores = []
        if not self.is_exact:
            n = self.threshold_steps
            self.thresholds = np.arange(n + 1, dtype=np.float64) / n
            self.tp_counts = np.zeros(n + 1, np.int64)
            self.fp_counts = np.zeros(n + 1, np.int64)
            self.count_actual_positive = 0
            self.count_actual_negative = 0

    def _eval_binned(self, labels: np.ndarray, scores: np.ndarray) -> None:
        pos = labels > 0.5
        self.count_actual_positive += int(pos.sum())
        self.count_actual_negative += int((~pos).sum())
        n = self.threshold_steps
        # O(N + steps): histogram scores into [i/n, (i+1)/n) bins, then
        # #(score >= i/n) is a reverse cumulative sum — score == i/n lands
        # in bin i, so the >= boundary semantics are exact.
        # +1e-9: keep a score EXACTLY at a threshold on the >= side despite
        # float rounding in scores * n (e.g. 0.3 * 10 == 2.9999999999999996)
        bins = np.clip(np.floor(scores * n + 1e-9).astype(np.int64), 0, n)
        pos_hist = np.bincount(bins[pos], minlength=n + 1)
        neg_hist = np.bincount(bins[~pos], minlength=n + 1)
        at_least = lambda h: np.cumsum(h[::-1])[::-1]
        tp, fp = at_least(pos_hist), at_least(neg_hist)
        tp[-1] = 0  # ROC.java:268 CompareAndSet pair: nothing passes t=1.0
        fp[-1] = 0
        self.tp_counts += tp
        self.fp_counts += fp

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None) -> None:
        labels = np.asarray(labels, np.float64)
        predictions = np.asarray(predictions, np.float64)
        if labels.ndim == 3:
            # time series [N,T,C]: flatten time; a [N,T] mask selects steps
            n, t, c = labels.shape
            labels = labels.reshape(n * t, c)
            predictions = predictions.reshape(n * t, -1)
            if mask is not None:
                m = np.asarray(mask).astype(bool)
                if m.shape != (n, t):
                    raise ValueError(
                        f"time-series ROC mask must be [N,T]; got {m.shape}")
                mask = m.reshape(n * t)
        if labels.ndim == 2 and labels.shape[1] == 2:
            labels = labels[:, 1]
            predictions = predictions[:, 1]
        elif labels.ndim == 2 and labels.shape[1] == 1:
            labels = labels[:, 0]
            predictions = predictions[:, 0]
        elif labels.ndim == 1 and predictions.ndim == 2:
            # 1-D class labels with [N, 2] probabilities: score class 1
            if predictions.shape[1] != 2:
                raise ValueError(
                    f"ROC is binary: got 1-D labels with [N, "
                    f"{predictions.shape[1]}] predictions (use ROCMultiClass)")
            predictions = predictions[:, -1]
        if mask is not None:
            m = np.asarray(mask).astype(bool).ravel()
            labels, predictions = labels[m], predictions[m]
        if self.is_exact:
            self.labels.append(labels.ravel())
            self.scores.append(predictions.ravel())
        else:
            self._eval_binned(labels.ravel(), predictions.ravel())

    def stats(self) -> str:
        """``ROC.stats()``: "AUC: [x]"."""
        return f"AUC: [{self.calculate_auc():.6f}]"

    # ---------------------------------------------------------------- curves
    def get_roc_curve(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(thresholds, fpr, tpr). Binned mode: one point per fixed
        threshold (``ROC.java getRocCurve``); exact mode: one point per
        distinct score."""
        if not self.is_exact:
            p = max(self.count_actual_positive, 1)
            n = max(self.count_actual_negative, 1)
            return (self.thresholds.copy(), self.fp_counts / n,
                    self.tp_counts / p)
        labels = np.concatenate(self.labels)
        scores = np.concatenate(self.scores)
        order = np.argsort(-scores)
        l = labels[order] > 0.5
        tp = np.cumsum(l)
        fp = np.cumsum(~l)
        n_pos, n_neg = max(int(l.sum()), 1), max(int((~l).sum()), 1)
        return (scores[order], fp / n_neg, tp / n_pos)

    def get_precision_recall_curve(self
                                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(thresholds, precision, recall) — ``getPrecisionRecallCurve``."""
        if not self.is_exact:
            p = max(self.count_actual_positive, 1)
            pred_pos = self.tp_counts + self.fp_counts
            precision = np.where(pred_pos > 0, self.tp_counts
                                 / np.maximum(pred_pos, 1), 1.0)
            return (self.thresholds.copy(), precision, self.tp_counts / p)
        labels = np.concatenate(self.labels)
        scores = np.concatenate(self.scores)
        order = np.argsort(-scores)
        l = labels[order] > 0.5
        tp = np.cumsum(l)
        fp = np.cumsum(~l)
        n_pos = max(int(l.sum()), 1)
        return (scores[order], tp / np.maximum(tp + fp, 1), tp / n_pos)

    def calculate_auc(self) -> float:
        if self.is_exact:
            return _auc_roc(np.concatenate(self.labels),
                            np.concatenate(self.scores))
        _, fpr, tpr = self.get_roc_curve()
        # thresholds ascend → (fpr, tpr) descend from (1,1) to (0,0)
        return float(_trapezoid(tpr[::-1], fpr[::-1]))

    def calculate_auc_pr(self) -> float:
        if self.is_exact:
            return _auc_pr(np.concatenate(self.labels),
                           np.concatenate(self.scores))
        _, precision, recall = self.get_precision_recall_curve()
        r, p = recall[::-1], precision[::-1]  # recall ascending
        return float(_trapezoid(p, r))

    # ----------------------------------------------------------- merge/serde
    def merge(self, other: "ROC") -> "ROC":
        """Distributed merge (``BaseEvaluation.merge``): count addition in
        binned mode (O(steps) state), score concatenation in exact mode."""
        if self.is_exact != other.is_exact or (
                not self.is_exact
                and self.threshold_steps != other.threshold_steps):
            raise ValueError(
                "cannot merge ROC instances with different threshold_steps "
                f"({self.threshold_steps} vs {other.threshold_steps})")
        if self.is_exact:
            self.labels.extend(other.labels)
            self.scores.extend(other.scores)
        else:
            self.tp_counts += other.tp_counts
            self.fp_counts += other.fp_counts
            self.count_actual_positive += other.count_actual_positive
            self.count_actual_negative += other.count_actual_negative
        return self

    def to_json(self) -> str:
        if self.is_exact:
            raise ValueError("exact-mode ROC state is the raw score set; "
                             "use threshold_steps > 0 for compact "
                             "serializable/mergeable state")
        return json.dumps({
            "threshold_steps": self.threshold_steps,
            "tp_counts": self.tp_counts.tolist(),
            "fp_counts": self.fp_counts.tolist(),
            "count_actual_positive": self.count_actual_positive,
            "count_actual_negative": self.count_actual_negative,
        })

    @staticmethod
    def from_json(s: str) -> "ROC":
        d = json.loads(s)
        r = ROC(threshold_steps=d["threshold_steps"])
        r.tp_counts = np.asarray(d["tp_counts"], np.int64)
        r.fp_counts = np.asarray(d["fp_counts"], np.int64)
        r.count_actual_positive = d["count_actual_positive"]
        r.count_actual_negative = d["count_actual_negative"]
        return r


class ROCBinary:
    """Per-output binary ROC for multi-label outputs [N, C]."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = int(threshold_steps)
        self.is_exact = self.threshold_steps <= 0
        self.labels = []
        self.scores = []
        self.masks = []  # per-batch [N, C] masks (or None), exact mode
        self._per_col = {}  # col -> binned ROC (ROCBinary.java mode)

    def _col_roc(self, col: int) -> "ROC":
        if col not in self._per_col:
            self._per_col[col] = ROC(threshold_steps=self.threshold_steps)
        return self._per_col[col]

    def num_labels(self) -> int:
        """Number of output columns seen so far (``numLabels``)."""
        if self._per_col:
            return max(self._per_col) + 1
        if self.labels:
            return int(np.asarray(self.labels[0]).shape[-1])
        return 0

    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels, np.float64)
        predictions = np.asarray(predictions, np.float64)
        if labels.ndim == 3:
            # time series [N,T,C]: flatten time; a [N,T] mask selects rows
            n, t, c = labels.shape
            labels = labels.reshape(n * t, c)
            predictions = predictions.reshape(n * t, -1)
            if mask is not None:
                m = np.asarray(mask).astype(bool)
                if m.shape == (n, t):
                    keep = m.reshape(n * t)
                    labels, predictions = labels[keep], predictions[keep]
                    mask = None
                else:  # [N,T,C] per-output mask
                    mask = m.reshape(n * t, c)
        m2 = None  # [N, C] per-output mask (ROCBinary.java supports both)
        if mask is not None:
            m = np.asarray(mask).astype(bool)
            if m.ndim == 2:
                m2 = m
            else:
                m = m.ravel()
                labels, predictions = labels[m], predictions[m]
        if self.is_exact:
            self.labels.append(labels)
            self.scores.append(predictions)
            self.masks.append(m2)
        else:
            for col in range(labels.shape[1]):
                keep = slice(None) if m2 is None else m2[:, col]
                self._col_roc(col).eval(labels[keep, col],
                                        predictions[keep, col])

    def calculate_auc(self, col: int) -> float:
        if not self.is_exact:
            return self._col_roc(col).calculate_auc()
        l = np.concatenate(self.labels)[:, col]
        s = np.concatenate(self.scores)[:, col]
        ms = [np.ones(len(lb), bool) if mk is None else mk[:, col]
              for lb, mk in zip(self.labels, self.masks)]
        keep = np.concatenate(ms)
        return _auc_roc(l[keep], s[keep])

    def get_roc_curve(self, col: int):
        """(thresholds, fpr, tpr) for one output column
        (``ROCBinary.getRocCurve``)."""
        return self._single(col).get_roc_curve()

    def get_precision_recall_curve(self, col: int):
        return self._single(col).get_precision_recall_curve()

    def _single(self, col: int) -> "ROC":
        if not self.is_exact:
            return self._col_roc(col)
        r = ROC()
        for lb, sc, mk in zip(self.labels, self.scores, self.masks):
            keep = slice(None) if mk is None else mk[:, col]
            r.eval(lb[keep, col], sc[keep, col])
        return r

    def merge(self, other: "ROCBinary") -> "ROCBinary":
        if self.is_exact != other.is_exact:
            raise ValueError("cannot merge exact with binned ROCBinary")
        if self.is_exact:
            self.labels.extend(other.labels)
            self.scores.extend(other.scores)
            self.masks.extend(other.masks)
        else:
            for col, r in other._per_col.items():
                self._col_roc(col).merge(r)
        return self


class ROCMultiClass:
    """One-vs-all ROC per class for softmax outputs [N, C]."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = int(threshold_steps)
        self.is_exact = self.threshold_steps <= 0
        self.labels = []
        self.scores = []
        self._per_cls = {}

    def _cls_roc(self, cls: int) -> "ROC":
        if cls not in self._per_cls:
            self._per_cls[cls] = ROC(threshold_steps=self.threshold_steps)
        return self._per_cls[cls]

    def num_classes(self) -> int:
        """Number of classes seen so far."""
        if self._per_cls:
            return max(self._per_cls) + 1
        if self.scores:
            return int(np.asarray(self.scores[0]).shape[-1])
        return 0

    def eval(self, labels, predictions, mask=None) -> None:
        labels = np.asarray(labels, np.float64)
        predictions = np.asarray(predictions, np.float64)
        if labels.ndim == 3 or predictions.ndim == 3:
            # time series [N,T,C]: flatten time; a [N,T] mask selects steps
            n, t = predictions.shape[:2]
            predictions = predictions.reshape(n * t, -1)
            labels = (labels.reshape(n * t, -1) if labels.ndim == 3
                      else labels.reshape(n * t))
            if mask is not None:
                m = np.asarray(mask).astype(bool)
                if m.shape != (n, t):
                    raise ValueError(
                        f"time-series ROCMultiClass mask must be [N,T]; got "
                        f"{m.shape}")
                mask = m.reshape(n * t)
        if mask is not None:
            # one-vs-all over softmax outputs: a mask is per-EXAMPLE; a 2-D
            # [N, 1] column is accepted and flattened
            m = np.asarray(mask).astype(bool)
            if m.ndim == 2 and m.shape[1] != 1:
                raise ValueError(
                    "ROCMultiClass masks are per-example ([N] or [N,1]); "
                    f"got shape {m.shape}")
            m = m.ravel()
            labels, predictions = labels[m], predictions[m]
        if self.is_exact:
            self.labels.append(labels)
            self.scores.append(predictions)
            return
        for cls in range(predictions.shape[1]):
            binary = (labels[:, cls] if labels.ndim == 2
                      else (labels == cls).astype(np.float64))
            self._cls_roc(cls).eval(binary, predictions[:, cls])

    def calculate_auc(self, cls: int) -> float:
        if not self.is_exact:
            return self._cls_roc(cls).calculate_auc()
        l = np.concatenate(self.labels)
        s = np.concatenate(self.scores)
        if l.ndim == 2:
            binary = l[:, cls]
        else:
            binary = (l == cls).astype(np.float64)
        return _auc_roc(binary, s[:, cls])

    def get_roc_curve(self, cls: int):
        """(thresholds, fpr, tpr) one-vs-all for one class
        (``ROCMultiClass.getRocCurve``)."""
        return self._single(cls).get_roc_curve()

    def get_precision_recall_curve(self, cls: int):
        return self._single(cls).get_precision_recall_curve()

    def _single(self, cls: int) -> "ROC":
        if not self.is_exact:
            return self._cls_roc(cls)
        r = ROC()
        for lb, sc in zip(self.labels, self.scores):
            binary = (lb[:, cls] if lb.ndim == 2
                      else (lb == cls).astype(np.float64))
            r.eval(binary, sc[:, cls])
        return r

    def merge(self, other: "ROCMultiClass") -> "ROCMultiClass":
        if self.is_exact != other.is_exact:
            raise ValueError("cannot merge exact with binned ROCMultiClass")
        if self.is_exact:
            self.labels.extend(other.labels)
            self.scores.extend(other.scores)
        else:
            for cls, r in other._per_cls.items():
                self._cls_roc(cls).merge(r)
        return self
