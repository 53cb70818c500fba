"""Calibration evaluation (DL4J ``eval/EvaluationCalibration.java``).

The port's own copy of ``deeplearning4j_tpu/eval/calibration.py``
(importing that package would import jax), numpy only, on host arrays.

Full reference depth: PER-CLASS reliability diagrams
(``getReliabilityDiagram(classIdx)``), per-class residual plots
(``getResidualPlot``) and probability histograms
(``getProbabilityHistogram``), overall variants, label/prediction class
counts, merge/reset — computed with the same bin semantics (last bin closed
at 1.0, positive-label rows selected by the label matrix, per-example or
per-output masks). Plus ``expected_calibration_error`` as the summary
scalar the dashboard panel plots.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Histogram:
    """``org.deeplearning4j.eval.curves.Histogram`` counterpart."""

    title: str
    lower: float
    upper: float
    counts: np.ndarray

    @property
    def bin_edges(self) -> np.ndarray:
        return np.linspace(self.lower, self.upper, len(self.counts) + 1)

    def to_dict(self) -> dict:
        return {"title": self.title, "lower": self.lower, "upper": self.upper,
                "counts": [int(c) for c in self.counts]}


@dataclasses.dataclass
class ReliabilityDiagram:
    """``eval/curves/ReliabilityDiagram`` counterpart."""

    title: str
    mean_predicted_value: np.ndarray
    frac_positives: np.ndarray

    def to_dict(self) -> dict:
        return {"title": self.title,
                "mean_predicted_value": [float(v) for v in self.mean_predicted_value],
                "frac_positives": [float(v) for v in self.frac_positives]}


class EvaluationCalibration:
    def __init__(self, reliability_bins: int = 10, histogram_bins: int = 50,
                 exclude_empty_bins: bool = True):
        self.rel_bins = reliability_bins
        self.hist_bins = histogram_bins
        self.exclude_empty_bins = exclude_empty_bins
        self._n_classes: Optional[int] = None

    # ------------------------------------------------------------- state
    def _init_state(self, n_classes: int) -> None:
        self._n_classes = n_classes
        b, h, c = self.rel_bins, self.hist_bins, n_classes
        # reliability: per (bin, class), matching rDiagBin* layouts
        self.rdiag_pos = np.zeros((b, c), np.int64)
        self.rdiag_total = np.zeros((b, c), np.int64)
        self.rdiag_sum_pred = np.zeros((b, c), np.float64)
        self.label_counts = np.zeros(c, np.int64)
        self.prediction_counts = np.zeros(c, np.int64)
        self.residual_overall = np.zeros(h, np.int64)
        self.residual_by_class = np.zeros((h, c), np.int64)
        self.prob_overall = np.zeros(h, np.int64)
        self.prob_by_class = np.zeros((h, c), np.int64)

    def reset(self) -> None:
        """Clear all accumulated statistics (rebuilt on the next eval)."""
        self._n_classes = None
        for f in ("rdiag_pos", "rdiag_total", "rdiag_sum_pred",
                  "label_counts", "prediction_counts", "residual_overall",
                  "residual_by_class", "prob_overall", "prob_by_class"):
            if hasattr(self, f):
                delattr(self, f)

    @property
    def num_classes(self) -> int:
        return -1 if self._n_classes is None else self._n_classes

    # --------------------------------------------------------------- eval
    def eval(self, labels, predictions, mask: Optional[np.ndarray] = None) -> None:
        labels = np.asarray(labels, np.float64)
        preds = np.asarray(predictions, np.float64)
        if labels.ndim == 1:
            labels = labels[:, None]
            preds = preds[:, None]
        if labels.ndim == 3:  # [N,T,C] time series → fold time into batch
            labels = labels.reshape(-1, labels.shape[-1])
            preds = preds.reshape(-1, preds.shape[-1])
            if mask is not None:
                mask = np.asarray(mask)
                mask = (mask.reshape(-1, mask.shape[-1]) if mask.ndim == 3
                        else mask.reshape(-1))  # [N,T,C] per-output / [N,T]
        n, c = labels.shape
        if self._n_classes is None:
            self._init_state(c)
        elif c != self._n_classes:
            raise ValueError(f"n_classes changed: {self._n_classes} → {c}")

        if mask is not None:
            m = np.asarray(mask, np.float64)
            if m.ndim == 1 or (m.ndim == 2 and m.shape[1] == 1):
                m = m.reshape(-1, 1) * np.ones((1, c))  # per-example
        else:
            m = np.ones_like(labels)
        valid = m > 0
        l_masked = labels * m
        cols = np.broadcast_to(np.arange(c), labels.shape)
        pos = (l_masked > 0.5)

        # reliability bins: [j/b, (j+1)/b), last bin closed at 1.0; clip
        # keeps slightly-out-of-range values countable (old np.clip behavior)
        bins = np.clip((preds * self.rel_bins).astype(int), 0,
                       self.rel_bins - 1)
        np.add.at(self.rdiag_total, (bins[valid], cols[valid]), 1)
        pv = pos & valid
        np.add.at(self.rdiag_pos, (bins[pv], cols[pv]), 1)
        np.add.at(self.rdiag_sum_pred, (bins[valid], cols[valid]),
                  preds[valid])

        self.label_counts += pos.sum(axis=0).astype(np.int64)
        # argmax over VALID outputs only (a per-output-masked column must
        # not be countable as the predicted class)
        pred_class = np.where(valid, preds, -np.inf).argmax(axis=1)
        row_valid = valid.any(axis=1)
        np.add.at(self.prediction_counts, pred_class[row_valid], 1)

        # residual + probability histograms (positive-label rows feed the
        # per-class columns, exactly the reference's l.mul(bitmask) selection)
        resid = np.abs(labels - preds)
        rb = np.clip((resid * self.hist_bins).astype(int), 0,
                     self.hist_bins - 1)
        pb = np.clip((preds * self.hist_bins).astype(int), 0,
                     self.hist_bins - 1)
        np.add.at(self.residual_overall, rb[valid], 1)
        np.add.at(self.residual_by_class, (rb[pv], cols[pv]), 1)
        np.add.at(self.prob_overall, pb[valid], 1)
        np.add.at(self.prob_by_class, (pb[pv], cols[pv]), 1)

    def merge(self, other: "EvaluationCalibration") -> None:
        if self.rel_bins != other.rel_bins or self.hist_bins != other.hist_bins:
            raise ValueError("cannot merge calibrations with different bins")
        if other._n_classes is None:
            return
        if self._n_classes is None:
            self._init_state(other._n_classes)
        elif self._n_classes != other._n_classes:
            raise ValueError(
                f"cannot merge calibrations over different class counts "
                f"({self._n_classes} vs {other._n_classes})")
        for f in ("rdiag_pos", "rdiag_total", "rdiag_sum_pred", "label_counts",
                  "prediction_counts", "residual_overall", "residual_by_class",
                  "prob_overall", "prob_by_class"):
            setattr(self, f, getattr(self, f) + getattr(other, f))

    # ------------------------------------------------------------ getters
    def _check_class(self, class_idx: int) -> None:
        if self._n_classes is None:
            raise ValueError("no data evaluated yet (or reset() was called)")
        if not (0 <= class_idx < self._n_classes):
            raise IndexError(
                f"class index {class_idx} out of range [0, {self._n_classes})")

    def _zero_hist(self, title: str) -> Histogram:
        return Histogram(title, 0.0, 1.0,
                         np.zeros(self.hist_bins, np.int64))

    def get_reliability_diagram(self, class_idx: int) -> ReliabilityDiagram:
        """Per-class reliability curve (``getReliabilityDiagram:309``)."""
        self._check_class(class_idx)
        total = self.rdiag_total[:, class_idx].astype(np.float64)
        mean_pred = np.divide(self.rdiag_sum_pred[:, class_idx], total,
                              out=np.zeros_like(total), where=total > 0)
        frac_pos = np.divide(self.rdiag_pos[:, class_idx], total,
                             out=np.zeros_like(total), where=total > 0)
        if self.exclude_empty_bins:
            keep = total > 0
            mean_pred, frac_pos = mean_pred[keep], frac_pos[keep]
        return ReliabilityDiagram(
            f"Reliability Diagram: Class {class_idx}", mean_pred, frac_pos)

    def get_residual_plot_all_classes(self) -> Histogram:
        title = "Residual Plot - All Predictions and Classes"
        if self._n_classes is None:
            return self._zero_hist(title)
        return Histogram(title, 0.0, 1.0, self.residual_overall.copy())

    def get_residual_plot(self, class_idx: int) -> Histogram:
        self._check_class(class_idx)
        return Histogram(
            f"Residual Plot - Predictions for Label Class {class_idx}",
            0.0, 1.0, self.residual_by_class[:, class_idx].copy())

    def get_probability_histogram_all_classes(self) -> Histogram:
        title = "Network Probabilities Histogram - All Predictions and Classes"
        if self._n_classes is None:
            return self._zero_hist(title)
        return Histogram(title, 0.0, 1.0, self.prob_overall.copy())

    def get_probability_histogram(self, class_idx: int) -> Histogram:
        self._check_class(class_idx)
        return Histogram(
            f"Network Probabilities Histogram - P(class {class_idx}) - "
            f"Data Labelled Class {class_idx} Only",
            0.0, 1.0, self.prob_by_class[:, class_idx].copy())

    # ------------------------------------------- overall summary (legacy)
    def reliability_diagram(self):
        """Overall (all classes pooled): (mean predicted prob, observed
        frequency) per bin — the pre-per-class summary view. Zeros before
        any data has been evaluated (fresh or reset instance)."""
        if self._n_classes is None:
            return np.zeros(self.rel_bins), np.zeros(self.rel_bins)
        total = self.rdiag_total.sum(axis=1).astype(np.float64)
        denom = np.maximum(total, 1)
        return (self.rdiag_sum_pred.sum(axis=1) / denom,
                self.rdiag_pos.sum(axis=1) / denom)

    def expected_calibration_error(self) -> float:
        if self._n_classes is None:
            return 0.0
        mean_p, obs = self.reliability_diagram()
        counts = self.rdiag_total.sum(axis=1)
        w = counts / max(counts.sum(), 1)
        return float(np.sum(w * np.abs(mean_p - obs)))

    def stats(self) -> str:
        return (f"EvaluationCalibration(nBins={self.rel_bins}, "
                f"ECE={self.expected_calibration_error():.4f})")
