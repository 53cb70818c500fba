"""Regression evaluation (DL4J ``eval/RegressionEvaluation.java``):
per-column MSE / MAE / RMSE / RSE / PC (Pearson) / R².

The port's own copy of ``deeplearning4j_tpu/eval/regression.py`` (importing
that package would import jax), numpy only, on host arrays."""

from __future__ import annotations

from typing import Optional

import numpy as np


class RegressionEvaluation:
    def __init__(self, n_columns: Optional[int] = None):
        self.n = 0
        self.labels_sum = None
        self.labels_sq_sum = None
        self.preds_sum = None
        self.preds_sq_sum = None
        self.cross_sum = None
        self.abs_err_sum = None
        self.sq_err_sum = None

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None) -> None:
        labels = np.asarray(labels, np.float64)
        predictions = np.asarray(predictions, np.float64)
        if labels.ndim == 3:
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
            if mask is not None:
                m = np.asarray(mask).reshape(-1).astype(bool)
                labels, predictions = labels[m], predictions[m]
        if self.labels_sum is None:
            c = labels.shape[-1]
            self.labels_sum = np.zeros(c)
            self.labels_sq_sum = np.zeros(c)
            self.preds_sum = np.zeros(c)
            self.preds_sq_sum = np.zeros(c)
            self.cross_sum = np.zeros(c)
            self.abs_err_sum = np.zeros(c)
            self.sq_err_sum = np.zeros(c)
        self.n += labels.shape[0]
        self.labels_sum += labels.sum(0)
        self.labels_sq_sum += (labels ** 2).sum(0)
        self.preds_sum += predictions.sum(0)
        self.preds_sq_sum += (predictions ** 2).sum(0)
        self.cross_sum += (labels * predictions).sum(0)
        self.abs_err_sum += np.abs(labels - predictions).sum(0)
        self.sq_err_sum += ((labels - predictions) ** 2).sum(0)

    def merge(self, other: "RegressionEvaluation") -> "RegressionEvaluation":
        """Distributed merge (``BaseEvaluation.merge``): every metric here
        is derived from per-column sums, so merging is sum addition."""
        if other.labels_sum is None:
            return self
        if self.labels_sum is None:
            for a in ("labels_sum", "labels_sq_sum", "preds_sum",
                      "preds_sq_sum", "cross_sum", "abs_err_sum",
                      "sq_err_sum"):
                setattr(self, a, getattr(other, a).copy())
            self.n = other.n
            return self
        for a in ("labels_sum", "labels_sq_sum", "preds_sum",
                  "preds_sq_sum", "cross_sum", "abs_err_sum", "sq_err_sum"):
            setattr(self, a, getattr(self, a) + getattr(other, a))
        self.n += other.n
        return self

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self.sq_err_sum[col] / self.n)

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self.abs_err_sum[col] / self.n)

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.sq_err_sum[col] / self.n))

    def relative_squared_error(self, col: int = 0) -> float:
        mean_label = self.labels_sum[col] / self.n
        denom = self.labels_sq_sum[col] - self.n * mean_label ** 2
        return float(self.sq_err_sum[col] / denom) if denom else float("inf")

    def pearson_correlation(self, col: int = 0) -> float:
        n = self.n
        num = self.cross_sum[col] - self.labels_sum[col] * self.preds_sum[col] / n
        d1 = self.labels_sq_sum[col] - self.labels_sum[col] ** 2 / n
        d2 = self.preds_sq_sum[col] - self.preds_sum[col] ** 2 / n
        denom = np.sqrt(d1 * d2)
        return float(num / denom) if denom else 0.0

    def r_squared(self, col: int = 0) -> float:
        mean_label = self.labels_sum[col] / self.n
        ss_tot = self.labels_sq_sum[col] - self.n * mean_label ** 2
        return float(1.0 - self.sq_err_sum[col] / ss_tot) if ss_tot else 0.0

    # -- column-averaged metrics + introspection (RegressionEvaluation.java
    #    averageX()/numColumns/reset/scoreForMetric surface) ----------------
    def num_columns(self) -> int:
        return 0 if self.labels_sum is None else len(self.labels_sum)

    def reset(self) -> None:
        self.n = 0
        for a in ("labels_sum", "labels_sq_sum", "preds_sum", "preds_sq_sum",
                  "cross_sum", "abs_err_sum", "sq_err_sum"):
            setattr(self, a, None)

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self.sq_err_sum / self.n))

    def average_mean_absolute_error(self) -> float:
        return float(np.mean(self.abs_err_sum / self.n))

    def average_root_mean_squared_error(self) -> float:
        return float(np.mean([self.root_mean_squared_error(c)
                              for c in range(self.num_columns())]))

    def average_relative_squared_error(self) -> float:
        return float(np.mean([self.relative_squared_error(c)
                              for c in range(self.num_columns())]))

    def average_pearson_correlation(self) -> float:
        return float(np.mean([self.pearson_correlation(c)
                              for c in range(self.num_columns())]))

    def average_r_squared(self) -> float:
        return float(np.mean([self.r_squared(c)
                              for c in range(self.num_columns())]))

    def score_for_metric(self, metric: str) -> float:
        """Column-averaged metric by name (``scoreForMetric``): MSE, MAE,
        RMSE, RSE, PC, R2 (case-insensitive)."""
        key = metric.upper()
        table = {
            "MSE": self.average_mean_squared_error,
            "MAE": self.average_mean_absolute_error,
            "RMSE": self.average_root_mean_squared_error,
            "RSE": self.average_relative_squared_error,
            "PC": self.average_pearson_correlation,
            "R2": self.average_r_squared,
        }
        if key not in table:
            raise ValueError(f"unknown regression metric {metric!r}; "
                             f"expected one of {sorted(table)}")
        return table[key]()

    def stats(self) -> str:
        cols = len(self.labels_sum)
        lines = ["Column    MSE            MAE            RMSE           R^2"]
        for c in range(cols):
            lines.append(f"col_{c}    {self.mean_squared_error(c):.6f}    "
                         f"{self.mean_absolute_error(c):.6f}    "
                         f"{self.root_mean_squared_error(c):.6f}    "
                         f"{self.r_squared(c):.6f}")
        return "\n".join(lines)
