"""Classification evaluation: accuracy, top-N, precision, recall, F-beta,
G-measure, MCC, the confusion matrix and its count maps.

The port's own copy of ``Evaluation`` and ``Prediction`` from
``deeplearning4j_tpu/eval/evaluation.py`` (importing that package would
import jax), numpy only, on host arrays. DL4J's conventions
(``eval/Evaluation.java``): macro averages run over the classes with at
least one true or predicted instance; a per-timestep ``[N, T, C]`` output
is flattened with the label mask applied; an example is top-N correct
when fewer than N class probabilities are strictly greater than the true
class's; ``record_meta_data`` given to ``eval`` keeps each record's
prediction for ``get_prediction_errors`` and the ``get_predictions*``
drill-downs. ``merge`` adds the counts of another evaluation (the
distributed form), ``to_json``/``from_json`` carry them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Prediction:
    """One recorded prediction (``eval/meta/Prediction.java``)."""

    actual: int
    predicted: int
    record_meta_data: Any

    def get_record_meta_data(self):
        return self.record_meta_data


class Evaluation:
    def __init__(self, num_classes: Optional[int] = None, labels_list=None,
                 top_n: int = 1):
        self.num_classes = num_classes
        self._initial_num_classes = num_classes  # restored by reset()
        self.labels_list = labels_list
        self.confusion: Optional[np.ndarray] = None  # [true, predicted]
        self.top_n = max(int(top_n), 1)
        self.top_n_correct_count = 0
        self.top_n_total_count = 0
        # (actual, predicted) → list of metadata; None until metadata seen
        self.confusion_meta: Optional[
            Dict[Tuple[int, int], List[Any]]] = None

    # ----------------------------------------------------------------- eval
    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None,
             record_meta_data: Optional[List[Any]] = None) -> None:
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:  # [N,T,C] → flatten time, applying mask
            n, t, c = labels.shape
            labels = labels.reshape(n * t, c)
            predictions = predictions.reshape(n * t, -1)
            if record_meta_data is not None:
                record_meta_data = [m for m in record_meta_data
                                    for _ in range(t)]
            if mask is not None:
                m = np.asarray(mask).reshape(n * t).astype(bool)
                labels = labels[m]
                predictions = predictions[m]
                if record_meta_data is not None:
                    record_meta_data = [x for x, keep
                                        in zip(record_meta_data, m) if keep]
        elif mask is not None:
            m = np.asarray(mask).astype(bool).ravel()
            labels = labels[m]
            predictions = predictions[m]
            if record_meta_data is not None:
                record_meta_data = [x for x, keep
                                    in zip(record_meta_data, m) if keep]

        if labels.ndim == 2 and labels.shape[1] > 1:
            true_idx = np.argmax(labels, axis=1)
            nc = labels.shape[1]
        else:
            true_idx = labels.astype(int).ravel()
            nc = self.num_classes or int(max(true_idx.max(), 0)) + 1
        if predictions.ndim == 2 and predictions.shape[1] > 1:
            pred_idx = np.argmax(predictions, axis=1)
            nc = max(nc, predictions.shape[1])
        else:
            pred_idx = (predictions.ravel() > 0.5).astype(int)
            nc = max(nc, 2)

        # grow the confusion matrix if a later batch reveals a higher class
        needed = max(nc, int(true_idx.max(initial=0)) + 1,
                     int(pred_idx.max(initial=0)) + 1,
                     self.num_classes or 0)
        if self.num_classes is None or needed > self.num_classes:
            old = self.confusion
            self.num_classes = needed
            self.confusion = np.zeros((needed, needed), np.int64)
            if old is not None:
                self.confusion[:old.shape[0], :old.shape[1]] = old
        elif self.confusion is None:
            self.confusion = np.zeros((self.num_classes, self.num_classes), np.int64)
        np.add.at(self.confusion, (true_idx, pred_idx), 1)

        # top-N accuracy (Evaluation.java:437: top-N correct when fewer
        # than N probabilities are STRICTLY greater than the true class's)
        if (self.top_n > 1 and predictions.ndim == 2
                and predictions.shape[1] > 1):
            true_prob = predictions[np.arange(len(true_idx)), true_idx]
            greater = (predictions > true_prob[:, None]).sum(axis=1)
            self.top_n_correct_count += int((greater < self.top_n).sum())
            self.top_n_total_count += len(true_idx)

        # per-record metadata → meta confusion matrix
        # (Evaluation.java:1481 addToMetaConfusionMatrix)
        if record_meta_data is not None:
            if len(record_meta_data) != len(true_idx):
                raise ValueError(
                    f"record_meta_data length {len(record_meta_data)} != "
                    f"number of (unmasked) examples {len(true_idx)}")
            if self.confusion_meta is None:
                self.confusion_meta = {}
            for a, p, m in zip(true_idx, pred_idx, record_meta_data):
                self.confusion_meta.setdefault((int(a), int(p)), []).append(m)

    def eval_time_series(self, labels, predictions, labels_mask=None):
        self.eval(labels, predictions, mask=labels_mask)

    # -------------------------------------------------------------- metrics
    def _check(self):
        if self.confusion is None:
            raise ValueError("No evaluation data; call eval() first")

    def accuracy(self) -> float:
        self._check()
        total = self.confusion.sum()
        return float(np.trace(self.confusion)) / max(total, 1)

    def top_n_accuracy(self) -> float:
        """``Evaluation.java:1159``: fraction of examples whose true class
        probability is among the N highest. Equals ``accuracy()`` when
        ``top_n == 1``."""
        if self.top_n <= 1:
            return self.accuracy()
        if self.top_n_total_count == 0:
            return 0.0
        return self.top_n_correct_count / self.top_n_total_count

    def _tp(self, i) -> int:
        return int(self.confusion[i, i])

    def _fp(self, i) -> int:
        return int(self.confusion[:, i].sum() - self.confusion[i, i])

    def _fn(self, i) -> int:
        return int(self.confusion[i, :].sum() - self.confusion[i, i])

    def precision(self, cls: Optional[int] = None) -> float:
        self._check()
        if cls is not None:
            denom = self._tp(cls) + self._fp(cls)
            return self._tp(cls) / denom if denom else 0.0
        vals = [self.precision(i) for i in range(self.num_classes)
                if self.confusion[:, i].sum() + self.confusion[i, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        self._check()
        if cls is not None:
            denom = self._tp(cls) + self._fn(cls)
            return self._tp(cls) / denom if denom else 0.0
        vals = [self.recall(i) for i in range(self.num_classes)
                if self.confusion[:, i].sum() + self.confusion[i, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f_beta(self, beta: float, cls: Optional[int] = None,
               averaging: str = "macro") -> float:
        """``Evaluation.fBeta(beta, class)`` — F-measure with recall
        weighted beta times as much as precision."""
        self._check()
        b2 = beta * beta
        if cls is not None:
            p, r = self.precision(cls), self.recall(cls)
            denom = b2 * p + r
            return (1 + b2) * p * r / denom if denom else 0.0
        if averaging == "macro":
            cs = self._support_classes()
            return float(np.mean([self.f_beta(beta, i) for i in cs])) \
                if cs else 0.0
        p = self.precision_averaged("micro")
        r = self.recall_averaged("micro")
        denom = b2 * p + r
        return (1 + b2) * p * r / denom if denom else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            p, r = self.precision(cls), self.recall(cls)
            return 2 * p * r / (p + r) if (p + r) else 0.0
        self._check()
        vals = [self.f1(i) for i in range(self.num_classes)
                if self.confusion[:, i].sum() + self.confusion[i, :].sum() > 0]
        return float(np.mean(vals)) if vals else 0.0

    # ------------------------------------------- averaging / extra metrics
    def _counts(self, i):
        tp = self._tp(i)
        fp = self._fp(i)
        fn = self._fn(i)
        tn = int(self.confusion.sum()) - tp - fp - fn
        return tp, fp, fn, tn

    # -- per-class count maps (Evaluation.java truePositives() family) ------
    def true_positives(self) -> Dict[int, int]:
        self._check()
        return {i: self._tp(i) for i in range(self.num_classes)}

    def false_positives(self) -> Dict[int, int]:
        self._check()
        return {i: self._fp(i) for i in range(self.num_classes)}

    def false_negatives(self) -> Dict[int, int]:
        self._check()
        return {i: self._fn(i) for i in range(self.num_classes)}

    def true_negatives(self) -> Dict[int, int]:
        self._check()
        return {i: self._counts(i)[3] for i in range(self.num_classes)}

    def positive(self) -> Dict[int, int]:
        """Actual count per class (``positive()``)."""
        self._check()
        return {i: int(self.confusion[i, :].sum())
                for i in range(self.num_classes)}

    def negative(self) -> Dict[int, int]:
        """Actual-negative count per class (``negative()``)."""
        self._check()
        total = int(self.confusion.sum())
        return {i: total - p for i, p in self.positive().items()}

    def false_negative_rate(self, cls: int, edge_case: float = 0.0) -> float:
        """FN / (FN + TP) (``falseNegativeRate``)."""
        self._check()
        tp, _, fn, _ = self._counts(cls)
        return fn / (fn + tp) if (fn + tp) else edge_case

    def false_alarm_rate(self) -> float:
        """Mean of macro FPR and FNR (``falseAlarmRate``)."""
        self._check()
        fpr = np.mean([self.false_positive_rate(i)
                       for i in range(self.num_classes)])
        fnr = np.mean([self.false_negative_rate(i)
                       for i in range(self.num_classes)])
        return float((fpr + fnr) / 2.0)

    def class_count(self, cls: int) -> int:
        """Actual instances of a class (``classCount``)."""
        self._check()
        return int(self.confusion[cls, :].sum())

    def get_num_row_counter(self) -> int:
        """Total examples seen (``getNumRowCounter``)."""
        return 0 if self.confusion is None else int(self.confusion.sum())

    def get_class_label(self, cls: int) -> str:
        """Label string for a class index (``getClassLabel``)."""
        if self.labels_list and cls < len(self.labels_list):
            return str(self.labels_list[cls])
        return str(cls)

    def get_top_n_correct_count(self) -> int:
        return self.top_n_correct_count

    def get_top_n_total_count(self) -> int:
        return self.top_n_total_count

    def reset(self) -> None:
        """Clear all accumulated state (``reset()``), restoring the
        constructor's class count."""
        self.confusion = None
        if self._initial_num_classes is not None:
            self.num_classes = self._initial_num_classes
        elif self.labels_list is not None:
            self.num_classes = len(self.labels_list)
        else:
            self.num_classes = None
        self.top_n_correct_count = 0
        self.top_n_total_count = 0
        self.confusion_meta = None

    def confusion_to_string(self) -> str:
        """Formatted confusion matrix (``confusionToString``): predicted
        classes across, actual down."""
        self._check()
        names = [self.get_class_label(i) for i in range(self.num_classes)]
        width = max(6, max(len(n) for n in names) + 1)
        head = " " * width + "".join(f"{n:>{width}}" for n in names)
        rows = [head]
        for i in range(self.num_classes):
            cells = "".join(f"{int(self.confusion[i, j]):>{width}}"
                            for j in range(self.num_classes))
            rows.append(f"{names[i]:>{width}}" + cells)
        rows.append("")
        rows.append(f"Confusion matrix format: Actual (rowClass) predicted "
                    f"as (columnClass) N times")
        return "\n".join(rows)

    def _support_classes(self):
        """Classes with at least one true or predicted instance — the
        subset this framework's macro averages run over (consistent with
        ``precision()``/``recall()``/``f1()``)."""
        return [i for i in range(self.num_classes)
                if self.confusion[:, i].sum()
                + self.confusion[i, :].sum() > 0]

    def _num_classes_excluded(self) -> int:
        """Classes left out of the macro averages for lack of support
        (``averageF1NumClassesExcluded`` family)."""
        self._check()
        return self.num_classes - len(self._support_classes())

    def average_f1_num_classes_excluded(self) -> int:
        return self._num_classes_excluded()

    def average_f_beta_num_classes_excluded(self) -> int:
        return self._num_classes_excluded()

    def average_precision_num_classes_excluded(self) -> int:
        return self._num_classes_excluded()

    def average_recall_num_classes_excluded(self) -> int:
        return self._num_classes_excluded()

    def precision_averaged(self, averaging: str = "macro") -> float:
        """``Evaluation.precision(EvaluationAveraging)``: macro averages
        per-class values (over supported classes, matching ``precision()``
        — the reference divides by ALL classes); micro pools counts."""
        self._check()
        if averaging == "macro":
            cs = self._support_classes()
            return float(np.mean([self.precision(i) for i in cs])) if cs \
                else 0.0
        tp = sum(self._tp(i) for i in range(self.num_classes))
        fp = sum(self._fp(i) for i in range(self.num_classes))
        return tp / (tp + fp) if tp + fp else 0.0

    def recall_averaged(self, averaging: str = "macro") -> float:
        self._check()
        if averaging == "macro":
            cs = self._support_classes()
            return float(np.mean([self.recall(i) for i in cs])) if cs \
                else 0.0
        tp = sum(self._tp(i) for i in range(self.num_classes))
        fn = sum(self._fn(i) for i in range(self.num_classes))
        return tp / (tp + fn) if tp + fn else 0.0

    def g_measure(self, cls: Optional[int] = None,
                  averaging: str = "macro") -> float:
        """Geometric mean of precision and recall
        (``Evaluation.gMeasure``)."""
        self._check()
        if cls is not None:
            return float(np.sqrt(self.precision(cls) * self.recall(cls)))
        if averaging == "macro":
            cs = self._support_classes()
            return float(np.mean([self.g_measure(i) for i in cs])) if cs \
                else 0.0
        p = self.precision_averaged("micro")
        r = self.recall_averaged("micro")
        return float(np.sqrt(p * r))

    def matthews_correlation_averaged(self, averaging: str = "macro"
                                      ) -> float:
        """``Evaluation.matthewsCorrelation(EvaluationAveraging)``."""
        self._check()
        if averaging == "macro":
            cs = self._support_classes()
            return float(np.mean([self.matthews_correlation(i)
                                  for i in cs])) if cs else 0.0
        tp, fp, fn, tn = (sum(self._counts(i)[j]
                              for i in range(self.num_classes))
                          for j in range(4))
        denom = np.sqrt(float((tp + fp) * (tp + fn)
                              * (tn + fp) * (tn + fn)))
        return ((tp * tn - fp * fn) / denom) if denom else 0.0

    def score_for_metric(self, metric: str) -> float:
        """``Evaluation.scoreForMetric(Metric)`` — the hook early-stopping
        score calculators select on: ACCURACY, F1, PRECISION, RECALL,
        GMEASURE, MCC (case-insensitive)."""
        m = metric.upper()
        if m == "ACCURACY":
            return self.accuracy()
        if m == "F1":
            return self.f1()
        if m == "PRECISION":
            return self.precision()
        if m == "RECALL":
            return self.recall()
        if m == "GMEASURE":
            return self.g_measure(averaging="macro")
        if m == "MCC":
            return self.matthews_correlation_averaged("macro")
        raise ValueError(f"Unknown metric: {metric}")

    def false_positive_rate(self, cls: int) -> float:
        self._check()
        tn = self.confusion.sum() - self._tp(cls) - self._fp(cls) - self._fn(cls)
        denom = self._fp(cls) + tn
        return self._fp(cls) / denom if denom else 0.0

    def matthews_correlation(self, cls: int) -> float:
        self._check()
        tp, fp, fn = self._tp(cls), self._fp(cls), self._fn(cls)
        tn = int(self.confusion.sum()) - tp - fp - fn
        denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        return ((tp * tn - fp * fn) / denom) if denom else 0.0

    def confusion_matrix(self) -> np.ndarray:
        self._check()
        return self.confusion.copy()

    # -------------------------------------------- prediction introspection
    def get_prediction_errors(self) -> Optional[List[Prediction]]:
        """Per-record misclassifications (``Evaluation.java:1506``), sorted
        by (actual, predicted). Only available when ``eval`` was called with
        ``record_meta_data``; returns None otherwise (reference contract)."""
        if self.confusion_meta is None:
            return None
        out: List[Prediction] = []
        for (a, p) in sorted(self.confusion_meta):
            if a == p:
                continue
            out.extend(Prediction(a, p, m) for m in self.confusion_meta[(a, p)])
        return out

    def get_predictions_by_actual_class(self, actual_class: int
                                        ) -> Optional[List[Prediction]]:
        """All recorded predictions whose TRUE class is ``actual_class``
        (``Evaluation.java:1554``)."""
        if self.confusion_meta is None:
            return None
        return [Prediction(a, p, m)
                for (a, p), ms in self.confusion_meta.items()
                if a == actual_class for m in ms]

    def get_prediction_by_predicted_class(self, predicted_class: int
                                          ) -> Optional[List[Prediction]]:
        """All recorded predictions whose PREDICTED class is
        ``predicted_class`` (``Evaluation.java:1583``)."""
        if self.confusion_meta is None:
            return None
        return [Prediction(a, p, m)
                for (a, p), ms in self.confusion_meta.items()
                if p == predicted_class for m in ms]

    def get_predictions(self, actual_class: int, predicted_class: int
                        ) -> Optional[List[Prediction]]:
        """Recorded predictions for one confusion-matrix cell
        (``Evaluation.java:1610``)."""
        if self.confusion_meta is None:
            return None
        return [Prediction(actual_class, predicted_class, m)
                for m in self.confusion_meta.get(
                    (actual_class, predicted_class), [])]

    def merge(self, other: "Evaluation") -> "Evaluation":
        if other.confusion is not None:
            if self.confusion is None:
                self.num_classes = other.num_classes
                self.confusion = other.confusion.copy()
            else:
                if other.confusion.shape[0] > self.confusion.shape[0]:
                    grown = np.zeros_like(other.confusion)
                    grown[:self.confusion.shape[0],
                          :self.confusion.shape[1]] = self.confusion
                    self.confusion = grown
                    self.num_classes = other.num_classes
                self.confusion[:other.confusion.shape[0],
                               :other.confusion.shape[1]] += other.confusion
        self.top_n_correct_count += other.top_n_correct_count
        self.top_n_total_count += other.top_n_total_count
        if other.confusion_meta is not None:
            if self.confusion_meta is None:
                self.confusion_meta = {}
            for k, ms in other.confusion_meta.items():
                self.confusion_meta.setdefault(k, []).extend(ms)
        return self

    # ---------------------------------------------------------------- serde
    def to_json(self) -> str:
        return json.dumps({
            "num_classes": self.num_classes,
            "confusion": None if self.confusion is None else self.confusion.tolist(),
            "top_n": self.top_n,
            "top_n_correct_count": self.top_n_correct_count,
            "top_n_total_count": self.top_n_total_count,
            "labels_list": self.labels_list,
        })

    @staticmethod
    def from_json(s: str) -> "Evaluation":
        d = json.loads(s)
        e = Evaluation(num_classes=d["num_classes"], top_n=d.get("top_n", 1),
                       labels_list=d.get("labels_list"))
        if d["confusion"] is not None:
            e.confusion = np.asarray(d["confusion"], np.int64)
        e.top_n_correct_count = d.get("top_n_correct_count", 0)
        e.top_n_total_count = d.get("top_n_total_count", 0)
        return e

    def stats(self) -> str:
        self._check()
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes:    {self.num_classes}",
            f" Accuracy:        {self.accuracy():.4f}",
        ]
        if self.top_n > 1 and self.top_n_total_count > 0:
            lines.append(
                f" Top {self.top_n} Accuracy:  {self.top_n_accuracy():.4f}")
        lines += [
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
            "",
            "=========================Confusion Matrix=========================",
        ]
        if self.labels_list:
            # labeled per-class block (Evaluation.stats() label output)
            width = max(len(str(l)) for l in self.labels_list)
            for i in range(self.num_classes):
                name = (self.labels_list[i] if i < len(self.labels_list)
                        else str(i))
                lines.append(
                    f" {name:<{width}}  " + " ".join(
                        f"{int(v):6d}" for v in self.confusion[i]))
        else:
            lines.append(str(self.confusion))
        return "\n".join(lines)
