"""Classification evaluation: accuracy, top-N, precision, recall, F-beta,
the confusion matrix.

The port's own copy of ``Evaluation`` and ``Prediction`` from
``deeplearning4j_tpu/eval/evaluation.py`` (importing that package would
import jax): the part that ``MultiLayerNetwork.evaluate`` and ``f1_score``
reach, numpy only, on host arrays. DL4J's conventions: macro averages run
over the classes with at least one true or predicted instance; a
per-timestep ``[N, T, C]`` output is flattened with the label mask
applied; an example is top-N correct when fewer than N class
probabilities are strictly greater than the true class's. Not ported yet
(ROADMAP A9): ROC, regression, binary and calibration evaluation, and the
rest of ``Evaluation`` (G-measure, MCC, the count maps, ``merge``, JSON
serde).
"""

from __future__ import annotations

import dataclasses
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


def _masked(labels, predictions, mask, meta):
    """Labels and predictions as 2-d rows (time flattened into the batch),
    with the masked-out rows (and their metadata) dropped."""
    if labels.ndim == 3:  # [N,T,C]
        n, t, c = labels.shape
        labels = labels.reshape(n * t, c)
        predictions = predictions.reshape(n * t, -1)
        if meta is not None:
            meta = [m for m in meta for _ in range(t)]
    if mask is not None:
        keep = np.asarray(mask).reshape(-1).astype(bool)
        labels, predictions = labels[keep], predictions[keep]
        if meta is not None:
            meta = [m for m, k in zip(meta, keep) if k]
    return labels, predictions, meta


class Evaluation:
    def __init__(self, num_classes: Optional[int] = None, labels_list=None,
                 top_n: int = 1):
        self.num_classes = num_classes
        self.labels_list = labels_list
        self.confusion: Optional[np.ndarray] = None  # [true, predicted]
        self.top_n = max(int(top_n), 1)
        self.top_n_correct_count = 0
        self.top_n_total_count = 0
        # (actual, predicted) -> metadata list; None until metadata is seen
        self.confusion_meta: Optional[Dict[Tuple[int, int], List[Any]]] = None

    # ----------------------------------------------------------------- eval
    def eval(self, labels, predictions, mask=None,
             record_meta_data: Optional[List[Any]] = None) -> None:
        labels, predictions, record_meta_data = _masked(
            np.asarray(labels), np.asarray(predictions), mask,
            record_meta_data)
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
                     int(pred_idx.max(initial=0)) + 1, self.num_classes or 0)
        if self.num_classes is None or needed > self.num_classes:
            old = self.confusion
            self.num_classes = needed
            self.confusion = np.zeros((needed, needed), np.int64)
            if old is not None:
                self.confusion[:old.shape[0], :old.shape[1]] = old
        elif self.confusion is None:
            self.confusion = np.zeros((self.num_classes, self.num_classes),
                                      np.int64)
        np.add.at(self.confusion, (true_idx, pred_idx), 1)

        if (self.top_n > 1 and predictions.ndim == 2
                and predictions.shape[1] > 1):
            true_prob = predictions[np.arange(len(true_idx)), true_idx]
            greater = (predictions > true_prob[:, None]).sum(axis=1)
            self.top_n_correct_count += int((greater < self.top_n).sum())
            self.top_n_total_count += len(true_idx)

        if record_meta_data is not None:
            if len(record_meta_data) != len(true_idx):
                raise ValueError(
                    f"record_meta_data length {len(record_meta_data)} != "
                    f"number of (unmasked) examples {len(true_idx)}")
            if self.confusion_meta is None:
                self.confusion_meta = {}
            for a, p, m in zip(true_idx, pred_idx, record_meta_data):
                self.confusion_meta.setdefault((int(a), int(p)), []).append(m)

    # -------------------------------------------------------------- metrics
    def _check(self):
        if self.confusion is None:
            raise ValueError("No evaluation data; call eval() first")

    def accuracy(self) -> float:
        self._check()
        return float(np.trace(self.confusion)) / max(self.confusion.sum(), 1)

    def top_n_accuracy(self) -> float:
        """Share of examples whose true class's probability is among the N
        highest; ``accuracy()`` when ``top_n == 1``."""
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

    def _support_classes(self):
        """Classes with at least one true or predicted instance, the ones
        the macro averages run over."""
        return [i for i in range(self.num_classes)
                if self.confusion[:, i].sum() + self.confusion[i, :].sum() > 0]

    def _macro(self, per_class) -> float:
        vals = [per_class(i) for i in self._support_classes()]
        return float(np.mean(vals)) if vals else 0.0

    def precision(self, cls: Optional[int] = None) -> float:
        self._check()
        if cls is None:
            return self._macro(self.precision)
        denom = self._tp(cls) + self._fp(cls)
        return self._tp(cls) / denom if denom else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        self._check()
        if cls is None:
            return self._macro(self.recall)
        denom = self._tp(cls) + self._fn(cls)
        return self._tp(cls) / denom if denom else 0.0

    def f_beta(self, beta: float, cls: Optional[int] = None,
               averaging: str = "macro") -> float:
        """F-measure with recall weighted ``beta`` times as much as
        precision; macro, or micro over the pooled counts."""
        self._check()
        b2 = beta * beta
        if cls is None and averaging == "macro":
            return self._macro(lambda i: self.f_beta(beta, i))
        if cls is None:
            tp = sum(self._tp(i) for i in range(self.num_classes))
            fp = sum(self._fp(i) for i in range(self.num_classes))
            fn = sum(self._fn(i) for i in range(self.num_classes))
            p = tp / (tp + fp) if tp + fp else 0.0
            r = tp / (tp + fn) if tp + fn else 0.0
        else:
            p, r = self.precision(cls), self.recall(cls)
        denom = b2 * p + r
        return (1 + b2) * p * r / denom if denom else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            p, r = self.precision(cls), self.recall(cls)
            return 2 * p * r / (p + r) if (p + r) else 0.0
        self._check()
        return self._macro(self.f1)

    def confusion_matrix(self) -> np.ndarray:
        self._check()
        return self.confusion.copy()

    # -------------------------------------------- prediction introspection
    def get_prediction_errors(self) -> Optional[List[Prediction]]:
        """Per-record misclassifications sorted by (actual, predicted);
        None unless ``eval`` was given ``record_meta_data``."""
        if self.confusion_meta is None:
            return None
        return [Prediction(a, p, m) for (a, p) in sorted(self.confusion_meta)
                if a != p for m in self.confusion_meta[(a, p)]]

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
            width = max(len(str(l)) for l in self.labels_list)
            for i in range(self.num_classes):
                name = (self.labels_list[i] if i < len(self.labels_list)
                        else str(i))
                lines.append(f" {name:<{width}}  " + " ".join(
                    f"{int(v):6d}" for v in self.confusion[i]))
        else:
            lines.append(str(self.confusion))
        return "\n".join(lines)
