"""Simple classification result wrappers.

Counterpart of ``deeplearning4j_tpu/nn/simple.py`` (numpy only, copied):
DL4J's ``nn/simple/`` ``multiclass/RankClassificationResult.java`` (each
row's classes ranked over a probability matrix) and
``binary/BinaryClassificationResult.java`` (a decision threshold and
class weights).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["RankClassificationResult", "BinaryClassificationResult"]


class RankClassificationResult:
    """Ranked class outcomes per example (``RankClassificationResult``).

    ``outcome``: [N, C] probabilities (a single vector is treated as one
    row). Classes are ranked descending per row.
    """

    def __init__(self, outcome, labels: Optional[Sequence[str]] = None):
        out = np.asarray(outcome, np.float32)
        if out.ndim == 1:
            out = out[None, :]
        if out.ndim > 2:
            raise ValueError(
                "Only works with vectors and matrices right now")
        self.probabilities = out
        n_classes = out.shape[1]
        if labels is None:
            self.labels = [str(i) for i in range(n_classes)]
        else:
            if len(labels) != n_classes:
                raise ValueError(
                    f"{len(labels)} labels for {n_classes} classes")
            self.labels = list(labels)
        # descending probability order per row
        self.ranked_indices = np.argsort(-out, axis=1)

    def max_outcome_for_row(self, r: int) -> str:
        """Top label of row ``r`` (``maxOutcomeForRow``)."""
        return self.labels[int(self.ranked_indices[r, 0])]

    def max_outcomes(self) -> List[str]:
        """Top label per row (``maxOutcomes``)."""
        return [self.max_outcome_for_row(r)
                for r in range(self.ranked_indices.shape[0])]

    def ranked_labels_for_row(self, r: int) -> List[str]:
        """All labels of row ``r``, best first."""
        return [self.labels[int(i)] for i in self.ranked_indices[r]]

    def probability_for_row(self, r: int, cls: int) -> float:
        return float(self.probabilities[r, cls])


@dataclasses.dataclass
class BinaryClassificationResult:
    """Decision threshold + class weights
    (``BinaryClassificationResult.java``)."""

    decision_threshold: float = 0.5
    class_weights: Optional[Sequence[float]] = None

    def decide(self, probabilities) -> np.ndarray:
        """Thresholded positive-class decisions for [N] or [N,2] input."""
        p = np.asarray(probabilities, np.float64)
        if p.ndim == 2:
            p = p[:, -1]
        if self.class_weights is not None and len(self.class_weights) == 2:
            w0, w1 = self.class_weights
            p = p * w1 / np.maximum(p * w1 + (1 - p) * w0, 1e-12)
        return (p >= self.decision_threshold).astype(np.int64)
