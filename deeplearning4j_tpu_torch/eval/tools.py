"""Render ROC / calibration evaluation results to standalone HTML.

Parity with ``deeplearning4j-core/.../evaluation/EvaluationTools.java``:
``roc_chart_to_html`` (ROC + precision/recall charts with an AUC header;
the ROCMultiClass/ROCBinary overloads emit one section per class) and
``export_roc_charts_to_html_file``. Charts are the dependency-free SVG
components from ``ui/components.py`` (the reference renders through its
ui-components module the same way).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.eval.roc import ROC, ROCBinary, ROCMultiClass
from deeplearning4j_tpu_torch.ui.components import (
    ChartLine,
    ComponentDiv,
    ComponentTable,
    ComponentText,
    StyleChart,
)

__all__ = [
    "roc_chart_to_html",
    "export_roc_charts_to_html_file",
    "calibration_chart_to_html",
]

_CHART_STYLE = StyleChart(width=600, height=400)


def _single_roc_section(roc: ROC, title_suffix: str = "") -> ComponentDiv:
    _, fpr, tpr = roc.get_roc_curve()
    thr, prec, rec = roc.get_precision_recall_curve()
    auc = roc.calculate_auc()
    auc_pr = roc.calculate_auc_pr()

    header = ComponentTable(
        ["Metric", "Value"],
        [["AUC (ROC)", f"{auc:.5f}"], ["AUC (PR)", f"{auc_pr:.5f}"]])

    roc_chart = ChartLine(f"ROC: TPR/Recall (y) vs. FPR (x){title_suffix}",
                          style=_CHART_STYLE)
    roc_chart.add_series("ROC", [float(v) for v in fpr],
                         [float(v) for v in tpr])

    pr_chart = ChartLine(f"Precision (y) vs. Recall (x){title_suffix}",
                         style=_CHART_STYLE)
    pr_chart.add_series("PR", [float(v) for v in rec],
                        [float(v) for v in prec])

    pr_thr = ChartLine(
        f"Precision and Recall (y) vs. Classifier Threshold (x){title_suffix}",
        style=_CHART_STYLE)
    pr_thr.add_series("Precision", [float(v) for v in thr],
                      [float(v) for v in prec])
    pr_thr.add_series("Recall", [float(v) for v in thr],
                      [float(v) for v in rec])

    return ComponentDiv(header, roc_chart, pr_chart, pr_thr)


def _num_classes(roc) -> int:
    if isinstance(roc, ROCMultiClass):
        return roc.num_classes()
    return roc.num_labels()


def roc_chart_to_html(roc, class_names: Optional[Sequence[str]] = None) -> str:
    """Standalone HTML for a ROC / ROCMultiClass / ROCBinary result
    (``EvaluationTools.rocChartToHtml``)."""
    if isinstance(roc, ROC):
        return _single_roc_section(roc).render_page(title="ROC evaluation")

    if not isinstance(roc, (ROCBinary, ROCMultiClass)):
        raise TypeError(f"Expected ROC/ROCBinary/ROCMultiClass, got {type(roc)}")

    page = ComponentDiv()
    for c in range(_num_classes(roc)):
        name = (class_names[c] if class_names and c < len(class_names)
                else str(c))
        page.add(ComponentText(f"Class: {name}"))
        page.add(_single_roc_section(roc._single(c), f" — class {name}"))
    return page.render_page(title="ROC evaluation (multi-class)")


def export_roc_charts_to_html_file(roc, path: str,
                                   class_names: Optional[Sequence[str]] = None
                                   ) -> None:
    """Write :func:`roc_chart_to_html` output to ``path``
    (``EvaluationTools.exportRocChartsToHtmlFile``)."""
    html = roc_chart_to_html(roc, class_names=class_names)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(html)


def calibration_chart_to_html(calibration, class_idx: int = 0) -> str:
    """Reliability diagram + probability histogram page for an
    EvaluationCalibration result (EvaluationTools' calibration role)."""
    diagram = calibration.get_reliability_diagram(class_idx)
    rel = ChartLine(diagram.title, style=_CHART_STYLE)
    rel.add_series("Model",
                   [float(v) for v in diagram.mean_predicted_value],
                   [float(v) for v in diagram.frac_positives])
    rel.add_series("Perfect", [0.0, 1.0], [0.0, 1.0])

    histogram = calibration.get_probability_histogram(class_idx)
    counts = np.asarray(histogram.counts, dtype=float)
    edges = histogram.bin_edges
    centers = (edges[:-1] + edges[1:]) / 2.0
    hist = ChartLine(histogram.title, style=_CHART_STYLE)
    hist.add_series("Count", [float(v) for v in centers],
                    [float(v) for v in counts])

    return ComponentDiv(rel, hist).render_page(title="Calibration")
