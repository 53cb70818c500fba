"""The port's evaluation classes (``deeplearning4j_tpu_torch/eval``) on the
CPU against the JAX package's (``deeplearning4j_tpu/eval``), numpy only on
both sides: the same seeded labels, predictions and masks go to both.

Each case feeds two batches. Every reading of the port's evaluator equals
the reference's to 1e-12 (metrics, curves, counts), its ``stats()`` text
is the same, and so is its ``to_json`` after ``json.loads`` where the
class has one; the port's evaluator of the two batches apart, merged,
reads the same as the reference's of both in one evaluator.
"""

import json

import numpy as np
import pytest

import deeplearning4j_tpu.eval as ref_eval
import deeplearning4j_tpu_torch.eval as port_eval

TOL = 1e-12
N, C, T = 40, 4, 5


def _probs(rng, *shape):
    z = np.exp(rng.normal(size=shape))
    return z / z.sum(-1, keepdims=True)


def _onehot(rng, n, c, t=None):
    ids = rng.integers(0, c, (n,) if t is None else (n, t))
    return np.eye(c)[ids]


def _sigmoid(rng, *shape):
    return 1.0 / (1.0 + np.exp(-rng.normal(size=shape)))


# each case: (evaluator factory over a module, batch maker over a seeded
# rng giving (labels, predictions, mask or None), JSON kind)
CASES = {
    "evaluation": (lambda m: m.Evaluation(),
                   lambda r: (_onehot(r, N, C), _probs(r, N, C), None), "json"),
    "evaluation_top3_labels": (
        lambda m: m.Evaluation(top_n=3, labels_list=["a", "bb", "ccc", "d"]),
        lambda r: (_onehot(r, N, C), _probs(r, N, C),
                   (r.random(N) > 0.3).astype(np.float32)), "json"),
    "evaluation_time_series": (
        lambda m: m.Evaluation(),
        lambda r: (_onehot(r, 6, C, T), _probs(r, 6, T, C),
                   (r.random((6, T)) > 0.3).astype(np.float32)), "json"),
    "evaluation_binary_column": (
        lambda m: m.Evaluation(),
        lambda r: (r.integers(0, 2, (N, 1)).astype(np.float64), r.random((N, 1)), None),
        "json"),
    "roc_exact_two_columns": (lambda m: m.ROC(),
                              lambda r: (_onehot(r, N, 2), _probs(r, N, 2), None), None),
    "roc_exact_ties": (lambda m: m.ROC(),
                       lambda r: (_onehot(r, N, 2), np.round(_probs(r, N, 2), 1), None),
                       None),
    "roc_exact_1d_labels": (
        lambda m: m.ROC(),
        lambda r: (r.integers(0, 2, N).astype(np.float64), _probs(r, N, 2), None), None),
    "roc_binned": (lambda m: m.ROC(threshold_steps=10),
                   lambda r: (_onehot(r, N, 2), np.round(_probs(r, N, 2), 1), None),
                   "json"),
    "roc_binned_one_column": (
        lambda m: m.ROC(threshold_steps=37),
        lambda r: (r.integers(0, 2, (N, 1)).astype(np.float64), r.random((N, 1)),
                   (r.random(N) > 0.2).astype(np.float32)), "json"),
    "roc_time_series": (
        lambda m: m.ROC(),
        lambda r: (_onehot(r, 6, 2, T), _probs(r, 6, T, 2),
                   (r.random((6, T)) > 0.3).astype(np.float32)), None),
    "roc_binned_time_series": (
        lambda m: m.ROC(threshold_steps=20),
        lambda r: (_onehot(r, 6, 2, T), _probs(r, 6, T, 2),
                   (r.random((6, T)) > 0.3).astype(np.float32)), "json"),
    "roc_binary_exact": (
        lambda m: m.ROCBinary(),
        lambda r: (r.integers(0, 2, (N, C)).astype(np.float64), _sigmoid(r, N, C),
                   (r.random((N, C)) > 0.2).astype(np.float32)), None),
    "roc_binary_binned": (
        lambda m: m.ROCBinary(threshold_steps=16),
        lambda r: (r.integers(0, 2, (N, C)).astype(np.float64), _sigmoid(r, N, C),
                   (r.random(N) > 0.2).astype(np.float32)), None),
    "roc_binary_time_series": (
        lambda m: m.ROCBinary(),
        lambda r: (r.integers(0, 2, (6, T, C)).astype(np.float64), _sigmoid(r, 6, T, C),
                   (r.random((6, T)) > 0.3).astype(np.float32)), None),
    "roc_multi_class_exact": (
        lambda m: m.ROCMultiClass(),
        lambda r: (_onehot(r, N, C), _probs(r, N, C), None), None),
    "roc_multi_class_int_labels": (
        lambda m: m.ROCMultiClass(threshold_steps=12),
        lambda r: (r.integers(0, C, N).astype(np.float64), _probs(r, N, C),
                   (r.random((N, 1)) > 0.2).astype(np.float32)), None),
    "roc_multi_class_time_series": (
        lambda m: m.ROCMultiClass(),
        lambda r: (_onehot(r, 6, C, T), _probs(r, 6, T, C),
                   (r.random((6, T)) > 0.3).astype(np.float32)), None),
    "regression": (lambda m: m.RegressionEvaluation(),
                   lambda r: (r.normal(size=(N, 3)), r.normal(size=(N, 3)), None), None),
    "regression_time_series": (
        lambda m: m.RegressionEvaluation(),
        lambda r: (r.normal(size=(6, T, 3)), r.normal(size=(6, T, 3)),
                   (r.random((6, T)) > 0.3).astype(np.float32)), None),
    "binary": (lambda m: m.EvaluationBinary(),
               lambda r: (r.integers(0, 2, (N, C)), _sigmoid(r, N, C), None), None),
    "binary_masked": (lambda m: m.EvaluationBinary(decision_threshold=0.4),
                      lambda r: (r.integers(0, 2, (N, C)), _sigmoid(r, N, C),
                                 (r.random((N, C)) > 0.2).astype(np.float32)), None),
    "calibration": (lambda m: m.EvaluationCalibration(),
                    lambda r: (_onehot(r, N, C), _probs(r, N, C),
                               (r.random(N) > 0.2).astype(np.float32)), None),
    "calibration_per_output_mask": (
        lambda m: m.EvaluationCalibration(reliability_bins=7, histogram_bins=13,
                                          exclude_empty_bins=False),
        lambda r: (_onehot(r, N, C), _probs(r, N, C),
                   (r.random((N, C)) > 0.2).astype(np.float32)), None),
    "calibration_time_series": (
        lambda m: m.EvaluationCalibration(),
        lambda r: (_onehot(r, 6, C, T), _probs(r, 6, T, C),
                   (r.random((6, T)) > 0.3).astype(np.float32)), None),
}


def _evaluation(e):
    out = {"stats": e.stats(), "confusion": e.confusion_matrix(),
           "accuracy": e.accuracy(), "top_n": e.top_n_accuracy(),
           "rows": e.get_num_row_counter(), "top_counts": (
               e.get_top_n_correct_count(), e.get_top_n_total_count()),
           "false_alarm_rate": e.false_alarm_rate(),
           "confusion_text": e.confusion_to_string(),
           "excluded": (e.average_f1_num_classes_excluded(),
                        e.average_f_beta_num_classes_excluded(),
                        e.average_precision_num_classes_excluded(),
                        e.average_recall_num_classes_excluded()),
           "precision": e.precision(), "recall": e.recall(), "f1": e.f1()}
    for avg in ("macro", "micro"):
        out[avg] = (e.precision_averaged(avg), e.recall_averaged(avg),
                    e.f_beta(0.5, averaging=avg), e.g_measure(averaging=avg),
                    e.matthews_correlation_averaged(avg))
    for metric in ("accuracy", "f1", "precision", "recall", "gmeasure", "mcc"):
        out[metric + "_score"] = e.score_for_metric(metric)
    for name in ("true_positives", "false_positives", "false_negatives",
                 "true_negatives", "positive", "negative"):
        out[name] = getattr(e, name)()
    for c in range(e.num_classes):
        out[f"class {c}"] = (
            e.precision(c), e.recall(c), e.f1(c), e.f_beta(2.0, c), e.g_measure(c),
            e.matthews_correlation(c), e.false_positive_rate(c),
            e.false_negative_rate(c), e.class_count(c), e.get_class_label(c))
    return out


def _curves(r, *args):
    return {"roc": r.get_roc_curve(*args), "pr": r.get_precision_recall_curve(*args)}


def _roc(r):
    return {"auc": r.calculate_auc(), "auc_pr": r.calculate_auc_pr(),
            "stats": r.stats(), **_curves(r)}


def _roc_columns(r, count):
    return {c: (r.calculate_auc(c), _curves(r, c)) for c in range(count)}


def _regression(e):
    out = {"stats": e.stats(), "columns": e.num_columns()}
    for c in range(e.num_columns()):
        out[c] = (e.mean_squared_error(c), e.mean_absolute_error(c),
                  e.root_mean_squared_error(c), e.relative_squared_error(c),
                  e.pearson_correlation(c), e.r_squared(c))
    for metric in ("mse", "mae", "rmse", "rse", "pc", "r2"):
        out[metric] = e.score_for_metric(metric)
    return out


def _binary(e):
    return {"stats": e.stats(), "named": e.stats([f"out{i}" for i in range(C)]),
            **{c: (e.accuracy(c), e.precision(c), e.recall(c), e.f1(c))
               for c in range(len(e.tp))}}


def _calibration(e):
    out = {"stats": e.stats(), "classes": e.num_classes,
           "ece": e.expected_calibration_error(),
           "overall": e.reliability_diagram(),
           "residual": e.get_residual_plot_all_classes().to_dict(),
           "probability": e.get_probability_histogram_all_classes().to_dict(),
           "counts": (e.label_counts, e.prediction_counts)}
    for c in range(e.num_classes):
        out[c] = (e.get_reliability_diagram(c).to_dict(),
                  e.get_residual_plot(c).to_dict(),
                  e.get_probability_histogram(c).to_dict())
    return out


def readings(e):
    """Everything the evaluator reports, by name."""
    kind = type(e).__name__
    if kind == "Evaluation":
        return _evaluation(e)
    if kind == "ROC":
        return _roc(e)
    if kind == "ROCBinary":
        return {"labels": e.num_labels(), **_roc_columns(e, e.num_labels())}
    if kind == "ROCMultiClass":
        return {"classes": e.num_classes(), **_roc_columns(e, e.num_classes())}
    if kind == "RegressionEvaluation":
        return _regression(e)
    if kind == "EvaluationBinary":
        return _binary(e)
    return _calibration(e)


def assert_same(got, want, where="reading"):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, str):
        assert got == want, where
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64),
                                   rtol=0, atol=TOL, err_msg=where)


def _fed(module, case, batches):
    make, _, _ = CASES[case]
    e = make(module)
    for labels, preds, mask in batches:
        e.eval(labels, preds, mask=mask)
    return e


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluator_matches_reference(case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    batches = [CASES[case][1](rng) for _ in range(2)]
    want = _fed(ref_eval, case, batches)
    got = _fed(port_eval, case, batches)
    assert_same(readings(got), readings(want), case)
    # two halves merged read as one pass
    merged = _fed(port_eval, case, batches[:1])
    merged.merge(_fed(port_eval, case, batches[1:]))
    assert_same(readings(merged), readings(want), case + " merged")
    if CASES[case][2] == "json":
        assert json.loads(got.to_json()) == json.loads(want.to_json())
        back = type(got).from_json(got.to_json())
        if hasattr(back, "stats"):
            assert back.stats() == want.stats()


def test_evaluation_records_and_resets_as_reference():
    rng = np.random.default_rng(7)
    labels, preds = _onehot(rng, N, C), _probs(rng, N, C)
    meta = [f"record {i}" for i in range(N)]
    sides = []
    for module in (ref_eval, port_eval):
        e = module.Evaluation(num_classes=C)
        e.eval(labels[:20], preds[:20], record_meta_data=meta[:20])
        other = module.Evaluation(num_classes=C)
        other.eval(labels[20:], preds[20:], record_meta_data=meta[20:])
        e.merge(other)
        got = {"errors": [(p.actual, p.predicted, p.get_record_meta_data())
                          for p in e.get_prediction_errors()],
               "actual": [(p.actual, p.predicted) for p in
                          e.get_predictions_by_actual_class(1)],
               "predicted": [(p.actual, p.predicted) for p in
                             e.get_prediction_by_predicted_class(2)],
               "cell": [p.record_meta_data for p in e.get_predictions(0, 1)]}
        e.reset()
        got["reset"] = (e.num_classes, e.confusion, e.get_num_row_counter(),
                        e.get_prediction_errors())
        sides.append(got)
    assert sides[0] == sides[1]


@pytest.mark.parametrize("case", ["multi_class_roc", "exact_json", "mask_shape",
                                  "binned_merge", "multi_class_mask"])
def test_refusals_as_reference(case):
    rng = np.random.default_rng(3)
    for module in (ref_eval, port_eval):
        if case == "multi_class_roc":
            call = lambda: module.ROC().eval(rng.integers(0, 3, N), _probs(rng, N, 3))  # noqa: E731
        elif case == "exact_json":
            call = module.ROC().to_json
        elif case == "mask_shape":
            call = lambda: module.ROC().eval(  # noqa: E731
                _onehot(rng, 6, 2, T), _probs(rng, 6, T, 2), mask=np.ones((6, T, 2)))
        elif case == "binned_merge":
            call = lambda: module.ROC(threshold_steps=5).merge(  # noqa: E731
                module.ROC(threshold_steps=6))
        else:
            call = lambda: module.ROCMultiClass().eval(  # noqa: E731
                _onehot(rng, N, C), _probs(rng, N, C), mask=np.ones((N, C)))
        with pytest.raises(ValueError):
            call()
