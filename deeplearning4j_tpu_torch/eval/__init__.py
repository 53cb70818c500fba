"""Evaluation of the PyTorch/CUDA port."""

from deeplearning4j_tpu_torch.eval.evaluation import Evaluation, Prediction  # noqa: F401
from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation  # noqa: F401
from deeplearning4j_tpu_torch.eval.roc import ROC, ROCBinary, ROCMultiClass  # noqa: F401
from deeplearning4j_tpu_torch.eval.binary import EvaluationBinary  # noqa: F401
from deeplearning4j_tpu_torch.eval.calibration import EvaluationCalibration  # noqa: F401
