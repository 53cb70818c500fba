"""Evaluation of the PyTorch/CUDA port."""

from deeplearning4j_tpu_torch.eval.evaluation import Evaluation, Prediction  # noqa: F401
