"""SameDiff, the graph builder of the PyTorch/CUDA port."""

from deeplearning4j_tpu_torch.autodiff.samediff import (  # noqa: F401
    SDVariable,
    SameDiff,
    TrainingConfig,
)
