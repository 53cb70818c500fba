"""Data containers and iterators of the PyTorch/CUDA port."""

from deeplearning4j_tpu_torch.datasets.dataset import (  # noqa: F401
    DataSet,
    DataSetIterator,
    ListDataSetIterator,
    MultiDataSet,
    batch_nbytes,
)
