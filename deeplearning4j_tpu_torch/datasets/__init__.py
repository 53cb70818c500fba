"""Data containers, iterators and normalizers of the PyTorch/CUDA port."""

from deeplearning4j_tpu_torch.datasets.dataset import (  # noqa: F401
    DataSet,
    DataSetIterator,
    ListDataSetIterator,
    MultiDataSet,
    batch_nbytes,
)
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: F401
    AsyncDataSetIterator,
    AsyncMultiDataSetIterator,
    DataSetIteratorSplitter,
    EarlyTerminationDataSetIterator,
    INDArrayDataSetIterator,
    IteratorDataSetIterator,
    MultipleEpochsIterator,
    SamplingDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.fetchers import (  # noqa: F401
    CifarDataSetIterator,
    EmnistDataSetIterator,
    IrisDataSetIterator,
    MnistDataFetcher,
    MnistDataSetIterator,
    SvhnDataSetIterator,
    TinyImageNetDataSetIterator,
    UciSequenceDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.normalizers import (  # noqa: F401
    ImagePreProcessingScaler,
    MultiNormalizer,
    Normalizer,
    NormalizerMinMaxScaler,
    NormalizerStandardize,
    NormalizingIterator,
    VGG16ImagePreProcessor,
)
