"""Configuration DSL of the PyTorch/CUDA port."""

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.network import (  # noqa: F401
    GlobalConf,
    ListBuilder,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.memory import (  # noqa: F401
    LayerMemoryReport,
    MemoryType,
    MemoryUseMode,
    NetworkMemoryReport,
    compiled_memory_analysis,
    network_memory_report,
)
