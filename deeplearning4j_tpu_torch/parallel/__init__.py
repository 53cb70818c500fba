"""Distributed training and serving front-ends of the PyTorch/CUDA port.

Counterpart of ``deeplearning4j_tpu/parallel``: the device mesh
(``mesh.py``, a ``DeviceMesh`` over the ranks of a ``torch.distributed``
world), the sharding rules that place a network's tensors on it as
DTensors (``sharding.py``), ``ParallelWrapper``'s data- and
tensor-parallel training (``trainer.py``), the training masters
(``master.py``) with threshold compression (``compression.py``), the
cross-slice update bridge (``dcn.py``) and ``ParallelInference``, whose
sharded serving keeps the ranks in lockstep (``lockstep.py``).
"""

from deeplearning4j_tpu_torch.parallel.mesh import make_mesh, local_mesh  # noqa: F401
from deeplearning4j_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    replicated,
    tp_param_specs,
    shard_model,
)
from deeplearning4j_tpu_torch.parallel.trainer import ParallelWrapper  # noqa: F401
from deeplearning4j_tpu_torch.parallel.compression import (  # noqa: F401
    threshold_encode,
    threshold_decode,
    EncodingHandler,
)
from deeplearning4j_tpu_torch.parallel.inference import (  # noqa: F401
    DispatcherCrashed,
    InferenceDeadlineExceeded,
    ParallelInference,
)
from deeplearning4j_tpu_torch.parallel.dcn import CrossSliceGradientBridge  # noqa: F401
from deeplearning4j_tpu_torch.parallel.master import (  # noqa: F401
    DistributedMultiLayerNetwork,
    ParameterAveragingTrainingMaster,
    SharedTrainingMaster,
    TrainingMaster,
    TrainingStats,
    init_distributed,
)
from deeplearning4j_tpu_torch.parallel.elastic import BackoffPolicy  # noqa: F401
from deeplearning4j_tpu_torch.parallel.time_source import (  # noqa: F401
    NTPTimeSource,
    SystemClockTimeSource,
    TimeSource,
    get_time_source,
    set_time_source,
)
