"""Distributed training and serving front-ends of the PyTorch/CUDA port.

Counterpart of ``deeplearning4j_tpu/parallel``: the device mesh
(``mesh.py``, a ``DeviceMesh`` over the ranks of a ``torch.distributed``
world), the sharding rules that place a network's tensors on it as
DTensors (``sharding.py``), ``ParallelWrapper``'s data- and
tensor-parallel training (``trainer.py``) and ``ParallelInference``.
"""

from deeplearning4j_tpu_torch.parallel.mesh import make_mesh, local_mesh  # noqa: F401
from deeplearning4j_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    replicated,
    tp_param_specs,
    shard_model,
)
from deeplearning4j_tpu_torch.parallel.trainer import ParallelWrapper  # noqa: F401
from deeplearning4j_tpu_torch.parallel.inference import (  # noqa: F401
    DispatcherCrashed,
    InferenceDeadlineExceeded,
    ParallelInference,
)
