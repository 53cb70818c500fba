"""Model serving of the PyTorch/CUDA port.

Counterpart of the JAX package's ``serving/``. Ported so far:

- ``registry``  — versioned model registry with atomic hot swap (on
  ``ParallelInference.update_model``) and rollback, bucket warmup, canary
  traffic splits, shadow mode, fallback chains; loads from live objects
  or paths (``util/model_guesser.py``);
- ``quantize``  — per-version dtype policies (``int8`` weight-only with
  per-output-channel scales, ``bf16``), calibrated at registration;
- ``breaker``   — per-version circuit breakers quarantining a forward
  that keeps crashing the dispatcher.

The HTTP front end (``server``, ``client``, ``admission``, ``brownout``)
comes with ROADMAP item 4.
"""

from deeplearning4j_tpu_torch.observe.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    instrument_http,
    parse_prometheus_text,
)
from deeplearning4j_tpu_torch.serving.breaker import CircuitBreaker  # noqa: F401
from deeplearning4j_tpu_torch.serving.registry import (  # noqa: F401
    ModelNotFound,
    ModelRegistry,
    ModelVersion,
    ServedModel,
    VersionQuarantined,
)
from deeplearning4j_tpu_torch.serving.quantize import (  # noqa: F401
    DTYPE_POLICIES,
    QuantizedModel,
    quantize_model,
)
