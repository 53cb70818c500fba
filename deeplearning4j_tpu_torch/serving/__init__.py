"""Model serving of the PyTorch/CUDA port.

Counterpart of the JAX package's ``serving/``. Ported so far:

- ``registry``  — versioned model registry with atomic hot swap (on
  ``ParallelInference.update_model``) and rollback, bucket warmup, canary
  traffic splits, shadow mode, fallback chains; loads from live objects
  or paths (``util/model_guesser.py``);
- ``quantize``  — per-version dtype policies (``int8`` weight-only with
  per-output-channel scales, ``bf16``), calibrated at registration;
- ``breaker``   — per-version circuit breakers quarantining a forward
  that keeps crashing the dispatcher;
- ``admission`` — bounded in-flight admission (429 + Retry-After), graceful
  drain;
- ``brownout``  — saturation/alert-driven degradation: priority shedding
  + fallback rerouting with hysteresis;
- ``server``    — the threaded HTTP front end: ``/v1/models/.../predict``
  (JSON or the ``streaming/codec.py`` binary frame), ``/v1/models``,
  ``/healthz``, ``/readyz``, ``/livez``, ``/alerts``, ``/slo``,
  ``/metrics``, ``/debug/capture``;
- ``client``    — the typed client with an opt-in ``RetryPolicy``
  (budgeted backoff retries, hedged requests);
- ``metrics``   — the deprecated re-export of ``observe/metrics.py``.
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
from deeplearning4j_tpu_torch.serving.admission import (  # noqa: F401
    AdmissionController,
    AdmissionRejected,
    Draining,
)
from deeplearning4j_tpu_torch.serving.breaker import CircuitBreaker  # noqa: F401
from deeplearning4j_tpu_torch.serving.brownout import (  # noqa: F401
    BrownoutController,
)
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
from deeplearning4j_tpu_torch.serving.server import ModelServer  # noqa: F401
from deeplearning4j_tpu_torch.serving.client import (  # noqa: F401
    ModelServingClient,
    RetryPolicy,
    ServingError,
)
