"""Observability of the port. Only the metrics core is ported so far
(``observe/metrics.py``, a copy of the JAX package's jax-free module); the
trace, export, health and other modules of ``deeplearning4j_tpu/observe/``
are not.
"""

from deeplearning4j_tpu_torch.observe.metrics import (  # noqa: F401
    Counter,
    Exemplar,
    Gauge,
    Histogram,
    HTTPObserverMixin,
    MetricsRegistry,
    default_registry,
    exemplar_trace_ids,
    format_exemplar,
    instrument_http,
    parse_prometheus_text,
)
