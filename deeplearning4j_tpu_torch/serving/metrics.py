"""DEPRECATED — the metrics core moved to ``deeplearning4j_tpu_torch.observe.metrics``.

This module re-exports the full surface for backward compatibility; new
code should import from ``deeplearning4j_tpu_torch.observe.metrics`` (or the
``deeplearning4j_tpu_torch.observe`` package), where the shared registry now
serves training, serving, clustering and UI alike.
"""

import warnings as _warnings

from deeplearning4j_tpu_torch.observe.metrics import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    HTTPObserverMixin,
    MetricsRegistry,
    default_registry,
    instrument_http,
    parse_prometheus_text,
)

_warnings.warn(
    "deeplearning4j_tpu_torch.serving.metrics moved to "
    "deeplearning4j_tpu_torch.observe.metrics; this alias will be removed",
    DeprecationWarning, stacklevel=2)
