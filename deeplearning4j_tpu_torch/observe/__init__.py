"""Observability of the port: tracing, metrics, logs and request cost.

Counterpart of the JAX package's ``observe/``. Ported so far:

- ``trace``     — ``Span``/``Tracer``/``TraceRecorder``: contextvar-nested
  spans, explicit cross-thread handoff, W3C ``traceparent`` in/out, a
  bounded ring buffer; ``enable_tracing()`` flips the batching dispatcher
  from no-op to recording;
- ``buildhook`` — the counterpart of ``jaxhook``: each ``nvcc`` build of a
  kernel library becomes a ``kernel_build`` span nested where it happened;
- ``export``    — Chrome trace-event JSON with flow arrows across threads,
  and a terminal text timeline;
- ``metrics``   — the Prometheus registry core, with trace-id exemplars;
- ``log``       — structured JSON-lines logging with trace correlation;
- ``cost``      — the request-cost ledger over ``batch_execute`` spans.

The listener, health, alerts, SLO, incident and fleet modules come with
ROADMAP items 4 and 5.
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
from deeplearning4j_tpu_torch.observe.trace import (  # noqa: F401
    Span,
    SpanContext,
    TraceRecorder,
    Tracer,
    current_traceparent,
    disable_tracing,
    enable_tracing,
    get_active_tracer,
    parse_traceparent,
    span,
)
from deeplearning4j_tpu_torch.observe.export import (  # noqa: F401
    text_timeline,
    to_chrome_trace,
    write_chrome_trace,
)
from deeplearning4j_tpu_torch.observe.cost import (  # noqa: F401
    CostLedger,
    RequestCost,
)
from deeplearning4j_tpu_torch.observe.buildhook import install_build_hook  # noqa: F401
from deeplearning4j_tpu_torch.observe.log import (  # noqa: F401
    LogHub,
    LogRecord,
    LogRing,
    StructuredLogger,
    at_most_every,
    disable_structured_logging,
    enable_structured_logging,
    every_n,
    get_active_hub,
    get_logger,
)
