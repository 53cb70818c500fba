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
- ``cost``      — the request-cost ledger over ``batch_execute`` spans;
- ``listener``  — ``TraceListener``: any ``fit()`` records spans and
  ``training_*`` series;
- ``health``    — ``TrainingWatchdog`` (NaN/Inf loss and parameters,
  gradient-norm EWMA, divergence, stalls) and the serving
  ``HealthReport`` behind ``/livez``;
- ``alerts``    — threshold, absence, rate and burn-rate rules over any
  registry's exposition, deduped notifications to sinks, the
  ``AlertManager`` evaluator (injectable clock);
- ``slo``       — declarative SLOs compiled into burn-rate rules, the
  ``/slo`` surface;
- ``fleet``     — metrics snapshot files, their federation, span files,
  tail sampling; ``export.merge_chrome_traces`` stitches the span files;
- ``incident``  — the flight recorder's bundles and ``capture_bundle``
  behind ``/debug/capture``.
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
    merge_chrome_traces,
    text_timeline,
    to_chrome_trace,
    write_chrome_trace,
)
from deeplearning4j_tpu_torch.observe.fleet import (  # noqa: F401
    FleetMetricsServer,
    FleetRegistry,
    MetricsFileExporter,
    SpanFileWriter,
    TailSampler,
    read_span_file,
)
from deeplearning4j_tpu_torch.observe.incident import (  # noqa: F401
    IncidentRecorder,
    capture_bundle,
)
from deeplearning4j_tpu_torch.observe.cost import (  # noqa: F401
    CostLedger,
    RequestCost,
)
from deeplearning4j_tpu_torch.observe.slo import (  # noqa: F401
    SLO,
    LatencyBurnRateRule,
    SLOSet,
    load_slos,
)
from deeplearning4j_tpu_torch.observe.listener import TraceListener  # noqa: F401
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
from deeplearning4j_tpu_torch.observe.health import (  # noqa: F401
    HealthCheck,
    HealthEvent,
    HealthReport,
    ServingHealth,
    TrainingWatchdog,
    WatchdogAlarm,
    attach_observability,
)
from deeplearning4j_tpu_torch.observe.alerts import (  # noqa: F401
    AbsenceRule,
    AlertManager,
    BurnRateRule,
    CallbackSink,
    LogSink,
    Notification,
    RateOfChangeRule,
    SLOSpec,
    ThresholdRule,
    WebhookSink,
    load_rules,
)
