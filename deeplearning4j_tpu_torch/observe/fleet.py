"""Fleet observability: cross-process metrics federation + span streaming.

Rounds 7-8 built a deep observability stack — and left it strictly
single-process, while the failures that matter (elastic shrink, host
kills, DCN partitions) are multi-process. This module is the operator
plane that spans the JOB instead of the process:

- :class:`MetricsFileExporter` — the worker side of federation: writes
  the registry's Prometheus exposition atomically to a snapshot file
  next to the worker's heartbeat file. Deliberately file-based (not a
  scrape socket): deterministic in CI, crash-durable up to the last
  completed iteration, and the supervisor already owns the directory.
- :class:`FleetRegistry` — the supervisor side: merges every worker
  snapshot through ``parse_prometheus_text`` (the established exposition
  contract), re-labels each series with ``{slot,host,generation}`` under
  a cardinality bound, and serves the union from :meth:`exposition` —
  duck-typing the ``MetricsRegistry`` surface the existing
  :class:`~deeplearning4j_tpu_torch.observe.alerts.AlertManager` and
  ``/metrics`` handlers consume, so burn-rate rules can watch the whole
  job unchanged.
- :class:`FleetMetricsServer` — a minimal HTTP front-end (``/metrics``,
  ``/healthz``, ``/alerts``) for supervisor processes, reusing the
  ModelServer's response plumbing (``observe.metrics.respond``).
- :class:`SpanFileWriter` / :func:`read_span_file` — crash-durable trace
  streaming: a ``TraceRecorder`` drop-in that ALSO appends every
  completed span as one JSON line, so a SIGKILLed worker keeps every
  span up to its last finished iteration.  The file opens with a meta
  line carrying the process's ``EPOCH_ANCHOR`` — the clock-alignment
  rule ``observe.export.merge_chrome_traces`` uses to put every
  process's monotonic timestamps on one wall-clock timeline.
- :class:`TailSampler` — Dapper-style tail-based sampling between the
  recorder and any span sink: complete traces persist only when slow,
  errored, exemplar-referenced, or alert-flagged (plus a deterministic
  probabilistic floor), under a bounded disk budget with drop
  accounting — always-on tracing at always-affordable cost.

Federation preserves exemplars: a worker's ``# {trace_id="..."}``
histogram annotations survive the parse → re-label → re-render cycle, so
a p99 bucket on the SUPERVISOR's ``/metrics`` still names the worker
trace that caused it.

Everything here follows the ``enable_tracing()`` discipline: a worker
without the supervisor's env vars, or a supervisor without a fleet
registry, pays a single ``is None`` check.
The port's copy of the JAX package's stdlib-only ``observe/fleet.py``:
the same files, the same exposition and the same span lines.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.observe.metrics import (MetricsRegistry,
                                                _format_value, _label_str,
                                                exemplar_trace_ids,
                                                format_exemplar,
                                                parse_prometheus_text)
from deeplearning4j_tpu_torch.observe.trace import EPOCH_ANCHOR, Span, TraceRecorder
from deeplearning4j_tpu_torch.util.fsio import atomic_write_text

#: labels the federation owns; a worker-side label with the same name is
#: overwritten (the supervisor's placement assignment is authoritative)
FEDERATION_LABELS = ("slot", "host", "generation")


class MetricsFileExporter:
    """Worker-side federation endpoint: write the registry's exposition
    text atomically to ``path`` (tmp + ``os.replace``, the heartbeat
    discipline — the supervisor never reads a torn snapshot). Export
    errors are swallowed: a full disk must not fail a training step."""

    def __init__(self, registry: MetricsRegistry, path: str):
        self.registry = registry
        self.path = str(path)
        self.exports = 0
        self.errors = 0
        self._lock = threading.Lock()

    def export(self) -> bool:
        with self._lock:
            try:
                atomic_write_text(self.path, self.registry.exposition())
                self.exports += 1
                return True
            except OSError:
                self.errors += 1
                return False


class FleetRegistry:
    """Supervisor-side union of a local registry and N worker snapshots.

    Duck-types the ``MetricsRegistry`` surface its consumers use
    (``counter``/``gauge``/``histogram``/``get``/``exposition``):
    instruments delegate to the LOCAL registry (where the supervisor's
    own ``elastic_*`` series and the AlertManager's state live);
    :meth:`exposition` appends the re-labeled union of every registered
    source, so ``AlertManager(metrics=fleet)`` and a ``/metrics``
    handler see one job-wide exposition.

    Federated series are re-labeled with the source's
    ``{slot,host,generation}`` assignment and capped at ``max_series``
    total (cardinality bound); drops and scrape failures are themselves
    exported (``fleet_federation_dropped_series_total`` /
    ``fleet_federation_scrape_errors_total``) — silent truncation would
    read as "all quiet".
    """

    def __init__(self, local: Optional[MetricsRegistry] = None, *,
                 max_series: int = 2000):
        self.local = local if local is not None else MetricsRegistry()
        self.max_series = int(max_series)
        self._sources: Dict[Any, Tuple[str, Dict[str, str]]] = {}
        self._lock = threading.Lock()
        self._m_sources = self.local.gauge(
            "fleet_sources", "Worker metric snapshots federated")
        self._m_dropped = self.local.counter(
            "fleet_federation_dropped_series_total",
            "Federated series dropped by the cardinality bound")
        self._m_errors = self.local.counter(
            "fleet_federation_scrape_errors_total",
            "Worker snapshot files that could not be read/parsed")

    # ------------------------------------------------------------- sources
    def set_source(self, key: Any, path: str,
                   labels: Dict[str, Any]) -> None:
        """Register (or update) one worker snapshot file under ``key``
        (the slot id); ``labels`` is the federation's label assignment
        (slot/host/generation)."""
        with self._lock:
            self._sources[key] = (str(path),
                                  {str(k): str(v) for k, v in labels.items()})
            self._m_sources.set(len(self._sources))

    def remove_source(self, key: Any) -> None:
        with self._lock:
            self._sources.pop(key, None)
            self._m_sources.set(len(self._sources))

    def clear_sources(self) -> None:
        with self._lock:
            self._sources.clear()
            self._m_sources.set(0)

    def sources(self) -> Dict[Any, Tuple[str, Dict[str, str]]]:
        with self._lock:
            return dict(self._sources)

    # --------------------------------------------------- instrument surface
    def counter(self, *a, **kw):
        return self.local.counter(*a, **kw)

    def gauge(self, *a, **kw):
        return self.local.gauge(*a, **kw)

    def histogram(self, *a, **kw):
        return self.local.histogram(*a, **kw)

    def get(self, name: str):
        return self.local.get(name)

    # ----------------------------------------------------------- exposition
    def federated_lines(self) -> List[str]:
        """The re-labeled union of every source, one sample line per
        series, capped at ``max_series``. Untyped on purpose: the HELP/
        TYPE headers belong to the writer; ``parse_prometheus_text``
        (the consumer contract) ignores them either way."""
        lines: List[str] = []
        dropped = 0
        errors = 0
        snapshot = self.sources()
        for key in sorted(snapshot, key=str):
            path, fed_labels = snapshot[key]
            try:
                with open(path, encoding="utf-8") as fh:
                    sample = parse_prometheus_text(fh.read())
            except FileNotFoundError:
                # a registered-but-not-yet-written snapshot (the
                # supervisor pre-unlinks it at launch; the worker's
                # first export lands only after its start-up) is a normal
                # boot window, not a scrape failure
                continue
            except (OSError, ValueError, AssertionError, IndexError):
                errors += 1
                continue
            exemplars = getattr(sample, "exemplars", {})
            for name in sorted(sample):
                for label_key in sorted(sample[name]):
                    if len(lines) >= self.max_series:
                        dropped += 1
                        continue
                    merged = dict(label_key)
                    merged.update(fed_labels)  # federation labels win
                    pairs = sorted(merged.items())
                    line = (f"{name}{_label_str((), (), extra=pairs)} "
                            f"{_format_value(sample[name][label_key])}")
                    # exemplars ride along under the SAME cardinality
                    # bound (an annotation on a kept series, never an
                    # extra series): the supervisor's p99 bucket keeps
                    # naming the worker trace that caused it
                    ex = exemplars.get((name, label_key))
                    if ex is not None:
                        line += " " + format_exemplar(ex)
                    lines.append(line)
        if dropped:
            self._m_dropped.inc(dropped)
        if errors:
            self._m_errors.inc(errors)
        return lines

    def exposition(self) -> str:
        text = self.local.exposition()
        fed = self.federated_lines()
        if fed:
            text += "\n".join(fed) + "\n"
        return text


class FleetMetricsServer:
    """Minimal observability front-end for supervisor processes: GET
    ``/metrics`` (the :class:`FleetRegistry` union, Prometheus text),
    ``/healthz``, ``/alerts`` when an ``AlertManager`` is attached, and
    ``/slo`` when an :class:`~.slo.SLOSet` is attached — the
    ModelServer's HTTP plumbing without the model surface."""

    def __init__(self, registry, *, host: str = "127.0.0.1", port: int = 0,
                 alerts=None, slo=None):
        self.registry = registry
        self.host = host
        self.port = int(port)
        self.alerts = alerts
        self.slo = slo
        self._httpd = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        """Bind (port 0 → ephemeral) and serve on a daemon thread;
        returns the bound port."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from deeplearning4j_tpu_torch.observe.metrics import respond, respond_json
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # silence
                pass

            def do_GET(self):
                from urllib.parse import urlparse
                path = urlparse(self.path).path
                if path == "/metrics":
                    respond(self, 200,
                            server.registry.exposition().encode(),
                            "text/plain; version=0.0.4")
                elif path == "/healthz":
                    respond_json(self, {"status": "ok"})
                elif path == "/alerts":
                    if server.alerts is None:
                        respond_json(self,
                                     {"error": "no alert manager attached"},
                                     404)
                    else:
                        respond_json(self, server.alerts.describe())
                elif path == "/slo":
                    if server.slo is None:
                        respond_json(self,
                                     {"error": "no slo config attached"},
                                     404)
                    else:
                        respond_json(self, server.slo.status(
                            metrics=server.registry,
                            alerts=server.alerts))
                else:
                    respond_json(self, {"error": "not found"}, 404)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="fleet-metrics-server")
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def url(self) -> str:
        return f"http://{self.host}:{self.port}"


# ---------------------------------------------------------------------------
# crash-durable span streaming
# ---------------------------------------------------------------------------

# the ONE attr sanitization rule, shared with every exporter
from deeplearning4j_tpu_torch.observe.export import sanitize_attr as _safe_attr


class SpanFileWriter(TraceRecorder):
    """A :class:`TraceRecorder` drop-in that ALSO appends every completed
    span as one JSON line to ``path`` — crash-durable: a SIGKILLed worker
    keeps every span up to its last finished iteration, which is exactly
    what the incident bundle and the merged fleet trace need from a
    victim.  The first line is a ``meta`` record carrying the process's
    monotonic↔epoch anchor (``observe.trace.EPOCH_ANCHOR``), the
    clock-alignment datum :func:`read_span_file` hands to
    ``merge_chrome_traces``.  A dead stream (disk full) detaches; the
    in-memory ring keeps recording (the ``LogHub`` contract).

    The file is TRUNCATED on open: one stream = one process = one
    anchor. A re-run supervisor re-using the same checkpoint dir (and
    therefore the same per-generation filenames) must not leave a stale
    process's spans under a fresh anchor — the merge rule is that a
    mis-aligned row is worse than a missing one."""

    def __init__(self, path: str, *, label: str, capacity: int = 65536,
                 extra_meta: Optional[Dict[str, Any]] = None):
        super().__init__(capacity)
        self.path = str(path)
        self.label = label
        self._file_lock = threading.Lock()
        self._fh = open(self.path, "w", encoding="utf-8")
        meta: Dict[str, Any] = {
            "kind": "meta", "label": label, "pid": os.getpid(),
            "anchor_perf_ns": EPOCH_ANCHOR[0],
            "anchor_epoch_us": EPOCH_ANCHOR[1],
        }
        if extra_meta:
            meta.update({str(k): _safe_attr(v)
                         for k, v in extra_meta.items()})
        self._write_line(meta)

    def add(self, span: Span) -> None:
        super().add(span)
        rec: Dict[str, Any] = {
            "kind": "span", "name": span.name, "cat": span.category,
            "trace": span.trace_id, "span": span.span_id,
            "parent": span.parent_id, "start_ns": span.start_ns,
            "end_ns": span.end_ns, "tid": span.thread_id,
            "tname": span.thread_name,
        }
        if span.attrs:
            rec["attrs"] = {str(k): _safe_attr(v)
                            for k, v in span.attrs.items()}
        if span.error:
            rec["error"] = span.error
        if span.links:
            rec["links"] = [{"trace": l.trace_id, "span": l.span_id}
                            for l in span.links]
        self._write_line(rec)

    def _write_line(self, obj: Dict[str, Any]) -> None:
        with self._file_lock:
            fh = self._fh
            if fh is None:
                return
            try:
                fh.write(json.dumps(obj) + "\n")
                fh.flush()
            except Exception:  # noqa: BLE001 - a dead stream must never
                # raise into an instrumented hot path; the ring records on
                self._fh = None
                try:
                    fh.close()
                except Exception:  # noqa: BLE001
                    pass

    def close(self) -> None:
        with self._file_lock:
            fh, self._fh = self._fh, None
            if fh is not None:
                fh.close()


class TailSampler(TraceRecorder):
    """Tail-based trace sampling at the recorder/sink seam.

    Sits where a :class:`SpanFileWriter` (or any ``add(span)`` sink)
    would: install it as the tracer's recorder and every completed span
    still lands in the in-memory ring (``super().add``) — the on-demand
    capture window keeps working — but the SINK only receives COMPLETE
    traces that earn their disk.  The decision runs when a trace's local
    root ends (a span with no parent, or one whose name is a configured
    root kind — a server whose root carries a remote ``traceparent``
    parent names ``http_request`` in ``slow_ms``), first match wins:

    ==========  ======================================================
    keep        predicate
    ==========  ======================================================
    error       any span in the trace carries ``error``
    slow        root duration >= ``slow_ms[root.name]``
                (else ``default_slow_ms``) milliseconds
    exemplar    the trace_id is referenced by a histogram exemplar in
                ``exemplar_source`` (a registry or a callable → set)
    alert       the attached ``AlertManager`` has any rule firing
    floor       deterministic probabilistic floor:
                ``int(trace_id[:8], 16) / 0xFFFFFFFF < probability``
    ==========  ======================================================

    Everything else drops.  Kept traces spend a bounded disk budget
    (``max_bytes``, estimated per span) — once exhausted, even keepers
    drop (counted separately: a full disk silently masquerading as "no
    slow traces" would be the worst lie).  Unfinished traces buffer up
    to ``max_pending`` before the oldest is evicted (a crashed client
    that never closes its root must not pin memory forever).  Every
    outcome is counted; :meth:`describe` is the accounting surface the
    bench commits."""

    def __init__(self, sink=None, *, slow_ms: Optional[Dict[str, float]]
                 = None, default_slow_ms: float = 250.0,
                 probability: float = 0.0,
                 max_bytes: int = 8 * 1024 * 1024,
                 max_pending: int = 512, capacity: int = 65536,
                 exemplar_source=None, alerts=None, metrics=None):
        super().__init__(capacity)
        if not 0.0 <= float(probability) <= 1.0:
            raise ValueError("probability must be in [0, 1]")
        self.sink = sink
        self.slow_ms = dict(slow_ms or {})
        self.default_slow_ms = float(default_slow_ms)
        self.probability = float(probability)
        self.max_bytes = int(max_bytes)
        self.max_pending = int(max_pending)
        self.exemplar_source = exemplar_source
        self.alerts = alerts
        self._ts_lock = threading.Lock()
        self._pending: "Dict[str, List[Span]]" = {}
        self._decided: "Dict[str, bool]" = {}
        self._decided_cap = 4096
        self.kept_traces = 0
        self.kept_spans = 0
        self.dropped_traces = 0
        self.dropped_spans = 0
        self.dropped_budget_traces = 0
        self.dropped_pending_traces = 0
        self.bytes_written = 0
        self.keep_reasons: Dict[str, int] = {}
        self._m_traces = None
        if metrics is not None:
            self._m_traces = metrics.counter(
                "trace_tail_traces_total",
                "Tail-sampling decisions by outcome",
                ("decision",))

    # ----------------------------------------------------------- recording
    def add(self, span: Span) -> None:
        super().add(span)          # the ring always records
        if self.sink is None:
            return
        trace_id = span.trace_id
        with self._ts_lock:
            verdict = self._decided.get(trace_id)
            if verdict is not None:
                # late arrival on an already-decided trace follows it
                if verdict:
                    self._emit_locked([span])
                else:
                    self.dropped_spans += 1
                return
            buf = self._pending.setdefault(trace_id, [])
            buf.append(span)
            if not (span.parent_id is None or span.name in self.slow_ms):
                self._evict_pending_locked()
                return
            spans = self._pending.pop(trace_id)
        # the keep predicates read OTHER subsystems (registry locks,
        # the alert manager's lock) — never under our own lock
        keep, reason = self._decide(span, spans)
        with self._ts_lock:
            self._remember_locked(trace_id, keep)
            if not keep:
                self.dropped_traces += 1
                self.dropped_spans += len(spans)
            else:
                est = sum(self._span_bytes(s) for s in spans)
                if self.bytes_written + est > self.max_bytes:
                    self._remember_locked(trace_id, False)
                    self.dropped_budget_traces += 1
                    self.dropped_traces += 1
                    self.dropped_spans += len(spans)
                    reason = "drop_budget"
                    keep = False
                else:
                    self.kept_traces += 1
                    self.keep_reasons[reason] = \
                        self.keep_reasons.get(reason, 0) + 1
                    self._emit_locked(spans)
        if self._m_traces is not None:
            # reason is the keep reason, "drop", or "drop_budget"
            self._m_traces.inc(decision=reason)

    # ----------------------------------------------------------- decisions
    def _decide(self, root: Span, spans: List[Span]) -> Tuple[bool, str]:
        if any(s.error for s in spans):
            return True, "error"
        end_ns = root.end_ns if root.end_ns is not None else root.start_ns
        dur_ms = max(end_ns - root.start_ns, 0) / 1e6
        if dur_ms >= self.slow_ms.get(root.name, self.default_slow_ms):
            return True, "slow"
        if root.trace_id in self._exemplar_ids():
            return True, "exemplar"
        if self.alerts is not None and self.alerts.firing():
            return True, "alert"
        if self.probability > 0.0 and self._floor_hit(root.trace_id):
            return True, "floor"
        return False, "drop"

    def _exemplar_ids(self) -> set:
        src = self.exemplar_source
        if src is None:
            return set()
        try:
            if callable(src):
                return set(src())
            return exemplar_trace_ids(src)
        except Exception:  # noqa: BLE001 - sampling must never raise
            return set()

    def _floor_hit(self, trace_id: str) -> bool:
        try:
            return int(trace_id[:8], 16) / 0xFFFFFFFF < self.probability
        except (ValueError, IndexError):
            return False

    # ------------------------------------------------------------ plumbing
    def _remember_locked(self, trace_id: str, keep: bool) -> None:
        self._decided[trace_id] = keep
        while len(self._decided) > self._decided_cap:
            self._decided.pop(next(iter(self._decided)))

    def _evict_pending_locked(self) -> None:
        while len(self._pending) > self.max_pending:
            tid = next(iter(self._pending))
            spans = self._pending.pop(tid)
            self._remember_locked(tid, False)
            self.dropped_pending_traces += 1
            self.dropped_traces += 1
            self.dropped_spans += len(spans)

    @staticmethod
    def _span_bytes(span: Span) -> int:
        # the JSON-line estimate (ids + fixed fields + attrs); cheap on
        # purpose — the budget bounds disk, it does not meter it
        n = 160 + len(span.name) + len(span.trace_id) + len(span.span_id)
        for k, v in (span.attrs or {}).items():
            n += len(str(k)) + len(str(v)) + 8
        return n

    def _emit_locked(self, spans: List[Span]) -> None:
        for s in spans:
            self.bytes_written += self._span_bytes(s)
            self.kept_spans += 1
            try:
                self.sink.add(s)
            except Exception:  # noqa: BLE001 - a dead sink must not
                pass           # raise into the instrumented hot path

    def flush_trace(self, trace_id: str) -> bool:
        """Force-keep one buffered trace (the on-demand capture's
        escape hatch for a trace the policy would drop)."""
        with self._ts_lock:
            spans = self._pending.pop(trace_id, None)
            if spans is None:
                return False
            self._remember_locked(trace_id, True)
            self.kept_traces += 1
            self.keep_reasons["forced"] = \
                self.keep_reasons.get("forced", 0) + 1
            self._emit_locked(spans)
            return True

    def describe(self) -> Dict[str, Any]:
        with self._ts_lock:
            return {
                "kept_traces": self.kept_traces,
                "kept_spans": self.kept_spans,
                "dropped_traces": self.dropped_traces,
                "dropped_spans": self.dropped_spans,
                "dropped_budget_traces": self.dropped_budget_traces,
                "dropped_pending_traces": self.dropped_pending_traces,
                "pending_traces": len(self._pending),
                "bytes_written": self.bytes_written,
                "max_bytes": self.max_bytes,
                "probability": self.probability,
                "default_slow_ms": self.default_slow_ms,
                "slow_ms": dict(self.slow_ms),
                "keep_reasons": dict(self.keep_reasons),
            }

    def close(self) -> None:
        """Drop undecided traces (they are incomplete by definition) and
        close the sink when it can be closed."""
        with self._ts_lock:
            for tid, spans in list(self._pending.items()):
                self.dropped_pending_traces += 1
                self.dropped_traces += 1
                self.dropped_spans += len(spans)
            self._pending.clear()
        if hasattr(self.sink, "close"):
            self.sink.close()


def read_span_file(path: str) -> Dict[str, Any]:
    """Parse one :class:`SpanFileWriter` output file:
    ``{"label", "pid", "anchor": (perf_ns, epoch_us), "spans": [dict]}``.
    Torn final lines (the writer was SIGKILLed mid-write) and unparseable
    lines are skipped — the surviving spans are the point."""
    out: Dict[str, Any] = {"label": os.path.basename(path), "pid": None,
                           "anchor": None, "meta": {}, "spans": []}
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            if not line.endswith("\n"):
                continue  # torn tail: that span never fully landed
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict):
                continue
            kind = rec.get("kind")
            if kind == "meta":
                if out["anchor"] is not None:
                    # defense in depth: the writer truncates on open, so
                    # a second meta line means two processes wrote one
                    # file — only the FIRST anchor can align the spans
                    # that follow it; keep it
                    continue
                out["label"] = rec.get("label", out["label"])
                out["pid"] = rec.get("pid")
                out["meta"] = {k: v for k, v in rec.items()
                               if k not in ("kind",)}
                try:
                    out["anchor"] = (int(rec["anchor_perf_ns"]),
                                     int(rec["anchor_epoch_us"]))
                except (KeyError, TypeError, ValueError):
                    pass
            elif kind == "span":
                if not isinstance(rec.get("start_ns"), int) \
                        or not isinstance(rec.get("end_ns"), int):
                    continue
                out["spans"].append(rec)
    return out
