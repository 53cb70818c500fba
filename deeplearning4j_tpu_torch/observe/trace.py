"""Dependency-free tracing core: spans, context propagation, ring recorder.

The Dapper-style answer to "where did this millisecond go" for the whole
stack: a :class:`Span` is one named, timed interval with attributes; a
:class:`Tracer` creates spans, maintains the current-span context through
``contextvars`` (so nesting works across any same-thread call chain,
including ``http.server`` handler threads), and records completed spans
into a bounded ring-buffer :class:`TraceRecorder`.

Cross-thread handoff is EXPLICIT, matching how the hot paths actually hop
threads: the enqueueing side captures ``tracer.current_context()`` (or the
span's ``.context``), ships it with the work item, and the worker either
passes it as ``parent=`` or records an after-the-fact interval with
:meth:`Tracer.record`. ``contextvars`` intentionally do NOT leak into
``threading.Thread`` targets, so an un-handed-off worker simply starts a
new root — never a wrong parent.

Trace identity follows the W3C Trace Context format so the serving tier can
join a client's timeline across the HTTP boundary:
``traceparent: 00-<32 hex trace-id>-<16 hex span-id>-01``.

Timestamps are ``time.perf_counter_ns()`` (monotonic); the exporter
normalizes to the earliest span, and :data:`EPOCH_ANCHOR` lets consumers
map to wall-clock when they must.

A copy of the JAX package's stdlib-only ``observe/trace.py``. The one
departure is the compile hook: the port has no XLA, and its compile is the
``nvcc`` build of a kernel library at first use. ``enable_tracing`` (its
``jax_hook`` keyword kept) installs ``observe/buildhook.py``, which turns
each real build into a ``kernel_build`` span; ``kernel_build`` is what
``compile_count`` and ``thread_compile_count`` count, and the
``kernel_builds_total`` / ``kernel_build_seconds_total`` counters it feeds
take the place of the reference's ``jax_compiles_total`` /
``jax_compile_seconds_total``.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

# wall-clock anchor: (perf_counter_ns at import, epoch micros at import)
EPOCH_ANCHOR: Tuple[int, int] = (time.perf_counter_ns(),
                                 int(time.time() * 1e6))


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


class SpanContext:
    """The portable identity of a span: what crosses threads and the wire."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def traceparent(self) -> str:
        """W3C ``traceparent`` header value (sampled flag always set)."""
        return f"00-{self.trace_id}-{self.span_id}-01"

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"SpanContext({self.trace_id[:8]}…/{self.span_id})"


def parse_traceparent(header: Optional[str]) -> Optional[SpanContext]:
    """Parse a W3C ``traceparent`` header; ``None`` on anything malformed
    (a bad header must never fail a request — tracing is best-effort)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, _flags = parts
    if len(version) != 2 or version == "ff":
        return None
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    return SpanContext(trace_id, span_id)


class Span:
    """One named, timed interval. Completed spans are immutable records in
    the recorder; open spans accept attributes and links."""

    __slots__ = ("name", "category", "trace_id", "span_id", "parent_id",
                 "start_ns", "end_ns", "attrs", "links", "thread_id",
                 "thread_name", "error")

    def __init__(self, name: str, *, trace_id: str, span_id: str,
                 parent_id: Optional[str], start_ns: int,
                 category: str = "app",
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.category = category
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_ns = start_ns
        self.end_ns: Optional[int] = None
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.links: List[SpanContext] = []
        self.thread_id = threading.get_ident()
        self.thread_name = threading.current_thread().name
        self.error: Optional[str] = None

    # ------------------------------------------------------------- mutation
    def set_attribute(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def add_link(self, ctx: Optional[SpanContext]) -> "Span":
        """Associate another span (e.g. the HTTP request a batch served)
        without making it a parent — exported as a Chrome flow arrow."""
        if ctx is not None:
            self.links.append(ctx)
        return self

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    @property
    def duration_ms(self) -> float:
        end = self.end_ns if self.end_ns is not None else time.perf_counter_ns()
        return (end - self.start_ns) / 1e6

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, {self.duration_ms:.3f}ms, "
                f"parent={self.parent_id})")


class TraceRecorder:
    """Bounded ring buffer of completed spans. Appends are O(1) and
    thread-safe; overflow silently drops the OLDEST spans (``dropped``
    counts them) so a long-running server can trace forever and export
    the recent window on demand."""

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self._spans: "deque[Span]" = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._total = 0

    def add(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            self._total += 1

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._total = 0

    @property
    def total_recorded(self) -> int:
        with self._lock:
            return self._total

    @property
    def dropped(self) -> int:
        with self._lock:
            return max(0, self._total - len(self._spans))

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


# the current span context, per execution context (thread/task)
_current_ctx: "contextvars.ContextVar[Optional[Tuple[str, str]]]" = \
    contextvars.ContextVar("dl4j_tpu_trace_ctx", default=None)


class Tracer:
    """Span factory + context manager + recorder front-end.

    ``metrics`` (optional, an ``observe.metrics.MetricsRegistry``) receives
    the compile-attribution counters the build hook emits
    (``kernel_builds_total``, ``kernel_build_seconds_total``).
    """

    def __init__(self, recorder: Optional[TraceRecorder] = None,
                 metrics=None, service: str = "deeplearning4j_tpu"):
        self.recorder = recorder if recorder is not None else TraceRecorder()
        self.metrics = metrics
        self.service = service
        self.compile_count = 0  # kernel_build spans seen (the rebuild alarm)
        self._compiles_by_thread: Dict[int, int] = {}
        # per-thread compile SECONDS (every compile event, kernel_build
        # included): the cost plane's exclusion source — a dispatcher
        # thread's delta around a batch is exactly the compile time that
        # batch must not bill to its requests
        self._compile_s_by_thread: Dict[int, float] = {}
        self._compile_lock = threading.Lock()

    # ------------------------------------------------------------- context
    def current_context(self) -> Optional[SpanContext]:
        cur = _current_ctx.get()
        return None if cur is None else SpanContext(*cur)

    def current_traceparent(self) -> Optional[str]:
        ctx = self.current_context()
        return None if ctx is None else ctx.traceparent()

    # --------------------------------------------------------------- spans
    @contextmanager
    def span(self, name: str, *, parent: Optional[SpanContext] = None,
             category: str = "app", attrs: Optional[Dict[str, Any]] = None
             ) -> Iterator[Span]:
        """Open a span as the current context; on exit it is timed, closed
        and recorded — even when the body raises (the error is noted on the
        span, then propagates)."""
        sp = self.start_span(name, parent=parent, category=category,
                             attrs=attrs)
        token = _current_ctx.set((sp.trace_id, sp.span_id))
        try:
            yield sp
        except BaseException as e:
            sp.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            _current_ctx.reset(token)
            self.end_span(sp)

    def start_span(self, name: str, *, parent: Optional[SpanContext] = None,
                   category: str = "app",
                   attrs: Optional[Dict[str, Any]] = None) -> Span:
        """Manual span start (pair with :meth:`end_span`). Does NOT set the
        current context — use :meth:`span` for that."""
        if parent is None:
            parent = self.current_context()
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = _new_trace_id(), None
        return Span(name, trace_id=trace_id, span_id=_new_span_id(),
                    parent_id=parent_id, start_ns=time.perf_counter_ns(),
                    category=category, attrs=attrs)

    def end_span(self, span: Span) -> None:
        if span.end_ns is None:
            span.end_ns = time.perf_counter_ns()
            self.recorder.add(span)

    def record(self, name: str, start_ns: int, end_ns: int, *,
               parent: Optional[SpanContext] = None, category: str = "app",
               attrs: Optional[Dict[str, Any]] = None,
               links: Sequence[SpanContext] = ()) -> Span:
        """Record an interval measured elsewhere as a completed span — the
        after-the-fact form every cross-thread site uses (queue waits,
        compile durations, per-iteration listener windows)."""
        if parent is None:
            parent = self.current_context()
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = _new_trace_id(), None
        sp = Span(name, trace_id=trace_id, span_id=_new_span_id(),
                  parent_id=parent_id, start_ns=int(start_ns),
                  category=category, attrs=attrs)
        for l in links:
            sp.add_link(l)
        sp.end_ns = int(end_ns)
        self.recorder.add(sp)
        return sp

    # -------------------------------------------- compile attribution sink
    def note_compile_event(self, span_name: str, duration_s: float) -> None:
        """Sink for the kernel build hook (``observe.buildhook``): records
        the just-finished compile as a span under whatever context is
        current on THIS thread — a kernel library built at its first use
        inside ``batch_execute`` nests exactly where it happened and shows
        up loudly."""
        now = time.perf_counter_ns()
        self.record(span_name, now - int(duration_s * 1e9), now,
                    category="compile")
        tid = threading.get_ident()
        with self._compile_lock:
            self._compile_s_by_thread[tid] = \
                self._compile_s_by_thread.get(tid, 0.0) + float(duration_s)
        if span_name == "kernel_build":
            with self._compile_lock:
                self.compile_count += 1
                self._compiles_by_thread[tid] = \
                    self._compiles_by_thread.get(tid, 0) + 1
            if self.metrics is not None:
                self.metrics.counter(
                    "kernel_builds_total",
                    "nvcc kernel library builds observed by the tracer").inc()
                self.metrics.counter(
                    "kernel_build_seconds_total",
                    "Cumulative nvcc kernel library build time").inc(duration_s)

    def thread_compile_count(self, thread_id: Optional[int] = None) -> int:
        """Compiles triggered on one thread (default: the calling thread) —
        the attribution a training listener wants: a serving dispatcher
        building a kernel library on ITS thread must not count against
        training running elsewhere in the process."""
        tid = thread_id if thread_id is not None else threading.get_ident()
        with self._compile_lock:
            return self._compiles_by_thread.get(tid, 0)

    def thread_compile_seconds(self,
                               thread_id: Optional[int] = None) -> float:
        """Cumulative compile seconds (``kernel_build`` and any other
        compile event) observed on one thread (default: the calling
        thread). The request-cost plane brackets each coalesced batch with
        this counter so a kernel build never bills to the requests that
        triggered it."""
        tid = thread_id if thread_id is not None else threading.get_ident()
        with self._compile_lock:
            return self._compile_s_by_thread.get(tid, 0.0)

    # -------------------------------------------------------------- export
    def chrome_trace(self) -> dict:
        from deeplearning4j_tpu_torch.observe.export import to_chrome_trace
        return to_chrome_trace(self.recorder.spans(), service=self.service)

    def write_chrome_trace(self, path) -> None:
        from deeplearning4j_tpu_torch.observe.export import write_chrome_trace
        write_chrome_trace(path, self.recorder.spans(), service=self.service)

    def flush(self, path) -> int:
        """Write the Chrome trace to ``path`` and return the span count —
        the one-call form every CLI/bench exit path uses."""
        self.write_chrome_trace(path)
        return len(self.recorder)

    def timeline(self, **kw) -> str:
        from deeplearning4j_tpu_torch.observe.export import text_timeline
        return text_timeline(self.recorder.spans(), **kw)


# ---------------------------------------------------------------------------
# process-wide activation: instrumented hot paths are zero-overhead no-ops
# until a tracer is enabled (one `is None` check per site)
# ---------------------------------------------------------------------------

_active_tracer: Optional[Tracer] = None
_active_lock = threading.Lock()


def get_active_tracer() -> Optional[Tracer]:
    return _active_tracer


def enable_tracing(tracer: Optional[Tracer] = None, *, metrics=None,
                   capacity: int = 65536, jax_hook: bool = True) -> Tracer:
    """Install ``tracer`` (or a fresh one) as the process-wide active tracer
    and (by default, ``jax_hook``, the reference's keyword) hook the kernel
    library builds into it (``observe.buildhook``). Returns the active
    tracer. Idempotent per tracer; a second call swaps the tracer."""
    global _active_tracer
    with _active_lock:
        if tracer is None:
            tracer = Tracer(TraceRecorder(capacity), metrics=metrics)
        elif tracer.metrics is None and metrics is not None:
            tracer.metrics = metrics  # honor metrics= for explicit tracers
        _active_tracer = tracer
    if jax_hook:
        from deeplearning4j_tpu_torch.observe.buildhook import install_build_hook
        install_build_hook()
    return tracer


def disable_tracing() -> None:
    """Deactivate tracing; every instrumented site reverts to a no-op.
    (The build hook stays registered — it is itself a no-op without an
    active tracer.)"""
    global _active_tracer
    with _active_lock:
        _active_tracer = None


@contextmanager
def span(name: str, *, parent: Optional[SpanContext] = None,
         category: str = "app",
         attrs: Optional[Dict[str, Any]] = None) -> Iterator[Optional[Span]]:
    """Module-level convenience: a span on the ACTIVE tracer, or a no-op
    (yielding ``None``) when tracing is off — the form the instrumented
    hot paths use."""
    tr = _active_tracer
    if tr is None:
        yield None
        return
    with tr.span(name, parent=parent, category=category, attrs=attrs) as sp:
        yield sp


def current_traceparent() -> Optional[str]:
    """The active context's W3C header value, or None (off / no open span)."""
    tr = _active_tracer
    return None if tr is None else tr.current_traceparent()


def current_span_ids() -> Tuple[Optional[str], Optional[str]]:
    """``(trace_id, span_id)`` of the span open on THIS execution
    context, or ``(None, None)``. Reads the shared contextvar directly —
    the ids are tracer-independent, so correlation stampers (log
    records, pipeline journal lines) work for explicitly-passed tracers
    too, not just the process-wide active one."""
    cur = _current_ctx.get()
    return (None, None) if cur is None else cur
