"""Structured logging with trace correlation — the third observability pillar.

Spans (``observe/trace.py``) and metrics (``observe/metrics.py``) answer
"where did the time go" and "how much"; this module answers "what
happened", in a form machines can join back to the other two: every
record is one JSON line carrying ``trace_id``/``span_id`` pulled from the
ACTIVE span automatically (the Dapper correlation contract — a log line
emitted inside a traced request is findable from that request's trace id,
across threads and the HTTP boundary, with no caller plumbing).

Pieces, mirroring the tracing layer's shape:

- :class:`LogRecord` — one structured event (timestamp, level, logger,
  message, trace/span ids, free-form fields) with a strict-JSON line form;
- :class:`LogRing` — bounded in-memory ring with drop accounting (the
  ``TraceRecorder`` pattern: a long-running server logs forever, exports
  the recent window on demand, and the drop count is honest);
- :class:`LogHub` — the process-wide sink: ring + optional JSON-lines
  stream. ``enable_structured_logging()`` installs one, exactly like
  ``enable_tracing()``; every emit site is a single ``is None`` check
  no-op until then;
- :class:`StdlibBridgeHandler` — a ``logging.Handler`` routed into the
  hub, so every existing ``logging.*`` call in the codebase gains trace
  correlation for free (installed on the root logger by
  ``enable_structured_logging(bridge_stdlib=True)``);
- :class:`every_n` / :class:`at_most_every` — rate-limit gates for
  hot-path logs (per-iteration watchdog findings, dispatcher retries),
  the latter with an injectable clock so tests never sleep.

A copy of the JAX package's stdlib-only ``observe/log.py``.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, TextIO

from deeplearning4j_tpu_torch.observe import trace as _trace

#: level names ↔ stdlib numeric levels (shared so the bridge is lossless)
LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
          "warning": logging.WARNING, "error": logging.ERROR,
          "critical": logging.CRITICAL}
_LEVEL_NAMES = {v: k for k, v in LEVELS.items()}


def _level_no(level) -> int:
    if isinstance(level, str):
        return LEVELS[level.lower()]
    return int(level)


def _level_name(levelno: int) -> str:
    name = _LEVEL_NAMES.get(levelno)
    if name is not None:
        return name
    # nearest named level at or below (stdlib allows arbitrary ints)
    below = [v for v in _LEVEL_NAMES if v <= levelno]
    return _LEVEL_NAMES[max(below)] if below else "debug"


def _jsonable(v: Any) -> Any:
    """Map any value to a strict-JSON-safe equivalent. Non-finite floats
    become their repr strings (``chrome://tracing``-style strictness: a
    NaN loss must survive ``json.loads`` downstream); unknown objects
    degrade to ``repr`` instead of failing the log site."""
    if isinstance(v, bool) or v is None or isinstance(v, (str, int)):
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else repr(v)
    if hasattr(v, "item") and not isinstance(v, (dict, list, tuple)):
        try:  # numpy scalars, 0-dim tensors
            return _jsonable(v.item())
        except Exception:  # noqa: BLE001 - non-scalar .item()
            return repr(v)
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return repr(v)


class LogRecord:
    """One structured log event. Immutable once emitted."""

    __slots__ = ("ts", "levelno", "logger", "message", "trace_id", "span_id",
                 "thread_name", "fields")

    def __init__(self, ts: float, levelno: int, logger: str, message: str,
                 trace_id: Optional[str], span_id: Optional[str],
                 thread_name: str, fields: Dict[str, Any]):
        self.ts = ts
        self.levelno = levelno
        self.logger = logger
        self.message = message
        self.trace_id = trace_id
        self.span_id = span_id
        self.thread_name = thread_name
        self.fields = fields

    @property
    def level(self) -> str:
        return _level_name(self.levelno)

    def to_dict(self) -> Dict[str, Any]:
        # free-form fields first, reserved keys authoritative on collision
        d: Dict[str, Any] = {str(k): _jsonable(v)
                             for k, v in self.fields.items()}
        d.update(ts=self.ts, level=self.level, logger=self.logger,
                 message=self.message, thread=self.thread_name)
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
            d["span_id"] = self.span_id
        return d

    def to_json(self) -> str:
        """The JSON-lines form (one line, strict JSON)."""
        return json.dumps(self.to_dict(), sort_keys=True, default=repr)

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"LogRecord({self.level}, {self.logger}, {self.message!r})"


class LogRing:
    """Bounded ring buffer of records; overflow drops the OLDEST and
    ``dropped`` counts them — the ``TraceRecorder`` contract."""

    def __init__(self, capacity: int = 8192):
        self.capacity = int(capacity)
        self._records: "deque[LogRecord]" = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._total = 0

    def add(self, record: LogRecord) -> None:
        with self._lock:
            self._records.append(record)
            self._total += 1

    def records(self) -> List[LogRecord]:
        with self._lock:
            return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._total = 0

    @property
    def total_recorded(self) -> int:
        with self._lock:
            return self._total

    @property
    def dropped(self) -> int:
        with self._lock:
            return max(0, self._total - len(self._records))

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


class LogHub:
    """The process-wide structured-log sink: every record lands in the
    ring; when a ``stream`` is attached each record is also written as one
    JSON line (the shippable form). Level filtering happens here, once."""

    def __init__(self, *, stream: Optional[TextIO] = None,
                 capacity: int = 8192, level="debug"):
        self.ring = LogRing(capacity)
        self.stream = stream
        self.levelno = _level_no(level)
        self._stream_lock = threading.Lock()
        self._owns_stream = False

    def emit(self, record: LogRecord) -> None:
        if record.levelno < self.levelno:
            return
        self.ring.add(record)
        # the stream is read AND written under the lock: close() (hub swap
        # or disable mid-run) must never yank it between the None check
        # and the write on an emitting thread
        with self._stream_lock:
            stream = self.stream
            if stream is not None:
                try:
                    stream.write(record.to_json() + "\n")
                    stream.flush()
                except Exception:  # noqa: BLE001 - a dead stream (disk
                    # full, closed fd) must never raise into arbitrary log
                    # call sites (the stdlib Handler contract); the ring
                    # keeps recording
                    self.stream = None
                    if self._owns_stream:
                        try:
                            stream.close()
                        except Exception:  # noqa: BLE001
                            pass

    def close(self) -> None:
        with self._stream_lock:
            stream, self.stream = self.stream, None
            if self._owns_stream and stream is not None:
                stream.close()


def _current_span_ids():
    tr = _trace.get_active_tracer()
    if tr is None:
        return None, None
    ctx = tr.current_context()
    if ctx is None:
        return None, None
    return ctx.trace_id, ctx.span_id


class StructuredLogger:
    """Named front-end over the ACTIVE hub. Binding is late (per call), so
    enabling structured logging mid-run picks up every existing logger,
    and every call is a no-op ``is None`` check until a hub exists."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def log(self, level, message: str, /, **fields) -> Optional[LogRecord]:
        hub = _active_hub
        if hub is None:
            return None
        levelno = _level_no(level)
        if levelno < hub.levelno:
            return None
        trace_id, span_id = _current_span_ids()
        rec = LogRecord(time.time(), levelno, self.name, str(message),
                        trace_id, span_id,
                        threading.current_thread().name, fields)
        hub.emit(rec)
        return rec

    def debug(self, message: str, /, **fields):
        return self.log(logging.DEBUG, message, **fields)

    def info(self, message: str, /, **fields):
        return self.log(logging.INFO, message, **fields)

    def warning(self, message: str, /, **fields):
        return self.log(logging.WARNING, message, **fields)

    def error(self, message: str, /, **fields):
        return self.log(logging.ERROR, message, **fields)


def get_logger(name: str) -> StructuredLogger:
    """A named structured logger (cheap; holds no state but the name)."""
    return StructuredLogger(name)


class StdlibBridgeHandler(logging.Handler):
    """Routes stdlib ``logging`` records into the active hub, stamping the
    current span's ids at emit time — every pre-existing ``log.info(...)``
    in the codebase joins the correlated stream for free."""

    def emit(self, record: logging.LogRecord) -> None:
        hub = _active_hub
        if hub is None:
            return
        try:
            message = record.getMessage()
        except Exception:  # noqa: BLE001 - bad %-format args must not raise
            message = str(record.msg)
        fields: Dict[str, Any] = {}
        if record.exc_info and record.exc_info[0] is not None:
            fields["exc_type"] = record.exc_info[0].__name__
            fields["exc"] = str(record.exc_info[1])
        trace_id, span_id = _current_span_ids()
        hub.emit(LogRecord(record.created, record.levelno, record.name,
                           message, trace_id, span_id,
                           threading.current_thread().name, fields))


# ---------------------------------------------------------------------------
# process-wide activation (the enable_tracing() pattern)
# ---------------------------------------------------------------------------

_active_hub: Optional[LogHub] = None
_active_lock = threading.Lock()
_bridge: Optional[StdlibBridgeHandler] = None


def get_active_hub() -> Optional[LogHub]:
    return _active_hub


def enable_structured_logging(*, stream: Optional[TextIO] = None,
                              path: Optional[str] = None,
                              capacity: int = 8192, level="debug",
                              bridge_stdlib: bool = True) -> LogHub:
    """Install the process-wide :class:`LogHub` and return it.

    ``stream`` (a text file object) or ``path`` (opened append-mode, owned
    and closed by ``disable_structured_logging``) receives JSON lines;
    with neither, records only land in the in-memory ring.
    ``bridge_stdlib`` attaches :class:`StdlibBridgeHandler` to the root
    logger (idempotent). A second call swaps the hub; the bridge follows
    the active hub automatically.
    """
    global _active_hub, _bridge
    if stream is not None and path is not None:
        raise ValueError("pass stream= or path=, not both")
    hub = LogHub(stream=stream, capacity=capacity, level=level)
    if path is not None:
        hub.stream = open(path, "a", encoding="utf-8")
        hub._owns_stream = True
    with _active_lock:
        old, _active_hub = _active_hub, hub
        if old is not None:
            old.close()
        if bridge_stdlib and _bridge is None:
            _bridge = StdlibBridgeHandler()
            logging.getLogger().addHandler(_bridge)
    return hub


def disable_structured_logging() -> None:
    """Deactivate: emit sites revert to no-ops, the stdlib bridge handler
    is removed, and a hub-owned file stream is closed."""
    global _active_hub, _bridge
    with _active_lock:
        hub, _active_hub = _active_hub, None
        if _bridge is not None:
            logging.getLogger().removeHandler(_bridge)
            _bridge = None
    if hub is not None:
        hub.close()


# ---------------------------------------------------------------------------
# rate-limit gates for hot-path logs
# ---------------------------------------------------------------------------

class every_n:
    """Callable gate: True on the 1st, (n+1)th, (2n+1)th ... call.

        _gate = every_n(100)
        ...
        if _gate():
            log.info("step", iteration=i)
    """

    def __init__(self, n: int):
        self.n = max(1, int(n))
        self._count = -1
        self._lock = threading.Lock()

    def __call__(self) -> bool:
        with self._lock:
            self._count += 1
            return self._count % self.n == 0


class at_most_every:
    """Callable gate: True at most once per ``seconds``, measured on
    ``clock`` (injectable — tests pass a manual clock, no sleeps)."""

    def __init__(self, seconds: float,
                 clock: Callable[[], float] = time.monotonic):
        self.seconds = float(seconds)
        self.clock = clock
        self._last: Optional[float] = None
        self._lock = threading.Lock()

    def __call__(self) -> bool:
        now = self.clock()
        with self._lock:
            if self._last is not None and now - self._last < self.seconds:
                return False
            self._last = now
            return True
