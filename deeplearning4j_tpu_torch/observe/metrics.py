"""Dependency-free metrics core: counters, gauges, histograms → Prometheus.

A copy of the JAX package's jax-free ``observe/metrics.py``: a thread-safe
registry of labeled instruments with text exposition in the Prometheus
0.0.4 format at ``/metrics``. The port's UI server, batching dispatcher,
model registry and cost ledger report through it. Deliberately stdlib-only and
duck-typed: lower layers just call ``registry.counter(...)`` on whatever
object they are handed.

Conventions follow the Prometheus client library:
- a metric name + label-name set is registered once; lookups with the same
  name return the SAME instrument (get-or-create), mismatched label names
  raise;
- histograms are cumulative (every bucket counts all observations ≤ its
  upper bound, ``+Inf`` always present) with ``_sum`` and ``_count`` series;
- histogram observations made under an active span carry an OpenMetrics
  **exemplar** — the bucket line grows a ``# {trace_id="..."} value ts``
  suffix linking the latest observation that landed in that bucket to its
  trace (the open span of ``observe/trace.py``). Exemplar labels are
  escaped exactly like series labels, and ``parse_prometheus_text``
  captures exemplars on its ``.exemplars`` side table.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

# latency-oriented default buckets (seconds), matching the Prometheus client
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _escape_label_value(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(names: Sequence[str], values: Tuple[str, ...],
               extra: Sequence[Tuple[str, str]] = ()) -> str:
    pairs = list(zip(names, values)) + list(extra)
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in pairs)
    return "{" + inner + "}"


class Exemplar:
    """One OpenMetrics exemplar: a label set (``trace_id`` by convention),
    the observed value that set it, and an optional unix timestamp."""

    __slots__ = ("labels", "value", "ts")

    def __init__(self, labels: Dict[str, str], value: float,
                 ts: Optional[float] = None):
        self.labels = {str(k): str(v) for k, v in dict(labels).items()}
        self.value = float(value)
        self.ts = None if ts is None else float(ts)

    def __eq__(self, other):
        return (isinstance(other, Exemplar)
                and self.labels == other.labels
                and self.value == other.value and self.ts == other.ts)

    def __repr__(self):
        return f"Exemplar({self.labels!r}, {self.value!r}, {self.ts!r})"


def format_exemplar(ex: Exemplar) -> str:
    """THE exemplar suffix grammar: ``# {k="v",...} value [timestamp]``,
    label values escaped exactly like series labels."""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in ex.labels.items())
    s = f"# {{{inner}}} {_format_value(ex.value)}"
    if ex.ts is not None:
        s += f" {_format_value(ex.ts)}"
    return s


# lazily bound: metrics must stay importable without pulling trace first
_trace_ctx = None


def _current_trace_id() -> Optional[str]:
    """The trace id of the span open on this execution context, or None."""
    global _trace_ctx
    if _trace_ctx is None:
        from deeplearning4j_tpu_torch.observe import trace as _t
        _trace_ctx = _t._current_ctx
    cur = _trace_ctx.get()
    return None if cur is None else cur[0]


class _Metric:
    """Base: a named instrument with a fixed label-name schema."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[n]) for n in self.label_names)

    def expose(self) -> List[str]:  # pragma: no cover - overridden
        raise NotImplementedError

    def _header(self) -> List[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        return lines


class Counter(_Metric):
    """Monotonically increasing count, per label combination."""

    kind = "counter"

    def __init__(self, name, help="", label_names=()):
        super().__init__(name, help, label_names)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def total(self) -> float:
        """Sum over every label combination (reconciliation checks)."""
        with self._lock:
            return sum(self._values.values())

    def expose(self) -> List[str]:
        lines = self._header()
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            lines.append(f"{self.name}{_label_str(self.label_names, key)}"
                         f" {_format_value(v)}")
        return lines


class Gauge(_Metric):
    """A value that can go up and down (queue depth, live version, ...)."""

    kind = "gauge"

    def __init__(self, name, help="", label_names=()):
        super().__init__(name, help, label_names)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def expose(self) -> List[str]:
        lines = self._header()
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            lines.append(f"{self.name}{_label_str(self.label_names, key)}"
                         f" {_format_value(v)}")
        return lines


class Histogram(_Metric):
    """Cumulative-bucket histogram (request latency, batch sizes)."""

    kind = "histogram"

    def __init__(self, name, help="", label_names=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, label_names)
        bs = sorted(float(b) for b in buckets)
        if not bs or bs[-1] != math.inf:
            bs.append(math.inf)
        self.buckets = tuple(bs)
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        # (series key, bucket index) -> latest Exemplar landing there
        self._exemplars: Dict[Tuple[Tuple[str, ...], int], Exemplar] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        value = float(value)
        # an observation made inside an active span links the bucket to
        # its trace — the p99 bucket names a trace you can actually open
        trace_id = _current_trace_id()
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
                    if trace_id is not None:
                        self._exemplars[(key, i)] = Exemplar(
                            {"trace_id": trace_id}, value, time.time())
                    break
            self._sums[key] = self._sums.get(key, 0.0) + value

    def exemplars(self, **labels) -> Dict[float, Exemplar]:
        """One series' exemplars keyed by bucket upper bound."""
        key = self._key(labels)
        with self._lock:
            return {self.buckets[i]: ex
                    for (k, i), ex in self._exemplars.items() if k == key}

    def count(self, **labels) -> int:
        key = self._key(labels)
        with self._lock:
            return sum(self._counts.get(key, ()))

    def total_count(self) -> int:
        with self._lock:
            return sum(sum(c) for c in self._counts.values())

    def sum(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._sums.get(key, 0.0)

    def expose(self) -> List[str]:
        lines = self._header()
        with self._lock:
            items = sorted((k, list(c), self._sums.get(k, 0.0))
                           for k, c in self._counts.items())
            exemplars = dict(self._exemplars)
        for key, counts, total in items:
            cum = 0
            for i, (ub, c) in enumerate(zip(self.buckets, counts)):
                cum += c
                le = _label_str(self.label_names, key,
                                extra=[("le", _format_value(ub))])
                line = f"{self.name}_bucket{le} {cum}"
                ex = exemplars.get((key, i))
                if ex is not None:
                    line += " " + format_exemplar(ex)
                lines.append(line)
            lbl = _label_str(self.label_names, key)
            lines.append(f"{self.name}_sum{lbl} {_format_value(total)}")
            lines.append(f"{self.name}_count{lbl} {cum}")
        return lines


class MetricsRegistry:
    """Get-or-create instrument factory + exposition."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, label_names, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or \
                        m.label_names != tuple(label_names):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}{m.label_names}")
                return m
            m = cls(name, help, label_names, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                label_names: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, label_names)

    def gauge(self, name: str, help: str = "",
              label_names: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, label_names)

    def histogram(self, name: str, help: str = "",
                  label_names: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, label_names,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def exposition(self) -> str:
        """Prometheus text format 0.0.4 (the ``/metrics`` payload)."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


_default_registry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """Process-wide shared registry."""
    return _default_registry


def instrument_http(registry: MetricsRegistry,
                    server: str) -> Callable[[str, int, float], None]:
    """Uniform HTTP instrumentation every front-end shares: returns
    ``observe(path, status, seconds)`` recording into
    ``http_requests_total{server,path,status}`` and
    ``http_request_latency_seconds{server,path}``."""
    requests = registry.counter(
        "http_requests_total", "HTTP requests by server, path and status",
        ("server", "path", "status"))
    latency = registry.histogram(
        "http_request_latency_seconds", "HTTP request latency",
        ("server", "path"))

    def observe(path: str, status: int, seconds: float) -> None:
        requests.inc(server=server, path=path, status=str(status))
        latency.observe(seconds, server=server, path=path)

    return observe


def respond(handler, code: int, body: bytes, content_type: str,
            headers: Sequence[Tuple[str, str]] = ()) -> None:
    """The one HTTP response shape every front-end shares (ModelServer,
    the fleet metrics server): status + Content-Type/Length + extra
    headers + any trace-correlation headers the handler staged on
    ``_trace_headers`` — so keep-alive clients always get an exact
    Content-Length and traced requests always echo their ids."""
    handler.send_response(code)
    handler.send_header("Content-Type", content_type)
    handler.send_header("Content-Length", str(len(body)))
    for k, v in headers:
        handler.send_header(k, v)
    for k, v in getattr(handler, "_trace_headers", ()):
        handler.send_header(k, v)
    handler.end_headers()
    handler.wfile.write(body)


def respond_json(handler, obj, code: int = 200,
                 headers: Sequence[Tuple[str, str]] = ()) -> None:
    import json
    respond(handler, code, json.dumps(obj).encode(), "application/json",
            headers)


class HTTPObserverMixin:
    """Handler mixin recording request count + latency through an
    ``instrument_http`` observer. Mix in BEFORE ``BaseHTTPRequestHandler``:

        class Handler(HTTPObserverMixin, BaseHTTPRequestHandler):
            observe = my_observe            # or None → zero overhead
            route_label = staticmethod(fn)  # optional path → label mapping
                                            # (keep label cardinality bounded)
    """

    observe = None  # (path, status, seconds) -> None, or None to disable

    @staticmethod
    def route_label(path: str) -> str:
        return path

    def send_response(self, code, message=None):
        self._status = code
        super().send_response(code, message)

    def handle_one_request(self):
        # class-level access: a plain function assigned as `observe = fn`
        # must NOT be bound as a method (fn takes no self)
        observe = type(self).observe
        if observe is None:
            return super().handle_one_request()
        import time
        from urllib.parse import urlparse
        t0 = time.perf_counter()
        self._status = None
        super().handle_one_request()
        if self._status is not None:  # a request was actually answered;
            # self.path may be unset when parse_request rejected the line
            path = urlparse(getattr(self, "path", "") or "").path
            observe(self.route_label(path), self._status,
                    time.perf_counter() - t0)


class ParsedExposition(dict):
    """``parse_prometheus_text``'s result: the plain
    ``{series: {sorted label pairs: value}}`` mapping every existing
    consumer indexes, plus an ``exemplars`` side table keyed by
    ``(series, sorted label pairs)`` so federation and the tail sampler
    can round-trip exemplars without a second parse."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.exemplars: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                             Exemplar] = {}


def _scan_labels(s: str, i: int) -> Tuple[Dict[str, str], int]:
    """Quote-aware label-block scanner: ``s[i]`` is ``{``; returns the
    label dict and the index just past the closing ``}``. Left-to-right
    with escape handling, so a ``}`` (or ``#``) INSIDE a label value can
    never truncate the block — the property the exemplar suffix (which
    contains its own ``}``) depends on."""
    labels: Dict[str, str] = {}
    i += 1
    while True:
        while s[i] in ", ":
            i += 1
        if s[i] == "}":
            return labels, i + 1
        eq = s.index("=", i)
        key = s[i:eq].strip()
        assert s[eq + 1] == '"'
        j = eq + 2
        buf = []
        while s[j] != '"':
            if s[j] == "\\":
                nxt = s[j + 1]
                buf.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                j += 2
            else:
                buf.append(s[j])
                j += 1
        labels[key] = "".join(buf)
        i = j + 1


def _parse_scalar(token: str) -> float:
    if token == "+Inf":
        return math.inf
    if token == "-Inf":
        return -math.inf
    return float(token)


def parse_prometheus_text(text: str) -> ParsedExposition:
    """Parse an exposition back into ``{series: {sorted label pairs: value}}``
    — the reconciliation half of the round trip used by the tests, the
    alert engine, fleet federation and the client's ``metrics()`` scrape.
    Handles escaped label values; exemplar suffixes
    (``# {trace_id="..."} v ts``) land on the result's ``.exemplars``."""
    out = ParsedExposition()
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        brace = line.find("{")
        space = line.find(" ")
        if brace != -1 and (space == -1 or brace < space):
            name = line[:brace]
            labels, i = _scan_labels(line, brace)
            rest = line[i:].strip()
        else:
            name, rest = line.split(None, 1)
            labels = {}
        exemplar = None
        hash_pos = rest.find("#")
        if hash_pos != -1:
            value_tok = rest[:hash_pos].strip()
            ex_part = rest[hash_pos + 1:].strip()
            if ex_part.startswith("{"):
                ex_labels, k = _scan_labels(ex_part, 0)
                tail = ex_part[k:].split()
                if tail:
                    exemplar = Exemplar(
                        ex_labels, _parse_scalar(tail[0]),
                        _parse_scalar(tail[1]) if len(tail) > 1 else None)
        else:
            value_tok = rest
        key = tuple(sorted(labels.items()))
        out.setdefault(name, {})[key] = _parse_scalar(value_tok)
        if exemplar is not None:
            out.exemplars[(name, key)] = exemplar
    return out


def exemplar_trace_ids(source) -> set:
    """Every ``trace_id`` referenced by an exemplar in ``source`` (a
    registry — anything with ``exposition()`` — or raw exposition text).
    Reads through the ``parse_prometheus_text`` contract, so it works on
    local and federated registries alike; the ``TailSampler``'s
    exemplar-referenced keep set."""
    text = source.exposition() if hasattr(source, "exposition") \
        else str(source)
    parsed = parse_prometheus_text(text)
    return {ex.labels["trace_id"] for ex in parsed.exemplars.values()
            if "trace_id" in ex.labels}
