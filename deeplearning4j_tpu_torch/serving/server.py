"""HTTP front-end: the network surface of the model-serving subsystem.

stdlib ``http.server`` (the same Play→stdlib translation as the KNN and UI
servers), one OS thread per connection, composing registry + admission +
metrics into the production request path:

==============================================  ==================================
endpoint                                        behavior
==============================================  ==================================
``POST /v1/models/<name>[:<version>]/predict``  JSON ``{"inputs": [...]}`` or the
                                                ``streaming/codec.py`` binary array
                                                frame (``application/octet-stream``);
                                                response mirrors the request type
``GET /v1/models``                              registry listing (versions, health,
                                                per-version canary traffic weights
                                                and shadow-experiment counters when
                                                a canary is in flight)
``GET /v1/models/<name>``                       one model's description
``GET /healthz``                                process liveness (always 200)
``GET /readyz``                                 readiness — 503 while draining, mid
                                                hot-swap, empty, dispatcher-dead, or
                                                bucket warmup incomplete (body lists
                                                the cold buckets per model)
``GET /livez``                                  condensed ``HealthReport`` status
                                                (``?verbose=1`` → full check list);
                                                503 only when a critical probe
                                                fails (dead dispatcher)
``GET /alerts``                                 the attached ``AlertManager``'s
                                                rule states + firing set
``GET /slo``                                    the attached ``SLOSet``'s
                                                compliance + burn rates + rule
                                                states (``observe/slo.py``)
``GET /metrics``                                Prometheus text exposition
``GET /debug/capture?seconds=N``                on-demand mini bundle: last-N-
                                                seconds spans as a Chrome trace
                                                + metrics snapshot + cost-ledger
                                                slice (``observe.incident
                                                .capture_bundle`` bounds)
==============================================  ==================================

Request cost: every dispatcher-served predict response carries
``X-Device-Ms`` — the request's row-weighted share of its batches'
device time (compile time excluded), billed from the shared
``observe.cost.CostLedger`` that ``/v1/models`` also surfaces.

Status mapping (the contract the tests reconcile against the metrics):
200 served · 400 malformed · 404 unknown model/version · 429 + ``Retry-After``
admission overflow/brownout shed · 500 model error · 503 + ``Retry-After``
draining/dispatcher-dead/quarantined · 504 deadline exceeded (expired
requests are never dispatched to the device).

Per-request deadlines ride the ``X-Deadline-Ms`` header (or ``deadline_ms``
in a JSON body) and propagate into the batching dispatcher.

Serving resilience (round 13): every dispatcher-crash 503 carries
``Retry-After`` (the supervised restart's remaining backoff when one is
pending); a breaker failover or brownout reroute answers 200 with an
``X-Degraded: breaker|brownout`` header and the version that actually
served. Request priorities ride ``X-Priority`` (0 batch, 1 standard,
2 interactive); while the attached :class:`BrownoutController` is engaged,
low-priority requests shed with 429 + ``Retry-After`` and un-pinned
predicts degrade to the registry's fallback chain. The serving chaos
faults (``util/faultinject.py``: ``reject_admission`` / ``drop_response``)
hook the front door here, keyed on a per-model request sequence.

Canary routing: un-pinned predict requests honor the registry's live
traffic split (``ModelRegistry.set_traffic_split`` — the ``pipeline/``
subsystem's canary data plane); the ``version`` field / ``X-Model-Version``
header in the response reports which version actually served, so a client
can tell it was canaried.  Shadow mode duplicates sampled live requests to
the candidate off the response path — the HTTP handler never waits on it.

Distributed tracing: a W3C ``traceparent`` request header joins the
caller's trace — the predict path runs inside an ``http_request`` span
parented to it (handler threads nest the dispatcher's ``queue_wait`` /
``batch_execute`` spans under the same trace via the request context), and
every predict response echoes ``X-Trace-Id`` (plus a ``traceparent`` of the
server's own span while tracing is active) so callers can correlate.

The port's copy of the JAX package's ``serving/server.py``: the same
routes, status codes, headers, metric names and labels, and the same
bytes for the same answer. Handler threads see only numpy: the registry
answers on the host, a bf16 version's answer as f32 marked for the
codec's 2-byte bf16 frame (``parallel/inference.py`` ``host_answer``).
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from deeplearning4j_tpu_torch.observe import trace as _trace
from deeplearning4j_tpu_torch.observe.metrics import (MetricsRegistry,
                                                default_registry)
from deeplearning4j_tpu_torch.observe.metrics import respond as _respond_http
from deeplearning4j_tpu_torch.observe.metrics import respond_json as _respond_json
from deeplearning4j_tpu_torch.parallel.inference import (DispatcherCrashed,
                                                   InferenceDeadlineExceeded)
from deeplearning4j_tpu_torch.serving.admission import (AdmissionController,
                                                  AdmissionRejected, Draining)
from deeplearning4j_tpu_torch.serving.brownout import BrownoutController
from deeplearning4j_tpu_torch.serving.registry import (ModelNotFound,
                                                 ModelRegistry,
                                                 VersionQuarantined)
from deeplearning4j_tpu_torch.streaming.codec import (deserialize_array,
                                                serialize_array)
from deeplearning4j_tpu_torch.util import faultinject as _faultinject

BINARY_CONTENT_TYPE = "application/octet-stream"


class _DroppedResponder:
    """Stand-in handler for a ``drop_response`` chaos fault: the request
    is processed for real (admission, dispatch, metrics) but every write
    is swallowed — then the server severs the connection, exactly like a
    network that ate the answer after the work was done."""

    __slots__ = ("headers",)

    def __init__(self, handler):
        self.headers = handler.headers

    def _json(self, *a, **k) -> None:
        pass

    def _respond(self, *a, **k) -> None:
        pass


class ModelServer:
    """Production inference front-end over a ``ModelRegistry``."""

    def __init__(self, registry: ModelRegistry, *,
                 host: str = "127.0.0.1", port: int = 0,
                 metrics: Optional[MetricsRegistry] = None,
                 max_inflight: int = 64, retry_after_s: float = 0.05,
                 default_deadline_s: Optional[float] = None,
                 alerts=None, brownout=None, slo=None, cost=None):
        self.registry = registry
        self.host = host
        self.port = port
        self.metrics = metrics if metrics is not None else default_registry()
        self.default_deadline_s = default_deadline_s
        self.admission = AdmissionController(
            max_inflight, retry_after_s=retry_after_s, metrics=self.metrics)
        self.alerts = alerts  # an observe.alerts.AlertManager, or None
        self.slo = slo        # an observe.slo.SLOSet, or None
        # the cost ledger is always on (the X-Device-Ms / /v1/models
        # contract): use the one given, else the registry's, else a fresh
        # one — and make sure the registry's dispatchers feed it
        if cost is None:
            cost = getattr(registry, "cost", None)
        if cost is None:
            from deeplearning4j_tpu_torch.observe.cost import CostLedger
            cost = CostLedger(self.metrics)
        self.cost = cost
        if getattr(registry, "cost", None) is not cost:
            registry.set_cost_ledger(cost)
        # brownout degradation: a ready BrownoutController, or a dict of
        # its kwargs (admission/alerts/metrics wired in here), or None
        if isinstance(brownout, dict):
            brownout = BrownoutController(
                admission=self.admission, alerts=alerts,
                metrics=self.metrics, **brownout)
        self.brownout: Optional[BrownoutController] = brownout
        from deeplearning4j_tpu_torch.observe.health import ServingHealth
        self.health = ServingHealth(registry=registry,
                                    admission=self.admission,
                                    brownout=self.brownout)
        # per-model HTTP request sequence — the serving chaos faults
        # (reject_admission / drop_response) key on it
        self._req_seq: dict = {}
        self._req_seq_lock = threading.Lock()
        self._m_requests = self.metrics.counter(
            "serving_requests_total",
            "Predict requests by model and HTTP status", ("model", "status"))
        self._m_latency = self.metrics.histogram(
            "serving_request_latency_seconds",
            "Predict latency (admission to response)", ("model",))
        self._m_dropped = self.metrics.counter(
            "serving_dropped_responses_total",
            "Responses computed but never delivered (connection severed "
            "— the drop_response chaos fault)", ("model",))
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> int:
        """Bind (port 0 → ephemeral) and serve on a background thread;
        returns the bound port."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # silence
                pass

            # keep-alive connections outlive the listener: track them so
            # stop() can sever idle ones (their handler threads sit in
            # readline() and would otherwise keep serving after shutdown)
            def setup(self):
                super().setup()
                with server._conns_lock:
                    server._conns.add(self.connection)

            def finish(self):
                with server._conns_lock:
                    server._conns.discard(self.connection)
                super().finish()

            # -------------------------------------------------- responders
            # the shared plumbing (observe.metrics.respond): status +
            # exact Content-Length + extra headers + the staged trace
            # correlation headers, whichever branch answered
            def _respond(self, code: int, body: bytes, content_type: str,
                         headers: Tuple[Tuple[str, str], ...] = ()) -> None:
                _respond_http(self, code, body, content_type, headers)

            def _json(self, obj, code: int = 200,
                      headers: Tuple[Tuple[str, str], ...] = ()) -> None:
                _respond_json(self, obj, code, headers)

            # ------------------------------------------------------- GETs
            def do_GET(self):
                # the handler instance persists across keep-alive requests:
                # correlation headers must never leak onto the next response
                self._trace_headers = ()
                parsed = urlparse(self.path)
                path = parsed.path
                if path == "/healthz":
                    self._json({"status": "ok"})
                elif path == "/livez":
                    report = server.health.report()
                    verbose = parse_qs(parsed.query).get("verbose",
                                                         ["0"])[0]
                    body = (report.to_dict()
                            if verbose not in ("0", "", "false")
                            else {"status": report.status})
                    # liveness only fails on a CRITICAL probe (a dead
                    # dispatcher never recovers in-process); degraded
                    # states report 200 with the status in the body
                    self._json(body, 200 if report.healthy else 503)
                elif path == "/alerts":
                    if server.alerts is None:
                        self._json({"error": "no alert manager attached"},
                                   404)
                    else:
                        self._json(server.alerts.describe())
                elif path == "/slo":
                    if server.slo is None:
                        self._json({"error": "no slo config attached"}, 404)
                    else:
                        self._json(server.slo.status(
                            metrics=server.metrics, alerts=server.alerts))
                elif path == "/readyz":
                    ready, body = server.readiness_detail()
                    self._json(body, 200 if ready else 503)
                elif path == "/metrics":
                    self._respond(200, server.metrics.exposition().encode(),
                                  "text/plain; version=0.0.4")
                elif path == "/debug/capture":
                    try:
                        seconds = float(parse_qs(parsed.query).get(
                            "seconds", ["60"])[0])
                    except (TypeError, ValueError):
                        self._json({"error": "seconds must be a number"},
                                   400)
                        return
                    from deeplearning4j_tpu_torch.observe.incident import \
                        capture_bundle
                    tracer = _trace.get_active_tracer()
                    sampler = (tracer.recorder if tracer is not None
                               and hasattr(tracer.recorder, "describe")
                               else None)
                    self._json(capture_bundle(
                        seconds=seconds, tracer=tracer,
                        metrics=server.metrics, cost=server.cost,
                        sampler=sampler))
                elif path == "/v1/models":
                    self._json({"models": server.registry.list_models(),
                                "cost": server.cost.describe()})
                elif path.startswith("/v1/models/"):
                    name = path[len("/v1/models/"):]
                    try:
                        self._json(server.registry.get(name).describe())
                    except ModelNotFound as e:
                        self._json({"error": str(e)}, 404)
                else:
                    self._json({"error": "not found"}, 404)

            # ------------------------------------------------------ predict
            def do_POST(self):
                self._trace_headers = ()  # no stale keep-alive correlation
                # drain the body FIRST, on every path: with HTTP/1.1
                # keep-alive, an unread body on a reject (404/429/503)
                # would desync the connection for the client's next request
                n = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(n)
                path = urlparse(self.path).path
                if not (path.startswith("/v1/models/")
                        and path.endswith("/predict")):
                    self._json({"error": "not found"}, 404)
                    return
                ref = path[len("/v1/models/"):-len("/predict")]
                name, version = server._parse_model_ref(ref)
                server._predict(self, name, version, raw)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self, *, drain: bool = True, drain_timeout_s: float = 5.0,
             shutdown_registry: bool = False) -> None:
        """Graceful shutdown: stop admitting, let in-flight requests finish,
        then close the listener (and optionally the dispatchers)."""
        if drain:
            self.admission.begin_drain()
            self.admission.wait_idle(drain_timeout_s)
        if self.alerts is not None:
            self.alerts.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        # sever surviving keep-alive connections: a persistent client would
        # otherwise keep getting answers from handler threads parked on
        # open sockets after the listener is gone
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if shutdown_registry:
            self.registry.shutdown()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ------------------------------------------------------------ internals
    def readiness(self) -> Tuple[bool, str]:
        if self.admission.draining:
            return False, "draining"
        if not self.registry.names():
            return False, "no models registered"
        if self.registry.swapping:
            return False, "hot-swap in progress"
        if not self.registry.healthy():
            return False, "inference dispatcher down"
        if not self.registry.warmed():
            return False, "warmup incomplete"
        return True, "ok"

    def readiness_detail(self) -> Tuple[bool, dict]:
        """``readiness()`` plus the machine-readable why: while bucket
        warmup is still running, the 503 body lists exactly which batch
        buckets would compile if a request hit them now."""
        ready, why = self.readiness()
        body: dict = {"ready": ready, "reason": why}
        if why == "warmup incomplete":
            body["cold_buckets"] = self.registry.cold_buckets()
            errors = self.registry.warmup_errors()
            if errors:  # failed (vs still-running) warmups, and why
                body["warmup_errors"] = errors
        return ready, body

    @staticmethod
    def _parse_model_ref(ref: str) -> Tuple[str, Optional[int]]:
        """``name`` or ``name:version`` (non-numeric suffix = part of the
        name, so names with colons still resolve)."""
        if ":" in ref:
            name, _, tail = ref.rpartition(":")
            try:
                return name, int(tail)
            except ValueError:
                pass
        return ref, None

    def _predict(self, handler, name: str, version: Optional[int],
                 raw: bytes) -> None:
        # join the caller's trace when a traceparent header arrives; echo
        # the trace id either way so the client can correlate
        parent = _trace.parse_traceparent(handler.headers.get("traceparent"))
        tracer = _trace.get_active_tracer()
        if tracer is None:
            if parent is not None:
                handler._trace_headers = (("X-Trace-Id", parent.trace_id),)
            self._predict_timed(handler, name, version, raw)
            return
        with tracer.span("http_request", parent=parent, category="serve",
                         attrs={"model": name}) as sp:
            handler._trace_headers = (
                ("traceparent", sp.context.traceparent()),
                ("X-Trace-Id", sp.trace_id))
            sp.set_attribute(
                "status", self._predict_timed(handler, name, version, raw))

    def _next_seq(self, name: str) -> int:
        """Per-model request sequence (chaos-fault keying). Unknown
        names return -1 and are never counted: the dict's cardinality
        is bounded by the registry's own names — a URL probe must not
        grow server state, the same rule the metric labels follow."""
        if not self.registry.has(name):
            return -1
        with self._req_seq_lock:
            seq = self._req_seq.get(name, 0)
            self._req_seq[name] = seq + 1
            return seq

    @staticmethod
    def _priority(handler) -> int:
        """``X-Priority``: 0 batch, 1 standard (default), 2 interactive —
        garbage parses as standard, never as an error."""
        try:
            return int(handler.headers.get("X-Priority", "1"))
        except (TypeError, ValueError):
            return 1

    @staticmethod
    def _sever(handler) -> None:
        """Close the connection without a response (drop_response)."""
        try:
            handler.connection.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            handler.connection.close()
        except OSError:
            pass
        handler.close_connection = True

    def _retry_headers(self,
                       retry_after_s: Optional[float] = None
                       ) -> Tuple[Tuple[str, str], ...]:
        retry = (retry_after_s if retry_after_s is not None
                 else self.admission.retry_after_s)
        return (("Retry-After", f"{max(retry, 0.001):.3f}"),)

    def _predict_timed(self, handler, name: str, version: Optional[int],
                       raw: bytes) -> int:
        t0 = time.perf_counter()
        status = 500
        dropped = False
        try:
            # serving chaos seam, keyed on (model, request seq). A
            # drop_response fault does all the work below for real but
            # swallows the writes — the connection is severed on the way
            # out, like a network that ate the answer
            seq = self._next_seq(name)
            out = handler
            if seq >= 0 and not _faultinject.on_response(name, seq):
                dropped = True
                out = _DroppedResponder(handler)
            if seq >= 0 and not _faultinject.on_admission(name, seq):
                status = 429
                out._json({"error": "injected admission rejection "
                                    "(chaos fault)"}, 429,
                          headers=self._retry_headers())
                return status
            degrade_to = None
            if self.brownout is not None and self.brownout.observe():
                prio = self._priority(handler)
                if self.brownout.should_shed(prio):
                    status = 429
                    self.admission.record_rejection("brownout")
                    out._json(
                        {"error": f"brownout: shedding priority {prio} "
                                  f"traffic"}, 429,
                        headers=self._retry_headers(
                            self.brownout.retry_after_s))
                    return status
                if self.brownout.degrade and version is None:
                    try:
                        degrade_to = self.registry.resolve_fallback(name)
                    except ModelNotFound:
                        degrade_to = None  # 404s downstream as before
            try:
                slot = self.admission.admit()
            except AdmissionRejected as e:
                status = 429
                out._json(
                    {"error": str(e)}, 429,
                    headers=self._retry_headers(e.retry_after_s))
                return status
            except Draining:
                status = 503
                out._json({"error": "server is draining"}, 503)
                return status
            with slot:
                status = self._predict_admitted(out, name, version, raw,
                                                degrade_to)
            return status
        finally:
            if dropped:
                self._sever(handler)
                self._m_dropped.inc(
                    model=name if self.registry.has(name) else "_unknown")
            # unknown names collapse to one sentinel label — URL probes must
            # not grow the metric registry without bound (same bounded-
            # cardinality rule as the UI server's route labels)
            label = name if self.registry.has(name) else "_unknown"
            self._m_requests.inc(model=label, status=str(status))
            self._m_latency.observe(time.perf_counter() - t0, model=label)

    def _predict_admitted(self, handler, name: str, version: Optional[int],
                          raw: bytes,
                          degrade_to: Optional[int] = None) -> int:
        binary = False
        try:
            content_type = (handler.headers.get("Content-Type") or "").split(
                ";")[0].strip().lower()
            deadline_s = self.default_deadline_s
            hdr = handler.headers.get("X-Deadline-Ms")
            if hdr is not None:
                deadline_s = float(hdr) / 1e3
            if content_type == BINARY_CONTENT_TYPE:
                binary = True
                x = deserialize_array(raw)
            else:
                body = json.loads(raw.decode() or "{}")
                if "inputs" not in body:
                    handler._json({"error": "body needs 'inputs'"}, 400)
                    return 400
                x = np.asarray(body["inputs"], dtype=np.float32)
                if "deadline_ms" in body:
                    deadline_s = float(body["deadline_ms"]) / 1e3
            if x.ndim == 0:
                handler._json({"error": "inputs must be at least 1-d"}, 400)
                return 400
            # brownout: an un-pinned predict degrades to the registry's
            # fallback chain while the brownout holds (the quantized /
            # previous version the operator designated)
            degraded = None
            if degrade_to is not None and version is None:
                served = self.registry.get(name)
                if degrade_to != served.current_version:
                    version = degrade_to
                    degraded = "brownout"
                    self.registry.note_degraded(name, "brownout")
            # version attributed from the model that ACTUALLY served the
            # batch — a hot-swap landing mid-request must not mislabel
            out, v = self.registry.predict_versioned(
                name, x, version=version, deadline_s=deadline_s)
            if degraded is None and version is None:
                # the registry served a breaker failover? the response
                # says so, so a client can tell it was degraded
                state = self.registry.breaker_state(name)
                if state is not None and state != "closed" \
                        and v != self.registry.get(name).current_version:
                    degraded = "breaker"
            extra = (("X-Degraded", degraded),) if degraded else ()
            # bill the request's device-time share HERE, where the
            # priority header is known; dispatcher-served requests get
            # the X-Device-Ms header, synchronous paths (pinned version,
            # canary, degraded) have no ledger entry and no header
            if self.cost is not None:
                trace_id, _ = _trace.current_span_ids()
                device_ms = self.cost.bill(
                    trace_id, model=name,
                    priority=str(self._priority(handler)))
                if device_ms is not None:
                    extra += (("X-Device-Ms", f"{device_ms:.6f}"),)
            if binary:
                handler._respond(200, serialize_array(out),
                                 BINARY_CONTENT_TYPE,
                                 headers=(("X-Model-Version", str(v)),)
                                 + extra)
            else:
                handler._json({"model": name, "version": v,
                               "outputs": np.asarray(out).tolist()},
                              headers=extra)
            return 200
        except ModelNotFound as e:
            handler._json({"error": str(e)}, 404)
            return 404
        except InferenceDeadlineExceeded as e:
            handler._json({"error": str(e)}, 504)
            return 504
        except VersionQuarantined as e:
            # breaker open, nothing to fail over to: back off and retry —
            # the hint is the remaining quarantine cooldown
            handler._json({"error": str(e)}, 503,
                          headers=self._retry_headers(e.retry_after_s))
            return 503
        except DispatcherCrashed as e:
            # transient under supervision (Retry-After = the restart
            # backoff remaining), terminal without — either way a
            # backoff-aware client now gets a concrete hint instead of
            # hammering a dead dispatcher
            handler._json({"error": str(e)}, 503,
                          headers=self._retry_headers(
                              getattr(e, "retry_after_s", None)))
            return 503
        except (ValueError, KeyError, json.JSONDecodeError,
                UnicodeDecodeError, struct.error) as e:
            # struct.error: a truncated binary frame is client garbage, not
            # a model fault — it must land in the 400 bucket
            handler._json({"error": str(e)}, 400)
            return 400
        except Exception as e:  # model raised — contained per request
            handler._json({"error": f"{type(e).__name__}: {e}"}, 500)
            return 500
