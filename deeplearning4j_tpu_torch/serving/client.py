"""Serving client — typed access to the ModelServer HTTP surface.

JSON or the ``streaming/codec.py`` binary frame on the predict path (binary
skips float→text→float for large tensors), plus listing, health probes and
a ``/metrics`` scrape that parses back into numbers. Raises ``ServingError``
carrying the HTTP status and the server's ``Retry-After`` hint so callers
can implement backoff.

Connections are PERSISTENT (HTTP/1.1 keep-alive), one per calling thread:
the TCP+handshake tax is paid once per thread, not once per ``predict`` —
without this, a latency benchmark of the server mostly measures the
client's connection churn. A connection the server dropped (restart,
drain) is re-established transparently, once, before the error surfaces
(counted in ``client_reconnects_total``; when the reconnect attempt also
fails, the ORIGINAL failure rides along as ``__cause__``). ``close()``
releases the sockets.

Resilient policy (round 13, opt-in via ``retry=RetryPolicy(...)``):

- **bounded retries with exponential backoff + deterministic jitter** on
  429/503 (and connection errors) — the jitter is hashed from the request
  path and attempt (the elastic supervisor's no-RNG trick), so a replay
  backs off identically; the server's ``Retry-After`` hint is honored as
  a floor on the computed delay.
- **client-side retry budget** (Google SRE: retries must never amplify an
  overload): each first-attempt request earns ``budget_ratio`` tokens,
  each retry spends one — when the bucket is dry, errors surface
  immediately instead of joining the stampede.
- **hedged requests** (*The Tail at Scale*): with ``hedge_after_s`` set,
  an idempotent predict that has not answered within the hedge window
  fires ONE duplicate and the first response wins. Both run to completion
  server-side (HTTP has no cancel), so hedge only against replicated or
  cheap backends; ``client_hedges_total`` / ``client_hedge_wins_total``
  keep the policy honest.

All of it is observable: pass ``metrics=`` (an ``observe.metrics``
registry) for ``client_retries_total{reason}``, ``client_reconnects_total``
and the hedge counters; ``sleep=`` is injectable so tests drive the
backoff without wall-clock waits.

Tracing: ``predict`` runs inside a ``client_predict`` span when a tracer is
active and ALWAYS ships a W3C ``traceparent`` header for it (creating a
fresh trace when no span is open), so the server's ``http_request`` span —
and everything under it — lands in the same timeline. The trace id the
server echoes back is kept on ``client.last_trace_id`` for correlation.

The port's copy of the JAX package's ``serving/client.py``: the same
requests and headers; a ``"bfloat16"`` answer frame decodes to f32
values (``streaming/codec.py``).
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import queue as _queue
import threading
import time
import weakref
from typing import Optional, Tuple
from urllib.parse import urlparse

import numpy as np

from deeplearning4j_tpu_torch.observe import trace as _trace
from deeplearning4j_tpu_torch.observe.metrics import parse_prometheus_text
from deeplearning4j_tpu_torch.serving.server import BINARY_CONTENT_TYPE
from deeplearning4j_tpu_torch.streaming.codec import (deserialize_array,
                                                serialize_array)


class ServingError(RuntimeError):
    """Non-2xx response; carries ``status``, ``message``, ``retry_after_s``
    and ``trace_id`` (the server's ``X-Trace-Id`` echo, when present)."""

    def __init__(self, status: int, message: str,
                 retry_after_s: Optional[float] = None):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message
        self.retry_after_s = retry_after_s
        self.trace_id: Optional[str] = None


@dataclasses.dataclass
class RetryPolicy:
    """Client-side resilience policy (see module docstring).

    ``statuses`` are the retryable HTTP codes — 429/503 by default: both
    mean "come back later" and both carry ``Retry-After``. 5xx codes that
    mean "the work itself failed" (500) or "the work ran too long" (504)
    are deliberately NOT retried: re-sending them amplifies load without
    changing the outcome."""

    max_retries: int = 3
    base_s: float = 0.05
    factor: float = 2.0
    max_s: float = 2.0
    jitter: float = 0.1
    statuses: Tuple[int, ...] = (429, 503)
    retry_connection_errors: bool = True
    budget_ratio: float = 0.1     # tokens earned per first-attempt request
    budget_cap: float = 10.0
    budget_initial: float = 3.0
    hedge_after_s: Optional[float] = None

    def delay(self, attempt: int, retry_after_s: Optional[float] = None,
              seed: str = "") -> float:
        """Backoff before retry ``attempt`` (1-based): the elastic
        supervisor's ladder (ONE implementation of the deterministic
        sha256 jitter — ``parallel.elastic.BackoffPolicy``), plus the
        server's ``Retry-After`` as a floor — backing off LESS than the
        server asked for would defeat the hint."""
        from deeplearning4j_tpu_torch.parallel.elastic import BackoffPolicy
        d = BackoffPolicy(base_s=self.base_s, factor=self.factor,
                          max_s=self.max_s,
                          jitter=self.jitter).delay(attempt, seed=seed)
        if retry_after_s is not None:
            d = max(d, retry_after_s)
        return d


class ModelServingClient:
    def __init__(self, url: str, timeout: float = 10.0,
                 keep_alive: bool = True,
                 retry: Optional[RetryPolicy] = None,
                 metrics=None, sleep=time.sleep):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.keep_alive = keep_alive
        self.retry = retry
        self.sleep = sleep
        parsed = urlparse(self.url)
        if parsed.scheme not in ("http", "https", ""):
            raise ValueError(f"unsupported scheme {parsed.scheme!r}")
        self._https = parsed.scheme == "https"
        self._host = parsed.hostname or "127.0.0.1"
        self._port = parsed.port or (443 if self._https else 80)
        # a path-routed base URL (http://gw/serving) prefixes every request
        self._base_path = parsed.path.rstrip("/")
        self._local = threading.local()
        # every thread's connection, for close(): thread-local storage is
        # only reachable from its own thread, so track them weakly here
        self._conns: "weakref.WeakSet[http.client.HTTPConnection]" = (
            weakref.WeakSet())
        self._conns_lock = threading.Lock()
        self.last_trace_id: Optional[str] = None  # server's X-Trace-Id echo
        # retry budget: a token bucket shared by every thread of this
        # client — the SRE rule that retries stay a bounded FRACTION of
        # organic traffic, whatever the thread count
        self._budget = retry.budget_initial if retry is not None else 0.0
        self._budget_lock = threading.Lock()
        self._m_retries = self._m_reconnects = None
        self._m_hedges = self._m_hedge_wins = None
        if metrics is not None:
            self._m_retries = metrics.counter(
                "client_retries_total",
                "Predict retries by trigger (HTTP status or 'connection')",
                ("reason",))
            self._m_reconnects = metrics.counter(
                "client_reconnects_total",
                "Keep-alive connections re-established after the server "
                "dropped them")
            self._m_hedges = metrics.counter(
                "client_hedges_total",
                "Duplicate (hedged) predicts fired after the hedge window")
            self._m_hedge_wins = metrics.counter(
                "client_hedge_wins_total",
                "Hedged predicts where the DUPLICATE answered first")

    # -------------------------------------------------------------- plumbing
    def _connection(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            cls = (http.client.HTTPSConnection if self._https
                   else http.client.HTTPConnection)
            conn = cls(self._host, self._port, timeout=self.timeout)
            self._local.conn = conn
            with self._conns_lock:
                self._conns.add(conn)
        return conn

    def _drop_connection(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            self._local.conn = None
            try:
                conn.close()
            except Exception:  # noqa: BLE001 — already broken
                pass

    def close(self) -> None:
        """Close every thread's persistent connection."""
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass
        self._local = threading.local()

    def _request(self, path: str, data: Optional[bytes] = None,
                 headers: Optional[dict] = None):
        method = "GET" if data is None else "POST"
        hdrs = dict(headers or {})
        if not self.keep_alive:
            hdrs["Connection"] = "close"
        # one transparent retry when a REUSED connection turns out to have
        # been closed server-side between requests (idle timeout, restart)
        # — never on a fresh connection and never on a timeout, so a slow
        # predict is not silently re-sent
        first_error: Optional[BaseException] = None
        for attempt in (0, 1):
            conn = self._connection()
            fresh = conn.sock is None
            try:
                conn.request(method, self._base_path + path, body=data,
                             headers=hdrs)
                resp = conn.getresponse()
                body = resp.read()
                break
            except (http.client.RemoteDisconnected, http.client.BadStatusLine,
                    ConnectionResetError, BrokenPipeError) as e:
                self._drop_connection()
                if fresh or attempt:
                    # the retry failed too: keep the ORIGINAL dead-
                    # connection failure on the chain — it names the
                    # socket the server actually dropped
                    if first_error is not None:
                        raise e from first_error
                    raise
                first_error = e
                if self._m_reconnects is not None:
                    self._m_reconnects.inc()
            except (http.client.HTTPException, OSError) as e:
                self._drop_connection()
                if first_error is not None:
                    raise e from first_error
                raise
        # Title-Case the keys: http.client preserves wire casing, and a
        # lowercasing proxy must not cost us Retry-After / X-Trace-Id
        resp_headers = {k.title(): v for k, v in resp.getheaders()}
        if not self.keep_alive or resp.will_close:
            self._drop_connection()
        echoed = resp_headers.get("X-Trace-Id")
        if echoed:
            # error responses echo X-Trace-Id too — correlation matters
            # MOST for failures, so capture it before raising
            self.last_trace_id = echoed
        if resp.status >= 400:
            try:
                message = json.loads(body.decode()).get("error", "")
            except Exception:  # noqa: BLE001 - body may not be JSON
                message = body.decode(errors="replace")
            retry = resp_headers.get("Retry-After")
            err = ServingError(
                resp.status, message,
                float(retry) if retry is not None else None)
            err.trace_id = echoed
            raise err
        return resp.status, body, resp_headers

    # -------------------------------------------------------------- predict
    def predict(self, model: str, inputs, *, version: Optional[int] = None,
                binary: bool = False,
                deadline_ms: Optional[float] = None,
                priority: Optional[int] = None) -> np.ndarray:
        """Predict; with a :class:`RetryPolicy` attached, retryable
        failures (429/503, dropped connections) back off and retry under
        the client's retry budget, and ``hedge_after_s`` arms tail-latency
        hedging. ``priority`` rides the ``X-Priority`` header (0 batch,
        1 standard, 2 interactive — brownout sheds low priorities
        first)."""
        ref = model if version is None else f"{model}:{version}"
        path = f"/v1/models/{ref}/predict"
        headers = {}
        if deadline_ms is not None:
            headers["X-Deadline-Ms"] = str(deadline_ms)
        if priority is not None:
            headers["X-Priority"] = str(int(priority))
        if self.retry is None:
            return self._predict_attempt(model, path, inputs, binary,
                                         headers)
        return self._predict_resilient(model, path, inputs, binary, headers)

    def _predict_attempt(self, model: str, path: str, inputs, binary: bool,
                         headers: dict) -> np.ndarray:
        """ONE traced request/response (each retry/hedge gets its own
        span — the timeline shows every attempt, not a blur)."""
        tracer = _trace.get_active_tracer()
        if tracer is None:
            return self._predict_send(path, inputs, binary, dict(headers))[0]
        with tracer.span("client_predict", category="serve",
                         attrs={"model": model, "url": self.url}) as sp:
            # the span's own context crosses the wire; the server parents
            # its http_request span to it
            hdrs = dict(headers)
            hdrs["traceparent"] = sp.context.traceparent()
            out, echoed = self._predict_send(path, inputs, binary, hdrs)
            if echoed:  # THIS response's echo only — a shared client may
                sp.set_attribute("server_trace_id", echoed)  # serve threads
            return out

    # ------------------------------------------------------------ resilience
    def _budget_credit(self, pol: RetryPolicy) -> None:
        with self._budget_lock:
            self._budget = min(pol.budget_cap,
                               self._budget + pol.budget_ratio)

    def _budget_spend(self) -> bool:
        with self._budget_lock:
            if self._budget >= 1.0:
                self._budget -= 1.0
                return True
            return False

    @property
    def retry_budget(self) -> float:
        """Tokens left in the retry bucket (observability/tests)."""
        with self._budget_lock:
            return self._budget

    def _predict_resilient(self, model: str, path: str, inputs,
                           binary: bool, headers: dict) -> np.ndarray:
        pol = self.retry
        self._budget_credit(pol)  # organic traffic funds the bucket
        attempt = 0
        while True:
            try:
                if pol.hedge_after_s is not None:
                    return self._predict_hedged(model, path, inputs,
                                                binary, headers, pol)
                return self._predict_attempt(model, path, inputs, binary,
                                             headers)
            except ServingError as e:
                if e.status not in pol.statuses:
                    raise
                err, reason, retry_after = e, str(e.status), e.retry_after_s
            except (http.client.HTTPException, OSError) as e:
                if not pol.retry_connection_errors:
                    raise
                err, reason, retry_after = e, "connection", None
            attempt += 1
            # the budget gates EVERY retry: when it is dry the error
            # surfaces immediately — a stampede of retrying clients is
            # how an overload becomes an outage
            if attempt > pol.max_retries or not self._budget_spend():
                raise err
            if self._m_retries is not None:
                self._m_retries.inc(reason=reason)
            self.sleep(pol.delay(attempt, retry_after, seed=path))

    def _predict_hedged(self, model: str, path: str, inputs, binary: bool,
                        headers: dict, pol: RetryPolicy) -> np.ndarray:
        """Fire the request; if no answer within ``hedge_after_s``, fire
        ONE duplicate and take whichever answers first. An error BEFORE
        the hedge window surfaces immediately (hedging fights latency,
        not failure — the retry loop owns failures). Hedged attempts run
        on short-lived threads with their own connections (closed on
        exit), so hedging trades the keep-alive win for the tail cut —
        price it accordingly."""
        results: "_queue.Queue" = _queue.Queue()

        def run(is_hedge: bool) -> None:
            try:
                results.put((is_hedge, True, self._predict_attempt(
                    model, path, inputs, binary, headers)))
            except BaseException as e:  # noqa: BLE001 — relayed, not lost
                results.put((is_hedge, False, e))
            finally:
                # each attempt thread dialed its own thread-local
                # connection; the thread dies with this call, so close
                # the socket NOW instead of leaking it until GC
                self._drop_connection()

        threading.Thread(target=run, args=(False,), daemon=True).start()
        hedged = False
        try:
            got = results.get(timeout=pol.hedge_after_s)
        except _queue.Empty:
            hedged = True
            if self._m_hedges is not None:
                self._m_hedges.inc()
            threading.Thread(target=run, args=(True,), daemon=True).start()
            got = results.get()
        is_hedge, ok, payload = got
        if ok:
            if is_hedge and self._m_hedge_wins is not None:
                self._m_hedge_wins.inc()
            return payload
        if hedged:
            # first completion failed but its twin is still running —
            # its answer may yet save the request
            is_hedge2, ok2, payload2 = results.get()
            if ok2:
                if is_hedge2 and self._m_hedge_wins is not None:
                    self._m_hedge_wins.inc()
                return payload2
        raise payload

    def _predict_send(self, path: str, inputs, binary: bool, headers: dict):
        """Returns ``(outputs, x_trace_id_or_None)`` — the echo is threaded
        back per call, never through shared client state."""
        if binary:
            headers["Content-Type"] = BINARY_CONTENT_TYPE
            _, body, resp_headers = self._request(
                path, serialize_array(np.asarray(inputs)), headers)
            return deserialize_array(body), resp_headers.get("X-Trace-Id")
        headers["Content-Type"] = "application/json"
        payload = {"inputs": np.asarray(inputs).tolist()}
        _, body, resp_headers = self._request(
            path, json.dumps(payload).encode(), headers)
        return (np.asarray(json.loads(body.decode())["outputs"]),
                resp_headers.get("X-Trace-Id"))

    # ------------------------------------------------------------ inspection
    def models(self) -> list:
        _, body, _ = self._request("/v1/models")
        return json.loads(body.decode())["models"]

    def model(self, name: str) -> dict:
        _, body, _ = self._request(f"/v1/models/{name}")
        return json.loads(body.decode())

    def healthy(self) -> bool:
        try:
            status, _, _ = self._request("/healthz")
            return status == 200
        except (ServingError, OSError):
            return False

    def ready(self) -> bool:
        try:
            status, _, _ = self._request("/readyz")
            return status == 200
        except ServingError:
            return False
        except OSError:
            return False

    # --------------------------------------------------------------- metrics
    def metrics_text(self) -> str:
        _, body, _ = self._request("/metrics")
        return body.decode()

    def metrics(self) -> dict:
        """Scrape and parse: ``{series: {sorted label pairs: value}}``."""
        return parse_prometheus_text(self.metrics_text())
