"""Request economics: device-time attribution for coalesced inference.

The dispatcher serves many requests in one ``batch_execute`` span; the
per-tenant question "what did THIS request cost in device time" needs
that span's duration split back across its requests.  THE apportionment
rule:

- each batch's **device milliseconds** are the ``batch_execute`` span's
  wall duration on the dispatcher thread MINUS any compile seconds
  (``kernel_build``: an ``nvcc`` build at a kernel's first use) observed
  on that thread during the span (``Tracer.thread_compile_seconds``
  delta) — a first request must never be billed the compile spike it
  happened to trigger. On the card the span closes only after the
  batch's answer is on the host, so its wall time covers the device work
  the batch queued;
- the remainder is divided **row-weighted** across the coalesced
  requests (a 6-row request in an 8-row batch pays 6/8ths);
- compile time is attributed separately per model
  (``request_compile_device_ms_total{model}``), never to a request;
- padding rows belong to nobody, so their time is spread across the real
  rows — the batch's full device time is always conserved:
  ``sum(per-request shares) + unattributed == sum(batch device time)``
  within float tolerance, which :meth:`CostLedger.conservation` checks
  and the bench re-proves on every CI run.

The :class:`CostLedger` keys per-request shares by **trace id** — the one
identifier that already flows client → HTTP span → ``inference_request``
→ the dispatcher's ``_Request.ctx`` — so the serving front-end can
:meth:`~CostLedger.bill` the finished request (observing
``request_device_ms{model,priority}`` with the priority only IT knows)
and echo the cost as the ``X-Device-Ms`` response header.  Requests that
arrive without a trace context (tracing disabled) still conserve: their
shares land in the per-model ``unattributed_device_ms`` bucket.

A copy of the JAX package's stdlib-only ``observe/cost.py``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

# request-level device-ms buckets: sub-ms CPU forwards through multi-second
# cold paths (the latency DEFAULT_BUCKETS are seconds-scaled; these are ms)
DEVICE_MS_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0,
                     100.0, 500.0, 1000.0, 5000.0)


class RequestCost:
    """One request's accumulated device time (a retried/failed-over
    request can appear in more than one batch; shares accumulate)."""

    __slots__ = ("trace_id", "model", "rows", "device_ms", "batches",
                 "billed")

    def __init__(self, trace_id: str, model: str):
        self.trace_id = trace_id
        self.model = model
        self.rows = 0
        self.device_ms = 0.0
        self.batches = 0
        self.billed = False

    def as_dict(self) -> dict:
        return {"trace_id": self.trace_id, "model": self.model,
                "rows": self.rows,
                "device_ms": round(self.device_ms, 6),
                "batches": self.batches, "billed": self.billed}


class CostLedger:
    """Queryable, bounded, conserving ledger of request device time.

    ``metrics`` (optional duck-typed registry) receives
    ``request_device_ms{model,priority}`` (observed at :meth:`bill` time,
    where the priority is known) and
    ``request_compile_device_ms_total{model}`` (at :meth:`record_batch`
    time — compile seconds go to the model, never a request).
    """

    def __init__(self, metrics=None, *, capacity: int = 4096):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._requests: "OrderedDict[str, RequestCost]" = OrderedDict()
        self.evicted = 0
        # per-model conservation accumulators
        self._models: Dict[str, dict] = {}
        self._m_device = self._m_compile = None
        if metrics is not None:
            self._m_device = metrics.histogram(
                "request_device_ms",
                "Per-request device milliseconds, row-weighted across the "
                "coalesced batch, compile time excluded",
                ("model", "priority"), buckets=DEVICE_MS_BUCKETS)
            self._m_compile = metrics.counter(
                "request_compile_device_ms_total",
                "Compile/lowering milliseconds attributed to the model "
                "(kernel builds at first use) — never billed to a request",
                ("model",))

    def _model(self, model: str) -> dict:
        rec = self._models.get(model)
        if rec is None:
            rec = self._models[model] = {
                "device_ms": 0.0, "compile_ms": 0.0,
                "attributed_device_ms": 0.0, "unattributed_device_ms": 0.0,
                "requests": 0, "batches": 0}
        return rec

    # -------------------------------------------------------------- record
    def record_batch(self, model: str, *, span_ms: float,
                     compile_ms: float = 0.0,
                     requests: Sequence[Tuple[Optional[str], int]] = ()
                     ) -> float:
        """Apportion one finished ``batch_execute`` span.

        ``span_ms`` is the span's full wall duration on the dispatcher
        thread; ``compile_ms`` the compile/lowering time observed inside
        it (excluded from request attribution); ``requests`` the
        coalesced ``(trace_id_or_None, rows)`` pairs.  Returns the
        steady-state device ms apportioned."""
        span_ms = float(span_ms)
        compile_ms = min(float(compile_ms), span_ms)
        device_ms = max(span_ms - compile_ms, 0.0)
        total_rows = sum(max(int(r), 0) for _, r in requests)
        with self._lock:
            rec = self._model(model)
            rec["device_ms"] += device_ms
            rec["compile_ms"] += compile_ms
            rec["batches"] += 1
            for trace_id, rows in requests:
                rows = max(int(rows), 0)
                share = (device_ms * rows / total_rows) if total_rows \
                    else 0.0
                if trace_id is None:
                    rec["unattributed_device_ms"] += share
                    continue
                rc = self._requests.get(trace_id)
                if rc is None:
                    rc = RequestCost(trace_id, model)
                    self._requests[trace_id] = rc
                    rec["requests"] += 1
                    while len(self._requests) > self.capacity:
                        self._requests.popitem(last=False)
                        self.evicted += 1
                rc.rows += rows
                rc.device_ms += share
                rc.batches += 1
                rec["attributed_device_ms"] += share
            if not total_rows:
                # a batch with zero real rows (shouldn't happen) still
                # conserves: its time is unattributed
                rec["unattributed_device_ms"] += device_ms
        if self._m_compile is not None and compile_ms > 0:
            self._m_compile.inc(compile_ms, model=model)
        return device_ms

    # ------------------------------------------------------------- queries
    def device_ms(self, trace_id: Optional[str]) -> Optional[float]:
        """The device ms attributed to one trace so far, or None."""
        if trace_id is None:
            return None
        with self._lock:
            rc = self._requests.get(trace_id)
            return None if rc is None else rc.device_ms

    def bill(self, trace_id: Optional[str], *, model: str,
             priority: str = "1") -> Optional[float]:
        """Close out one request at the serving boundary: observe its
        share into ``request_device_ms{model,priority}`` (once — a
        request retried through ``bill`` twice is only observed on new
        accumulation) and return the ms for the ``X-Device-Ms`` header."""
        if trace_id is None:
            return None
        with self._lock:
            rc = self._requests.get(trace_id)
            if rc is None:
                return None
            first = not rc.billed
            rc.billed = True
            ms = rc.device_ms
        if first and self._m_device is not None:
            self._m_device.observe(ms, model=model, priority=str(priority))
        return ms

    def totals(self, model: Optional[str] = None) -> dict:
        """Conservation-grade totals, per model or summed over all."""
        with self._lock:
            if model is not None:
                return dict(self._model(model))
            out = {"device_ms": 0.0, "compile_ms": 0.0,
                   "attributed_device_ms": 0.0,
                   "unattributed_device_ms": 0.0,
                   "requests": 0, "batches": 0}
            for rec in self._models.values():
                for k in out:
                    out[k] += rec[k]
            return out

    def conservation(self, model: Optional[str] = None,
                     tol: float = 1e-6) -> dict:
        """THE invariant: attributed + unattributed == total device ms.
        Returns ``{"ok": bool, "error_ms": float, ...totals}``."""
        t = self.totals(model)
        err = abs(t["attributed_device_ms"] + t["unattributed_device_ms"]
                  - t["device_ms"])
        t["error_ms"] = err
        t["ok"] = err <= tol + 1e-9 * max(t["device_ms"], 1.0)
        return t

    def recent(self, n: int = 50) -> List[dict]:
        """The newest ``n`` per-request entries (the ``/debug/capture``
        cost slice)."""
        with self._lock:
            items = list(self._requests.values())[-int(n):]
        return [rc.as_dict() for rc in items]

    def describe(self) -> dict:
        """Operator payload: per-model totals + conservation + bounds
        (the ``/v1/models`` cost block)."""
        with self._lock:
            models = {m: dict(rec) for m, rec in self._models.items()}
            tracked = len(self._requests)
        out = {"models": {}, "capacity": self.capacity,
               "tracked_requests": tracked, "evicted_requests": self.evicted}
        for m, rec in models.items():
            rec = {k: (round(v, 6) if isinstance(v, float) else v)
                   for k, v in rec.items()}
            out["models"][m] = rec
        cons = self.conservation()
        out["conservation"] = {"ok": cons["ok"],
                               "error_ms": round(cons["error_ms"], 9)}
        return out
