"""ParallelInference — dynamic-batching inference front-end.

Counterpart of ``deeplearning4j_tpu/parallel/inference.py``: requests from
many client threads are queued, one dispatcher thread coalesces them
within a ``wait_ms`` window measured from the oldest queued request, pads
the batch to the smallest declared bucket and runs the model's ``output``
on it; ``warmup`` runs every bucket ahead of time.

Serving contract (as the reference):
- a request whose deadline has passed is never dispatched; it fails with
  ``InferenceDeadlineExceeded``;
- a dispatcher-thread crash fails every queued, in-flight and future
  request with ``DispatcherCrashed`` (terminal: supervised restarts come
  with the serving-tier slice, as do metrics, tracing and the cost ledger);
- ``shutdown`` fails every request still queued.

The dispatcher thread enters ``torch.inference_mode()`` itself (the mode
is thread-local).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.train_step import to_host


class InferenceDeadlineExceeded(TimeoutError):
    """The request's deadline expired before a result was produced."""


class DispatcherCrashed(RuntimeError):
    """The batching dispatcher thread died. ``dispatched`` is True only for
    a request that was part of the dying batch."""

    def __init__(self, msg: str, *, dispatched: bool = False):
        super().__init__(msg)
        self.dispatched = dispatched


# _Request lifecycle: PENDING -(dispatcher)-> CLAIMED, or
#                     PENDING -(client timeout / shutdown)-> CANCELLED.
_PENDING, _CLAIMED, _CANCELLED = 0, 1, 2


class _Request:
    __slots__ = ("x", "event", "result", "error", "deadline", "_state",
                 "_lock")

    def __init__(self, x, deadline: Optional[float] = None):
        self.x = x
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.deadline = deadline  # absolute time.monotonic() stamp
        self._state = _PENDING
        self._lock = threading.Lock()

    def claim(self) -> bool:
        """Dispatcher-side: take ownership for dispatch. Returns False if
        the client cancelled OR the deadline already passed (then the error
        is delivered here so the waiter unblocks)."""
        with self._lock:
            if self._state != _PENDING:
                return False
            if self.deadline is not None and time.monotonic() >= self.deadline:
                self._state = _CANCELLED
                self.error = InferenceDeadlineExceeded(
                    "deadline expired while queued")
                self.event.set()
                return False
            self._state = _CLAIMED
            return True

    def cancel(self, error: Exception) -> bool:
        """Client-side: abandon a still-queued request."""
        with self._lock:
            if self._state != _PENDING:
                return False
            self._state = _CANCELLED
            self.error = error
            self.event.set()
            return True

    def fail_unclaimed(self, error: Exception) -> bool:
        """Fail the request if nobody owns it yet (shutdown/crash paths)."""
        with self._lock:
            if self._state == _CLAIMED:
                return False
            self._state = _CANCELLED
            self.error = error
            self.event.set()
            return True


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


class ParallelInference:
    """Batched inference front-end over a model's ``output``.

    mode: 'inplace' (alias 'sequential') runs each request in the calling
    thread; 'batched' coalesces requests in a dispatcher thread up to
    ``max_batch_size`` rows within ``wait_ms`` of the oldest request.
    ``buckets`` are the batch sizes a dispatch is padded to (default:
    powers of two up to ``max_batch_size``). The model is a network of this
    package (its ``output`` takes a host array and returns a tensor on its
    device); results come back as numpy arrays.
    """

    def __init__(self, model, *, mode: str = "batched", max_batch_size: int = 32,
                 queue_limit: int = 64, wait_ms: float = 2.0,
                 buckets: Optional[Sequence[int]] = None):
        if mode not in ("sequential", "inplace", "batched"):
            raise ValueError(f"unknown mode {mode!r} (inplace|sequential|batched)")
        self.model = model
        self.mode = mode
        self.max_batch_size = int(max_batch_size)
        self.wait_s = wait_ms / 1e3
        if buckets is None:
            raw = []
            b = 1
            while b < self.max_batch_size:
                raw.append(b)
                b <<= 1
            raw.append(_pow2(self.max_batch_size))
        else:
            raw = [int(b) for b in buckets]
            if not raw or min(raw) < 1:
                raise ValueError("buckets must be positive batch sizes")
        self.buckets: Tuple[int, ...] = tuple(sorted(set(raw)))
        # one preallocated host buffer per (bucket, row shape, dtype); the
        # dispatcher is serial and copies each result off the device before
        # the buffer is rewritten
        self._pad_buffers: Dict[tuple, np.ndarray] = {}
        self._max_pad_buffers = max(16, 2 * len(self.buckets))
        self._q: "queue.Queue[_Request]" = queue.Queue(maxsize=queue_limit)
        self._shutdown = False
        self._worker = None
        self.dispatcher_error: Optional[BaseException] = None
        self.batches_dispatched = 0
        self._inflight_batch: List[_Request] = []
        self._carry: Optional[_Request] = None  # claimed, awaiting next batch
        if mode == "batched":
            self._worker = threading.Thread(target=self._run, daemon=True,
                                            name="ParallelInference")
            self._worker.start()

    # ----------------------------------------------------------- client API
    @property
    def healthy(self) -> bool:
        """False once the dispatcher thread has crashed or after shutdown."""
        return not self._shutdown and self.dispatcher_error is None

    def output(self, x, *, deadline_s: Optional[float] = None) -> np.ndarray:
        """Predict; ``deadline_s`` is a relative per-request deadline.

        Raises ``InferenceDeadlineExceeded`` past the deadline (whether the
        request was still queued or its batch finished too late) and
        ``DispatcherCrashed`` when the batching thread is gone."""
        x = np.asarray(x)
        if x.ndim == 0:
            raise ValueError("request must be at least 1-d (a batch of rows)")
        if self._shutdown:
            raise RuntimeError("ParallelInference is shut down")
        if self.mode in ("sequential", "inplace"):
            return to_host(self.model.output(x))
        if self.dispatcher_error is not None:
            raise DispatcherCrashed("inference dispatcher died") \
                from self.dispatcher_error
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        req = _Request(x, deadline=deadline)
        self._q.put(req)
        # re-check AFTER the put: a crash or shutdown that drained the queue
        # concurrently with this enqueue would otherwise strand the request
        if self.dispatcher_error is not None:
            req.fail_unclaimed(DispatcherCrashed("inference dispatcher died"))
        elif self._shutdown:
            req.fail_unclaimed(RuntimeError("ParallelInference shut down"))
        if deadline is None:
            req.event.wait()
        elif not req.event.wait(max(deadline - time.monotonic(), 0.0)):
            # still queued → cancel so the dispatcher skips it; already
            # claimed → await the batch but report the deadline anyway
            req.cancel(InferenceDeadlineExceeded(
                f"deadline of {deadline_s}s expired"))
            req.event.wait()
            if req.error is None:
                raise InferenceDeadlineExceeded(
                    f"deadline of {deadline_s}s expired (late batch)")
        if req.error is not None:
            raise req.error
        return req.result

    def _bucket_for(self, n: int) -> int:
        """Smallest declared bucket holding ``n`` rows, else the next power
        of two (a shape warmup did not run)."""
        for b in self.buckets:
            if b >= n:
                return b
        return _pow2(n)

    def warmup(self, row_shape: Sequence[int], *, dtype=np.float32) -> dict:
        """Run the forward for every declared bucket ahead of time (kernel
        builds, allocator growth, library autotuning). Returns
        ``{bucket: seconds}``."""
        report = {}
        with torch.inference_mode():
            for b in self.buckets:
                x = np.zeros((b,) + tuple(row_shape), dtype)
                t0 = time.perf_counter()
                self.model.output(x).cpu()
                report[b] = time.perf_counter() - t0
        return report

    def shutdown(self) -> None:
        self._shutdown = True
        if self._worker is not None:
            self._worker.join(timeout=5.0)
        # fail any requests still queued so no client blocks forever
        self._fail_queued(RuntimeError("ParallelInference shut down"))

    def _fail_queued(self, error: Exception) -> None:
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            r.fail_unclaimed(error)

    # ------------------------------------------------------------ dispatcher
    def _run(self) -> None:
        try:
            with torch.inference_mode():
                self._run_loop()
        except BaseException as e:  # noqa: BLE001 — containment seam
            # the crash must not strand waiters: record it, fail the dying
            # batch, the carried request and everything queued; output()
            # fails fast from now on
            self.dispatcher_error = e
            crash = DispatcherCrashed(f"inference dispatcher died: {e!r}",
                                      dispatched=True)
            for r in self._inflight_batch:
                if not r.event.is_set():
                    r.error = crash
                    r.event.set()
            undispatched = DispatcherCrashed(
                f"inference dispatcher died: {e!r}")
            if self._carry is not None and not self._carry.event.is_set():
                self._carry.error = undispatched
                self._carry.event.set()
                self._carry = None
            self._fail_queued(undispatched)

    def _run_loop(self) -> None:
        # a claimed request that would overflow the largest declared bucket
        # is carried into the NEXT batch instead of forcing a new shape
        cap = self.buckets[-1]
        while not self._shutdown:
            if self._carry is not None:
                first, self._carry = self._carry, None
            else:
                try:
                    first = self._q.get(timeout=0.05)
                except queue.Empty:
                    continue
                if not first.claim():  # cancelled or expired while queued
                    continue
            batch: List[_Request] = [first]
            # published before coalescing: a crash past the first claim
            # must be able to fail these waiters
            self._inflight_batch = batch
            n = first.x.shape[0]
            t0 = time.monotonic()
            while n < self.max_batch_size:
                remaining = self.wait_s - (time.monotonic() - t0)
                if remaining <= 0:
                    break
                try:
                    r = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if not r.claim():
                    continue
                if n + r.x.shape[0] > cap:
                    self._carry = r
                    break
                batch.append(r)
                n += r.x.shape[0]
            self._dispatch_batch(batch, n)
            self._inflight_batch = []
        if self._carry is not None and not self._carry.event.is_set():
            self._carry.error = RuntimeError("ParallelInference shut down")
            self._carry.event.set()
            self._carry = None

    def _assemble(self, batch: List[_Request], n: int,
                  target: int) -> np.ndarray:
        """Coalesce request rows into ONE padded host batch, written straight
        into a preallocated per-bucket buffer when the rows agree in shape
        and dtype."""
        first = batch[0].x
        row_shape, dtype = first.shape[1:], first.dtype
        if not all(r.x.shape[1:] == row_shape and r.x.dtype == dtype
                   for r in batch[1:]):
            x = np.concatenate([r.x for r in batch], axis=0)
            if target > n:
                pad = np.zeros((target - n,) + x.shape[1:], x.dtype)
                x = np.concatenate([x, pad], axis=0)
            return x
        key = (target, row_shape, dtype.str)
        buf = self._pad_buffers.get(key)
        if buf is None:
            while len(self._pad_buffers) >= self._max_pad_buffers:
                self._pad_buffers.pop(next(iter(self._pad_buffers)))
            buf = np.zeros((target,) + tuple(row_shape), dtype)
            self._pad_buffers[key] = buf
        off = 0
        for r in batch:
            k = r.x.shape[0]
            buf[off:off + k] = r.x
            off += k
        if off < target:
            buf[off:] = 0  # stale rows from the last batch must not leak
        return buf

    def _dispatch_batch(self, batch: List[_Request], n: int) -> None:
        try:
            x = self._assemble(batch, n, self._bucket_for(n))
            out = to_host(self.model.output(x))
            self.batches_dispatched += 1
            off = 0
            for r in batch:
                k = r.x.shape[0]
                r.result = out[off:off + k]
                off += k
                r.event.set()
        except Exception as e:  # deliver errors to the batch's clients
            for r in batch:
                r.error = e
                r.event.set()
