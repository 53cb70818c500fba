"""ParallelInference — dynamic-batching inference front-end.

Counterpart of ``deeplearning4j_tpu/parallel/inference.py``: requests from
many client threads are queued, one dispatcher thread coalesces them
within a ``wait_ms`` window measured from the oldest queued request, pads
the batch to the smallest declared bucket and runs the model's ``output``
on it; ``warmup`` runs every bucket ahead of time, through the same
transfer path the dispatcher uses, so a live request never pays a kernel
build, an allocator growth or a library's autotuning.

Serving fast path:
- the coalesce-and-pad step writes request rows straight into ONE
  preallocated per-bucket host buffer (always: the reference's
  ``reuse_pad_buffer`` keyword is accepted and has no effect). For a model
  on the card the buffer is pinned and its copy to the device is
  asynchronous; an event recorded after the copy is waited on before the
  buffer is refilled, so a copy in flight is never overwritten;
- a dispatch that lands on an UNDECLARED bucket, or on a (bucket, row
  shape, dtype) that warmup never ran for the serving model, is counted in
  ``inference_cold_dispatches_total``.

Serving contract (as the reference):
- a request whose deadline has passed is never dispatched; it fails with
  ``InferenceDeadlineExceeded``;
- a dispatcher-thread crash fails every queued, in-flight and future
  request with ``DispatcherCrashed``; with ``max_restarts > 0`` the next
  request after the backoff window (``parallel/elastic.BackoffPolicy``,
  on an injectable ``restart_clock``) restarts the thread in place, and
  while the window runs requests fail fast with ``retry_after_s``. The
  ``dispatched`` flag marks a request that was in the dying batch.
  ``serving_dispatcher_restarts_total{model}`` counts the restarts;
- ``update_model`` swaps the served model atomically: in-flight batches
  finish on the old model, and ``output(return_model=True)`` names the
  model object that served each answer;
- ``shutdown`` fails every request still queued.

Tracing (``observe/trace.py``): with a tracer active, every batched request
runs inside an ``inference_request`` span whose context rides the request
across the thread hop; the dispatcher records a ``queue_wait`` span per
request (parented to the request's context) and a ``batch_execute`` span
around the forward, flow-linked to every request it served. The span
closes after the answer is copied to the host, so on the card its wall
time covers the device work (what the cost ledger apportions).

The dispatcher thread enters ``torch.inference_mode()`` itself (the mode
is thread-local), and so does every restarted one.

Sharded serving (``mesh=``, a ``DeviceMesh`` over the whole
``torch.distributed`` world): the declared buckets are rounded up to the
mesh's ``data`` axis, a model placed on a mesh (``shard_model`` /
``shard_model_with_rules``; a network given unplaced with ``mesh=`` is
placed replicated on it) is served through the world's lockstep stream
(``parallel/lockstep.py``, C35): the padded batch goes from rank 0 to
every rank, is placed ``Shard(0)`` on the data axis by
``sharding.place_batch``, and every rank runs the same forward, whose
full answer (C33) rank 0 returns. Every rank binds the same models under
the same tags (:meth:`bind_model`; ``update_model`` and the registry's
``register`` do it) and the followers call :meth:`follow`. The forward
of a placed network runs under ``torch.no_grad()`` instead of inference
mode (DTensor's views cannot be made of inference tensors).
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.train_step import to_host
from deeplearning4j_tpu_torch.observe import trace as _trace
from deeplearning4j_tpu_torch.parallel.mesh import DATA_AXIS, axis_size
from deeplearning4j_tpu_torch.streaming.codec import mark_bfloat16
from deeplearning4j_tpu_torch.util import faultinject as _faultinject


def host_answer(a) -> np.ndarray:
    """A forward's answer on the host. A bf16 answer (the reference's is a
    bf16 numpy array) comes back as f32 marked for the codec's 2-byte bf16
    frame (``streaming/codec.py``), so the model server answers the
    reference's bytes."""
    out = to_host(a)
    if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
        return mark_bfloat16(out)
    return out


class InferenceDeadlineExceeded(TimeoutError):
    """The request's deadline expired before a result was produced."""


class DispatcherCrashed(RuntimeError):
    """The batching dispatcher thread died.

    ``retry_after_s`` is set when a supervised restart is pending (come
    back after the backoff); ``None`` means terminal (no supervision, or
    the budget is spent). ``dispatched`` is True only for a request that
    was part of the dying batch — the signal the per-version circuit
    breaker counts; fast-fail rejections while a restart is pending never
    carry it."""

    def __init__(self, msg: str, *, retry_after_s: Optional[float] = None,
                 dispatched: bool = False):
        super().__init__(msg)
        self.retry_after_s = retry_after_s
        self.dispatched = dispatched


# _Request lifecycle: PENDING -(dispatcher)-> CLAIMED, or
#                     PENDING -(client timeout / shutdown)-> CANCELLED.
_PENDING, _CLAIMED, _CANCELLED = 0, 1, 2


class _Request:
    __slots__ = ("x", "event", "result", "error", "deadline", "_state",
                 "_lock", "served_model", "ctx", "t_enqueue", "t_claim")

    def __init__(self, x, deadline: Optional[float] = None,
                 ctx: Optional[_trace.SpanContext] = None):
        self.x = x
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.served_model = None  # the model object that actually served
        self.deadline = deadline  # absolute time.monotonic() stamp
        self._state = _PENDING
        self._lock = threading.Lock()
        self.ctx = ctx  # trace context handed across the dispatcher hop
        # timestamps only for traced requests: the untraced path pays nothing
        self.t_enqueue = time.perf_counter_ns() if ctx is not None else None
        self.t_claim: Optional[int] = None

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


class _PadBuffer:
    """One preallocated host batch: ``array`` is what the rows are written
    into; for a model on the card it is a view of the pinned tensor
    ``pinned``, and ``copied`` the event recorded after its last
    asynchronous copy to the device."""

    __slots__ = ("array", "pinned", "copied")

    def __init__(self, shape, dtype, pin: bool):
        self.pinned = None
        self.copied = None
        if pin:
            self.pinned = torch.from_numpy(np.zeros(shape, dtype)).pin_memory()
            self.array = self.pinned.numpy()
        else:
            self.array = np.zeros(shape, dtype)

    def wait_copied(self) -> None:
        """Block until the last copy out of the buffer has finished."""
        if self.copied is not None:
            self.copied.synchronize()
            self.copied = None


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


def _model_device(model) -> Optional[torch.device]:
    dev = getattr(model, "device", None)
    return None if dev is None else torch.device(dev)


def _model_mesh(model):
    """The mesh a network is placed on, or None."""
    return getattr(model, "_mesh", None)


def _world_mesh(mesh):
    """``mesh`` (None, or a ``DeviceMesh``), checked to span the whole
    world: every follower of the lockstep stream runs every forward."""
    if mesh is not None:
        import torch.distributed as dist

        if mesh.size() != dist.get_world_size():
            raise ValueError(f"a serving mesh spans the whole world: {mesh.size()} of "
                             f"{dist.get_world_size()} ranks")
    return mesh


def _round_up(buckets, mesh) -> Tuple[int, ...]:
    """Each bucket rounded up to a multiple of the mesh's data-axis size,
    so that the padded batch always shards evenly."""
    d = axis_size(mesh, DATA_AXIS)
    return tuple(sorted({-(-int(b) // d) * d for b in buckets}))


class ParallelInference:
    """Batched inference front-end over a model's ``output``.

    mode: 'inplace' (alias 'sequential') runs each request in the calling
    thread; 'batched' coalesces requests in a dispatcher thread up to
    ``max_batch_size`` rows within ``wait_ms`` of the oldest request.
    ``buckets`` are the batch sizes a dispatch is padded to (default:
    powers of two up to ``max_batch_size``). The model is a network of this
    package, or anything with its ``output`` (a host array or a tensor in,
    a tensor or array out) and ``device``; results come back as numpy
    arrays.

    ``metrics``: optional duck-typed registry (``observe.metrics``). When
    given, records ``inference_batch_size`` (histogram), and the gauges
    ``inference_queue_depth`` and ``inference_dispatcher_up``, the counters
    ``inference_cold_dispatches_total`` and
    ``serving_dispatcher_restarts_total``, each labelled ``model`` (the
    ``metrics_name``). ``cost``: an ``observe.cost.CostLedger`` that each
    traced batch's device time is apportioned into.
    """

    def __init__(self, model, *, mode: str = "batched", max_batch_size: int = 32,
                 queue_limit: int = 64, wait_ms: float = 2.0, mesh=None,
                 metrics=None, metrics_name: str = "default",
                 buckets: Optional[Sequence[int]] = None,
                 reuse_pad_buffer: bool = True,
                 max_restarts: int = 0, restart_backoff=None,
                 restart_clock=time.monotonic, cost=None):
        if mode not in ("sequential", "inplace", "batched"):
            raise ValueError(f"unknown mode {mode!r} (inplace|sequential|batched)")
        self.model = model
        self.mode = mode
        self.max_batch_size = int(max_batch_size)
        self.wait_s = wait_ms / 1e3
        self.mesh = _world_mesh(mesh)
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
        self.buckets: Tuple[int, ...] = _round_up(raw, self.mesh)
        # bounded: clients choose the row shape and dtype
        self._pad_buffers: Dict[tuple, _PadBuffer] = {}
        self._max_pad_buffers = max(16, 2 * len(self.buckets))
        # PER MODEL: the (bucket, row shape, dtype) signatures warmup ran;
        # weak keys, so a retired version is not pinned by its set
        self._warmed_keys: "weakref.WeakKeyDictionary" = (
            weakref.WeakKeyDictionary())
        self._model_lock = threading.Lock()
        self._q: "queue.Queue[_Request]" = queue.Queue(maxsize=queue_limit)
        self._shutdown = False
        self._worker = None
        self.dispatcher_error: Optional[BaseException] = None
        self.batches_dispatched = 0
        self._inflight_batch: List[_Request] = []
        self._carry: Optional[_Request] = None  # claimed, awaiting next batch
        self._metrics_name = metrics_name
        self.cost = cost
        # supervision: restart in place under the backoff ladder;
        # max_restarts=0 keeps the terminal-crash contract
        self.max_restarts = int(max_restarts)
        self.restarts_used = 0
        if restart_backoff is None:
            from deeplearning4j_tpu_torch.parallel.elastic import BackoffPolicy
            restart_backoff = BackoffPolicy()
        self._restart_backoff = restart_backoff
        self._restart_clock = restart_clock
        self._restart_at: Optional[float] = None  # restart_clock stamp
        self._restart_lock = threading.Lock()
        self._forward_seq = 0  # per-model dispatch counter (chaos keying)
        self._m_batch = self._m_depth = self._m_up = self._m_cold = None
        self._m_restarts = None
        if metrics is not None:
            self._m_batch = metrics.histogram(
                "inference_batch_size",
                "Coalesced rows per dispatched device batch", ("model",),
                buckets=[2 ** i for i in range(0, 11)])
            self._m_depth = metrics.gauge(
                "inference_queue_depth", "Requests waiting for dispatch",
                ("model",))
            self._m_up = metrics.gauge(
                "inference_dispatcher_up",
                "1 while the batching dispatcher thread is alive", ("model",))
            self._m_up.set(1, model=metrics_name)
            self._m_cold = metrics.counter(
                "inference_cold_dispatches_total",
                "Dispatches padded to an UNDECLARED (never-warmed) bucket — "
                "each one may pay a live kernel build or allocator growth",
                ("model",))
            self._m_restarts = metrics.counter(
                "serving_dispatcher_restarts_total",
                "Supervised in-place restarts of a crashed batching "
                "dispatcher thread", ("model",))
        # sharded serving: the world's lockstep stream once a model on a
        # mesh is bound, and the models every rank binds under one tag
        self._lockstep = None
        self._bound: Dict[object, object] = {}   # tag -> model
        self._tags: Dict[int, object] = {}       # id(model) -> tag
        self._bind_cv = threading.Condition()
        self._next_tag = 0
        if self.mesh is not None:
            self.bind_model(model)
        if mode == "batched":
            self._start_worker()

    def _start_worker(self) -> None:
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="ParallelInference")
        self._worker.start()

    # ----------------------------------------------------------- client API
    @property
    def healthy(self) -> bool:
        """False once the dispatcher thread has crashed or after shutdown."""
        if self.mode in ("sequential", "inplace"):
            return not self._shutdown
        return not self._shutdown and self.dispatcher_error is None

    def output(self, x, *, deadline_s: Optional[float] = None,
               return_model: bool = False):
        """Predict; ``deadline_s`` is a relative per-request deadline.

        Raises ``InferenceDeadlineExceeded`` past the deadline (whether the
        request was still queued or its batch finished too late) and
        ``DispatcherCrashed`` when the batching thread is gone.
        ``return_model=True`` returns ``(result, model)``, ``model`` being
        the object that served the batch — the only truthful attribution
        under concurrent hot swaps."""
        x = np.asarray(x)
        if x.ndim == 0:
            raise ValueError("request must be at least 1-d (a batch of rows)")
        if self._shutdown:
            raise RuntimeError("ParallelInference is shut down")
        self._require_leader()
        if self.mode in ("sequential", "inplace"):
            model = self._model()
            with _trace.span("inference_request", category="serve",
                             attrs={"model": self._metrics_name,
                                    "rows": int(x.shape[0]),
                                    "mode": self.mode}):
                res = self.forward_now(model, x)
            return (res, model) if return_model else res
        if self.dispatcher_error is not None:
            self._ensure_dispatcher()
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        tracer = _trace.get_active_tracer()
        if tracer is None:
            return self._output_batched(x, deadline, deadline_s,
                                        return_model, None)
        # per-request span: enqueue → wait → result; its context rides the
        # _Request across the dispatcher thread
        with tracer.span("inference_request", category="serve",
                         attrs={"model": self._metrics_name,
                                "rows": int(x.shape[0]),
                                "mode": "batched"}) as sp:
            return self._output_batched(x, deadline, deadline_s,
                                        return_model, sp.context)

    def _output_batched(self, x, deadline, deadline_s, return_model, ctx):
        req = _Request(x, deadline=deadline, ctx=ctx)
        self._q.put(req)
        # re-check AFTER the put: a crash or shutdown that drained the queue
        # concurrently with this enqueue would otherwise strand the request
        if self.dispatcher_error is not None:
            req.fail_unclaimed(DispatcherCrashed(
                "inference dispatcher died",
                retry_after_s=self.restart_state()["retry_after_s"]))
        elif self._shutdown:
            req.fail_unclaimed(RuntimeError("ParallelInference shut down"))
        if self._m_depth is not None:
            self._m_depth.set(self._q.qsize(), model=self._metrics_name)
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
        return (req.result, req.served_model) if return_model else req.result

    def update_model(self, model) -> None:
        """Atomically swap the served model (``ParallelInference.updateModel``).
        In-flight batches finish on the old model. On a mesh every rank
        makes the call (it binds the model under the next tag); rank 0's
        activation then reaches the followers through the stream."""
        tag = self._tag_for(model)
        if tag is None and (self.mesh is not None or _model_mesh(model) is not None):
            tag = self.bind_model(model)
        if tag is not None and self._lockstep.leader:
            self._lockstep.submit(self._metrics_name, "activate", tag)
        with self._model_lock:
            self.model = model

    def _model(self):
        with self._model_lock:
            return self.model

    # ----------------------------------------------------------- supervision
    def _ensure_dispatcher(self) -> None:
        """Crashed-dispatcher gate on the request path: restart the thread
        in place once the backoff window has passed, or raise
        ``DispatcherCrashed`` — with a ``retry_after_s`` hint while the
        window runs, terminally once the budget is gone. Lazy (no
        supervisor thread), so the ladder is deterministic under an
        injected clock."""
        with self._restart_lock:
            if self.dispatcher_error is None or self._shutdown:
                return  # restarted concurrently (or shutting down)
            cause = self.dispatcher_error
            if self._restart_at is None:
                msg = ("inference dispatcher died"
                       if self.max_restarts == 0 else
                       f"inference dispatcher died (restart budget of "
                       f"{self.max_restarts} exhausted)")
                raise DispatcherCrashed(msg) from cause
            remaining = self._restart_at - self._restart_clock()
            if remaining > 0:
                raise DispatcherCrashed(
                    "inference dispatcher died; restart pending",
                    retry_after_s=remaining) from cause
            # the dying thread may still be failing its casualties: let it
            # finish before a new thread shares the queue
            old = self._worker
            if old is not None and old is not threading.current_thread():
                old.join(timeout=5.0)
            self.restarts_used += 1
            self.dispatcher_error = None
            self._restart_at = None
            self._inflight_batch = []
            self._carry = None
            self._start_worker()
            if self._m_up is not None:
                self._m_up.set(1, model=self._metrics_name)
            if self._m_restarts is not None:
                self._m_restarts.inc(model=self._metrics_name)

    def restart_state(self) -> dict:
        """Supervision snapshot for health probes: whether the dispatcher
        is crashed, whether a restart is still possible, and how long
        until the backoff window opens."""
        with self._restart_lock:
            crashed = self.dispatcher_error is not None
            pending = crashed and self._restart_at is not None
            retry_after = None
            if pending:
                retry_after = max(
                    0.0, self._restart_at - self._restart_clock())
            return {"crashed": crashed,
                    "restart_pending": pending,
                    "retry_after_s": retry_after,
                    "restarts_used": self.restarts_used,
                    "max_restarts": self.max_restarts,
                    "terminal": crashed and self._restart_at is None}

    # ------------------------------------------------------------ fast path
    def _bucket_for(self, n: int) -> Tuple[int, bool]:
        """Smallest declared bucket holding ``n`` rows, or (cold) the next
        power of two, rounded up to the mesh's data axis. Returns
        ``(target_rows, declared)``."""
        for b in self.buckets:
            if b >= n:
                return b, True
        return _round_up([_pow2(n)], self.mesh)[0], False

    def _to_device(self, x: np.ndarray, model, buf: Optional[_PadBuffer] = None):
        """Host batch → what the model's ``output`` is given, exactly as the
        dispatcher ships it (shared with warmup): a tensor on the model's
        card, copied asynchronously out of a pinned pad buffer (an event
        marks the copy's end), or the host array for a CPU model."""
        dev = _model_device(model)
        if dev is None or dev.type == "cpu":
            return x
        if buf is not None and buf.pinned is not None:
            xd = buf.pinned.to(dev, non_blocking=True)
            buf.copied = torch.cuda.Event()
            buf.copied.record(torch.cuda.current_stream(dev))
            return xd
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def set_mesh(self, mesh) -> None:
        """Repoint the dispatch at ``mesh`` (None: the model's own device)
        and round the declared buckets up to its data-axis size. A model
        placed on a mesh is still served on its own placement."""
        self.mesh = _world_mesh(mesh)
        self.buckets = _round_up(self.buckets, self.mesh)
        if self.mesh is not None:
            self._attach()

    # ------------------------------------------------------ sharded serving
    def _attach(self):
        if self._lockstep is None:
            from deeplearning4j_tpu_torch.parallel.lockstep import stream

            self._lockstep = stream()
            self._lockstep.attach(self._metrics_name, self)
        return self._lockstep

    def _require_leader(self) -> None:
        if self._lockstep is not None and not self._lockstep.leader:
            raise RuntimeError(
                f"rank {self._lockstep.rank} follows rank 0 on the mesh: requests "
                "go to rank 0; call follow() here")

    def bind_model(self, model, tag=None):
        """Bind ``model`` for sharded serving under ``tag`` (the next
        integer by default); every rank binds the same models under the
        same tags, in the same order. A network not placed on a mesh is
        placed replicated on this dispatcher's mesh. Returns the tag, or
        None for a model served on one device."""
        if _model_mesh(model) is None:
            if self.mesh is None:
                return None
            if hasattr(model, "_mesh"):  # a network of this package
                from deeplearning4j_tpu_torch.parallel.sharding import shard_model

                shard_model(model, self.mesh)
        self._attach()
        with self._bind_cv:
            if tag is None:
                tag = self._next_tag
            if isinstance(tag, int):
                self._next_tag = max(self._next_tag, tag + 1)
            self._bound[tag] = model
            self._tags[id(model)] = tag
            self._bind_cv.notify_all()
        return tag

    def unbind_model(self, model) -> None:
        """Drop a retired model from sharded serving: on rank 0 through the
        stream, so that every rank drops it after the operations that
        named it."""
        tag = self._tag_for(model)
        if tag is None:
            return
        if self._lockstep.leader:
            self._lockstep.submit(self._metrics_name, "unbind", tag)
            self._drop_tag(tag)

    def _drop_tag(self, tag) -> None:
        with self._bind_cv:
            model = self._bound.pop(tag, None)
            if model is not None and self._tags.get(id(model)) == tag:
                del self._tags[id(model)]

    def _tag_for(self, model):
        with self._bind_cv:
            tag = self._tags.get(id(model))
            return tag if tag is not None and self._bound.get(tag) is model else None

    def _bound_model(self, tag):
        """The model bound under ``tag``, waiting for the bind."""
        from deeplearning4j_tpu_torch.parallel.lockstep import BIND_TIMEOUT_S

        deadline = time.monotonic() + BIND_TIMEOUT_S
        with self._bind_cv:
            while tag not in self._bound:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RuntimeError(f"{self._metrics_name}: no model bound under "
                                       f"tag {tag!r}")
                self._bind_cv.wait(remaining)
            return self._bound[tag]

    @staticmethod
    def _mesh_forward(model, x: torch.Tensor):
        """The forward every rank runs: the batch placed ``Shard(0)`` on
        the model's data axis, the full answer back."""
        mesh = _model_mesh(model)
        if mesh is not None:
            from deeplearning4j_tpu_torch.parallel.sharding import place_batch

            x = place_batch(x, mesh)
        with torch.inference_mode(False), torch.no_grad():
            return model.output(x)

    def _lockstep_forward(self, model, tag, x: np.ndarray,
                          buf: Optional[_PadBuffer] = None, op: str = "forward"):
        """Rank 0's forward through the stream: the batch on this rank's
        device, sent to the followers, the same forward on every rank;
        the answer on the host."""
        with torch.inference_mode(False):
            dev = _model_device(model)
            if dev is None or dev.type == "cpu":
                xd = torch.from_numpy(np.array(x))
            else:
                xd = self._to_device(x, model, buf)
            return self._lockstep.submit(
                self._metrics_name, op, tag, xd,
                lambda batch: host_answer(self._mesh_forward(model, batch)))

    def _follow_op(self, header: dict, batch) -> None:
        """A follower's share of one operation of rank 0's."""
        op, tag = header["op"], header.get("tag")
        if op in ("forward", "warmup"):
            self._mesh_forward(self._bound_model(tag), batch)
        elif op == "activate":
            model = self._bound_model(tag)
            with self._model_lock:
                self.model = model
        elif op == "unbind":
            self._drop_tag(tag)
        else:
            raise ValueError(f"unknown lockstep operation {op!r}")

    def follow(self) -> int:
        """On a follower rank: run rank 0's mesh operations until it stops
        (its ``shutdown``); returns how many ran. Returns 0 at once on
        rank 0 or a world of one (C35)."""
        if self._lockstep is None:
            return 0
        return self._lockstep.follow()

    def forward_now(self, model, x) -> np.ndarray:
        """One synchronous forward of ``model`` on the calling thread (the
        registry's pinned, canary, fallback and shadow paths): through the
        stream when the model is bound for sharded serving."""
        tag = self._tag_for(model)
        if tag is not None:
            return self._lockstep_forward(model, tag, np.asarray(x))
        with torch.inference_mode():
            return host_answer(model.output(np.asarray(x)))

    def warmup(self, row_shape: Sequence[int], *, dtype=np.float32,
               model=None, buckets: Optional[Sequence[int]] = None,
               mesh=None) -> dict:
        """Run the forward for every declared bucket (or those holding
        ``buckets``' row counts) ahead of time, through the dispatcher's
        own transfer path: kernel builds, allocator growth and library
        autotuning happen here, never under a live request. ``model``
        defaults to the live model; a version not yet activated can be
        warmed before its hot swap. A bound model warms through the
        stream on its own placement (``mesh`` is the reference's
        override, which the placement already gives). Returns ``{bucket:
        seconds}``; a follower runs rank 0's warm-ups in ``follow()`` and
        returns ``{}`` here."""
        if mesh is not None:
            _world_mesh(mesh)
        if self._lockstep is not None and not self._lockstep.leader:
            return {}
        model = self._model() if model is None else model
        tag = self._tag_for(model)
        if tag is None and _model_mesh(model) is not None:
            raise ValueError("warmup of a model placed on a mesh that no rank bound: "
                             "bind_model() (or register()) it on every rank first")
        report = {}
        with torch.inference_mode():
            for b in (self.buckets if buckets is None else
                      [self._bucket_for(int(x))[0] for x in buckets]):
                x = np.zeros((b,) + tuple(row_shape), dtype)
                t0 = time.perf_counter()
                if tag is not None:
                    self._lockstep_forward(model, tag, x, op="warmup")
                else:
                    to_host(model.output(self._to_device(x, model)))
                report[b] = time.perf_counter() - t0
                try:
                    self._warmed_keys.setdefault(model, set()).add(
                        (b, tuple(row_shape), np.dtype(dtype).str))
                except TypeError:  # a model that takes no weak reference:
                    pass           # its dispatches count cold
        return report

    def shutdown(self) -> None:
        self._shutdown = True
        if self._worker is not None:
            self._worker.join(timeout=5.0)
        # fail any requests still queued so no client blocks forever
        self._fail_queued(RuntimeError("ParallelInference shut down"))
        if self._m_up is not None:
            self._m_up.set(0, model=self._metrics_name)
        if self._lockstep is not None:
            # rank 0's last endpoint sends stop: every follow() returns
            self._lockstep.detach(self._metrics_name, self)

    def _fail_queued(self, error: Exception) -> None:
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            r.fail_unclaimed(error)
        if self._m_depth is not None:
            self._m_depth.set(0, model=self._metrics_name)

    # ------------------------------------------------------------ dispatcher
    def _run(self) -> None:
        try:
            with torch.inference_mode():
                self._run_loop()
        except BaseException as e:  # noqa: BLE001 — containment seam
            # the crash must not strand waiters: under supervision the
            # restart window is scheduled BEFORE the error becomes visible
            # (same lock as _ensure_dispatcher), so a racing request never
            # reads "crashed" without a window
            retry_after = None
            with self._restart_lock:
                if self.restarts_used < self.max_restarts \
                        and not self._shutdown:
                    retry_after = self._restart_backoff.delay(
                        self.restarts_used + 1, seed=self._metrics_name)
                    self._restart_at = self._restart_clock() + retry_after
                else:
                    self._restart_at = None
                self.dispatcher_error = e
            if self._m_up is not None:
                self._m_up.set(0, model=self._metrics_name)
            # the dying batch's forwards DIED (dispatched=True, what the
            # breaker counts); the carry and the queued ones never ran
            crash = DispatcherCrashed(
                f"inference dispatcher died: {e!r}",
                retry_after_s=retry_after, dispatched=True)
            for r in self._inflight_batch:
                if not r.event.is_set():
                    r.error = crash
                    r.event.set()
            undispatched = DispatcherCrashed(
                f"inference dispatcher died: {e!r}",
                retry_after_s=retry_after)
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
                if first.ctx is not None:
                    first.t_claim = time.perf_counter_ns()
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
                if r.ctx is not None:
                    r.t_claim = time.perf_counter_ns()
                if n + r.x.shape[0] > cap:
                    self._carry = r
                    break
                batch.append(r)
                n += r.x.shape[0]
            if self._m_depth is not None:
                self._m_depth.set(self._q.qsize(), model=self._metrics_name)
            self._dispatch(batch, n)
            self._inflight_batch = []
        if self._carry is not None and not self._carry.event.is_set():
            self._carry.error = RuntimeError("ParallelInference shut down")
            self._carry.event.set()
            self._carry = None

    def _dispatch(self, batch: List[_Request], n: int) -> None:
        tracer = _trace.get_active_tracer()
        if tracer is None:
            return self._dispatch_batch(batch, n, None)
        # queue-wait attribution first, parented to each REQUEST's span
        # (the explicit handoff: contextvars never cross the thread hop)
        for r in batch:
            if r.ctx is not None and r.t_claim is not None:
                tracer.record("queue_wait", r.t_enqueue, r.t_claim,
                              parent=r.ctx, category="serve",
                              attrs={"model": self._metrics_name})
        # a kernel built at first use runs on THIS thread inside the span,
        # so the per-thread compile-seconds delta is what the cost ledger
        # must not bill to the batch's requests
        compile_s0 = tracer.thread_compile_seconds()
        with tracer.span("batch_execute", category="serve",
                         attrs={"model": self._metrics_name, "rows": n,
                                "requests": len(batch)}) as sp:
            for r in batch:
                sp.add_link(r.ctx)
            self._dispatch_batch(batch, n, sp)
        if self.cost is not None and sp.end_ns is not None:
            compile_ms = (tracer.thread_compile_seconds() - compile_s0) * 1e3
            self.cost.record_batch(
                self._metrics_name,
                span_ms=(sp.end_ns - sp.start_ns) / 1e6,
                compile_ms=compile_ms,
                requests=[(r.ctx.trace_id if r.ctx is not None else None,
                           int(r.x.shape[0])) for r in batch])

    def _assemble(self, batch: List[_Request], n: int, target: int,
                  pin: bool) -> Tuple[np.ndarray, Optional[_PadBuffer]]:
        """Coalesce request rows into ONE padded host batch, written straight
        into a preallocated per-bucket buffer when the rows agree in shape
        and dtype. Returns ``(batch array, its buffer)``."""
        first = batch[0].x
        row_shape, dtype = first.shape[1:], first.dtype
        homogeneous = all(r.x.shape[1:] == row_shape and r.x.dtype == dtype
                          for r in batch[1:])
        if not homogeneous:
            x = np.concatenate([r.x for r in batch], axis=0)
            if target > n:
                pad = np.zeros((target - n,) + x.shape[1:], x.dtype)
                x = np.concatenate([x, pad], axis=0)
            return x, None
        key = (target, row_shape, dtype.str, pin)
        buf = self._pad_buffers.get(key)
        if buf is None:
            while len(self._pad_buffers) >= self._max_pad_buffers:
                self._pad_buffers.pop(next(iter(self._pad_buffers))).wait_copied()
            buf = _PadBuffer((target,) + tuple(row_shape), dtype, pin)
            self._pad_buffers[key] = buf
        buf.wait_copied()  # never refill a buffer whose copy is in flight
        off = 0
        for r in batch:
            k = r.x.shape[0]
            buf.array[off:off + k] = r.x
            off += k
        if off < target:
            buf.array[off:] = 0  # stale rows from the last batch must not leak
        return buf.array, buf

    def _dispatch_batch(self, batch: List[_Request], n: int, sp) -> None:
        try:
            target, declared = self._bucket_for(n)
            model = self._model()
            dev = _model_device(model)
            x, buf = self._assemble(batch, n, target,
                                    pin=dev is not None and dev.type == "cuda")
            # cold: off-bucket, or a signature warmup never ran for THIS
            # model (lazy mode, where no warmup ever ran, counts only
            # off-bucket dispatches)
            keys = None
            any_warmed = len(self._warmed_keys) > 0
            if any_warmed:
                try:
                    keys = self._warmed_keys.get(model)
                except TypeError:
                    keys = None
            cold = not declared or (
                any_warmed and
                (keys is None or
                 (target, x.shape[1:], x.dtype.str) not in keys))
            if cold and self._m_cold is not None:
                self._m_cold.inc(model=self._metrics_name)
            if sp is not None:
                sp.set_attribute("padded_to", int(target))
                if cold:
                    sp.set_attribute("cold_bucket", True)
            # serving chaos seam, keyed on (model, dispatch seq): a
            # crash_forward raises a BaseException that escapes this
            # handler and kills the dispatcher thread
            seq = self._forward_seq
            self._forward_seq += 1
            _faultinject.on_forward(self._metrics_name, seq)
            tag = self._tag_for(model)
            if tag is not None:
                out = self._lockstep_forward(model, tag, x, buf)
            else:
                out = host_answer(model.output(self._to_device(x, model, buf)))
            if buf is not None and np.may_share_memory(out, buf.array):
                out = out.copy()  # an answer must outlive the reused buffer
            self.batches_dispatched += 1
            if self._m_batch is not None:
                self._m_batch.observe(n, model=self._metrics_name)
            off = 0
            for r in batch:
                k = r.x.shape[0]
                r.result = out[off:off + k]
                r.served_model = model
                off += k
                r.event.set()
        except Exception as e:  # deliver errors to the batch's clients
            if sp is not None:
                sp.error = f"{type(e).__name__}: {e}"
            for r in batch:
                r.error = e
                r.event.set()
