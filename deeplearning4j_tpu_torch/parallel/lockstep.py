"""The ordered stream of mesh operations that keeps a sharded server's
ranks in lockstep.

In the reference one controller holds every device, and a sharded
forward is one program over all of them. In the port every rank is a
process (C29), so a forward of a network placed on a mesh needs every
rank to run the same operations in the same order. Rank 0 (the leader)
takes the requests; the other ranks (followers) run each operation as
rank 0 announces it, inside a blocking :meth:`LockstepStream.follow`
(C35):

- every operation on a mesh (a dispatch, a warm-up, a version's
  activation, a retired version, stop) goes through :meth:`submit` on
  rank 0, which sends its header (``broadcast_object_list``), then its
  batch (``broadcast``), and runs it, all under one lock. So no two
  threads of a rank ever issue collectives at the same time, and every
  rank sees the operations in one order;
- a follower receives each header, then the batch, and hands them to the
  endpoint the header names (a ``ParallelInference``), waiting at most
  ``BIND_TIMEOUT_S`` for the model the header names to be registered on
  it (every rank makes the same ``register`` calls, the SPMD program);
- while rank 0 has nothing to send, it sends a heartbeat every
  ``HEARTBEAT_S`` seconds, so that a follower's wait never reaches the
  process group's timeout; a lost rank fails at that timeout instead;
- when rank 0's last endpoint closes it sends stop, and every ``follow()``
  returns.

A world of one runs the same stream with no followers: :meth:`submit`
runs the operation under the lock and sends nothing.

Every mesh a stream serves spans the whole world (each follower runs
every forward). While a stream has endpoints, rank 0 issues no other
collectives on the world.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

#: seconds of silence after which rank 0 sends a heartbeat
HEARTBEAT_S = 2.0
#: how long a follower waits for an endpoint or a model an operation names
BIND_TIMEOUT_S = 120.0


class LockstepStream:
    """One world's ordered stream of mesh operations (see the module's
    docstring). Get it with :func:`stream`."""

    def __init__(self, pg=None):
        self._pg = pg
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        self._lock = threading.Lock()  # one operation at a time, collectives included
        self._cv = threading.Condition()
        self._endpoints: Dict[str, object] = {}
        self._last_send = time.monotonic()
        self._beat_stop: Optional[threading.Event] = None
        self.ops_sent = 0  # the operations rank 0 ran through the stream

    @property
    def leader(self) -> bool:
        return self.rank == 0

    # ------------------------------------------------------------ endpoints
    def attach(self, name: str, endpoint) -> None:
        """Name ``endpoint`` on this rank (every rank attaches the same
        names, the SPMD program)."""
        with self._cv:
            have = self._endpoints.get(name)
            if have is not None and have is not endpoint:
                raise ValueError(f"a lockstep endpoint named {name!r} exists already")
            self._endpoints[name] = endpoint
            self._cv.notify_all()
        if self.leader and self.world > 1:
            self._start_heartbeat()

    def detach(self, name: str, endpoint) -> None:
        """Forget ``endpoint``; on rank 0 the last one to go sends stop."""
        with self._cv:
            if self._endpoints.get(name) is endpoint:
                del self._endpoints[name]
            empty = not self._endpoints
        if self.leader and empty and self.world > 1:
            self._send_stop()

    def endpoint(self, name: str):
        """The endpoint ``name``, waiting for it to be attached."""
        deadline = time.monotonic() + BIND_TIMEOUT_S
        with self._cv:
            while name not in self._endpoints:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RuntimeError(f"rank {self.rank}: no lockstep endpoint {name!r} "
                                       f"after {BIND_TIMEOUT_S} s")
                self._cv.wait(remaining)
            return self._endpoints[name]

    # ---------------------------------------------------------------- rank 0
    def _device(self) -> torch.device:
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def _send_header(self, header: dict) -> None:
        dist.broadcast_object_list([header], src=0, device=self._device())
        self._last_send = time.monotonic()

    def submit(self, name: str, op: str, tag=None, batch: Optional[torch.Tensor] = None,
               run: Optional[Callable] = None):
        """On rank 0: send the operation ``op`` for endpoint ``name`` (and
        ``batch``, a tensor on this rank's device) to the followers, then
        ``run(batch)`` and return its result, all under the stream's lock."""
        if not self.leader:
            raise RuntimeError(f"rank {self.rank} follows rank 0: mesh operations are "
                               "submitted on rank 0")
        with self._lock:
            if self.world > 1:
                header = {"op": op, "to": name, "tag": tag}
                if batch is not None:
                    header["shape"] = list(batch.shape)
                    header["dtype"] = str(batch.dtype).replace("torch.", "")
                self._send_header(header)
                if batch is not None:
                    dist.broadcast(batch.contiguous(), src=0)
            self.ops_sent += 1
            return None if run is None else run(batch)

    def _send_stop(self) -> None:
        with self._lock:
            if self._beat_stop is not None:
                self._beat_stop.set()
                self._beat_stop = None
            self._send_header({"op": "stop"})

    def _start_heartbeat(self) -> None:
        with self._lock:
            if self._beat_stop is not None:
                return
            stop = self._beat_stop = threading.Event()
        threading.Thread(target=self._beat, args=(stop,), daemon=True,
                         name="lockstep-heartbeat").start()

    def _beat(self, stop: threading.Event) -> None:
        while not stop.wait(HEARTBEAT_S / 2):
            with self._lock:
                if stop.is_set():
                    return
                if time.monotonic() - self._last_send >= HEARTBEAT_S:
                    self._send_header({"op": "tick"})

    # -------------------------------------------------------------- followers
    def follow(self) -> int:
        """On a follower: run every operation rank 0 sends, in order, until
        it sends stop; returns the number of operations run. On rank 0
        (the leader) it returns 0 at once."""
        if self.leader:
            return 0
        done = 0
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, device=self._device())
            header = box[0]
            op = header["op"]
            if op == "stop":
                return done
            if op == "tick":
                continue
            batch = None
            if "shape" in header:
                batch = torch.empty(header["shape"], dtype=getattr(torch, header["dtype"]),
                                    device=self._device())
                dist.broadcast(batch, src=0)
            target = self.endpoint(header["to"])
            try:
                target._follow_op(header, batch)
            except Exception:  # noqa: BLE001 - rank 0 delivers the same failure
                log.exception("rank %d: lockstep operation %s failed", self.rank, header)
            done += 1


_lock = threading.Lock()
_current: Optional[LockstepStream] = None


def stream() -> LockstepStream:
    """The stream of the current ``torch.distributed`` world (made at
    first use; a new world gets a new stream)."""
    global _current
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a torch.distributed world: make_mesh() "
                           "opens one, or init_distributed() joins one")
    pg = dist.distributed_c10d._get_default_group()
    with _lock:
        if _current is None or _current._pg is not pg:
            _current = LockstepStream(pg)
        return _current
