"""Deterministic fault injection: make failure paths CI-provable.

The elastic supervisor (``parallel/elastic.py``) exists to survive
worker death, heartbeat stalls, torn checkpoints and lossy DCN links —
none of which occur naturally on a clean CI host. This module injects
those faults *deterministically* from a JSON ``FaultPlan`` so the
recovery choreography is exercised by ordinary subprocess CPU tests
instead of being demo-only:

- ``kill``: SIGKILL the worker process the moment it reports step S —
  a preemption without grace (the reference's fixed-membership design,
  ``SharedTrainingWrapper.java:131-156``, simply dies here).
- ``stall``: block inside step S (training and heartbeats both stop) —
  a hung host; the supervisor's heartbeat watchdog must kill + recover.
- ``stall_heartbeat``: suppress heartbeats from step S on while training
  continues — a partitioned/zombie worker; the supervisor must fence it.
- ``corrupt_checkpoint``: truncate or overwrite checkpoint files right
  after the save at step S commits — exercises the restore-time
  integrity fallback (``OrbaxCheckpointManager.restore(fallback=True)``).
  The checkpoint is a world-level artifact written by whichever rank is
  0 at that step, so this fault matches on ``step`` alone (``worker``
  is accepted but ignored).
- ``drop_dcn`` / ``duplicate_dcn``: drop or duplicate the Nth outbound
  cross-slice gradient frame (``parallel/dcn.py``) — lossy UDP-ish
  transport semantics.

Host-scoped faults (pod-scale failure domains; a "host" in CI is a
process group the elastic supervisor forms on localhost):

- ``kill_host``: SIGKILL every worker of host group H the moment it
  reports step S — a whole machine disappearing, the failure domain the
  per-worker ``kill`` cannot express.
- ``partition``: from step S on, host group H is cut from the rest of
  the job — its workers block inside the step (a collective across the
  partition can never complete) while their background heartbeats stay
  alive, and every DCN frame crossing the boundary is dropped in both
  directions. The signature the supervisor's step-progress watchdog
  keys on: liveness without progress.
- ``slow_save``: stall the asynchronous checkpoint thread for
  ``duration_s`` during the save of step S — a slow/hung filesystem;
  training must keep overlapping and the bounded in-flight window must
  backpressure instead of accumulating torn saves.
- ``kill`` additionally accepts a ``phase`` field
  (``pre_write | mid_shard | pre_stamp``): instead of firing on the
  training step, the SIGKILL lands at that point of the checkpoint
  commit protocol — the torn-async-save matrix.

Serving-scoped faults (the serving chaos harness; a "model" here is a
registered serving name, the sequence a per-model request/forward
counter):

- ``crash_forward``: the model's forward raises a non-``Exception``
  error at dispatch sequence S — the batching dispatcher thread DIES
  (the containment seam ``ParallelInference._run`` exists for), which
  is what trips restart supervision and the per-version circuit
  breaker. Keyed on the per-model *forward* sequence (dispatches, not
  HTTP requests — a coalesced batch is one forward).
- ``slow_forward``: the forward at dispatch sequence S blocks for
  ``duration_s`` — a latency spike; drives deadline/brownout paths.
- ``reject_admission``: the HTTP front-end sheds request S (per-model
  *request* sequence) at the door with 429 + ``Retry-After`` — a
  simulated overload the resilient client must absorb via its retry
  budget.
- ``drop_response``: the front-end processes request S fully, then
  severs the connection without writing the response — the network
  eating an answer; proves the client's reconnect + retry path.

Activation: set ``DL4J_TPU_FAULT_PLAN`` to a plan file path (or inline
JSON) before the process starts. When the variable is unset every hook
is a single-``is None``-check no-op — the production hot path pays one
attribute load and a comparison, nothing else.

Faults are keyed on (worker slot, step/seq) — host faults on (host
group, step/seq), serving faults on (model name, request/forward seq):
pure functions of training/traffic progress, so a plan replays
identically on every run — which is what lets tests assert exact
recovery points. The process's own host group arrives through
``DL4J_TPU_ELASTIC_HOST`` (or :func:`set_host`).

A copy of the JAX package's stdlib-only ``util/faultinject.py``: the same
environment variables and the same plan JSON, so one plan file drives
either package. In the port only :func:`on_forward` is wired so far (the
batching dispatcher, ``parallel/inference.py``); the training, checkpoint,
DCN and HTTP front-end hooks are wired with the modules that call them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Dict, List, Optional

ENV_VAR = "DL4J_TPU_FAULT_PLAN"
ENV_HOST_VAR = "DL4J_TPU_ELASTIC_HOST"

FAULT_TYPES = ("kill", "stall", "stall_heartbeat", "corrupt_checkpoint",
               "drop_dcn", "duplicate_dcn",
               "kill_host", "partition", "slow_save",
               "crash_forward", "slow_forward", "reject_admission",
               "drop_response")
HOST_FAULT_TYPES = ("kill_host", "partition")
SERVING_FAULT_TYPES = ("crash_forward", "slow_forward", "reject_admission",
                       "drop_response")
CORRUPT_MODES = ("truncate", "garbage", "delete")
SAVE_PHASES = ("pre_write", "mid_shard", "pre_stamp")


class InjectedDispatcherCrash(BaseException):
    """``crash_forward``'s payload. Deliberately NOT an ``Exception``:
    a model error is contained per request (the 500 path), but this must
    escape ``ParallelInference._dispatch_batch``'s per-request handler
    and kill the dispatcher thread itself — the failure mode the
    supervision/breaker machinery exists for."""


@dataclasses.dataclass
class Fault:
    """One planned fault. ``worker`` is the elastic SLOT id (stable across
    restarts and renumbering), ``step`` the global training iteration (or
    checkpoint step for ``corrupt_checkpoint``, frame sequence number for
    the DCN faults). Host-scoped faults carry ``host`` (the failure
    domain) instead of a meaningful ``worker``; a ``kill``/``slow_save``
    may carry ``phase`` to fire inside the checkpoint commit protocol
    rather than on the training step."""

    type: str
    worker: object  # int slot, or "*" for any worker
    step: int
    mode: str = "truncate"        # corrupt_checkpoint only
    duration_s: float = 3600.0    # stall/partition/slow_save only
    signum: int = int(signal.SIGKILL)
    host: object = None           # kill_host / partition failure domain
    phase: Optional[str] = None   # kill/slow_save: commit-protocol phase
    model: object = None          # serving faults: model name, or "*"

    def matches(self, worker, step: int) -> bool:
        return (self.worker == "*" or self.worker == worker) \
            and int(step) == int(self.step)

    def matches_host(self, host, step: int) -> bool:
        return host is not None \
            and (self.host == "*" or self.host == host) \
            and int(step) == int(self.step)

    def matches_model(self, model, seq: int) -> bool:
        return (self.model == "*" or self.model == model) \
            and int(seq) == int(self.step)


class FaultPlan:
    """A validated list of :class:`Fault` entries."""

    def __init__(self, faults: List[Fault]):
        self.faults = list(faults)

    # -- construction / validation --------------------------------------
    @classmethod
    def parse(cls, spec) -> "FaultPlan":
        """Build from a parsed dict; raises ``ValueError`` with the
        offending fault index on any schema problem."""
        if not isinstance(spec, dict) or "faults" not in spec:
            raise ValueError(
                "fault plan must be an object with a 'faults' list")
        raw = spec["faults"]
        if not isinstance(raw, list):
            raise ValueError("'faults' must be a list")
        faults = []
        for i, f in enumerate(raw):
            if not isinstance(f, dict):
                raise ValueError(f"fault[{i}]: must be an object")
            unknown = set(f) - {"type", "worker", "step", "mode",
                                "duration_s", "signal", "host", "phase",
                                "model"}
            if unknown:
                raise ValueError(
                    f"fault[{i}]: unknown field(s) {sorted(unknown)}")
            ftype = f.get("type")
            if ftype not in FAULT_TYPES:
                raise ValueError(
                    f"fault[{i}]: unknown type {ftype!r} "
                    f"(one of {', '.join(FAULT_TYPES)})")
            model = f.get("model")
            if ftype in SERVING_FAULT_TYPES:
                if not (isinstance(model, str) and model):
                    raise ValueError(
                        f"fault[{i}]: {ftype} needs a 'model' name "
                        f"(a registered serving name, or '*'), "
                        f"got {model!r}")
                for bad in ("worker", "host", "phase", "mode"):
                    if bad in f:
                        raise ValueError(
                            f"fault[{i}]: {bad!r} is not valid on the "
                            f"serving fault {ftype} (keyed on model + "
                            f"request/forward seq)")
            elif model is not None:
                raise ValueError(
                    f"fault[{i}]: 'model' is only valid on "
                    f"{'/'.join(SERVING_FAULT_TYPES)}, not {ftype}")
            worker = f.get("worker", "*")
            ok = worker == "*" or (isinstance(worker, int) and worker >= 0) \
                or (isinstance(worker, str) and worker)
            if not ok:
                raise ValueError(
                    f"fault[{i}]: worker must be a slot index >= 0, a "
                    f"slice-id string, or '*', got {worker!r}")
            host = f.get("host")
            if ftype in HOST_FAULT_TYPES:
                if ftype == "kill_host":
                    host_ok = host == "*" \
                        or (isinstance(host, int) and host >= 0)
                else:  # partition: "*" would cut everyone from everyone
                    host_ok = isinstance(host, int) and host >= 0
                if not host_ok:
                    raise ValueError(
                        f"fault[{i}]: {ftype} needs a host group index "
                        f">= 0{' (or *)' if ftype == 'kill_host' else ''}, "
                        f"got {host!r}")
            elif ftype == "slow_save" and host is not None:
                # optionally host-scoped: stall the saver thread of every
                # worker on one host (worker matching is ignored then)
                if not (host == "*" or (isinstance(host, int) and host >= 0)):
                    raise ValueError(
                        f"fault[{i}]: slow_save host must be a host group "
                        f"index >= 0 or '*', got {host!r}")
            elif host is not None:
                raise ValueError(
                    f"fault[{i}]: 'host' is only valid on "
                    f"{'/'.join(HOST_FAULT_TYPES)}/slow_save, not {ftype}")
            phase = f.get("phase")
            if phase is not None:
                if ftype not in ("kill", "kill_host", "slow_save"):
                    raise ValueError(
                        f"fault[{i}]: 'phase' is only valid on "
                        f"kill/kill_host/slow_save, not {ftype}")
                if phase not in SAVE_PHASES:
                    raise ValueError(
                        f"fault[{i}]: unknown save phase {phase!r} "
                        f"(one of {', '.join(SAVE_PHASES)})")
            step = f.get("step")
            if not isinstance(step, int) or step < 0:
                raise ValueError(
                    f"fault[{i}]: step must be an int >= 0, got {step!r}")
            mode = f.get("mode", "truncate")
            if ftype == "corrupt_checkpoint" and mode not in CORRUPT_MODES:
                raise ValueError(
                    f"fault[{i}]: corrupt mode {mode!r} "
                    f"(one of {', '.join(CORRUPT_MODES)})")
            duration = f.get("duration_s", 3600.0)
            if not isinstance(duration, (int, float)) or duration < 0:
                raise ValueError(
                    f"fault[{i}]: duration_s must be >= 0, got {duration!r}")
            signame = f.get("signal", "KILL")
            try:
                signum = int(getattr(signal, f"SIG{signame}"))
            except (AttributeError, TypeError):
                raise ValueError(
                    f"fault[{i}]: unknown signal {signame!r}") from None
            faults.append(Fault(type=ftype, worker=worker, step=step,
                                mode=mode, duration_s=float(duration),
                                signum=signum, host=host, phase=phase,
                                model=model))
        return cls(faults)

    @classmethod
    def load(cls, spec: str) -> "FaultPlan":
        """From a file path or an inline JSON string."""
        text = spec
        if not spec.lstrip().startswith("{"):
            with open(spec, "r", encoding="utf-8") as fh:
                text = fh.read()
        return cls.parse(json.loads(text))

    def lint(self) -> List[str]:
        """Dry-run lint (no fault is executed): duplicate triggers and
        shadowed entries that can never fire."""
        problems: List[str] = []
        seen: Dict[tuple, int] = {}
        for i, f in enumerate(self.faults):
            key = (f.type, f.worker, f.host, f.step, f.phase, f.model)
            if key in seen:
                problems.append(
                    f"fault[{i}] duplicates fault[{seen[key]}]: "
                    f"{f.type} worker={f.worker} step={f.step}")
            seen[key] = i
        # a kill/stall at step S shadows any later-step fault on the same
        # worker within the same generation
        fatal = {}
        for i, f in enumerate(self.faults):
            if f.type in ("kill", "stall") and f.worker != "*":
                cur = fatal.get(f.worker)
                if cur is None or f.step < cur[1]:
                    fatal[f.worker] = (i, f.step)
        for i, f in enumerate(self.faults):
            if f.worker == "*" or f.type in ("kill", "stall"):
                continue
            hit = fatal.get(f.worker)
            if hit is not None and f.step > hit[1] \
                    and f.type in ("stall_heartbeat", "slow_save"):
                problems.append(
                    f"fault[{i}] ({f.type} worker={f.worker} step={f.step}) "
                    f"can never fire: fault[{hit[0]}] kills/stalls that "
                    f"worker at step {hit[1]} first")
        # same shadowing at host-group granularity: a kill_host/partition
        # at step S ends that host's generation — a later-step host fault
        # on the SAME host can never fire within it
        fatal_host = {}
        for i, f in enumerate(self.faults):
            if f.type in HOST_FAULT_TYPES and f.host != "*":
                cur = fatal_host.get(f.host)
                if cur is None or f.step < cur[1]:
                    fatal_host[f.host] = (i, f.step)
        for i, f in enumerate(self.faults):
            if f.type not in HOST_FAULT_TYPES or f.host == "*":
                continue
            hit = fatal_host.get(f.host)
            if hit is not None and i != hit[0] and f.step > hit[1]:
                problems.append(
                    f"fault[{i}] ({f.type} host={f.host} step={f.step}) "
                    f"can never fire: fault[{hit[0]}] kills/partitions that "
                    f"host at step {hit[1]} first")
        # serving shadows are same-sequence, not later-step (dispatchers
        # restart, so a crash does not end the timeline): an admission
        # rejection at request S means the response path for S is never
        # reached, and a crash_forward at dispatch S fires before a
        # slow_forward stall of the same dispatch ever starts
        by_key: Dict[tuple, int] = {}
        for i, f in enumerate(self.faults):
            if f.type in SERVING_FAULT_TYPES:
                by_key.setdefault((f.type, f.model, f.step), i)
        for i, f in enumerate(self.faults):
            if f.type == "drop_response":
                hit = by_key.get(("reject_admission", f.model, f.step))
                if hit is not None:
                    problems.append(
                        f"fault[{i}] (drop_response model={f.model} "
                        f"seq={f.step}) can never fire: fault[{hit}] "
                        f"rejects that request at admission first")
            elif f.type == "slow_forward":
                hit = by_key.get(("crash_forward", f.model, f.step))
                if hit is not None:
                    problems.append(
                        f"fault[{i}] (slow_forward model={f.model} "
                        f"seq={f.step}) can never fire: fault[{hit}] "
                        f"crashes that dispatch first")
        return problems

    def find(self, ftype: str, worker, step: int) -> Optional[Fault]:
        for f in self.faults:
            if f.type == ftype and f.matches(worker, step):
                return f
        return None


# -- process-wide activation -------------------------------------------------

_plan: Optional[FaultPlan] = None
if os.environ.get(ENV_VAR):
    _plan = FaultPlan.load(os.environ[ENV_VAR])

# this process's host group (failure domain); host-scoped faults are
# inert in processes that never learned theirs
_host: Optional[int] = None
if os.environ.get(ENV_HOST_VAR, "").isdigit():
    _host = int(os.environ[ENV_HOST_VAR])

# injectable for tests: on_step's kill must be observable without dying
_kill = os.kill
_sleep = time.sleep


def active_plan() -> Optional[FaultPlan]:
    return _plan


def set_plan(plan: Optional[FaultPlan]) -> None:
    """Activate a plan in-process (tests); ``None`` deactivates."""
    global _plan
    _plan = plan


def current_host() -> Optional[int]:
    return _host


def set_host(host: Optional[int]) -> None:
    """Declare this process's host group (``None`` = unknown)."""
    global _host
    _host = None if host is None else int(host)


# -- hooks (each begins with the single is-None check) -----------------------

def on_step(worker, step: int, host=None) -> None:
    """Call once per completed training iteration. May not return (kill),
    or may block for a long time (stall / partition)."""
    if _plan is None:
        return
    host = _host if host is None else host
    for f in _plan.faults:
        # phase-scoped kills belong to on_save_phase; skipping them here
        # (rather than taking the first kill match) keeps a plan that
        # lists both a phase kill and a plain kill for the same (worker,
        # step) firing both
        if f.phase is not None:
            continue
        if f.type == "kill" and f.matches(worker, step):
            _kill(os.getpid(), f.signum)
            return
        if f.type == "kill_host" and f.matches_host(host, step):
            _kill(os.getpid(), f.signum)
            return
    f = _plan.find("stall", worker, step)
    if f is not None:
        _sleep(f.duration_s)
        return
    # partition: this host is cut off — a collective across the boundary
    # can never complete, so the step blocks while (background)
    # heartbeats stay alive. Sticky from the configured step onward.
    for f in _plan.faults:
        if f.type == "partition" and host is not None and f.host == host \
                and int(step) >= int(f.step):
            _sleep(f.duration_s)
            return


def on_save_phase(worker, step: int, phase: str, host=None) -> None:
    """Call at each phase of the checkpoint commit protocol
    (``pre_write`` → own shard about to be written, ``mid_shard`` → own
    shard landed / model write not finalized, ``pre_stamp`` → everything
    finalized, commit stamp not yet written). Applies phase-scoped kills
    (the torn-async-save matrix) and ``slow_save`` stalls (a slow
    filesystem; fires at ``pre_write`` unless the fault names a phase)."""
    if _plan is None:
        return
    host = _host if host is None else host
    for f in _plan.faults:
        if f.type == "kill" and f.phase == phase and f.matches(worker, step):
            _kill(os.getpid(), f.signum)
            return
        if f.type == "kill_host" and f.phase == phase \
                and f.matches_host(host, step):
            _kill(os.getpid(), f.signum)
            return
        if f.type == "slow_save" and (f.phase or "pre_write") == phase:
            # a host field scopes the stall to that host group (worker
            # matching is ignored then — the default worker "*" would
            # otherwise stall everyone)
            hit = f.matches_host(host, step) if f.host is not None \
                else f.matches(worker, step)
            if hit:
                _sleep(f.duration_s)


def partition_active(host_a, host_b, seq: int) -> bool:
    """Are host groups ``a`` and ``b`` separated at sequence/step
    ``seq``? True when a planned partition has cut either side off."""
    if _plan is None or host_a is None or host_b is None \
            or host_a == host_b:
        return False
    for f in _plan.faults:
        if f.type == "partition" and int(seq) >= int(f.step) \
                and f.host in (host_a, host_b):
            return True
    return False


def on_heartbeat(worker, step: int) -> bool:
    """True → emit the heartbeat; False → suppress it (zombie worker).
    Suppression is sticky from the configured step onward — a stalled
    heartbeat does not resume."""
    if _plan is None:
        return True
    for f in _plan.faults:
        if f.type == "stall_heartbeat" \
                and (f.worker == "*" or f.worker == worker) \
                and int(step) >= int(f.step):
            return False
    return True


def on_checkpoint_saved(worker, step: int, directory: str) -> None:
    """Call right after a checkpoint at ``step`` commits under
    ``directory``; applies any planned corruption to the files just
    written. The model checkpoint is a WORLD-level artifact written by
    whichever rank is 0 when step ``step`` commits, so the fault's
    ``worker`` field is ignored here — matching on it would make a
    fault targeting a non-rank-0 slot silently never fire."""
    if _plan is None:
        return
    for f in _plan.faults:
        if f.type == "corrupt_checkpoint" and int(step) == int(f.step):
            corrupt_checkpoint(directory, mode=f.mode)
            return


def on_dcn_send(worker, seq: int, frame: bytes,
                host=None) -> List[bytes]:
    """Transform one outbound DCN frame: ``[]`` drops it, two copies
    duplicate it, ``[frame]`` passes through. ``host`` is accepted for
    call symmetry with :func:`on_dcn_recv`; a partition is enforced at
    the RECEIVER, where the cut is destination-aware — a sender cannot
    know which of its (possibly fanned-out) recipients sit across the
    boundary, and a blanket sender-side drop would sever intra-host
    links the partition model defines as uncut."""
    if _plan is None:
        return [frame]
    if _plan.find("drop_dcn", worker, seq) is not None:
        return []
    if _plan.find("duplicate_dcn", worker, seq) is not None:
        return [frame, frame]
    return [frame]


def on_dcn_recv(worker, seq: int, frame_host=None, host=None) -> bool:
    """True → deliver the inbound frame; False → drop it (the sender is
    on the far side of an active partition). Covers the direction
    ``on_dcn_send`` cannot: frames already in flight from a peer the
    partition has since cut off."""
    if _plan is None:
        return True
    host = _host if host is None else host
    return not partition_active(host, frame_host, seq)


def on_forward(model: str, seq: int) -> None:
    """Call once per dispatched forward of serving ``model`` (dispatch
    sequence ``seq``). May raise :class:`InjectedDispatcherCrash`
    (``crash_forward`` — kills the dispatcher thread) or block for
    ``duration_s`` (``slow_forward``). A crash shadows a stall planned
    for the same dispatch."""
    if _plan is None:
        return
    for f in _plan.faults:
        if f.type == "crash_forward" and f.matches_model(model, seq):
            raise InjectedDispatcherCrash(
                f"injected crash_forward: {model} forward #{seq}")
    for f in _plan.faults:
        if f.type == "slow_forward" and f.matches_model(model, seq):
            _sleep(f.duration_s)
            return


def on_admission(model: str, seq: int) -> bool:
    """True → admit request ``seq`` of ``model``; False → the front-end
    sheds it with 429 + ``Retry-After`` (``reject_admission``: a
    simulated overload the client's retry budget must absorb)."""
    if _plan is None:
        return True
    for f in _plan.faults:
        if f.type == "reject_admission" and f.matches_model(model, seq):
            return False
    return True


def on_response(model: str, seq: int) -> bool:
    """True → write the response for request ``seq``; False → the
    front-end severs the connection after doing the work
    (``drop_response``: the network ate the answer — the client must
    reconnect and retry)."""
    if _plan is None:
        return True
    for f in _plan.faults:
        if f.type == "drop_response" and f.matches_model(model, seq):
            return False
    return True


# -- shared corruption implementation ---------------------------------------

def corrupt_checkpoint(path: str, mode: str = "truncate") -> List[str]:
    """Damage a checkpoint on disk; returns the files touched.

    ``path`` may be a single file (zip checkpoint) or a directory (an
    orbax step dir) — directories are walked and every regular file
    is damaged, so the restore cannot quietly succeed off an
    untouched shard. Modes: ``truncate`` (keep the first half),
    ``garbage`` (overwrite the middle with 0xFF), ``delete`` (unlink).
    """
    if mode not in CORRUPT_MODES:
        raise ValueError(f"unknown corrupt mode {mode!r}")
    targets: List[str] = []
    if os.path.isdir(path):
        for root, _dirs, files in os.walk(path):
            targets.extend(os.path.join(root, f) for f in sorted(files))
    elif os.path.exists(path):
        targets.append(path)
    else:
        raise FileNotFoundError(f"no checkpoint at {path}")
    touched = []
    for t in targets:
        if mode == "delete":
            os.unlink(t)
            touched.append(t)
            continue
        size = os.path.getsize(t)
        with open(t, "r+b") as fh:
            if mode == "truncate":
                fh.truncate(max(0, size // 2))
            else:  # garbage
                fh.seek(max(0, size // 4))
                fh.write(b"\xff" * max(1, size // 2))
        touched.append(t)
    return touched
