"""Preemption handling: checkpoint-on-signal + resume.

The reference has **no** elastic/preemption story (SURVEY.md §5: worker
membership fixed at job start, fault tolerance delegated to Spark retry; the
survey explicitly calls for real preemption handling in the TPU build). TPU
VMs receive maintenance-event preemptions as SIGTERM with a grace window —
this module arms a handler that snapshots the model (params + updater state
+ training position) via ModelSerializer and lets training resume from the
snapshot after rescheduling.

The port's copy of the JAX package's ``util/preemption.py`` with the zip
backend; a signal that lands inside a training step is saved at the
step's end (see ``PreemptionHandler._handle``).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
from typing import Callable, Optional

log = logging.getLogger(__name__)

_ORBAX_WAITS = (
    "backend='orbax' comes with util/orbax_checkpoint.py, which the port "
    "brings with the multi-device slice (ROADMAP §A 8); use backend='zip'")


class PreemptionHandler:
    """Arms SIGTERM (and optionally SIGINT) to checkpoint a model.

    Usage::

        handler = PreemptionHandler(net, "ckpt/preempt.zip")
        handler.arm()
        net.fit(iterator, epochs=...)   # a SIGTERM mid-fit saves + raises
        handler.disarm()

    The saved zip is a normal ModelSerializer checkpoint plus a sidecar
    ``.state.json`` recording iteration/epoch, so ``resume()`` restores the
    exact training position.
    """

    def __init__(self, model, checkpoint_path: str,
                 signals=(signal.SIGTERM,), exit_after_save: bool = False,
                 on_preempt: Optional[Callable] = None,
                 backend: str = "zip",
                 async_saver=None, flush_grace_s: float = 30.0):
        if backend not in ("zip", "orbax"):
            raise ValueError("backend must be 'zip' or 'orbax'")
        if backend == "orbax":
            raise NotImplementedError(_ORBAX_WAITS)
        self.model = model
        self.checkpoint_path = str(checkpoint_path)
        self.signals = tuple(signals)
        self.exit_after_save = exit_after_save
        self.on_preempt = on_preempt
        self.backend = backend
        #: anything with ``flush(timeout) -> bool`` (e.g. an elastic
        #: AsyncCheckpointSession): an in-flight ASYNC checkpoint is
        #: flushed inside the SIGTERM grace window (after this handler's
        #: own immediate snapshot) — otherwise the preemption abandons a
        #: torn step that was seconds from committing
        self.async_saver = async_saver
        self.flush_grace_s = flush_grace_s
        self.flush_timed_out = threading.Event()
        self._previous = {}
        self.preempted = threading.Event()
        self.saved = threading.Event()
        self._hook = None

    # -- checkpointing ---------------------------------------------------
    def save(self) -> str:
        import zipfile

        from deeplearning4j_tpu_torch.util import model_serializer

        directory = os.path.dirname(self.checkpoint_path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        tmp = self.checkpoint_path + ".tmp"
        model_serializer.write_model(self.model, tmp)
        # training position travels INSIDE the zip so the whole checkpoint
        # is one atomic os.replace — no torn sidecar in the grace window
        with zipfile.ZipFile(tmp, "a") as z:
            z.writestr("preemption_state.json", json.dumps(
                {"iteration": getattr(self.model, "iteration", 0),
                 "epoch": getattr(self.model, "epoch", 0)}))
        os.replace(tmp, self.checkpoint_path)
        self.saved.set()
        return self.checkpoint_path

    @staticmethod
    def resume(checkpoint_path: str, device=None):
        """(model, state_dict) from a preemption checkpoint zip, the model
        on ``device`` (None: the card). An orbax directory waits for
        ``util/orbax_checkpoint.py`` (ROADMAP §A 8)."""
        import zipfile

        if os.path.isdir(str(checkpoint_path)):
            raise NotImplementedError(_ORBAX_WAITS)

        from deeplearning4j_tpu_torch.util import model_serializer

        model = model_serializer.restore_model(str(checkpoint_path),
                                               device=device)
        state = {"iteration": 0, "epoch": 0}
        with zipfile.ZipFile(str(checkpoint_path)) as z:
            if "preemption_state.json" in z.namelist():
                state = json.loads(z.read("preemption_state.json"))
        model.iteration = int(state.get("iteration", 0))
        model.epoch = int(state.get("epoch", 0))
        return model, state

    def rollback(self, device=None):
        """Restore the last good checkpoint this handler wrote — the
        watchdog-recovery flow: a raise-policy ``TrainingWatchdog``
        (``observe/health.py``) aborts a diverging ``fit()`` with
        ``WatchdogAlarm``, the caller catches it and rolls the model back
        to the pre-divergence snapshot. Returns ``(model, state)`` like
        :meth:`resume`.

        Strict about provenance: only a checkpoint THIS handler wrote
        qualifies — a file left at the same path by an earlier process is
        not a known-good snapshot of the current run (restore those
        explicitly with :meth:`resume`)."""
        if not self.saved.is_set():
            raise RuntimeError(
                f"this handler has not written a checkpoint to "
                f"{self.checkpoint_path}; rollback() only restores its own "
                f"snapshot — use resume() for a pre-existing file")
        return self.resume(self.checkpoint_path, device=device)

    def flush_async(self) -> bool:
        """Drain an in-flight async checkpoint under the bounded grace
        deadline (``flush_grace_s``). True when everything landed; on
        timeout the in-flight step stays torn (unstamped — never
        restorable, by the commit protocol) and ``flush_timed_out`` is
        set. The SIGTERM handler calls this AFTER taking its own
        snapshot — a hung flush must not burn the grace window before
        anything at all is saved."""
        if self.async_saver is None:
            return True
        ok = bool(self.async_saver.flush(timeout=self.flush_grace_s))
        if not ok:
            self.flush_timed_out.set()
            log.warning(
                "In-flight async checkpoint did not land within the "
                "%.1fs grace window; the torn step is unstamped and "
                "will never be restored", self.flush_grace_s)
        return ok

    # -- signal plumbing -------------------------------------------------
    def _handle(self, signum, frame):
        log.warning("Preemption signal %s: checkpointing to %s",
                    signum, self.checkpoint_path)
        self.preempted.set()
        if getattr(self.model, "in_step", False):
            # the signal landed inside a training step: between two of its
            # in-place updates the parameters are half updated, or the
            # iteration is not yet counted. Defer: the armed step-end hook
            # (or the caller via maybe_save_pending) saves at the step's end
            log.warning("Deferring preemption checkpoint to the end of the "
                        "training step")
        else:
            self.save()
        # own snapshot FIRST (fast, and safe even if the filesystem that
        # stalled the async save is the slow one), THEN spend what is
        # left of the grace window letting the overlapped save commit —
        # the reverse order could burn the whole window on a hung flush
        # and lose both checkpoints
        self.flush_async()
        if self.on_preempt is not None:
            self.on_preempt(self)
        if self.exit_after_save and self.saved.is_set():
            raise SystemExit(143)

    def maybe_save_pending(self) -> bool:
        """Complete a deferred preemption save; call at a step boundary."""
        if self.preempted.is_set() and not self.saved.is_set():
            self.save()
            if self.exit_after_save:
                raise SystemExit(143)
            return True
        return False

    def arm(self) -> "PreemptionHandler":
        if threading.current_thread() is not threading.main_thread():
            # signal.signal would raise a bare ValueError("signal only
            # works in main thread") — say what to do instead
            raise RuntimeError(
                "PreemptionHandler.arm() must be called from the main "
                "thread: CPython only delivers signal handlers there. "
                "From a worker/background thread, either arm the handler "
                "on the main thread before spawning, or supervise the "
                "training process externally with ElasticJobSupervisor "
                "(the multi-device slice, ROADMAP §A 8), which handles "
                "SIGKILL-style death no in-process handler can see")
        for s in self.signals:
            self._previous[s] = signal.signal(s, self._handle)
        # safe-point hook: complete deferred saves at the end of a step
        hooks = getattr(self.model, "step_end_hooks", None)
        if hooks is not None and self._hook is None:
            self._hook = self.maybe_save_pending
            hooks.append(self._hook)
        return self

    def disarm(self) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()
        hooks = getattr(self.model, "step_end_hooks", None)
        if hooks is not None and self._hook in hooks:
            hooks.remove(self._hook)
        self._hook = None

    def __enter__(self) -> "PreemptionHandler":
        return self.arm()

    def __exit__(self, *exc) -> None:
        self.disarm()
