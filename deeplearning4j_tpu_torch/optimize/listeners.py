"""Training listeners — the observer SPI every fit loop invokes.

Counterpart of ``deeplearning4j_tpu/optimize/listeners.py`` (reference
``optimize/listeners/``: ``ScoreIterationListener``,
``PerformanceListener.java:22`` (samples/sec, batches/sec ``:87-88``),
``EvaluativeListener.java:34``, ``CollectScoresIterationListener``,
``TimeIterationListener``, ``SleepyTrainingListener.java:28``,
``CheckpointListener.java:72`` (rotation: keepLast /
saveEveryNIterations)), with the same classes, messages and file names.

Listener protocol (duck-typed, as both networks' fit loops call it,
``nn/network_api.py``): ``iteration_done(model, iteration, epoch)``,
``on_epoch_start(model)``, ``on_epoch_end(model)``.

Reading ``model.score_`` waits for the device, so the throughput
listener reads it only when it prints. ``ParamAndGradientIterationListener``
computes every tensor's statistics on the network's device and reads them
back in one transfer per report. ``ProfilerListener`` records a
``torch.profiler`` window into a Chrome trace.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.train_step import to_host

log = logging.getLogger(__name__)


class TrainingListener:
    """Base (TrainingListener/IterationListener)."""

    def iteration_done(self, model, iteration: int, epoch: int) -> None:
        pass

    def on_epoch_start(self, model) -> None:
        pass

    def on_epoch_end(self, model) -> None:
        pass


class ScoreIterationListener(TrainingListener):
    """Log score every N iterations (ScoreIterationListener)."""

    def __init__(self, print_iterations: int = 10, printer: Callable = None):
        self.print_iterations = max(1, print_iterations)
        self.printer = printer or (lambda s: log.info(s))

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.print_iterations == 0:
            self.printer(f"Score at iteration {iteration} is {model.score_}")


class PerformanceListener(TrainingListener):
    """Throughput reporting (PerformanceListener.java:87-88)."""

    def __init__(self, frequency: int = 10, report_score: bool = False,
                 printer: Callable = None):
        self.frequency = max(1, frequency)
        self.report_score = report_score
        self.printer = printer or (lambda s: log.info(s))
        self._last_time: Optional[float] = None
        self._last_iter = 0
        self.last_samples_per_sec: Optional[float] = None
        self.last_batches_per_sec: Optional[float] = None

    def iteration_done(self, model, iteration, epoch):
        now = time.perf_counter()
        if self._last_time is None:
            self._last_time, self._last_iter = now, iteration
            return
        if iteration - self._last_iter >= self.frequency:
            dt = now - self._last_time
            batches = iteration - self._last_iter
            self.last_batches_per_sec = batches / dt
            batch_size = getattr(model, "last_batch_size", None)
            msg = (f"iteration {iteration}; {self.last_batches_per_sec:.1f} "
                   f"batches/sec")
            if batch_size:
                self.last_samples_per_sec = self.last_batches_per_sec * batch_size
                msg += f"; {self.last_samples_per_sec:.1f} samples/sec"
            if self.report_score:
                msg += f"; score {model.score_}"
            self.printer(msg)
            self._last_time, self._last_iter = now, iteration


class CollectScoresIterationListener(TrainingListener):
    """Collect (iteration, score) pairs (CollectScoresIterationListener)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[Tuple[int, float]] = []

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, model.score_))

    def export_scores(self, path, delimiter: str = ",") -> None:
        """Write collected (iteration, score) pairs
        (``CollectScoresIterationListener.exportScores``)."""
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(f"iteration{delimiter}score\n")
            for it, sc in self.scores:
                fh.write(f"{it}{delimiter}{sc}\n")


class TimeIterationListener(TrainingListener):
    """ETA logging over a planned iteration count (TimeIterationListener)."""

    def __init__(self, total_iterations: int, frequency: int = 10,
                 printer: Callable = None):
        self.total = total_iterations
        self.frequency = max(1, frequency)
        self.printer = printer or (lambda s: log.info(s))
        self.start = time.time()

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.frequency == 0 and iteration > 0:
            elapsed = time.time() - self.start
            remaining = elapsed / iteration * max(self.total - iteration, 0)
            self.printer(f"iteration {iteration}/{self.total}; "
                         f"ETA {remaining:.0f}s")


class EvaluativeListener(TrainingListener):
    """Periodic evaluation on a held-out iterator (EvaluativeListener.java:34).

    By default runs classification ``Evaluation`` via ``model.evaluate``;
    pass ``evaluations`` — factories of evaluators (EvaluationCalibration,
    ROC, …: anything with ``eval(labels, predictions, mask=…)``) — for the
    reference's ``evalWith(IEvaluation...)`` mode: each window builds fresh
    evaluators and streams the held-out predictions, read to the host,
    through all of them.
    """

    def __init__(self, iterator, frequency: int = 1, unit: str = "epoch",
                 printer: Callable = None, evaluations=None):
        if unit not in ("epoch", "iteration"):
            raise ValueError("unit must be 'epoch' or 'iteration'")
        self.iterator = iterator
        self.frequency = max(1, frequency)
        self.unit = unit
        self.printer = printer or (lambda s: log.info(s))
        self.eval_factories = list(evaluations) if evaluations else None
        self.evaluations: List = []
        self._callback = None

    def _evaluate(self, model):
        if self.eval_factories is None:
            e = model.evaluate(self.iterator)
            self.evaluations.append(e)
            self.printer(
                f"Evaluation: accuracy={e.accuracy():.4f} f1={e.f1():.4f}")
            return
        import inspect

        evs = [f() for f in self.eval_factories]
        # keyword support is read up front: a catch-and-retry would feed an
        # evaluator that failed half way twice
        takes_mask = []
        for e in evs:
            try:
                takes_mask.append(
                    "mask" in inspect.signature(e.eval).parameters)
            except (TypeError, ValueError):
                takes_mask.append(False)
        try:
            out_params = inspect.signature(model.output).parameters
        except (TypeError, ValueError):
            out_params = {}
        it = self.iterator
        if hasattr(it, "reset"):
            it.reset()
        for ds in it:
            kw = {}
            if ds.features_mask is not None and "mask" in out_params:
                kw["mask"] = ds.features_mask  # padded steps stay masked
            preds = to_host(model.output(ds.features, **kw))
            labels = to_host(ds.labels)
            lmask = None if ds.labels_mask is None else to_host(ds.labels_mask)
            for e, tm in zip(evs, takes_mask):
                if tm:
                    e.eval(labels, preds, mask=lmask)
                else:
                    e.eval(labels, preds)
        self.evaluations.append(evs)  # always a list: stable element type
        parts = [e.stats() if hasattr(e, "stats") else repr(e) for e in evs]
        self.printer("Evaluation: " + "; ".join(parts))

    def set_callback(self, callback) -> None:
        """Post-evaluation hook (``callbacks/EvaluationCallback.java``):
        ``callback(listener, evaluations, model)`` after each window.
        ``evaluations`` is always a LIST of evaluator objects (the
        reference passes an IEvaluation[]), in both modes."""
        self._callback = callback

    def iteration_done(self, model, iteration, epoch):
        if self.unit == "iteration" and iteration % self.frequency == 0:
            self._evaluate(model)
            self._fire_callback(model)

    def on_epoch_end(self, model):
        # model.epoch is already the completed-epoch count here (the fit
        # loop increments it before on_epoch_end)
        if self.unit == "epoch" and model.epoch % self.frequency == 0:
            self._evaluate(model)
            self._fire_callback(model)

    def _fire_callback(self, model) -> None:
        if self._callback is not None:
            last = self.evaluations[-1]
            self._callback(self, last if isinstance(last, list) else [last], model)


class ComposableIterationListener(TrainingListener):
    """Bundles several listeners behind one handle
    (``ComposableIterationListener.java``)."""

    def __init__(self, *listeners):
        if len(listeners) == 1 and isinstance(listeners[0], (list, tuple)):
            listeners = tuple(listeners[0])
        self.listeners = list(listeners)

    def iteration_done(self, model, iteration, epoch):
        for l in self.listeners:
            l.iteration_done(model, iteration, epoch)

    def on_epoch_start(self, model):
        for l in self.listeners:
            l.on_epoch_start(model)

    def on_epoch_end(self, model):
        for l in self.listeners:
            l.on_epoch_end(model)


class ParamAndGradientIterationListener(TrainingListener):
    """Periodic per-parameter AND per-gradient statistics
    (``ParamAndGradientIterationListener.java``): mean magnitude (and
    optionally min/max) of every parameter tensor, and of its gradient,
    every N iterations, written through ``printer`` as tab-separated
    lines.

    Gradient columns need ``gradient_batch`` — a DataSet (or ``(x, y)``
    tuple) the gradients are computed on at each window via
    ``compute_gradient_and_score``, as in the JAX package (whose step
    never keeps its gradients). Without ``gradient_batch`` only parameter
    columns are emitted. The statistics of every tensor, and the score,
    are computed where the tensors lie and read back in one transfer."""

    def __init__(self, iterations: int = 1, print_header: bool = True,
                 print_mean: bool = True, print_min_max: bool = False,
                 gradient_batch=None, printer: Callable = None):
        self.iterations = max(1, iterations)
        self.print_header = print_header
        self.print_mean = print_mean
        self.print_min_max = print_min_max
        self.gradient_batch = gradient_batch
        self.printer = printer or (lambda s: log.info(s))
        self._header_done = False

    def _param_items(self, model):
        if hasattr(model, "param_table"):
            return sorted(model.param_table().items())
        return []

    def _gradient_items(self, model):
        if self.gradient_batch is None:
            return []
        ds = self.gradient_batch
        if isinstance(ds, tuple):
            x, y = ds
            grads, _ = model.compute_gradient_and_score(x, y)
        else:
            grads, _ = model.compute_gradient_and_score(
                ds.features, ds.labels,
                features_mask=ds.features_mask, labels_mask=ds.labels_mask)
        # keyed by layer index (sequential) or vertex name (graph), each
        # layer's names sorted: the JAX package's column order
        return [(f"{k}_{pname}", grads[k][pname])
                for k in sorted(grads) for pname in sorted(grads[k])]

    def _stat_cols(self, key, suffix=""):
        cols = []
        if self.print_mean:
            cols.append(f"{key}_{suffix}mean_mag")
        if self.print_min_max:
            cols += [f"{key}_{suffix}min", f"{key}_{suffix}max"]
        return cols

    def _stat_tensors(self, t: torch.Tensor) -> List[torch.Tensor]:
        a = t.detach()
        a = a.float() if a.dtype in (torch.bfloat16, torch.float16) else a
        vals = []
        if self.print_mean:
            vals.append(a.abs().mean())
        if self.print_min_max:
            vals += [a.min(), a.max()]
        return [v.double() for v in vals]

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.iterations != 0:
            return
        items = self._param_items(model)
        if not items:
            return
        grad_items = self._gradient_items(model)
        if self.print_header and not self._header_done:
            cols = ["iteration", "score"]
            for key, _ in items:
                cols += self._stat_cols(key)
            for key, _ in grad_items:
                cols += self._stat_cols(key, "grad_")
            self.printer("\t".join(cols))
            self._header_done = True
        stats = [s for _, t in items + grad_items for s in self._stat_tensors(t)]
        device = items[0][1].device
        score = getattr(model, "_score", None)
        if isinstance(score, torch.Tensor):  # read with the statistics
            stats.insert(0, score.detach().to(device, torch.float64))
        host = torch.stack(stats).cpu().tolist() if stats else []
        if isinstance(score, torch.Tensor):
            score, host = host[0], host[1:]
        else:
            score = model.score_
        vals = [str(iteration), f"{score:.6f}"] + [f"{v:.6e}" for v in host]
        self.printer("\t".join(vals))


class SleepyTrainingListener(TrainingListener):
    """Latency injection for debugging/fault testing
    (SleepyTrainingListener.java:28)."""

    def __init__(self, timer_iteration_ms: float = 0.0, timer_epoch_ms: float = 0.0):
        self.timer_iteration_ms = timer_iteration_ms
        self.timer_epoch_ms = timer_epoch_ms

    def iteration_done(self, model, iteration, epoch):
        if self.timer_iteration_ms > 0:
            time.sleep(self.timer_iteration_ms / 1e3)

    def on_epoch_end(self, model):
        if self.timer_epoch_ms > 0:
            time.sleep(self.timer_epoch_ms / 1e3)


class CheckpointListener(TrainingListener):
    """Periodic checkpointing with rotation (CheckpointListener.java:72-144).

    ``keep_last=n`` keeps the newest n checkpoints; ``keep_every_n`` also
    retains every n-th (keepLastAndEvery). Save cadence:
    ``save_every_n_iterations`` or ``save_every_n_epochs``. Checkpoints are
    the port's model zips (``util/model_serializer.py``), which the JAX
    package reads too.
    """

    def __init__(self, model_dir, *, save_every_n_iterations: Optional[int] = None,
                 save_every_n_epochs: Optional[int] = None,
                 keep_last: Optional[int] = None,
                 keep_every_n: Optional[int] = None,
                 save_updater: bool = True):
        if save_every_n_iterations is None and save_every_n_epochs is None:
            raise ValueError("set save_every_n_iterations or save_every_n_epochs")
        if keep_last is not None and keep_last < 1:
            raise ValueError("keep_last must be >= 1 (or None to keep all)")
        self.dir = Path(model_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.save_every_n_iterations = save_every_n_iterations
        self.save_every_n_epochs = save_every_n_epochs
        self.keep_last = keep_last
        self.keep_every_n = keep_every_n
        self.save_updater = save_updater
        self._counter = 0

    # -- persistence ---------------------------------------------------------
    def _save(self, model, iteration, epoch):
        from deeplearning4j_tpu_torch.util.model_serializer import write_model
        self._counter += 1
        name = f"checkpoint_{self._counter}_iter_{iteration}_epoch_{epoch}.zip"
        write_model(model, self.dir / name, save_updater=self.save_updater)
        self._rotate()

    def _checkpoints(self) -> List[Path]:
        return sorted(self.dir.glob("checkpoint_*.zip"),
                      key=lambda p: int(p.name.split("_")[1]))

    def _rotate(self):
        if self.keep_last is None:
            return
        for p in self._checkpoints()[:-self.keep_last]:
            num = int(p.name.split("_")[1])
            if self.keep_every_n and num % self.keep_every_n == 0:
                continue
            p.unlink()

    def last_checkpoint(self) -> Optional[Path]:
        cps = self._checkpoints()
        return cps[-1] if cps else None

    # -- static loaders (CheckpointListener.loadCheckpointMLN:…) ------------
    @staticmethod
    def available_checkpoints(model_dir) -> List[dict]:
        """List saved checkpoints with parsed (number, iteration, epoch)
        (``CheckpointListener.availableCheckpoints``)."""
        out = []
        for p in sorted(Path(model_dir).glob("checkpoint_*.zip"),
                        key=lambda q: int(q.name.split("_")[1])):
            parts = p.stem.split("_")
            out.append({"number": int(parts[1]), "iteration": int(parts[3]),
                        "epoch": int(parts[5]), "path": p})
        return out

    @staticmethod
    def load_checkpoint(model_dir, number: Optional[int] = None, device=None):
        """Restore a checkpointed model — the newest, or checkpoint
        ``number`` (``loadCheckpointMLN`` / ``loadLastCheckpointMLN``) — on
        ``device``: ``cuda`` unless the caller passes ``"cpu"``."""
        from deeplearning4j_tpu_torch.util.model_serializer import restore_model
        cps = CheckpointListener.available_checkpoints(model_dir)
        if not cps:
            raise FileNotFoundError(f"no checkpoints under {model_dir}")
        if number is None:
            return restore_model(cps[-1]["path"], device=device)
        for c in cps:
            if c["number"] == number:
                return restore_model(c["path"], device=device)
        raise FileNotFoundError(
            f"no checkpoint number {number} under {model_dir} "
            f"(available: {[c['number'] for c in cps]})")

    # -- hooks ---------------------------------------------------------------
    def iteration_done(self, model, iteration, epoch):
        if (self.save_every_n_iterations and
                iteration % self.save_every_n_iterations == 0):
            self._save(model, iteration, epoch)

    def on_epoch_end(self, model):
        # model.epoch is already the completed-epoch count here
        ep = model.epoch
        if self.save_every_n_epochs and ep % self.save_every_n_epochs == 0:
            self._save(model, model.iteration, ep)


class OneTimeLogger:
    """Deduplicating logger (``util/OneTimeLogger.java``): each distinct
    message is emitted once per process; repeats are dropped."""

    _seen = set()

    @classmethod
    def warn(cls, message: str, *args) -> None:
        cls._log(logging.WARNING, message, args)

    @classmethod
    def info(cls, message: str, *args) -> None:
        cls._log(logging.INFO, message, args)

    @classmethod
    def _log(cls, level, message, args) -> None:
        key = (level, message)
        if key in cls._seen:
            return
        cls._seen.add(key)
        log.log(level, message, *args)

    @classmethod
    def reset(cls) -> None:
        cls._seen.clear()


class ProfilerListener(TrainingListener):
    """Records a ``torch.profiler`` window over training iterations and
    writes it as a Chrome trace (``chrome://tracing`` / Perfetto) into
    ``log_dir`` (the JAX package records a ``jax.profiler`` trace there).

    Starts at iteration ``start_iteration`` and stops ``n_iterations``
    later; ``trace_path`` is the file written. Before it stops it waits
    for the model's device, so that the window holds the device work of
    its steps and not only their launches. One-shot: re-arm with
    ``reset()``.
    """

    def __init__(self, log_dir: str, start_iteration: int = 3,
                 n_iterations: int = 5):
        self.log_dir = str(log_dir)
        self.start_iteration = int(start_iteration)
        self.n_iterations = max(1, int(n_iterations))
        self._active = False
        self._done = False
        self._stop_at = None
        self._prof = None
        self.trace_path: Optional[str] = None
        self.last_error = None

    def reset(self) -> None:
        self._done = False

    def _start(self, model):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if getattr(model, "device", torch.device("cpu")).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        try:
            self._prof = profile(activities=acts)
            self._prof.start()
            self._active = True
        except Exception as e:  # a profiler the platform refuses
            self.last_error = f"{type(e).__name__}: {e}"
            self._prof = None
            self._done = True

    def _stop(self, model=None):
        device = getattr(model, "device", None)
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        try:
            self._prof.stop()
            Path(self.log_dir).mkdir(parents=True, exist_ok=True)
            path = Path(self.log_dir) / f"trace_iter_{self.start_iteration}.json"
            self._prof.export_chrome_trace(str(path))
            self.trace_path = str(path)
        except Exception as e:
            self.last_error = f"{type(e).__name__}: {e}"
        self._active = False
        self._done = True

    def iteration_done(self, model, iteration, epoch):
        # the iteration counter is cumulative across fit calls and epochs,
        # so the window spans them; an epoch boundary does NOT close it
        # (single-batch fit loops end an epoch every step)
        if self._done:
            return
        if not self._active and iteration >= self.start_iteration:
            self._start(model)
            self._stop_at = iteration + self.n_iterations
        elif self._active and iteration >= self._stop_at:
            self._stop(model)

    def close(self, model=None) -> None:
        """Stop now if the window is still open (training ended before
        ``n_iterations`` more steps ran)."""
        if self._active:
            self._stop(model)
