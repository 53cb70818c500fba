"""TraceListener — the TrainingListener → observe bridge.

Attach it like any other listener and every ``fit()`` in the framework
(MultiLayerNetwork, ComputationGraph, ParallelWrapper — anything that
fires ``iteration_done``) records per-iteration spans and exports
training metrics through the same Prometheus registry the serving tier
scrapes at ``/metrics`` — the role DL4J's PerformanceListener +
StatsListener play for the training UI, landed in the unified pipeline.

Spans are recorded AFTER the fact (the iteration window is closed inside
``iteration_done``), so the listener owns no open span state: a peer
listener throwing mid-iteration, or training aborting, can never leave a
dangling span behind.

Exported series (all labeled ``model``):

- ``training_steps_total``            counter
- ``training_step_seconds``           histogram (iteration wall time)
- ``training_examples_total``         counter   (rows seen)
- ``training_epochs_total``           counter
- ``training_score``                  gauge     (last loss; device sync!)
- ``training_compile_total``          counter   (compiles attributed to
  training steps, sampled from the active tracer's compile counter: in
  the port a ``kernel_build``, an ``nvcc`` build at a kernel's first use)
- ``training_last_batch_size``        gauge
- ``training_transfer_bytes_total``   counter   (host→device batch payload,
  sampled from the model's ``transfer_bytes`` accumulator)

The port's copy of the JAX package's ``observe/listener.py``: the same
series, labels and spans.
"""

from __future__ import annotations

import time
from typing import Optional

from deeplearning4j_tpu_torch.observe import trace as _trace
from deeplearning4j_tpu_torch.observe.metrics import (MetricsRegistry,
                                                default_registry)
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener

# step-time oriented buckets: 1ms … 60s (training steps dwarf the serving
# latency defaults)
STEP_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class TraceListener(TrainingListener):
    """Record per-iteration spans + training metrics from any fit loop.

    ``tracer=None`` binds to the ACTIVE tracer at each call (so enabling
    tracing mid-run starts recording without re-wiring listeners);
    ``metrics=None`` uses the process-wide default registry — the one the
    serving/KNN/UI servers already expose.
    ``collect_score=False`` skips the ``training_score`` gauge and its
    device sync for throughput-critical runs.
    """

    def __init__(self, tracer: Optional[_trace.Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 model_name: str = "default", *,
                 collect_score: bool = True):
        self._tracer = tracer
        self.model_name = model_name
        self.collect_score = collect_score
        self.metrics = metrics if metrics is not None else default_registry()
        m = self.metrics
        self._m_steps = m.counter(
            "training_steps_total", "Completed training iterations",
            ("model",))
        self._m_step_time = m.histogram(
            "training_step_seconds", "Training iteration wall time",
            ("model",), buckets=STEP_BUCKETS)
        self._m_examples = m.counter(
            "training_examples_total", "Training examples consumed",
            ("model",))
        self._m_epochs = m.counter(
            "training_epochs_total", "Completed training epochs", ("model",))
        self._m_score = m.gauge(
            "training_score", "Last training loss/score", ("model",))
        self._m_compiles = m.counter(
            "training_compile_total",
            "Kernel builds observed during training iterations", ("model",))
        self._m_batch = m.gauge(
            "training_last_batch_size", "Rows in the last training batch",
            ("model",))
        self._m_transfer = m.counter(
            "training_transfer_bytes_total",
            "Host to device bytes shipped with training batches", ("model",))
        self._t_last: Optional[int] = None
        self._compiles_seen: Optional[int] = None
        self._transfer_seen: Optional[int] = None

    # ------------------------------------------------------------- helpers
    def _active(self) -> Optional[_trace.Tracer]:
        return self._tracer if self._tracer is not None \
            else _trace.get_active_tracer()

    # ------------------------------------------------------ listener hooks
    def on_epoch_start(self, model) -> None:
        # (re)anchor the window so the first iteration of each epoch does
        # not absorb between-epoch work (evaluation, checkpointing)
        self._t_last = time.perf_counter_ns()
        # baseline the compile counter BEFORE the first step so step-0's
        # compile counts as "observed during training"
        if self._compiles_seen is None:
            tracer = self._active()
            if tracer is not None:
                self._compiles_seen = tracer.thread_compile_count()
        # likewise baseline the model's transfer accumulator so bytes shipped
        # before this listener attached are not replayed into the counter
        if self._transfer_seen is None:
            total = getattr(model, "transfer_bytes", None)
            if total is not None:
                self._transfer_seen = int(total)

    def iteration_done(self, model, iteration: int, epoch: int) -> None:
        now = time.perf_counter_ns()
        tracer = self._active()
        batch = int(getattr(model, "last_batch_size", 0) or 0)
        self._m_steps.inc(model=self.model_name)
        if batch:
            self._m_examples.inc(batch, model=self.model_name)
            self._m_batch.set(batch, model=self.model_name)
        if self.collect_score:
            try:
                self._m_score.set(float(model.score_), model=self.model_name)
            except Exception:  # noqa: BLE001 - score may be unset/deferred
                pass
        if tracer is not None:
            # recompiles since the last window, counted PER THREAD: only
            # compiles triggered on this training thread attribute to
            # training (a serving dispatcher compiling a new batch bucket
            # elsewhere in the process must not trip the alarm)
            count = tracer.thread_compile_count()
            if self._compiles_seen is None:
                self._compiles_seen = count
            elif count > self._compiles_seen:
                self._m_compiles.inc(count - self._compiles_seen,
                                     model=self.model_name)
                self._compiles_seen = count
        # transfer bytes: the fit loops accumulate model.transfer_bytes per
        # batch; export the delta since the last window (baselined at epoch
        # start so history before this listener attached is not replayed)
        total = getattr(model, "transfer_bytes", None)
        if total is not None:
            total = int(total)
            if self._transfer_seen is None:
                self._transfer_seen = 0
            if total > self._transfer_seen:
                self._m_transfer.inc(total - self._transfer_seen,
                                     model=self.model_name)
                self._transfer_seen = total
        if self._t_last is not None:
            dt_s = (now - self._t_last) / 1e9
            self._m_step_time.observe(dt_s, model=self.model_name)
            if tracer is not None:
                tracer.record(
                    "train_iteration", self._t_last, now, category="train",
                    attrs={"iteration": iteration, "epoch": epoch,
                           "batch": batch, "model": self.model_name})
        self._t_last = now

    def on_epoch_end(self, model) -> None:
        self._m_epochs.inc(model=self.model_name)
        self._t_last = None  # next window opens at on_epoch_start
