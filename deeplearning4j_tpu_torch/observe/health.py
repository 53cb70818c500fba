"""Health watchdogs: training divergence detection + serving probes.

The detection half of the observability loop. Training side:
:class:`TrainingWatchdog` is a TrainingListener (attach it like any other
listener — or through :func:`attach_observability`, the one attachment
path it shares with ``TraceListener``) that notices a run going bad while
it is still cheap to stop:

- NaN/Inf loss the step it appears;
- NaN/Inf parameters (periodic scan — a device sync, so off by default);
- gradient-norm explosion/vanishing against an EWMA baseline (norms come
  from a ``gradient_batch`` probe, the ``ParamAndGradientIterationListener``
  technique, or are pushed by an outer loop via
  :meth:`TrainingWatchdog.observe_gradient_norm`);
- loss divergence: score strictly rising for K consecutive windows;
- step-time stall: an iteration taking ``stall_factor``× the rolling
  median (injectable clock — tests drive it without sleeps).

Each check carries a configurable action policy — ``"log"`` (structured
log with trace correlation), ``"raise"`` (:class:`WatchdogAlarm`, which
``EarlyStoppingTrainer`` converts into an ``Error`` termination and the
``util/preemption.py`` rollback flow catches to restore the last good
checkpoint), or a callback.

Serving side: :class:`ServingHealth` folds ``ParallelInference``
dispatcher liveness, ``AdmissionController`` saturation/drain and
``ModelRegistry`` state into one :class:`HealthReport`, served by
``ModelServer`` on ``GET /livez`` (``?verbose=1`` for the full check
list) — the condensed answer "is this process worth keeping alive".

The port's copy of the JAX package's ``observe/health.py``. On the card
each check reads the host once: the parameter scan reduces every
tensor's finiteness on the device and reads the flags together, and the
gradient probe sums each tensor's squares in f64 on the device and reads
the total; the score check reads ``score_`` as the reference's does.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from statistics import median
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.observe import log as _slog
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener

log = logging.getLogger(__name__)

def _all_finite(arrays) -> List[bool]:
    """Whether each array is finite everywhere: one flag a tensor reduced
    where it lies, every flag read in one transfer."""
    flags = [torch.isfinite(torch.as_tensor(a)).all() for a in arrays]
    return torch.stack([f.to(flags[0].device) for f in flags]).tolist()


def _sum_squares_f64(arrays) -> float:
    """Σ a² over every entry of every array in f64, summed where the
    arrays lie and read once."""
    parts = [torch.as_tensor(a).detach().double().square().sum() for a in arrays]
    if not parts:
        return 0.0
    return float(torch.stack([p.to(parts[0].device) for p in parts]).sum())


_CHECKS = ("nan_loss", "nan_params", "nan_gradient", "gradient_explosion",
           "gradient_vanishing", "loss_divergence", "step_stall")


class HealthEvent:
    """One watchdog finding."""

    __slots__ = ("check", "message", "iteration", "epoch", "value",
                 "model_name", "ts")

    def __init__(self, check: str, message: str, iteration: int, epoch: int,
                 value: float, model_name: str):
        self.check = check
        self.message = message
        self.iteration = iteration
        self.epoch = epoch
        self.value = value
        self.model_name = model_name
        self.ts = time.time()

    def to_dict(self) -> Dict[str, Any]:
        return {"check": self.check, "message": self.message,
                "iteration": self.iteration, "epoch": self.epoch,
                "value": self.value, "model": self.model_name,
                "ts": self.ts}

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"HealthEvent({self.check}, iter={self.iteration})"


class WatchdogAlarm(RuntimeError):
    """Raised by a ``"raise"``-policy check. Carries the event; propagates
    out of ``fit()`` so an outer loop (EarlyStopping, the preemption
    rollback flow) can stop the run and recover."""

    def __init__(self, event: HealthEvent):
        super().__init__(f"{event.check} at iteration {event.iteration}: "
                         f"{event.message}")
        self.event = event


class TrainingWatchdog(TrainingListener):
    """Divergence watchdog for any fit loop.

    ``action`` is the default policy (``"log"`` | ``"raise"`` | a callable
    taking the :class:`HealthEvent`); ``actions`` overrides it per check
    name (see module docstring for the check names). Every event is also
    appended to ``self.events`` and counted in
    ``watchdog_events_total{model,check}`` when ``metrics`` is given.

    ``clock`` returns seconds (monotonic); inject a manual one to test
    stall detection deterministically. ``gradient_batch`` — a DataSet or
    ``(x, y)`` tuple — enables the gradient-norm checks via a probe
    ``compute_gradient_and_score`` every ``check_gradients_every``
    iterations (device work: size the probe batch accordingly).
    """

    def __init__(self, *, model_name: str = "default",
                 action="log", actions: Optional[Dict[str, Any]] = None,
                 metrics=None,
                 check_params_every: int = 0,
                 gradient_batch=None, check_gradients_every: int = 1,
                 grad_ewma_alpha: float = 0.1,
                 grad_explode_factor: float = 50.0,
                 grad_vanish_factor: float = 1e-4,
                 grad_warmup: int = 5,
                 divergence_windows: int = 5,
                 stall_factor: float = 10.0, stall_window: int = 16,
                 stall_min_history: int = 5,
                 clock: Callable[[], float] = time.perf_counter):
        unknown = set(actions or ()) - set(_CHECKS)
        if unknown:
            raise ValueError(f"unknown watchdog checks {sorted(unknown)}; "
                             f"known: {_CHECKS}")
        self.model_name = model_name
        self.action = action
        self.actions = dict(actions or {})
        self.check_params_every = int(check_params_every)
        self.gradient_batch = gradient_batch
        self.check_gradients_every = max(1, int(check_gradients_every))
        self.grad_ewma_alpha = float(grad_ewma_alpha)
        self.grad_explode_factor = float(grad_explode_factor)
        self.grad_vanish_factor = float(grad_vanish_factor)
        self.grad_warmup = max(1, int(grad_warmup))
        self.divergence_windows = max(1, int(divergence_windows))
        self.stall_factor = float(stall_factor)
        self.stall_min_history = max(2, int(stall_min_history))
        self.clock = clock
        self.events: List[HealthEvent] = []
        self._m_events = None
        if metrics is not None:
            self._m_events = metrics.counter(
                "watchdog_events_total",
                "Training watchdog findings by check", ("model", "check"))
        self._slog = _slog.get_logger("observe.health")
        self._grad_ewma: Optional[float] = None
        self._grad_seen = 0
        self._prev_score: Optional[float] = None
        self._rising = 0
        self._step_times: "deque[float]" = deque(maxlen=int(stall_window))
        self._t_last: Optional[float] = None
        self._iteration = 0
        self._epoch = 0

    # ------------------------------------------------------------- events
    def _fire(self, check: str, message: str, value: float) -> None:
        event = HealthEvent(check, message, self._iteration, self._epoch,
                            float(value), self.model_name)
        self.events.append(event)
        if self._m_events is not None:
            self._m_events.inc(model=self.model_name, check=check)
        # structured stream when one is active (fields + trace correlation
        # ride along); plain stdlib warning otherwise so the finding is
        # never silent
        if _slog.get_active_hub() is not None:
            self._slog.warning(message, check=check, value=value,
                               iteration=self._iteration, epoch=self._epoch,
                               model=self.model_name)
        else:
            log.warning("[watchdog:%s] %s", check, message)
        act = self.actions.get(check, self.action)
        if callable(act):
            act(event)
        elif act == "raise":
            raise WatchdogAlarm(event)
        elif act != "log":
            raise ValueError(f"unknown watchdog action {act!r} for {check}")

    # ------------------------------------------------------------- checks
    def observe_gradient_norm(self, norm: float) -> None:
        """Feed one global gradient norm (probe-computed here, or pushed by
        an outer training loop that materializes norms anyway, e.g. for
        clipping). Explosion/vanishing are judged against an EWMA baseline
        after ``grad_warmup`` observations."""
        norm = float(norm)
        if not np.isfinite(norm):
            self._fire("nan_gradient",
                       f"gradient norm is non-finite ({norm})", norm)
            return
        if self._grad_seen >= self.grad_warmup and self._grad_ewma is not None:
            # zero baseline (all-zero norms through warmup: frozen params,
            # fully masked batches): ANY nonzero norm is an explosion —
            # the factor semantics in the limit, not a disabled check
            if (norm > self.grad_explode_factor * self._grad_ewma
                    if self._grad_ewma > 0 else norm > 0.0):
                self._fire(
                    "gradient_explosion",
                    f"gradient norm {norm:.4g} exceeds "
                    f"{self.grad_explode_factor}x the EWMA baseline "
                    f"{self._grad_ewma:.4g}", norm)
                return  # a spike must not poison the baseline
            if (self._grad_ewma > 0
                    and norm < self.grad_vanish_factor * self._grad_ewma):
                self._fire(
                    "gradient_vanishing",
                    f"gradient norm {norm:.4g} fell below "
                    f"{self.grad_vanish_factor}x the EWMA baseline "
                    f"{self._grad_ewma:.4g}", norm)
                return
        self._grad_seen += 1
        a = self.grad_ewma_alpha
        self._grad_ewma = (norm if self._grad_ewma is None
                           else a * norm + (1 - a) * self._grad_ewma)

    def _check_score(self, model) -> None:
        try:
            score = float(model.score_)
        except Exception:  # noqa: BLE001 - score may be unset/deferred
            return
        if not np.isfinite(score):
            self._fire("nan_loss", f"training loss is non-finite ({score})",
                       score)
            self._prev_score = None
            return
        if self._prev_score is not None and score > self._prev_score:
            self._rising += 1
            if self._rising >= self.divergence_windows:
                self._fire(
                    "loss_divergence",
                    f"loss rose for {self._rising} consecutive windows "
                    f"(now {score:.6g})", score)
                self._rising = 0
        else:
            self._rising = 0
        self._prev_score = score

    def _check_params(self, model) -> None:
        params = getattr(model, "params", None)
        if params is None:
            return
        groups = params.values() if isinstance(params, dict) else params
        named = [(name, arr) for group in groups if isinstance(group, dict)
                 for name, arr in group.items()]
        if not named:
            return
        for (name, _), finite in zip(named, _all_finite([a for _, a in named])):
            if not finite:
                self._fire(
                    "nan_params",
                    f"parameter {name!r} contains non-finite values",
                    float("nan"))
                return  # one event per scan is enough

    def _check_gradients(self, model) -> None:
        ds = self.gradient_batch
        if isinstance(ds, tuple):
            grads, _ = model.compute_gradient_and_score(*ds)
        else:
            # masks only when present: ComputationGraph's
            # compute_gradient_and_score has no mask kwargs
            kw = {}
            if getattr(ds, "features_mask", None) is not None:
                kw["features_mask"] = ds.features_mask
            if getattr(ds, "labels_mask", None) is not None:
                kw["labels_mask"] = ds.labels_mask
            grads, _ = model.compute_gradient_and_score(
                ds.features, ds.labels, **kw)
        groups = grads.values() if isinstance(grads, dict) else grads
        sq = _sum_squares_f64([arr for g in groups for arr in g.values()])
        self.observe_gradient_norm(np.sqrt(sq))

    def _check_stall(self, now: float) -> None:
        if self._t_last is None:
            return
        dt = now - self._t_last
        if (len(self._step_times) >= self.stall_min_history
                and dt > self.stall_factor * median(self._step_times)):
            self._fire(
                "step_stall",
                f"iteration took {dt:.4g}s vs rolling median "
                f"{median(self._step_times):.4g}s "
                f"(x{dt / median(self._step_times):.1f})", dt)
        self._step_times.append(dt)

    # ------------------------------------------------------ listener hooks
    def on_epoch_start(self, model) -> None:
        # re-anchor so the first step of an epoch does not absorb
        # between-epoch work (evaluation, checkpointing) as a false stall
        self._t_last = self.clock()

    def iteration_done(self, model, iteration: int, epoch: int) -> None:
        now = self.clock()
        self._iteration, self._epoch = iteration, epoch
        self._check_stall(now)
        self._t_last = now
        self._check_score(model)
        if (self.check_params_every
                and iteration % self.check_params_every == 0):
            self._check_params(model)
        if (self.gradient_batch is not None
                and iteration % self.check_gradients_every == 0):
            self._check_gradients(model)

    def on_epoch_end(self, model) -> None:
        self._t_last = None


def attach_observability(model, *, tracer=None, metrics=None,
                         model_name: str = "default",
                         trace: bool = True,
                         watchdog=None) -> list:
    """The one listener attachment path TraceListener and the watchdog
    share: appends a ``TraceListener`` (unless ``trace=False``) and a
    :class:`TrainingWatchdog` (pass ``watchdog=True`` for defaults, a dict
    of :class:`TrainingWatchdog` kwargs, or a ready instance) to
    ``model.listeners``; returns the listeners it attached."""
    from deeplearning4j_tpu_torch.observe.listener import TraceListener

    attached = []
    if trace:
        attached.append(TraceListener(tracer, metrics, model_name))
    if watchdog is not None and watchdog is not False:
        if isinstance(watchdog, TrainingWatchdog):
            wd = watchdog
        else:
            kw = dict(watchdog) if isinstance(watchdog, dict) else {}
            kw.setdefault("model_name", model_name)
            kw.setdefault("metrics", metrics)
            wd = TrainingWatchdog(**kw)
        attached.append(wd)
    model.listeners.extend(attached)
    return attached


# ---------------------------------------------------------------------------
# serving-side probes
# ---------------------------------------------------------------------------

class HealthCheck:
    """One probe result. ``critical`` failing drives the report to
    ``down`` (restart-worthy); non-critical failures mark ``degraded``."""

    __slots__ = ("name", "healthy", "detail", "critical")

    def __init__(self, name: str, healthy: bool, detail: str = "",
                 critical: bool = False):
        self.name = name
        self.healthy = bool(healthy)
        self.detail = detail
        self.critical = critical

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "healthy": self.healthy,
                "detail": self.detail, "critical": self.critical}


class HealthReport:
    """A set of checks condensed to one status: ``ok`` (all healthy),
    ``degraded`` (non-critical failures) or ``down`` (a critical probe
    failed — the process is not worth keeping alive)."""

    def __init__(self, checks: List[HealthCheck]):
        self.checks = list(checks)

    @property
    def status(self) -> str:
        if any(c.critical and not c.healthy for c in self.checks):
            return "down"
        if any(not c.healthy for c in self.checks):
            return "degraded"
        return "ok"

    @property
    def healthy(self) -> bool:
        return self.status != "down"

    def to_dict(self) -> Dict[str, Any]:
        return {"status": self.status,
                "checks": [c.to_dict() for c in self.checks]}


class ServingHealth:
    """Folds the serving tier's state into one :class:`HealthReport`:
    per-model dispatcher liveness (critical only when the crash is
    TERMINAL — a supervised dispatcher with a restart pending is degraded,
    not restart-worthy: the process will heal itself), circuit-breaker
    quarantines and brownout mode (degraded), admission saturation above
    ``saturation_threshold`` and drain mode (degraded), and registry
    emptiness/hot-swap state. ``extra_probes`` are callables returning a
    :class:`HealthCheck`, the plug point for custom checks."""

    def __init__(self, registry=None, admission=None, *,
                 saturation_threshold: float = 0.9,
                 brownout=None,
                 extra_probes: Optional[List[Callable[[], HealthCheck]]]
                 = None):
        self.registry = registry
        self.admission = admission
        self.brownout = brownout
        self.saturation_threshold = float(saturation_threshold)
        self.extra_probes = list(extra_probes or [])

    def report(self) -> HealthReport:
        checks: List[HealthCheck] = []
        if self.registry is not None:
            names = self.registry.names()
            checks.append(HealthCheck(
                "registry_models", bool(names),
                f"{len(names)} model(s) registered: {', '.join(names)}"
                if names else "no models registered"))
            breaker_states = getattr(self.registry, "breaker_states", None)
            for name in names:
                try:
                    inf = self.registry.get(name).inference
                except Exception:  # noqa: BLE001 - unregistered between
                    continue       # names() and get(); not a failure
                err = getattr(inf, "dispatcher_error", None)
                rst_fn = getattr(inf, "restart_state", None)
                rst = rst_fn() if callable(rst_fn) else None
                if inf.healthy:
                    detail = "up"
                    if rst is not None and rst["restarts_used"]:
                        detail = (f"up (supervised: restarted "
                                  f"{rst['restarts_used']}x of "
                                  f"{rst['max_restarts']} budget)")
                    checks.append(HealthCheck(
                        f"dispatcher:{name}", True, detail, critical=True))
                elif rst is not None and rst["restart_pending"]:
                    # a crash the supervisor will heal is NOT a reason to
                    # kill the process — /livez stays 200 (degraded)
                    checks.append(HealthCheck(
                        f"dispatcher:{name}", False,
                        f"crashed; in-place restart in "
                        f"{rst['retry_after_s']:.2f}s (used "
                        f"{rst['restarts_used']}/{rst['max_restarts']})",
                        critical=False))
                else:
                    checks.append(HealthCheck(
                        f"dispatcher:{name}", False,
                        f"dispatcher dead: {err!r}" if err is not None
                        else "shut down",
                        critical=True))
                if breaker_states is not None:
                    try:
                        tripped = {v: s
                                   for v, s in breaker_states(name).items()
                                   if s != "closed"}
                    except Exception:  # noqa: BLE001 - unregistered race
                        tripped = {}
                    if tripped:
                        checks.append(HealthCheck(
                            f"breaker:{name}", False,
                            "quarantined version(s): " + ", ".join(
                                f"v{v}={s}"
                                for v, s in sorted(tripped.items()))))
            if self.registry.swapping:
                checks.append(HealthCheck(
                    "registry_swap", False, "hot-swap in progress"))
        if self.brownout is not None and self.brownout.active:
            checks.append(HealthCheck(
                "brownout", False,
                "brownout active: "
                + (self.brownout.describe().get("last_reason") or "")))
        if self.admission is not None:
            inflight = self.admission.inflight
            limit = self.admission.max_inflight
            saturated = inflight >= self.saturation_threshold * limit
            checks.append(HealthCheck(
                "admission_saturation", not saturated,
                f"{inflight}/{limit} in flight"))
            if self.admission.draining:
                checks.append(HealthCheck(
                    "admission_drain", False, "draining"))
        for probe in self.extra_probes:
            checks.append(probe())
        return HealthReport(checks)
