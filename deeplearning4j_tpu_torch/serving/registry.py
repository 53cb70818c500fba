"""Versioned model registry — the control plane of the serving tier.

Each registered name owns a monotonically-versioned history and ONE
``ParallelInference`` dispatcher; activating a version is an atomic
``ParallelInference.update_model`` hot-swap (in-flight batches finish on the
old weights, the next coalesced batch runs the new ones — no request ever
sees a torn model), and ``rollback`` re-activates the previously live
version. Models load from every source the framework already speaks:

- a live model object (trained in-process, zoo-built, Keras-imported);
- a path, routed through ``util.model_guesser.load_model_guess`` — own
  ModelSerializer zips, reference DL4J checkpoints, Keras HDF5.

This is the role of the reference's model-server deployments around
``ParallelInference.java`` (dl4j-streaming pumping fresh checkpoints into a
running model), made explicit as an API.

Serving fast path: registration is where serving pays its one-time
costs, so no live request ever does —

- **bucket warmup**: every declared batch bucket's forward is executed at
  ``register`` time (kernel libraries built at first use, the caching
  allocator grown, library autotuning done), for EVERY version —
  including not-yet-active ones — so a later hot-swap or rollback lands on
  an already-warm forward. ``warmup="sync"`` blocks registration until
  warm; ``"async"`` warms on a background thread while ``/readyz`` reports
  the cold buckets; ``"off"`` restores the lazy behavior.
  ``serving_warmup_seconds{model}`` and ``serving_buckets_warm{model}``
  expose the state.
- **persistent compile cache**: ``compile_cache_dir=`` points the kernel
  build directory at disk (``util/compile_cache.py``), so a restarted
  server loads the kernel libraries built before instead of running
  ``nvcc`` again.
- **dtype policy**: ``register(..., dtype_policy="int8"|"bf16")`` serves a
  weight-quantized wrapper of the version (``serving/quantize.py``),
  calibrated against ``sample_input`` at registration; the quantization
  error is recorded on the version and can gate registration
  (``quant_tolerance``).

Canary deploys (the ``pipeline/`` subsystem's data plane):

- **weighted routing**: ``set_traffic_split(name, {version: fraction})``
  gives non-live versions deterministic fractions of un-pinned ``predict``
  traffic (smooth weighted round-robin — no RNG, so tests and replays see
  exact request counts); the live version serves the remainder through
  the batching dispatcher.  The split is warm-gated: a version whose AOT
  bucket warmup has not finished (or failed) is refused a fraction, so a
  canary never puts a cold forward in front of traffic.
  ``serving_canary_fraction{model,version}`` exports the live split
  (cardinality bounded by the registry's own version history — one series
  per version ever canaried, zeroed when the split clears).
- **shadow mode**: ``set_shadow(name, version, sample=...)`` duplicates
  every Nth live request to the candidate OFF the response path (a
  bounded background queue; overflow drops the sample, never the
  response) and diffs the outputs: ``shadow_requests_total{model}`` /
  ``shadow_divergence_total{model}`` count the comparisons and the
  out-of-tolerance ones, and a bounded in-memory divergence log keeps the
  worst offenders for inspection.  Any hot-swap (promote, rollback)
  clears both the split and the shadow — a new live version invalidates
  the experiment.

Serving resilience (round 13): the data plane self-heals —

- **dispatcher supervision**: ``max_dispatcher_restarts`` lets a crashed
  batching dispatcher restart in place under the elastic backoff ladder
  (``ParallelInference`` does the restarting; the registry just wires the
  budget and the injectable clock through), so a single poisoned batch no
  longer kills the name until a human intervenes.
- **per-version circuit breakers** (``serving/breaker.py``): with
  ``breaker=dict(...)`` every registered version gets a
  closed→open→half-open breaker fed by forward crashes. A version that
  keeps crashing the dispatcher is quarantined (its siblings keep the
  restart budget) and un-pinned traffic fails over to the
  **fallback chain** — ``set_fallback(name, ["previous"])`` or explicit
  version numbers (e.g. the int8 policy variant registered alongside) —
  until the half-open probe proves the forward healthy again.
  ``serving_breaker_state{model,version}`` (0/1/2) and
  ``serving_degraded_requests_total{model,reason}`` journal every move.
- **failover on crash**: any un-pinned request that loses its dispatcher
  mid-flight is re-served on the fallback chain instead of surfacing a
  503, when a chain is designated — the acceptance bar for the chaos
  tests is *zero client-visible 5xx after the breaker trips*.

Counterpart of the JAX package's ``serving/registry.py``, ported whole
but for GSPMD-sharded serving: ``mesh=`` and ``sharding_rules=`` raise a
``ValueError`` until the multi-device slice (ROADMAP item 8). Path loads
(``register(path=...)``, :meth:`ModelRegistry.load`) place the network on
``cuda`` unless ``device="cpu"`` is asked for (the registry's own
``device=`` or the call's). Every forward the registry runs itself (the
pinned and canary paths, the fallback chain, the shadow worker) runs under
``torch.inference_mode()``, which the shadow worker's thread enters itself.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from deeplearning4j_tpu_torch.nn.train_step import to_host
from deeplearning4j_tpu_torch.parallel.inference import (
    DispatcherCrashed, InferenceDeadlineExceeded, ParallelInference, host_answer)
from deeplearning4j_tpu_torch.serving import breaker as _breaker
from deeplearning4j_tpu_torch.serving import quantize as _quantize


def _no_mesh(what: str, value) -> None:
    if value is not None:
        raise ValueError(
            f"{what}: GSPMD-sharded serving comes with the multi-device "
            "slice (ROADMAP item 8); the port serves each version on one "
            "device")


def _predict_host(model, x) -> np.ndarray:
    """One synchronous forward, answered on the host."""
    with torch.inference_mode():
        return host_answer(model.output(np.asarray(x)))


class ModelNotFound(KeyError):
    """Unknown model name or version (the HTTP 404 path)."""


class VersionQuarantined(RuntimeError):
    """The live version's circuit breaker is open and the fallback chain
    resolved to nothing servable — the 503 + ``Retry-After`` path.
    ``retry_after_s`` hints when the quarantine could lift."""

    def __init__(self, msg: str, retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class ModelVersion:
    """One immutable registry entry. ``model`` is the object that SERVES
    (the quantized wrapper under a non-float32 ``dtype_policy``);
    ``quant_error`` carries the calibration stats when a sample batch was
    provided at registration."""

    __slots__ = ("version", "model", "source", "registered_at",
                 "dtype_policy", "quant_error")

    def __init__(self, version: int, model, source: str,
                 dtype_policy: str = "float32",
                 quant_error: Optional[dict] = None):
        self.version = version
        self.model = model
        self.source = source
        self.registered_at = time.time()
        self.dtype_policy = dtype_policy
        self.quant_error = quant_error


class ServedModel:
    """A name + its version history + the live batching dispatcher."""

    def __init__(self, name: str, inference: ParallelInference):
        self.name = name
        self.inference = inference
        self.versions: Dict[int, ModelVersion] = {}
        # monotonic high-water mark: version numbers are never reused,
        # even after unregister() — journals and per-version metric
        # series must never conflate two different candidates
        self.next_version = 1
        self.current_version: Optional[int] = None
        self.previous_version: Optional[int] = None
        # version -> warmup state:
        #   {"status": "pending"|"warming"|"warm"|"skipped"|"error",
        #    "buckets": [declared], "warm": [done], "seconds": float,
        #    "reason": str|None}
        self.warmup_state: Dict[int, dict] = {}
        # version -> resolved (row_shape, dtype) spec, kept so rewarm()
        # can re-run a failed warmup without re-resolving the model
        self.warmup_spec: Dict[int, Optional[tuple]] = {}
        # canary data plane: non-live version -> traffic fraction, plus
        # the smooth-WRR accumulators that make routing deterministic
        self.traffic_split: Dict[int, float] = {}
        self._wrr_acc: Dict[int, float] = {}
        # shadow experiment state (None when off); mutated under the
        # registry lock, read by the shadow worker
        self.shadow: Optional[dict] = None
        # resilience: one breaker per version (when enabled) and the
        # registry-designated fallback chain — version numbers and/or
        # "previous", resolved in order at failover time
        self.breakers: Dict[int, "_breaker.CircuitBreaker"] = {}
        self.fallbacks: List[object] = []

    def pick_weighted(self) -> int:
        """Smooth weighted round-robin over {current + split versions}.
        Called under the registry lock.  Deterministic: each version's
        accumulator grows by its weight every request; the largest
        accumulator serves and pays 1.  Ties break toward the heavier
        weight (the live version on an even split), then the lower
        version — no RNG anywhere, so a 0.25 split serves exactly 1 of
        every 4 requests from the canary."""
        weights = dict(self.traffic_split)
        weights[self.current_version] = max(
            0.0, 1.0 - sum(self.traffic_split.values()))
        for v, w in weights.items():
            self._wrr_acc[v] = self._wrr_acc.get(v, 0.0) + w
        chosen = max(weights,
                     key=lambda v: (self._wrr_acc[v], weights[v], -v))
        self._wrr_acc[chosen] -= 1.0
        return chosen

    def describe(self) -> dict:
        def _ver(v: ModelVersion) -> dict:
            d = {"version": v.version, "source": v.source,
                 "registered_at": v.registered_at,
                 "dtype_policy": v.dtype_policy}
            if v.quant_error is not None:
                d["quant_error"] = v.quant_error
            w = self.warmup_state.get(v.version)
            if w is not None:
                d["warmup"] = dict(w)
            return d

        d = {
            "name": self.name,
            "current_version": self.current_version,
            "previous_version": self.previous_version,
            "healthy": self.inference.healthy,
            "versions": [_ver(v) for v in sorted(self.versions.values(),
                                                 key=lambda m: m.version)],
        }
        # a canary in flight is operator-visible: the /v1/models payload
        # carries the live split and the shadow experiment's counters
        if self.traffic_split:
            d["traffic"] = [{"version": v, "fraction": f}
                            for v, f in sorted(self.traffic_split.items())]
        if self.shadow is not None:
            s = self.shadow
            d["shadow"] = {"version": s["version"], "sample": s["sample"],
                           "requests": s["requests"],
                           "divergences": s["divergences"],
                           "dropped": s["dropped"]}
        if self.fallbacks:
            d["fallbacks"] = list(self.fallbacks)
        tripped = {str(v): br.state for v, br in sorted(self.breakers.items())
                   if br.state != _breaker.CLOSED}
        if tripped:  # a quarantine in flight is operator-visible
            d["breakers"] = tripped
        return d


class ModelRegistry:
    """Thread-safe registry; one ``ParallelInference`` per model name.

    ``metrics`` is an ``observe.metrics.MetricsRegistry`` (duck-typed) shared
    with the dispatchers — swap/rollback events and per-model live-version
    gauges land next to the batch/queue series the dispatchers emit.
    """

    def __init__(self, *, metrics=None, max_batch_size: int = 32,
                 queue_limit: int = 64, wait_ms: float = 2.0, mesh=None,
                 buckets: Optional[Sequence[int]] = None,
                 warmup: str = "sync",
                 compile_cache_dir: Optional[str] = None,
                 max_dispatcher_restarts: int = 0,
                 restart_backoff=None,
                 breaker: Optional[dict] = None,
                 time_source=None, cost=None, device=None):
        """Resilience knobs (round 13): ``max_dispatcher_restarts`` lets
        each name's crashed dispatcher restart in place (0 keeps the
        terminal-crash contract); ``restart_backoff`` is an elastic
        ``BackoffPolicy``; ``breaker=dict(failure_threshold=, window_s=,
        cooldown_s=, half_open_probes=)`` arms a per-version circuit
        breaker (None = off); ``time_source`` (a
        ``parallel.time_source.TimeSource``) drives breaker cooldowns AND
        restart backoff so chaos tests run on a manual clock. ``device``
        places the networks that path registrations load (None: ``cuda``,
        raising without one)."""
        if warmup not in ("sync", "async", "off"):
            raise ValueError(f"warmup must be sync|async|off, got {warmup!r}")
        _no_mesh("ModelRegistry(mesh=)", mesh)
        self.device = device
        if compile_cache_dir is not None:
            from deeplearning4j_tpu_torch.util.compile_cache import (
                enable_persistent_compile_cache)
            enable_persistent_compile_cache(compile_cache_dir)
        self._models: Dict[str, ServedModel] = {}
        self._lock = threading.RLock()
        self._swap_lock = threading.Lock()  # serializes hot-swaps
        self._metrics = metrics
        self._time_source = time_source
        restart_clock = (time.monotonic if time_source is None else
                         lambda: time_source.current_time_millis() / 1e3)
        # optional observe.cost.CostLedger shared by every dispatcher:
        # per-request device-time attribution (the /v1/models cost block
        # and the X-Device-Ms header read it)
        self.cost = cost
        self._pi_kw = dict(max_batch_size=max_batch_size,
                           queue_limit=queue_limit, wait_ms=wait_ms,
                           buckets=buckets,
                           max_restarts=int(max_dispatcher_restarts),
                           restart_clock=restart_clock, cost=cost)
        if restart_backoff is not None:
            self._pi_kw["restart_backoff"] = restart_backoff
        self._breaker_kw = dict(breaker) if breaker is not None else None
        if self._breaker_kw is not None:
            # fail fast on a typo'd knob, not at first registration
            _breaker.CircuitBreaker(time_source=time_source,
                                    **self._breaker_kw)
        self._warmup_mode = warmup
        self._swapping = 0  # >0 while a hot-swap is in progress (readiness)
        self._m_swaps = self._m_version = None
        self._m_warm_s = self._m_warm_n = None
        self._m_canary = self._m_shadow_req = self._m_shadow_div = None
        self._m_breaker = self._m_degraded = None
        # shadow worker: ONE daemon + bounded queue per registry, started
        # lazily; overflow drops the shadow sample, never the response
        self._shadow_queue: "deque" = deque()
        self._shadow_cv = threading.Condition()
        self._shadow_inflight = 0
        self._shadow_stop = False
        self._shadow_thread: Optional[threading.Thread] = None
        if metrics is not None:
            self._m_swaps = metrics.counter(
                "serving_model_swaps_total",
                "Hot-swap activations (including rollbacks)",
                ("model", "kind"))
            self._m_version = metrics.gauge(
                "serving_model_version", "Currently live version", ("model",))
            self._m_warm_s = metrics.gauge(
                "serving_warmup_seconds",
                "Wall seconds the last registration spent pre-compiling "
                "batch buckets", ("model",))
            self._m_warm_n = metrics.gauge(
                "serving_buckets_warm",
                "Batch buckets of the LIVE version already warmed "
                "(requests on them never build a kernel)", ("model",))
            self._m_canary = metrics.gauge(
                "serving_canary_fraction",
                "Traffic fraction routed to a non-live version "
                "(0 when the split is cleared)", ("model", "version"))
            self._m_shadow_req = metrics.counter(
                "shadow_requests_total",
                "Live requests duplicated to a shadow candidate",
                ("model",))
            self._m_shadow_div = metrics.counter(
                "shadow_divergence_total",
                "Shadow comparisons whose output diverged past the "
                "configured threshold", ("model",))
            self._m_breaker = metrics.gauge(
                "serving_breaker_state",
                "Per-version circuit breaker: 0 closed, 1 open "
                "(quarantined), 2 half-open (probing). Cardinality "
                "bounded by the registry's own version history",
                ("model", "version"))
            self._m_degraded = metrics.counter(
                "serving_degraded_requests_total",
                "Requests served on a fallback/degraded version instead "
                "of the one that should have served them",
                ("model", "reason"))

    # ------------------------------------------------------------- loading
    @staticmethod
    def load(path: str, device=None):
        """Load a model of unknown provenance (ModelGuesser order: own MLN
        zip → own CG zip → DL4J MLN/CG checkpoint → Keras h5) onto
        ``device`` (None: ``cuda``, raising without one)."""
        from deeplearning4j_tpu_torch.util.model_guesser import load_model_guess
        return load_model_guess(str(path), device=device)

    # ------------------------------------------------------------ mutation
    def register(self, name: str, model=None, *, path: Optional[str] = None,
                 activate: bool = True, dtype_policy: str = "float32",
                 sample_input=None, input_shape: Optional[Sequence[int]] = None,
                 quant_tolerance: Optional[float] = None,
                 mesh=None, sharding_rules=None, device=None) -> int:
        """Register a new version of ``name``; returns the version number.

        Exactly one of ``model`` (a live object) or ``path`` (anything
        ``load_model_guess`` accepts) must be given. The first version of a
        name activates unconditionally; later ones only when ``activate``
        — and under ``warmup="async"`` the activation happens when the new
        version's warmup COMPLETES (the hot-swap must land on an already-
        compiled forward, never put a cold version in front of traffic).

        ``dtype_policy``: serve this version ``"float32"`` (as-is),
        ``"bf16"`` or ``"int8"`` (weight-quantized wrapper; see
        ``serving/quantize.py``). With a non-float policy and a
        ``sample_input`` batch, the quantized output is calibrated against
        the float one and the deviation recorded on the version
        (``quant_tolerance`` rejects the registration past that relative
        error).

        Warmup input spec resolution, per version: ``input_shape`` (a
        per-row feature shape) > ``sample_input``'s row shape > the conf's
        ``InputType`` > the first layer's ``n_in``. A model yielding no
        spec (duck-typed stubs) skips warmup and is treated as warm.

        ``device`` places a ``path`` load (None: the registry's
        ``device``, else ``cuda``). ``mesh`` / ``sharding_rules`` (GSPMD-
        sharded serving) raise until the multi-device slice.
        """
        if (model is None) == (path is None):
            raise ValueError("register() needs exactly one of model=/path=")
        if dtype_policy not in _quantize.DTYPE_POLICIES:
            raise ValueError(f"unknown dtype_policy {dtype_policy!r} "
                             f"(one of {_quantize.DTYPE_POLICIES})")
        _no_mesh("register(mesh=)", mesh)
        _no_mesh("register(sharding_rules=)", sharding_rules)
        source = "object"
        if path is not None:
            model = self.load(path, device=self.device if device is None
                              else device)
            source = str(path)
        quant_error = None
        served_obj = model
        if dtype_policy != "float32":
            served_obj = _quantize.quantize_model(model, dtype_policy)
            if sample_input is not None:
                quant_error = _quantize.calibrate(model, served_obj,
                                                  sample_input)
                _quantize.check_tolerance(quant_error, quant_tolerance)
            if path is not None:
                # registry-owned checkpoint load: nobody else references
                # the float model, so don't pin a full float param copy
                # next to the quantized one for the version's lifetime
                served_obj.release_base_params()
        first = False
        with self._lock:
            served = self._models.get(name)
            if served is None:
                first = True
                pi_kw = dict(self._pi_kw)
                served = ServedModel(
                    name, ParallelInference(
                        served_obj, mode="batched", metrics=self._metrics,
                        metrics_name=name, **pi_kw))
                self._models[name] = served
            version = served.next_version
            served.next_version += 1
            served.versions[version] = ModelVersion(
                version, served_obj, source, dtype_policy=dtype_policy,
                quant_error=quant_error)
            if self._breaker_kw is not None:
                served.breakers[version] = _breaker.CircuitBreaker(
                    time_source=self._time_source,
                    name=f"{name}:v{version}", **self._breaker_kw)
                if self._m_breaker is not None:
                    self._m_breaker.set(0, model=name,
                                        version=str(version))
            if first:
                served.current_version = version
                self._note_swap(name, version, "register")
        spec = self._resolve_row_spec(served_obj, input_shape, sample_input)
        # async warmup + activate: the swap must land on an already-
        # compiled forward, so the warmup thread activates when it's warm
        # (on warmup FAILURE the old version keeps serving — rewarm() then
        # activate() is the recovery path)
        defer = (not first and activate and spec is not None
                 and self._warmup_mode == "async")
        self._begin_warmup(served, version, spec, activate_after=defer)
        if not first and activate and not defer:
            self.activate(name, version)
        if first:
            with self._lock:
                self._update_warm_gauge(served)
        return version

    # ------------------------------------------------------------- warmup
    def _resolve_row_spec(self, model, input_shape,
                          sample_input) -> Optional[Tuple[tuple, object]]:
        """(row_shape, host dtype) to warm with, or None (skip warmup)."""
        if input_shape is not None:
            return tuple(int(s) for s in input_shape), np.float32
        if sample_input is not None:
            s = np.asarray(sample_input)
            if s.ndim >= 1:
                # warm with the HOST dtype requests actually arrive in —
                # the JSON path parses to float32 regardless of model
                # dtype, and np.random/np.array default to float64, which
                # no wire format ships: warming '<f8' would leave the live
                # '<f4' signature cold (and falsely alarm the cold counter)
                dt = s.dtype if (np.issubdtype(s.dtype, np.floating)
                                 and s.dtype != np.float64) else np.float32
                return tuple(s.shape[1:]), dt
        conf = getattr(model, "conf", None)
        if conf is None:
            return None
        it = getattr(conf, "input_type", None)
        if it is not None:
            return tuple(it.batch_shape(1)[1:]), np.float32
        # single-input graph with a declared InputType
        input_types = getattr(conf, "input_types", None)
        inputs = getattr(conf, "inputs", None)
        if (input_types and inputs and len(inputs) == 1
                and input_types[0] is not None):
            return tuple(input_types[0].batch_shape(1)[1:]), np.float32
        layers = getattr(conf, "layers", None)
        if layers:
            n_in = getattr(layers[0], "n_in", None)
            if n_in:
                return (int(n_in),), np.float32
        return None

    def _begin_warmup(self, served: ServedModel, version: int,
                      spec: Optional[Tuple[tuple, object]],
                      activate_after: bool = False) -> None:
        declared = list(served.inference.buckets)
        served.warmup_spec[version] = spec
        if self._warmup_mode == "off" or spec is None:
            with self._lock:
                served.warmup_state[version] = {
                    "status": "skipped", "buckets": declared, "warm": [],
                    "seconds": 0.0,
                    "reason": ("warmup disabled"
                               if self._warmup_mode == "off"
                               else "no input spec (pass input_shape= or "
                                    "sample_input=)")}
            return
        with self._lock:
            served.warmup_state[version] = {
                "status": "pending", "buckets": declared, "warm": [],
                "seconds": 0.0, "reason": None}
        if self._warmup_mode == "sync":
            self._run_warmup(served, version, spec, activate_after)
        else:
            threading.Thread(target=self._run_warmup,
                             args=(served, version, spec, activate_after),
                             name=f"warmup-{served.name}-v{version}",
                             daemon=True).start()

    def _run_warmup(self, served: ServedModel, version: int,
                    spec: Tuple[tuple, object],
                    activate_after: bool = False) -> None:
        row_shape, dtype = spec
        state = served.warmup_state[version]
        model = served.versions[version].model
        state["status"] = "warming"
        t0 = time.perf_counter()
        try:
            for b in state["buckets"]:
                served.inference.warmup(row_shape, dtype=dtype, model=model,
                                        buckets=[b])
                with self._lock:
                    state["warm"].append(b)
                    self._update_warm_gauge(served)
            with self._lock:
                state["status"] = "warm"
                state["seconds"] = round(time.perf_counter() - t0, 4)
                if self._m_warm_s is not None:
                    self._m_warm_s.set(state["seconds"], model=served.name)
        except Exception as e:  # noqa: BLE001 — a warmup failure must not
            # take the registry down; the version stays cold and /readyz
            # says why
            with self._lock:
                state["status"] = "error"
                state["reason"] = f"{type(e).__name__}: {e}"
                state["seconds"] = round(time.perf_counter() - t0, 4)
                if activate_after:
                    state["reason"] += ("; deferred activation skipped — "
                                        "previous version keeps serving")
            return
        if activate_after:
            try:
                self.activate(served.name, version)
            except Exception as e:  # noqa: BLE001 — surfaced, not fatal
                with self._lock:
                    state["reason"] = (f"warm, but deferred activation "
                                       f"failed: {type(e).__name__}: {e}")

    def _update_warm_gauge(self, served: ServedModel) -> None:
        if self._m_warm_n is None:
            return
        state = served.warmup_state.get(served.current_version)
        if state is None:
            return
        n = (len(state["buckets"]) if state["status"] == "skipped"
             else len(state["warm"]))
        self._m_warm_n.set(n, model=served.name)

    def cold_buckets(self) -> Dict[str, List[int]]:
        """Per model: declared buckets of the LIVE version not yet warmed
        (empty when warm, skipped, or warmup disabled). The ``/readyz``
        payload."""
        out: Dict[str, List[int]] = {}
        with self._lock:
            for name, served in self._models.items():
                state = served.warmup_state.get(served.current_version)
                if state is None or state["status"] == "skipped":
                    continue
                cold = [b for b in state["buckets"]
                        if b not in state["warm"]]
                if cold:
                    out[name] = cold
        return out

    def warmed(self) -> bool:
        """True when no live version still has cold buckets."""
        return not self.cold_buckets()

    def warmup_errors(self) -> Dict[str, str]:
        """Per model: the error reason when the LIVE version's warmup
        FAILED (readyz surfaces this next to the cold buckets, so an
        operator can tell a crashed warmup from one still running)."""
        out: Dict[str, str] = {}
        with self._lock:
            for name, served in self._models.items():
                state = served.warmup_state.get(served.current_version)
                if state is not None and state["status"] == "error":
                    out[name] = state["reason"] or "warmup failed"
        return out

    def rewarm(self, name: str, version: Optional[int] = None) -> int:
        """Re-run bucket warmup for ``version`` (default: live) — the
        recovery path when registration-time warmup errored (transient
        OOM, device hiccup) and the process should become ready without
        a restart. Returns the version warmed."""
        with self._lock:
            served = self._get(name)
            v = served.current_version if version is None else version
            if v not in served.versions:
                raise ModelNotFound(f"{name} has no version {v}")
            spec = served.warmup_spec.get(v)
        self._begin_warmup(served, v, spec)
        with self._lock:
            self._update_warm_gauge(served)
        return v

    def warmup_state(self, name: str,
                     version: Optional[int] = None) -> dict:
        """The warmup record of ``version`` (default: live) of ``name``."""
        with self._lock:
            served = self._get(name)
            v = served.current_version if version is None else version
            state = served.warmup_state.get(v)
            return dict(state) if state is not None else {"status": "unknown"}

    def unregister(self, name: str, version: int) -> None:
        """Retire a non-live version: drop it (and its warmup state, any
        traffic fraction, any shadow experiment on it) from the registry
        so a long-running pipeline does not accumulate one full model per
        rejected candidate. The LIVE version is refused; retiring the
        previous version clears the rollback target."""
        with self._lock:
            served = self._get(name)
            if version not in served.versions:
                raise ModelNotFound(f"{name} has no version {version}")
            if version == served.current_version:
                raise ValueError(
                    f"{name} v{version} is the live version; activate "
                    "another version before unregistering it")
            if version in served.traffic_split:
                del served.traffic_split[version]
                served._wrr_acc = {}
                if self._m_canary is not None:
                    self._m_canary.set(0, model=name, version=str(version))
            if served.shadow is not None \
                    and served.shadow["version"] == version:
                served.shadow = None
            if served.previous_version == version:
                served.previous_version = None
            del served.versions[version]
            served.warmup_state.pop(version, None)
            served.warmup_spec.pop(version, None)
            if served.breakers.pop(version, None) is not None \
                    and self._m_breaker is not None:
                self._m_breaker.set(0, model=name, version=str(version))
            # explicit version numbers in the fallback chain die with the
            # version (resolution would skip them anyway; keeping them
            # would advertise a fallback that can never serve)
            served.fallbacks = [f for f in served.fallbacks
                                if f == "previous" or f != version]

    # ------------------------------------------- resilience: breaker/fallback
    def set_fallback(self, name: str, chain: Sequence[object]) -> None:
        """Designate the failover chain for ``name``: an ordered list of
        version numbers and/or the string ``"previous"`` (re-resolved at
        failover time against whatever is then the previous version).
        Resolution skips entries that are missing, not warm, or whose own
        breaker is not closed — the first survivor serves."""
        with self._lock:
            served = self._get(name)
            parsed: List[object] = []
            for entry in chain:
                if entry == "previous":
                    parsed.append("previous")
                    continue
                v = int(entry)
                if v not in served.versions:
                    raise ModelNotFound(f"{name} has no version {v}")
                parsed.append(v)
            served.fallbacks = parsed

    def get_fallback(self, name: str) -> List[object]:
        with self._lock:
            return list(self._get(name).fallbacks)

    def _resolve_fallback_locked(self, served: ServedModel,
                                 exclude: Optional[int] = None
                                 ) -> Optional[int]:
        """First chain entry that can actually serve. Called under the
        registry lock."""
        for entry in served.fallbacks:
            v = served.previous_version if entry == "previous" else entry
            if v is None or v == exclude or v not in served.versions:
                continue
            state = served.warmup_state.get(v)
            status = None if state is None else state["status"]
            if status not in ("warm", "skipped"):
                continue  # a cold fallback is no fallback
            br = served.breakers.get(v)
            if br is not None and br.state != _breaker.CLOSED:
                continue  # it is quarantined too
            return v
        return None

    def resolve_fallback(self, name: str,
                         exclude: Optional[int] = None) -> Optional[int]:
        """Public resolution (``exclude`` defaults to nothing): the
        version a degraded/brownout request would be served on, or None."""
        with self._lock:
            return self._resolve_fallback_locked(self._get(name), exclude)

    def note_degraded(self, name: str, reason: str) -> None:
        """Count a request served degraded for ``reason`` (the HTTP
        front-end's brownout rerouting reports through here so every
        degraded request lands in ONE series)."""
        if self._m_degraded is not None:
            self._m_degraded.inc(model=name, reason=reason)

    def breaker_state(self, name: str,
                      version: Optional[int] = None) -> Optional[str]:
        """``closed`` / ``open`` / ``half_open`` for ``version`` (default:
        live), or None when breakers are disabled."""
        with self._lock:
            served = self._get(name)
            v = served.current_version if version is None else version
            br = served.breakers.get(v)
            return None if br is None else br.state

    def breaker_states(self, name: str) -> Dict[int, str]:
        """Every version's breaker state (empty when disabled)."""
        with self._lock:
            return {v: br.state
                    for v, br in self._get(name).breakers.items()}

    def _breaker_of(self, served: ServedModel,
                    version: Optional[int]
                    ) -> Optional["_breaker.CircuitBreaker"]:
        if version is None:
            return None
        return served.breakers.get(version)

    def _note_breaker(self, served: ServedModel, version: int,
                      br: "_breaker.CircuitBreaker") -> None:
        if self._m_breaker is not None:
            self._m_breaker.set(br.code, model=served.name,
                                version=str(version))

    def _serve_degraded(self, served: ServedModel, x, deadline_s,
                        exclude: Optional[int], reason: str,
                        original: Optional[BaseException] = None):
        """Serve one request on the fallback chain (synchronous pinned
        path — the dispatcher belongs to the version we are escaping).
        Raises ``original`` (or :class:`VersionQuarantined`) when the
        chain resolves to nothing."""
        with self._lock:
            fb = self._resolve_fallback_locked(served, exclude=exclude)
            model = served.versions[fb].model if fb is not None else None
        if fb is None:
            if original is not None:
                raise original
            br = served.breakers.get(exclude) if exclude is not None \
                else None
            raise VersionQuarantined(
                f"{served.name} v{exclude} is quarantined (circuit "
                f"breaker open) and the fallback chain resolved to "
                f"nothing servable",
                retry_after_s=br.retry_after_s() if br is not None
                else None)
        t0 = time.perf_counter()
        out = _predict_host(model, x)
        if deadline_s is not None \
                and time.perf_counter() - t0 > deadline_s:
            raise InferenceDeadlineExceeded(
                f"degraded predict on {served.name} v{fb} took "
                f"{time.perf_counter() - t0:.3f}s "
                f"(deadline {deadline_s:.3f}s)")
        if self._m_degraded is not None:
            self._m_degraded.inc(model=served.name, reason=reason)
        return out, fb

    # ------------------------------------------------------ canary routing
    def _require_warm(self, served: ServedModel, version: int,
                      what: str) -> None:
        """A version may only receive (or shadow) traffic once its AOT
        bucket warmup finished — 'skipped' counts (no spec / warmup off),
        'pending'/'warming'/'error' do not."""
        state = served.warmup_state.get(version)
        status = None if state is None else state["status"]
        if status not in ("warm", "skipped"):
            raise ValueError(
                f"{served.name} v{version} is not warmed "
                f"(warmup status: {status}); a cold version must never "
                f"receive {what} — rewarm() it first")

    def set_traffic_split(self, name: str,
                          fractions: Dict[int, float]) -> None:
        """Route ``fractions`` of un-pinned predict traffic to non-live
        versions (the live version serves the remainder).  Every target
        must exist, be warm, and not be the live version; fractions are
        in (0, 1] and sum to at most 1.  Deterministic smooth-WRR
        routing; accumulators reset on every split change."""
        with self._lock:
            served = self._get(name)
            total = 0.0
            for v, f in fractions.items():
                if v not in served.versions:
                    raise ModelNotFound(f"{name} has no version {v}")
                if v == served.current_version:
                    raise ValueError(
                        f"{name} v{v} is the live version; split "
                        "fractions name canary versions only")
                f = float(f)
                if not 0.0 < f <= 1.0:
                    raise ValueError(
                        f"fraction for v{v} must be in (0, 1], got {f}")
                self._require_warm(served, v, "a traffic fraction")
                total += f
            if total > 1.0 + 1e-9:
                raise ValueError(
                    f"split fractions sum to {total:.4g} (> 1.0)")
            previous = set(served.traffic_split)
            served.traffic_split = {int(v): float(f)
                                    for v, f in fractions.items()}
            served._wrr_acc = {}
            if self._m_canary is not None:
                for v in previous - set(served.traffic_split):
                    self._m_canary.set(0, model=name, version=str(v))
                for v, f in served.traffic_split.items():
                    self._m_canary.set(f, model=name, version=str(v))

    def clear_traffic_split(self, name: str) -> None:
        """End the canary split: all un-pinned traffic returns to the
        live version's batching dispatcher."""
        self.set_traffic_split(name, {})

    def get_traffic_split(self, name: str) -> Dict[int, float]:
        with self._lock:
            return dict(self._get(name).traffic_split)

    # -------------------------------------------------------- shadow mode
    def set_shadow(self, name: str, version: int, *, sample: float = 1.0,
                   divergence_threshold: float = 1e-3,
                   max_log: int = 100, max_queue: int = 64) -> None:
        """Duplicate every Nth live request (N = round(1/``sample``)) to
        ``version`` off the response path and diff the outputs.  The
        candidate must be warm (it runs a real forward).  Divergences
        past ``divergence_threshold`` (max-abs difference) increment
        ``shadow_divergence_total{model}`` and land in a bounded log."""
        if not 0.0 < float(sample) <= 1.0:
            raise ValueError(f"sample must be in (0, 1], got {sample}")
        with self._lock:
            served = self._get(name)
            if version not in served.versions:
                raise ModelNotFound(f"{name} has no version {version}")
            if version == served.current_version:
                raise ValueError(
                    f"{name} v{version} is the live version; shadow "
                    "mode mirrors traffic to a NON-live candidate")
            self._require_warm(served, version, "shadow traffic")
            served.shadow = {
                "version": int(version), "sample": float(sample),
                "every": max(1, int(round(1.0 / float(sample)))),
                "threshold": float(divergence_threshold),
                "counter": 0, "requests": 0, "divergences": 0,
                "dropped": 0, "max_queue": int(max_queue),
                "log": deque(maxlen=int(max_log)),
            }
        self._ensure_shadow_worker()

    def clear_shadow(self, name: str) -> None:
        with self._lock:
            self._get(name).shadow = None

    def shadow_state(self, name: str) -> Optional[dict]:
        """Counters of the live shadow experiment (None when off)."""
        with self._lock:
            s = self._get(name).shadow
            if s is None:
                return None
            return {k: s[k] for k in ("version", "sample", "requests",
                                      "divergences", "dropped")}

    def shadow_log(self, name: str) -> List[dict]:
        """The bounded divergence log, worst-offenders-keep-rolling."""
        with self._lock:
            s = self._get(name).shadow
            return [] if s is None else list(s["log"])

    def _ensure_shadow_worker(self) -> None:
        with self._shadow_cv:
            if (self._shadow_thread is not None
                    and self._shadow_thread.is_alive()):
                return
            self._shadow_stop = False
            self._shadow_thread = threading.Thread(
                target=self._shadow_loop, name="shadow-worker", daemon=True)
            self._shadow_thread.start()

    def _enqueue_shadow(self, served: ServedModel, x, live_out) -> None:
        """Called under the registry lock from the predict path: count the
        request against the sampling stride and, when it samples, hand
        (input, live output) to the worker — NEVER the model call itself;
        the response path pays a deque append at most."""
        s = served.shadow
        s["counter"] += 1
        if s["counter"] % s["every"]:
            return
        with self._shadow_cv:
            # the bound is per EXPERIMENT: one model's backlog must not
            # silently starve another model's shadow counters
            pending = sum(1 for item in self._shadow_queue
                          if item[0] is served)
            if pending >= s["max_queue"]:
                s["dropped"] += 1
                return
            self._shadow_queue.append(
                (served, s["version"], np.asarray(x),
                 np.asarray(live_out)))
            self._shadow_cv.notify()

    def _shadow_loop(self) -> None:
        # the mode is thread-local: this worker enters it itself
        with torch.inference_mode():
            self._shadow_serve()

    def _shadow_serve(self) -> None:
        while True:
            with self._shadow_cv:
                while not self._shadow_queue:
                    self._shadow_inflight = 0
                    self._shadow_cv.notify_all()  # drain_shadow waiters
                    if self._shadow_stop:
                        return  # shutdown: don't pin the registry forever
                    self._shadow_cv.wait()
                served, version, x, live_out = self._shadow_queue.popleft()
                self._shadow_inflight = 1
            try:
                self._shadow_compare(served, version, x, live_out)
            except Exception:  # noqa: BLE001 — the worker must survive
                pass

    def _shadow_compare(self, served: ServedModel, version: int,
                        x, live_out) -> None:
        with self._lock:
            s = served.shadow
            if s is None or s["version"] != version:
                return  # experiment ended while queued
            model = served.versions[version].model
        try:
            shadow_out = to_host(model.output(x))
            diff = float(np.max(np.abs(
                shadow_out.astype(np.float64)
                - np.asarray(live_out).astype(np.float64))))
            error = None
        except Exception as e:  # noqa: BLE001 — a crashing candidate is
            # maximally divergent, not a worker fault
            diff, error = float("inf"), f"{type(e).__name__}: {e}"
        with self._lock:
            s = served.shadow
            if s is None or s["version"] != version:
                return
            s["requests"] += 1
            if self._m_shadow_req is not None:
                self._m_shadow_req.inc(model=served.name)
            if diff > s["threshold"]:
                s["divergences"] += 1
                if self._m_shadow_div is not None:
                    self._m_shadow_div.inc(model=served.name)
                entry = {"diff": diff, "rows": int(np.asarray(x).shape[0]),
                         "ts": time.time()}
                if error is not None:
                    entry["error"] = error
                s["log"].append(entry)

    def drain_shadow(self, timeout_s: float = 5.0) -> bool:
        """Block until the shadow queue is empty and idle (tests and
        deterministic canary ticks); True when drained."""
        deadline = time.monotonic() + timeout_s
        with self._shadow_cv:
            while self._shadow_queue or self._shadow_inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._shadow_cv.wait(remaining)
        return True

    def activate(self, name: str, version: int, *,
                 _kind: str = "activate") -> None:
        """Atomic hot-swap of the live version (rollback's forward twin).
        Activations are serialized by ``_swap_lock`` so the dispatcher's
        live model can never disagree with ``current_version`` when two
        publishers race."""
        with self._swap_lock:
            with self._lock:
                served = self._get(name)
                if version not in served.versions:
                    raise ModelNotFound(f"{name} has no version {version}")
                if version == served.current_version:
                    return
                self._swapping += 1
            try:
                # the swap itself is atomic inside ParallelInference; the
                # _swapping counter only widens the readiness signal around it
                served.inference.update_model(served.versions[version].model)
                with self._lock:
                    served.previous_version = served.current_version
                    served.current_version = version
                    # a swap invalidates any canary experiment against the
                    # OLD live version: clear the split + shadow so no
                    # stale fraction keeps routing (promote's forward twin)
                    if served.traffic_split and self._m_canary is not None:
                        for v in served.traffic_split:
                            self._m_canary.set(0, model=name,
                                               version=str(v))
                    served.traffic_split = {}
                    served._wrr_acc = {}
                    served.shadow = None
                    self._note_swap(name, version, _kind)
                    # hot-swap keeps warm: the incoming version was warmed
                    # at ITS registration, so the gauge usually stays full
                    self._update_warm_gauge(served)
            finally:
                with self._lock:
                    self._swapping -= 1

    def rollback(self, name: str) -> int:
        """Re-activate the previously live version; returns it. Counts as
        ONE swap event (kind=rollback) — summing the swap counter over
        kinds must equal the number of swaps."""
        with self._lock:
            served = self._get(name)
            prev = served.previous_version
            if prev is None:
                raise ModelNotFound(f"{name} has no previous version")
        self.activate(name, prev, _kind="rollback")
        return prev

    def _note_swap(self, name: str, version: int, kind: str) -> None:
        if self._m_swaps is not None:
            self._m_swaps.inc(model=name, kind=kind)
        if self._m_version is not None:
            self._m_version.set(version, model=name)

    # ------------------------------------------------------------- queries
    def _get(self, name: str) -> ServedModel:
        served = self._models.get(name)
        if served is None:
            raise ModelNotFound(f"no model named {name!r}")
        return served

    def get(self, name: str) -> ServedModel:
        with self._lock:
            return self._get(name)

    def set_cost_ledger(self, ledger) -> None:
        """Attach (or swap) the cost ledger for every present AND future
        dispatcher — the ModelServer wires its own ledger through here
        when the registry was built without one."""
        with self._lock:
            self.cost = ledger
            self._pi_kw["cost"] = ledger
            for served in self._models.values():
                served.inference.cost = ledger

    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._models

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def list_models(self) -> List[dict]:
        with self._lock:
            return [self._models[n].describe() for n in sorted(self._models)]

    @property
    def swapping(self) -> bool:
        with self._lock:
            return self._swapping > 0

    def healthy(self) -> bool:
        """Every dispatcher alive (readiness ingredient)."""
        with self._lock:
            return all(m.inference.healthy for m in self._models.values())

    # ------------------------------------------------------------ data path
    def predict(self, name: str, x, *, version: Optional[int] = None,
                deadline_s: Optional[float] = None):
        """Predict through the live dispatcher; see ``predict_versioned``."""
        return self.predict_versioned(name, x, version=version,
                                      deadline_s=deadline_s)[0]

    def predict_versioned(self, name: str, x, *,
                          version: Optional[int] = None,
                          deadline_s: Optional[float] = None):
        """Predict; returns ``(outputs, version_served)``.

        A pinned ``version`` that is not the live one runs synchronously on
        that version's model (no batching) — the escape hatch for canarying
        an old/new version side by side; the live version always goes
        through the coalescing dispatcher. ``version_served`` is attributed
        from the model object that ACTUALLY served the batch, so a hot-swap
        landing mid-request can never mislabel an old model's output with
        the new version number.

        Un-pinned requests honor the canary split: a live
        ``set_traffic_split`` routes each request deterministically
        (smooth WRR) to the live dispatcher or a canary version's model;
        live-path responses additionally feed the shadow sampler when a
        shadow experiment is armed.

        Resilience (un-pinned, dispatcher-bound requests only): the live
        version's circuit breaker is consulted before dispatch — open
        means the request serves on the fallback chain (or raises
        :class:`VersionQuarantined` when the chain is empty); half-open
        admits one probe at a time. A ``DispatcherCrashed`` whose request
        actually reached the forward feeds the breaker, and the request
        itself is re-served on the fallback chain when one exists — the
        crash stays invisible to the client.
        """
        served = self.get(name)
        routed = None
        unpinned = version is None
        with self._lock:
            current = served.current_version
            if version is not None and version not in served.versions:
                raise ModelNotFound(f"{name} has no version {version}")
            if version is None and served.traffic_split:
                routed = served.pick_weighted()
                if routed != current:
                    version = routed
            pinned = (served.versions[version].model
                      if version is not None and version != current else None)
            brk = (self._breaker_of(served, current)
                   if unpinned and pinned is None else None)
        if pinned is not None:
            # the pinned/canary path runs synchronously (no batching) —
            # honor the deadline contract the dispatcher gives live
            # traffic: a response that took longer than its budget is a
            # 504, never an arbitrarily-late 200. (The forward itself is
            # not preemptible, so the check is after the fact.)
            t0 = time.perf_counter()
            out = _predict_host(pinned, x)
            if deadline_s is not None \
                    and time.perf_counter() - t0 > deadline_s:
                raise InferenceDeadlineExceeded(
                    f"synchronous predict on {name} v{version} took "
                    f"{time.perf_counter() - t0:.3f}s "
                    f"(deadline {deadline_s:.3f}s)")
            return out, version
        route = _breaker.ALLOW if brk is None else brk.allow()
        if brk is not None:
            # allow() may have flipped open -> half_open; keep the gauge
            # truthful at every decision point
            self._note_breaker(served, current, brk)
        if route == _breaker.FALLBACK:
            return self._serve_degraded(served, x, deadline_s,
                                        exclude=current,
                                        reason="breaker_open")
        try:
            out, model = served.inference.output(x, deadline_s=deadline_s,
                                                 return_model=True)
        except DispatcherCrashed as e:
            if brk is not None:
                if getattr(e, "dispatched", False):
                    # the forward of the LIVE version took the thread
                    # down — breaker evidence (probe or regular traffic)
                    brk.record_failure(probe=route == _breaker.PROBE)
                elif route == _breaker.PROBE:
                    # the probe never reached the forward (restart still
                    # pending): no verdict, release the probe slot
                    brk.abort_probe()
                self._note_breaker(served, current, brk)
            if not unpinned:
                raise
            # failover: the crash stays invisible when a chain exists
            return self._serve_degraded(served, x, deadline_s,
                                        exclude=current,
                                        reason="crash_failover",
                                        original=e)
        except BaseException:
            if brk is not None and route == _breaker.PROBE:
                brk.abort_probe()  # 504/model error is not a crash verdict
            raise
        if brk is not None:
            brk.record_success(probe=route == _breaker.PROBE)
            self._note_breaker(served, current, brk)
        with self._lock:
            ver = next((mv.version for mv in served.versions.values()
                        if mv.model is model), served.current_version)
            if served.shadow is not None and ver == served.current_version:
                self._enqueue_shadow(served, x, out)
        return out, ver

    # ----------------------------------------------------------- lifecycle
    def shutdown(self) -> None:
        """Stop every dispatcher (flushes in-flight batches first) and
        the shadow worker (a parked daemon thread would otherwise keep
        the registry and every model graph alive for process lifetime)."""
        with self._lock:
            models = list(self._models.values())
        for m in models:
            m.inference.shutdown()
        with self._shadow_cv:
            self._shadow_stop = True
            self._shadow_queue.clear()
            self._shadow_cv.notify_all()
        # joined, so that no thread is inside torch when the interpreter
        # exits after a shutdown (that aborts the process)
        if self._shadow_thread is not None:
            self._shadow_thread.join(timeout=5.0)
