"""Pipeline runner: the orchestration that makes the stages one product.

``ContinuousPipeline`` composes the subsystem — journaled state machine
(``state.py``), streaming trainer (``trainer.py``), eval gate
(``gate.py``), canary controller (``canary.py``) and the registry's
weighted-routing/shadow data plane (``serving/registry.py``) — into the
loop::

    stream -> TRAIN (mini-epoch fit, watchdog-guarded)
           -> EVAL  (gate vs the serving version, journaled)
           -> CANARY (ramp + shadow, SLO/alert-watched)
           -> PROMOTE (hot-swap) | ROLLBACK (discard)

Crash safety: every stage is entered/committed through the fenced
journal, so a restarted pipeline resumes at the crashed stage and
converges to the same terminal state.  Work that cannot survive a crash
is *redone* (an uncommitted TRAIN retrains from the serving version, an
uncommitted CANARY re-ramps from the first step); work that must happen
exactly once is *idempotent* (PROMOTE re-runs ``registry.activate``,
which no-ops when the version is already live) and the journal's
single-terminal rule makes a second promote/rollback un-committable.
The trained candidate itself is made durable at TRAIN commit: the runner
serializes it into the journal directory and records the path, so a
restarted process (whose in-memory registry is fresh) re-registers the
same weights rather than the same version *number*.

``PipelineConfig`` is the JSON schema shared by the ``pipeline`` CLI
subcommand, ``examples/pipeline_config.json`` and
``tools/validate_pipeline_config.py``.

The port's copy of the JAX package's ``pipeline/runner.py``, on the
port's ``ModelRegistry`` and zip serializer.
"""

from __future__ import annotations

import json
import os
import threading
import time as _time
from typing import Any, Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.observe import log as _slog
from deeplearning4j_tpu_torch.observe.health import WatchdogAlarm
from deeplearning4j_tpu_torch.pipeline.canary import CanaryController, parse_schedule
from deeplearning4j_tpu_torch.pipeline.gate import GATE_METRICS, EvalGate
from deeplearning4j_tpu_torch.pipeline.state import PipelineStateMachine
from deeplearning4j_tpu_torch.pipeline.trainer import (ContinuousTrainer,
                                                 StreamBuffer, StreamStuck)

_WATCHDOG_MODES = ("off", "log", "raise")


class CandidateLost(RuntimeError):
    """A resumed run's candidate is neither registered in this process
    nor recoverable from its persisted checkpoint — the run cannot
    proceed and is decided as a journaled ROLLBACK."""


class PipelineConfig:
    """Parsed + validated pipeline parameters.

    Schema (all sections optional, defaults shown)::

        {
          "name": "model",
          "cycles": 1,
          "train": {"batch_size": 32, "batches_per_mini_epoch": 4,
                    "mini_epochs": 3, "take_timeout_s": 5.0,
                    "watchdog": "raise"},
          "gate":  {"metric": "loss", "rel_margin": 0.0,
                    "abs_margin": 0.0, "batch_size": 64},
          "canary": {"schedule": [{"fraction": 0.1, "hold_s": 30},
                                  {"fraction": 0.5, "hold_s": 30}],
                     "shadow_sample": 0.25,
                     "divergence_threshold": 0.001,
                     "max_divergences": null,
                     "abort_on_alerts": null,
                     "poll_s": 0.5}
        }

    ``parse`` raises ``ValueError`` naming the offending field on any
    schema problem; :meth:`lint` returns dry-run warnings for configs
    that parse but cannot behave as written (the validator's second
    pass).
    """

    _SECTIONS = ("name", "cycles", "train", "gate", "canary")
    _TRAIN_KEYS = ("batch_size", "batches_per_mini_epoch", "mini_epochs",
                   "take_timeout_s", "watchdog")
    _GATE_KEYS = ("metric", "rel_margin", "abs_margin", "batch_size")
    _CANARY_KEYS = ("schedule", "shadow_sample", "divergence_threshold",
                    "max_divergences", "abort_on_alerts", "poll_s")

    def __init__(self):
        self.name = "model"
        self.cycles = 1
        self.train: Dict[str, Any] = {
            "batch_size": 32, "batches_per_mini_epoch": 4,
            "mini_epochs": 3, "take_timeout_s": 5.0, "watchdog": "raise"}
        self.gate: Dict[str, Any] = {
            "metric": "loss", "rel_margin": 0.0, "abs_margin": 0.0,
            "batch_size": 64}
        self.canary: Dict[str, Any] = {
            "schedule": [{"fraction": 0.1, "hold_s": 30},
                         {"fraction": 0.5, "hold_s": 30}],
            "shadow_sample": 0.25, "divergence_threshold": 1e-3,
            "max_divergences": None, "abort_on_alerts": None,
            "poll_s": 0.5}

    # ------------------------------------------------------------- parsing
    @classmethod
    def parse(cls, spec) -> "PipelineConfig":
        """From a parsed dict, a JSON string, or a file path."""
        if isinstance(spec, (str, bytes)) and not str(
                spec).lstrip().startswith("{"):
            with open(spec, "r", encoding="utf-8") as fh:
                spec = json.load(fh)
        elif isinstance(spec, (str, bytes)):
            spec = json.loads(spec)
        if not isinstance(spec, dict):
            raise ValueError("pipeline config must be a JSON object")
        unknown = set(spec) - set(cls._SECTIONS)
        if unknown:
            raise ValueError(f"unknown config section(s) {sorted(unknown)} "
                             f"(known: {cls._SECTIONS})")
        cfg = cls()
        if "name" in spec:
            if not isinstance(spec["name"], str) or not spec["name"]:
                raise ValueError("name: must be a non-empty string")
            cfg.name = spec["name"]
        if "cycles" in spec:
            if not isinstance(spec["cycles"], int) or spec["cycles"] < 1:
                raise ValueError(
                    f"cycles: must be an int >= 1, got {spec['cycles']!r}")
            cfg.cycles = spec["cycles"]
        for section, known, target in (
                ("train", cls._TRAIN_KEYS, cfg.train),
                ("gate", cls._GATE_KEYS, cfg.gate),
                ("canary", cls._CANARY_KEYS, cfg.canary)):
            sub = spec.get(section)
            if sub is None:
                continue
            if not isinstance(sub, dict):
                raise ValueError(f"{section}: must be an object")
            bad = set(sub) - set(known)
            if bad:
                raise ValueError(f"{section}: unknown key(s) {sorted(bad)} "
                                 f"(known: {known})")
            target.update(sub)
        cfg._validate()
        return cfg

    def _validate(self) -> None:
        t = self.train
        for key in ("batch_size", "batches_per_mini_epoch", "mini_epochs"):
            if not isinstance(t[key], int) or t[key] < 1:
                raise ValueError(
                    f"train.{key}: must be an int >= 1, got {t[key]!r}")
        if not isinstance(t["take_timeout_s"], (int, float)) \
                or t["take_timeout_s"] <= 0:
            raise ValueError(
                f"train.take_timeout_s: must be > 0, "
                f"got {t['take_timeout_s']!r}")
        wd = t["watchdog"]
        if not (wd in _WATCHDOG_MODES or isinstance(wd, dict)):
            raise ValueError(
                f"train.watchdog: must be one of {_WATCHDOG_MODES} or a "
                f"TrainingWatchdog kwargs object, got {wd!r}")
        g = self.gate
        if g["metric"] not in GATE_METRICS:
            raise ValueError(f"gate.metric: unknown metric "
                             f"{g['metric']!r} (one of {GATE_METRICS})")
        for key in ("rel_margin", "abs_margin"):
            if not isinstance(g[key], (int, float)) or g[key] < 0:
                raise ValueError(
                    f"gate.{key}: must be >= 0, got {g[key]!r}")
        if not isinstance(g["batch_size"], int) or g["batch_size"] < 1:
            raise ValueError(f"gate.batch_size: must be an int >= 1, "
                             f"got {g['batch_size']!r}")
        c = self.canary
        try:
            parse_schedule(c["schedule"])
        except (TypeError, KeyError) as e:
            raise ValueError(f"canary.schedule: malformed step ({e})") from e
        except ValueError as e:
            raise ValueError(f"canary.schedule: {e}") from e
        if not isinstance(c["shadow_sample"], (int, float)) \
                or not 0.0 <= c["shadow_sample"] <= 1.0:
            raise ValueError(f"canary.shadow_sample: must be in [0, 1], "
                             f"got {c['shadow_sample']!r}")
        if not isinstance(c["divergence_threshold"], (int, float)) \
                or c["divergence_threshold"] < 0:
            raise ValueError(
                f"canary.divergence_threshold: must be >= 0, "
                f"got {c['divergence_threshold']!r}")
        if c["max_divergences"] is not None and (
                not isinstance(c["max_divergences"], int)
                or c["max_divergences"] < 0):
            raise ValueError(
                f"canary.max_divergences: must be null or an int >= 0, "
                f"got {c['max_divergences']!r}")
        if c["abort_on_alerts"] is not None and (
                not isinstance(c["abort_on_alerts"], list)
                or not all(isinstance(a, str) for a in c["abort_on_alerts"])):
            raise ValueError(
                "canary.abort_on_alerts: must be null or a list of rule "
                "names")
        if not isinstance(c["poll_s"], (int, float)) or c["poll_s"] <= 0:
            raise ValueError(
                f"canary.poll_s: must be > 0, got {c['poll_s']!r}")

    # ---------------------------------------------------------------- lint
    def lint(self) -> List[str]:
        """Dry-run warnings for configs that parse but cannot behave as
        written (nothing is executed)."""
        problems: List[str] = []
        c = self.canary
        if c["max_divergences"] is not None and c["shadow_sample"] == 0:
            problems.append(
                "canary.max_divergences is set but shadow_sample is 0 — "
                "no shadow comparisons ever run, so the divergence budget "
                "can never trigger a rollback")
        if all(float(s["fraction"] if isinstance(s, dict) else s.fraction)
               * float(s["hold_s"] if isinstance(s, dict) else s.hold_s) == 0
               for s in c["schedule"]):
            problems.append(
                "canary.schedule holds every fraction for 0s — the canary "
                "decides instantly and observes no traffic")
        if self.train["watchdog"] == "off" \
                and self.gate["rel_margin"] == 0 \
                and self.gate["abs_margin"] == 0:
            problems.append(
                "train.watchdog is off and both gate margins are 0 — a "
                "noisily-trained candidate will be rejected by the strict "
                "gate with no earlier signal; consider watchdog 'log' or "
                "a small gate margin")
        return problems


class ContinuousPipeline:
    """One model's continuous-training loop over a live registry.

    The caller owns the stream (a ``streaming.Route`` delivering into
    ``buffer``), the ``registry`` (with the model's serving version
    registered and live) and the held-out ``eval_set``; the pipeline owns
    the journal under ``state_dir`` and the stage choreography.

    ``canary_wait(poll_s)`` runs between canary ticks — the seam where
    deterministic callers advance a ``ManualTimeSource`` and drive
    traffic; it defaults to a real sleep.  ``alerts`` is an
    ``observe.alerts.AlertManager`` whose firing rules can roll the
    canary back.  :meth:`request_stop` (the CLI's SIGTERM path) drains
    cleanly: the open run is decided as a journaled ROLLBACK instead of
    being abandoned mid-stage.
    """

    def __init__(self, registry, name: str, state_dir: str, *,
                 config: Optional[PipelineConfig] = None,
                 buffer: Optional[StreamBuffer] = None,
                 route=None, eval_set=None,
                 metrics=None, tracer=None, time_source=None, alerts=None,
                 sample_input=None,
                 candidate_source: Optional[Callable[[], Any]] = None,
                 canary_wait: Optional[Callable[[float], None]] = None):
        self.registry = registry
        self.name = name
        self.state_dir = str(state_dir)
        self.config = config if config is not None else PipelineConfig()
        self.buffer = buffer if buffer is not None else StreamBuffer()
        self.route = route
        self.eval_set = eval_set
        self.metrics = metrics
        self.tracer = tracer
        self.time_source = time_source
        self.alerts = alerts
        self.sample_input = sample_input
        self.candidate_source = candidate_source
        self.canary_wait = canary_wait
        self.sm = PipelineStateMachine(self.state_dir, name=name,
                                       metrics=metrics)
        self._stop = threading.Event()
        self._log = _slog.get_logger("pipeline")
        # how long the CANARY stage waits for an async candidate warmup
        # before deciding rollback (sync warmup finishes at registration,
        # so the default path never waits)
        self.warm_timeout_s = 120.0

    # ------------------------------------------------------------ plumbing
    def request_stop(self) -> None:
        """Ask for a clean drain: the current run decides ROLLBACK at the
        next stage boundary / canary tick instead of crashing mid-stage."""
        self._stop.set()

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    def _serving_model(self):
        served = self.registry.get(self.name)
        return served.versions[served.current_version].model

    def _candidate_model(self):
        if self.candidate_source is not None:
            return self.candidate_source()
        base = self._serving_model()
        if hasattr(base, "clone"):
            return base.clone()
        raise TypeError(
            f"serving model {type(base).__name__} has no clone(); pass "
            "candidate_source= to supply candidate models")

    def _persist_candidate(self, model) -> Optional[str]:
        """Serialize the trained candidate next to the journal so a
        restarted process can re-register the same weights."""
        path = os.path.join(self.state_dir,
                            f"candidate_run{self.sm.run:04d}.zip")
        try:
            from deeplearning4j_tpu_torch.util import model_serializer
            model_serializer.write_model(model, path)
            return path
        except Exception:  # noqa: BLE001 — non-serializable candidates
            # (duck-typed stubs) stay process-local; resume then retrains
            return None

    def _ensure_candidate(self, data: dict) -> int:
        """Resolve the journaled candidate to a version in THIS process's
        registry: the journaled version when it exists, else re-register
        from the persisted checkpoint path."""
        version = data.get("candidate_version")
        served = self.registry.get(self.name)
        if version is not None and version in served.versions:
            return int(version)
        path = data.get("candidate_path")
        if not path:
            # later-stage records only carry the version; the durable
            # checkpoint path lives in this run's TRAIN commit
            for r in self.sm.stage_history():
                if (r.get("stage"), r.get("event")) == ("TRAIN", "commit"):
                    path = r.get("data", {}).get("candidate_path")
        if path and os.path.exists(path):
            return self.registry.register(
                self.name, path=path, activate=False,
                sample_input=self.sample_input)
        raise CandidateLost(
            f"run {self.sm.run}: candidate v{version} is not registered "
            f"and its checkpoint is gone (path={path!r})")

    def restore_promoted(self) -> Optional[int]:
        """Re-apply the journal's LATEST committed PROMOTE to this
        process's registry — the cross-process crash-recovery step for
        callers (the CLI) that rebuild the registry from the original
        baseline artifact: without it a restart would silently serve
        pre-promotion weights and write them to --modelOutputPath even
        though the journal records the promotion. Returns the version
        the promoted weights got in THIS registry (None when no promote
        was journaled or its checkpoint is gone)."""
        records = self.sm.journal.records()
        last_promote = None
        for r in records:
            if (r.get("stage"), r.get("event")) == ("PROMOTE", "commit"):
                last_promote = r
        if last_promote is None:
            return None
        run = int(last_promote.get("run", -1))
        path = None
        for r in records:
            if int(r.get("run", -2)) == run and \
                    (r.get("stage"), r.get("event")) == ("TRAIN", "commit"):
                path = r.get("data", {}).get("candidate_path")
        if not path or not os.path.exists(path):
            self._log.warning(
                "journal records a PROMOTE but its candidate checkpoint "
                "is gone; serving the registered baseline",
                run=run, candidate_path=path)
            return None
        version = self.registry.register(
            self.name, path=path, activate=True,
            sample_input=self.sample_input)
        self._log.info("restored journaled promotion", run=run,
                       version=version, candidate_path=path)
        return version

    def _candidate_zip(self, run: int) -> str:
        return os.path.join(self.state_dir, f"candidate_run{run:04d}.zip")

    def _retire_candidate(self, run: int, version: Optional[int]) -> None:
        """A decided ROLLBACK has no further use for the candidate: drop
        its registry version (full weights + warmed forwards) and its
        persisted checkpoint, so an indefinitely-running pipeline does
        not leak one model per rejected cycle."""
        try:
            if version is not None \
                    and version != self.registry.get(
                        self.name).current_version:
                self.registry.unregister(self.name, version)
        except Exception:  # noqa: BLE001 — retirement is best-effort
            pass
        try:
            os.unlink(self._candidate_zip(run))
        except OSError:
            pass

    def _prune_candidate_zips(self, keep_run: int) -> None:
        """After a PROMOTE, only the promoted run's checkpoint is needed
        (it is what ``restore_promoted`` re-registers after a restart)."""
        try:
            names = os.listdir(self.state_dir)
        except OSError:
            return
        keep = os.path.basename(self._candidate_zip(keep_run))
        for n in names:
            if n.startswith("candidate_run") and n.endswith(".zip") \
                    and n != keep:
                try:
                    os.unlink(os.path.join(self.state_dir, n))
                except OSError:
                    pass

    def _await_candidate_warm(self, version: int) -> tuple:
        """Block until the candidate's AOT warmup finished (async
        registries warm in the background; the traffic split is
        warm-gated, so fronting a cold candidate is refused anyway).
        A FAILED warmup gets one ``rewarm()``; persistent failure or
        timeout returns (False, why) and the canary decides rollback
        instead of crash-looping on the warm gate."""
        if not hasattr(self.registry, "warmup_state"):
            return True, "registry has no warmup tracking"
        deadline = _time.monotonic() + self.warm_timeout_s
        rewarmed = False
        while True:
            state = self.registry.warmup_state(self.name, version)
            status = state.get("status")
            if status in ("warm", "skipped", "unknown"):
                return True, status
            if status == "error":
                if rewarmed:
                    return False, (state.get("reason")
                                   or "warmup failed twice")
                rewarmed = True
                try:
                    self.registry.rewarm(self.name, version)
                except Exception as e:  # noqa: BLE001
                    return False, f"rewarm failed: {e}"
                continue
            if _time.monotonic() > deadline:
                return False, (f"warmup still {status!r} after "
                               f"{self.warm_timeout_s}s")
            _time.sleep(0.05)

    # -------------------------------------------------------------- stages
    def _stage_train(self) -> dict:
        cfg = self.config.train
        candidate = self._candidate_model()
        wd = cfg["watchdog"]
        watchdog = (None if wd == "off"
                    else dict(wd) if isinstance(wd, dict)
                    else {"action": wd})
        trainer = ContinuousTrainer(
            candidate, self.buffer,
            batch_size=cfg["batch_size"],
            batches_per_mini_epoch=cfg["batches_per_mini_epoch"],
            take_timeout_s=cfg["take_timeout_s"],
            metrics=self.metrics, tracer=self.tracer,
            model_name=f"{self.name}-candidate", watchdog=watchdog)
        stats = None
        for _ in range(cfg["mini_epochs"]):
            if self._stop.is_set():
                break
            try:
                stats = trainer.train_mini_epoch()
            except StreamStuck:
                err = (getattr(self.route, "error", None)
                       if self.route is not None else None)
                if err is not None:
                    # a FAILED route is not a drained one: a candidate
                    # trained on a truncated stream must not promote
                    raise StreamStuck(f"stream failed: {err!r}") from err
                if trainer.mini_epochs > 0 and self._route_finished():
                    break  # stream drained cleanly: train on what arrived
                raise
        if stats is None:
            raise StreamStuck(
                "stream delivered nothing to train on "
                f"(route error: {getattr(self.route, 'error', None)!r})")
        version = self.registry.register(
            self.name, model=candidate, activate=False,
            sample_input=self.sample_input)
        path = self._persist_candidate(candidate)
        return {"candidate_version": version, "candidate_path": path,
                "examples": trainer.examples_seen,
                "mini_epochs": trainer.mini_epochs,
                "score": stats["score"]}

    def _route_finished(self) -> bool:
        """A CLEAN drain only — a failed route is handled (and raised)
        separately in the train loop."""
        if self.route is None:
            return True  # no route attached: caller feeds the buffer
        return getattr(self.route, "result", None) is not None

    def _stage_eval(self, candidate_version: int) -> dict:
        if self.eval_set is None:
            raise ValueError("eval gate needs eval_set= (a held-out "
                             "DataSet) — refusing to promote unevaluated "
                             "candidates")
        cfg = self.config.gate
        gate = EvalGate(self.eval_set, metric=cfg["metric"],
                        rel_margin=cfg["rel_margin"],
                        abs_margin=cfg["abs_margin"],
                        batch_size=cfg["batch_size"])
        served = self.registry.get(self.name)
        candidate = served.versions[candidate_version].model
        result = gate.evaluate(candidate, self._serving_model())
        out = result.to_dict()
        out["candidate_version"] = candidate_version
        return out

    def _stage_canary(self, candidate_version: int) -> dict:
        cfg = self.config.canary
        warm, why = self._await_candidate_warm(candidate_version)
        if not warm:
            return {"decision": "rollback",
                    "reason": f"candidate never became warm: {why}",
                    "candidate_version": candidate_version,
                    "shadow": {"requests": 0, "divergences": 0}}
        controller = CanaryController(
            self.registry, self.name, candidate_version,
            schedule=cfg["schedule"], time_source=self.time_source,
            alerts=self.alerts, abort_on_alerts=cfg["abort_on_alerts"],
            shadow_sample=cfg["shadow_sample"],
            divergence_threshold=cfg["divergence_threshold"],
            max_divergences=cfg["max_divergences"],
            on_event=lambda kind, detail: self.sm.note(
                f"canary {kind}", **detail))
        controller.start()
        while True:
            if self._stop.is_set():
                controller.report_alarm("operator stop (drain)")
            decision = controller.tick()
            if decision is not None:
                break
            if self.canary_wait is not None:
                self.canary_wait(cfg["poll_s"])
            else:
                _time.sleep(cfg["poll_s"])
        shadow = controller.shadow_final or {"requests": 0,
                                             "divergences": 0}
        return {"decision": decision, "reason": controller.reason,
                "candidate_version": candidate_version,
                "shadow": {k: shadow.get(k, 0)
                           for k in ("requests", "divergences")}}

    # ------------------------------------------------------------ the loop
    def _rollback_run(self, reason: str) -> dict:
        """Decide the open run as a journaled ROLLBACK from wherever it
        currently is — the recovery for a resumed run whose candidate is
        unrecoverable (a crash loop otherwise: the run could neither
        finish nor be superseded)."""
        st = self.sm.state()
        if st.stage in ("TRAIN", "EVAL", "CANARY") and not st.committed:
            self.sm.commit(st.stage, aborted=reason)
        st = self.sm.state()
        if not (st.stage == "ROLLBACK" and not st.committed):
            self.sm.enter("ROLLBACK", reason=reason)
        self.registry.clear_traffic_split(self.name)
        self.registry.clear_shadow(self.name)
        self.sm.commit("ROLLBACK", reason=reason)
        self._retire_candidate(self.sm.run, None)
        return self._summary()

    def run_cycle(self) -> dict:
        """Advance the journal to this run's terminal commit — starting a
        fresh run from IDLE, or finishing a crashed predecessor's run
        from its resume point — and return the run summary.

        While a tracer is active the whole cycle runs inside a
        ``pipeline_run`` span, so every journal append made during it
        (``PipelineJournal.append`` stamps the active trace id) and every
        log line is correlatable back to the cycle that decided."""
        from deeplearning4j_tpu_torch.observe import trace as _trace
        tracer = self.tracer if self.tracer is not None \
            else _trace.get_active_tracer()
        if tracer is None:
            return self._run_cycle_inner()
        with tracer.span("pipeline_run", category="pipeline",
                         attrs={"pipeline": self.name}) as sp:
            summary = self._run_cycle_inner()
            sp.set_attribute("run", summary.get("run"))
            sp.set_attribute("outcome", summary.get("outcome"))
            return summary

    def _run_cycle_inner(self) -> dict:
        st = self.sm.state()
        if st.stage == "IDLE":
            # a predecessor that crashed right after begin_run left an
            # opened-but-empty run: continue IT rather than abandoning it
            # undecided under a fresh run number
            if not self.sm.open_empty_run():
                self.sm.begin_run()
            st = self.sm.state()
        self._log.info("pipeline cycle", run=self.sm.run, stage=st.stage,
                       committed=st.committed)
        try:
            return self._run_stages(st)
        except CandidateLost as e:
            # the run cannot proceed and must not crash-loop: decide it
            self._log.warning("candidate unrecoverable; rolling back",
                              run=self.sm.run, reason=str(e))
            return self._rollback_run(f"candidate lost: {e}")

    def _run_stages(self, st) -> dict:
        # TRAIN ---------------------------------------------------------
        if st.stage in ("IDLE",) or (st.stage == "TRAIN"
                                     and not st.committed):
            if st.stage != "TRAIN":
                self.sm.enter("TRAIN")
            try:
                data = self._stage_train()
            except (WatchdogAlarm, StreamStuck) as e:
                self.sm.commit("TRAIN", aborted=f"{type(e).__name__}: {e}")
                self.sm.enter("ROLLBACK", reason=f"TRAIN aborted: {e}")
                data = None
            if data is not None:
                self.sm.commit("TRAIN", **data)
            st = self.sm.state()

        # EVAL ----------------------------------------------------------
        if st.stage == "TRAIN" and st.committed:
            if "candidate_version" not in st.data:  # aborted TRAIN commit
                self.sm.enter("ROLLBACK", reason="TRAIN aborted")
            else:
                version = self._ensure_candidate(st.data)
                self.sm.enter("EVAL", candidate_version=version)
            st = self.sm.state()
        if st.stage == "EVAL" and not st.committed:
            version = self._ensure_candidate(st.data)
            self.sm.commit("EVAL", **self._stage_eval(version))
            st = self.sm.state()

        # gate verdict → CANARY or ROLLBACK -----------------------------
        if st.stage == "EVAL" and st.committed:
            version = self._ensure_candidate(st.data)
            if not st.data.get("passed"):
                self.sm.enter("ROLLBACK", candidate_version=version,
                              reason=st.data.get("detail",
                                                 "eval gate failed"))
            else:
                self.sm.enter("CANARY", candidate_version=version)
            st = self.sm.state()
        if st.stage == "CANARY" and not st.committed:
            version = self._ensure_candidate(st.data)
            self.sm.commit("CANARY", **self._stage_canary(version))
            st = self.sm.state()

        # decision → PROMOTE or ROLLBACK --------------------------------
        if st.stage == "CANARY" and st.committed:
            version = self._ensure_candidate(st.data)
            if st.data.get("decision") == "promote":
                self.sm.enter("PROMOTE", candidate_version=version)
            else:
                self.sm.enter("ROLLBACK", candidate_version=version,
                              reason=st.data.get("reason", "canary"))
            st = self.sm.state()
        if st.stage == "PROMOTE" and not st.committed:
            version = self._ensure_candidate(st.data)
            # idempotent: a resume after the swap landed no-ops here, so
            # the journal's single PROMOTE commit matches ≤1 swap event
            self.registry.activate(self.name, version)
            self.sm.commit("PROMOTE", version=version)
            # older runs' checkpoints are superseded; keep only this one
            # (restore_promoted's cross-process recovery artifact)
            self._prune_candidate_zips(self.sm.run)
        elif st.stage == "ROLLBACK" and not st.committed:
            # nothing was promoted; make sure no canary plumbing survives
            self.registry.clear_traffic_split(self.name)
            self.registry.clear_shadow(self.name)
            self.sm.commit("ROLLBACK",
                           reason=st.data.get("reason", "rolled back"))
            # the rejected candidate has no further use: free its
            # registry slot + persisted checkpoint
            self._retire_candidate(self.sm.run,
                                   st.data.get("candidate_version"))
        return self._summary()

    def _summary(self) -> dict:
        outcome = self.sm.decided()
        terminal = [r for r in self.sm.stage_history()
                    if r.get("event") == "commit"
                    and r.get("stage") == outcome]
        data = terminal[-1].get("data", {}) if terminal else {}
        summary = {"run": self.sm.run, "outcome": outcome,
                   "detail": data,
                   "live_version":
                       self.registry.get(self.name).current_version}
        self._log.info("pipeline run decided", **{
            "run": summary["run"], "outcome": outcome,
            "live_version": summary["live_version"]})
        return summary

    def run(self, cycles: Optional[int] = None) -> List[dict]:
        """Run ``cycles`` full runs (default: config), stopping early on
        :meth:`request_stop`; returns the per-run summaries."""
        cycles = self.config.cycles if cycles is None else int(cycles)
        out = []
        for _ in range(cycles):
            out.append(self.run_cycle())
            if self._stop.is_set():
                break
        return out
