"""Persistent pipeline state machine: the crash-safe spine of the
continuous-training loop.

A pipeline *run* moves through fixed stages::

    IDLE -> TRAIN -> EVAL -> CANARY -> PROMOTE | ROLLBACK

Every stage is a two-phase record in an append-only journal — ``enter``
when work begins, ``commit`` when it finished — so a crash at any point
leaves an unambiguous resume point: the stage that was entered but never
committed.  The terminal stages are exclusive per run (journal-enforced):
a run commits exactly one ``PROMOTE`` or one ``ROLLBACK``, never both and
never two, which is what makes a restarted pipeline unable to
double-promote.

Fencing reuses the elastic supervisor's ``GenerationLedger`` commit-stamp
pattern (``parallel/elastic.py``): each pipeline *process* acquires an
ownership token; every journal append re-reads the owner file first and
refuses to write under a stale token (:class:`StalePipelineError`), and
acquisition snapshots the sequence numbers the previous owner had
committed — a zombie's append that slips past the re-read race is dropped
on replay because its seq is not in its token's fenced snapshot.  The
result is the same guarantee the elastic ledger gives checkpoints: a
process that lost ownership can still write bytes, but nothing it writes
after the fence is ever part of the recovered state.

Fault injection: after every journal append the machine calls
``util.faultinject.on_step("pipeline", seq)`` — a fault plan entry like
``{"type": "kill", "worker": "pipeline", "step": 7}`` SIGKILLs the
pipeline process at the 7th journal record, which is how CI proves that
a restart mid-CANARY resumes and converges to the same terminal state.

The port's copy of the JAX package's jax-free ``pipeline/state.py``: the
same journal lines, so either package replays the other's journal.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.observe import trace as _trace
from deeplearning4j_tpu_torch.util import faultinject
from deeplearning4j_tpu_torch.util.fsio import atomic_write_text

OWNER_FILE = "pipeline_owner.json"
JOURNAL_FILE = "pipeline_journal.jsonl"

STAGES = ("TRAIN", "EVAL", "CANARY", "PROMOTE", "ROLLBACK")
TERMINAL_STAGES = ("PROMOTE", "ROLLBACK")

# stage -> stages that may legally be ENTERED after it commits
_NEXT: Dict[str, tuple] = {
    "TRAIN": ("EVAL", "ROLLBACK"),   # ROLLBACK: watchdog-rejected candidate
    "EVAL": ("CANARY", "PROMOTE", "ROLLBACK"),
    "CANARY": ("PROMOTE", "ROLLBACK"),
    "PROMOTE": (),
    "ROLLBACK": (),
}

# the fault-injection slot id for every pipeline-process transition
FAULT_SLOT = "pipeline"


class StalePipelineError(RuntimeError):
    """This process lost pipeline ownership (another process acquired the
    journal); its transitions are un-committable."""


class IllegalTransition(RuntimeError):
    """The requested stage is not legal from the current state."""


class AlreadyDecided(RuntimeError):
    """The run already committed a terminal stage — a second
    promote/rollback is refused (single-decision semantics)."""


class PipelineJournal:
    """Fenced append-only journal under ``directory``.

    ``acquire()`` takes ownership: it fences every earlier owner by
    snapshotting the seqs each had appended (the elastic ledger's
    ``known_steps``), then installs a fresh token.  ``append()`` re-reads
    the owner file and refuses stale tokens.  ``records()`` replays only
    *eligible* lines: the current owner's, plus fenced owners' lines that
    are inside their snapshot — a zombie's post-fence line parses fine but
    is not part of recovered state.
    """

    def __init__(self, directory: str):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.owner_path = os.path.join(self.directory, OWNER_FILE)
        self.journal_path = os.path.join(self.directory, JOURNAL_FILE)
        self._next_seq: Optional[int] = None  # cached at acquire()

    # ------------------------------------------------------------ ownership
    def _read_owner(self) -> Optional[dict]:
        try:
            with open(self.owner_path, encoding="utf-8") as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None

    def _repair_torn_tail(self) -> None:
        """Terminate a torn final line (a crash mid-write) so the NEXT
        append starts on a fresh line instead of concatenating into the
        torn JSON and vanishing from replay. The torn record itself stays
        unparseable — it never committed — but everything after it must."""
        try:
            with open(self.journal_path, "rb") as fh:
                fh.seek(-1, os.SEEK_END)
                last = fh.read(1)
        except (OSError, ValueError):  # missing or empty journal
            return
        if last != b"\n":
            with open(self.journal_path, "ab") as fh:
                fh.write(b"\n")
                fh.flush()
                os.fsync(fh.fileno())

    def acquire(self, meta: Optional[dict] = None) -> str:
        """Become the journal's owner; returns the new token. Any earlier
        owner is fenced with a snapshot of the seqs it has committed so
        far — everything it appends afterwards is ineligible."""
        self._repair_torn_tail()
        owner = self._read_owner() or {"lineage": []}
        seqs_by_token: Dict[str, List[int]] = {}
        for rec in self._raw_records():
            seqs_by_token.setdefault(rec["token"], []).append(rec["seq"])
        for entry in owner.get("lineage", []):
            if not entry.get("fenced"):
                entry["fenced"] = True
                entry["known_seqs"] = sorted(
                    seqs_by_token.get(entry["token"], []))
        token = f"{os.getpid():x}-{os.urandom(8).hex()}"
        owner.setdefault("lineage", []).append(
            {"token": token, "fenced": False, "known_seqs": []})
        owner["token"] = token
        owner["acquired_ms"] = int(time.time() * 1000)
        if meta:
            owner["meta"] = meta
        atomic_write_text(self.owner_path, json.dumps(owner, indent=1),
                          fsync=True)
        # cache the next seq so appends don't re-scan the whole journal
        # (O(n^2) over a long-lived pipeline otherwise). A fenced zombie
        # appending concurrently may collide on a seq — harmless: replay
        # eligibility is keyed on (token, seq) and the zombie's seq is
        # outside its fence snapshot either way.
        self._next_seq = self._line_count() + 1
        return token

    def current_token(self) -> Optional[str]:
        owner = self._read_owner()
        return None if owner is None else owner.get("token")

    # -------------------------------------------------------------- append
    def append(self, token: str, record: Dict[str, Any]) -> int:
        """Append one record under ``token``; returns its seq. Re-reads
        the owner file first: a stale token raises
        :class:`StalePipelineError` and writes nothing."""
        if self.current_token() != token:
            raise StalePipelineError(
                f"pipeline ownership lost (token {token[:8]}… fenced); "
                "this process must not commit transitions")
        if self._next_seq is None:  # append without acquire (tests)
            self._next_seq = self._line_count() + 1
        seq = self._next_seq
        rec = dict(record)
        rec["seq"] = seq
        rec["token"] = token
        rec["ts"] = time.time()
        # trace correlation (the LogRecord contract): a journal line
        # written inside a traced pipeline run carries the active span's
        # ids, so a promote/rollback decision is joinable with the spans
        # and logs that caused it. Reads the context directly (ids are
        # tracer-independent) so an explicitly-passed runner tracer
        # correlates too; no open span → no fields, no cost.
        trace_id, span_id = _trace.current_span_ids()
        if trace_id is not None:
            rec.setdefault("trace_id", trace_id)
            rec.setdefault("span_id", span_id)
        line = json.dumps(rec, sort_keys=True)
        with open(self.journal_path, "a", encoding="utf-8") as fh:
            fh.write(line + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        self._next_seq = seq + 1
        return seq

    def _line_count(self) -> int:
        n = 0
        try:
            with open(self.journal_path, encoding="utf-8") as fh:
                for line in fh:
                    if line.endswith("\n"):
                        n += 1
        except OSError:
            pass
        return n

    # --------------------------------------------------------------- replay
    def _raw_records(self) -> List[dict]:
        out: List[dict] = []
        try:
            with open(self.journal_path, encoding="utf-8") as fh:
                lines = fh.readlines()
        except OSError:
            return out
        for line in lines:
            if not line.endswith("\n"):
                continue  # torn final line: that record never committed
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "seq" in rec and "token" in rec:
                out.append(rec)
        return out

    def records(self, eligible_only: bool = True) -> List[dict]:
        recs = self._raw_records()
        if not eligible_only:
            return recs
        owner = self._read_owner()
        if owner is None:
            return []
        eligible: Dict[str, Optional[set]] = {}
        for entry in owner.get("lineage", []):
            eligible[entry["token"]] = (
                set(entry.get("known_seqs", [])) if entry.get("fenced")
                else None)  # None = unfenced: everything counts
        out = []
        for rec in recs:
            known = eligible.get(rec["token"], set())
            if known is None or rec["seq"] in known:
                out.append(rec)
        return out


class PipelineState:
    """A snapshot of where the machine is: ``run`` (0 = none yet),
    ``stage`` (``"IDLE"`` or a :data:`STAGES` member), whether that stage
    has committed, and the stage's recorded data."""

    __slots__ = ("run", "stage", "committed", "data")

    def __init__(self, run: int, stage: str, committed: bool, data: dict):
        self.run = run
        self.stage = stage
        self.committed = committed
        self.data = data

    def to_dict(self) -> dict:
        return {"run": self.run, "stage": self.stage,
                "committed": self.committed, "data": dict(self.data)}

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"PipelineState(run={self.run}, stage={self.stage}, "
                f"committed={self.committed})")


class PipelineStateMachine:
    """The journaled stage machine one continuous-training pipeline runs on.

    Constructing it ACQUIRES ownership of ``directory`` (fencing any
    previous process) and replays the eligible journal into the in-memory
    state, so ``resume_point()`` immediately says where a crashed
    predecessor stopped.  All mutations go through :meth:`begin_run`,
    :meth:`enter`, :meth:`commit` and :meth:`note`; each appends a fenced
    journal record and fires the ``"pipeline"`` fault-injection step hook.

    ``metrics`` (optional ``observe.metrics.MetricsRegistry``) exports
    ``pipeline_stage{pipeline}`` (index into IDLE+STAGES),
    ``pipeline_transitions_total{pipeline,stage,event}`` and
    ``pipeline_runs_total{pipeline,outcome}``.
    """

    def __init__(self, directory: str, *, name: str = "default",
                 metrics=None):
        self.name = name
        self.journal = PipelineJournal(directory)
        self.token = self.journal.acquire(meta={"name": name})
        self._m_stage = self._m_trans = self._m_runs = None
        if metrics is not None:
            self._m_stage = metrics.gauge(
                "pipeline_stage",
                "Current pipeline stage (0=IDLE, then TRAIN..ROLLBACK)",
                ("pipeline",))
            self._m_trans = metrics.counter(
                "pipeline_transitions_total",
                "Journaled pipeline stage transitions",
                ("pipeline", "stage", "event"))
            self._m_runs = metrics.counter(
                "pipeline_runs_total",
                "Completed pipeline runs by terminal outcome",
                ("pipeline", "outcome"))
        self._replay()
        self._export_stage()

    # -------------------------------------------------------------- replay
    def _replay(self) -> None:
        self.run = 0
        self.stage: Optional[str] = None    # None = IDLE
        self.stage_committed = False
        self.stage_data: dict = {}
        self.terminal: Dict[int, str] = {}  # run -> committed terminal stage
        for rec in self.journal.records():
            event = rec.get("event")
            if event == "run":
                self.run = int(rec["run"])
                self.stage, self.stage_committed = None, False
                self.stage_data = {}
            elif event == "enter":
                self.stage = rec["stage"]
                self.stage_committed = False
                self.stage_data = rec.get("data", {})
            elif event == "commit":
                self.stage = rec["stage"]
                self.stage_committed = True
                self.stage_data = rec.get("data", {})
                if rec["stage"] in TERMINAL_STAGES:
                    self.terminal[int(rec["run"])] = rec["stage"]
            # "note" records are observability only — no state effect

    # ------------------------------------------------------------- queries
    def state(self) -> PipelineState:
        if self.stage is None or self.run in self.terminal:
            return PipelineState(self.run, "IDLE", True, {})
        return PipelineState(self.run, self.stage, self.stage_committed,
                             dict(self.stage_data))

    def resume_point(self) -> Optional[PipelineState]:
        """Where a crashed predecessor stopped: the open run's last stage
        (entered-or-committed), or ``None`` when the journal is at IDLE
        (no run, or the last run reached its terminal commit)."""
        st = self.state()
        return None if st.stage == "IDLE" else st

    def open_empty_run(self) -> bool:
        """True when a run was opened (``begin_run`` journaled) but
        crashed before entering any stage — the runner CONTINUES that run
        instead of opening a new one, preserving the exactly-one-terminal
        -per-run invariant."""
        return (self.run > 0 and self.run not in self.terminal
                and self.stage is None)

    def decided(self, run: Optional[int] = None) -> Optional[str]:
        """The terminal stage a run committed (``None`` while undecided)."""
        return self.terminal.get(self.run if run is None else int(run))

    def stage_history(self, run: Optional[int] = None) -> List[dict]:
        """All eligible records of one run, oldest first."""
        run = self.run if run is None else int(run)
        return [r for r in self.journal.records()
                if int(r.get("run", -1)) == run]

    # ----------------------------------------------------------- mutations
    def _append(self, record: dict) -> int:
        seq = self.journal.append(self.token, record)
        if self._m_trans is not None and record.get("event") in (
                "enter", "commit"):
            self._m_trans.inc(pipeline=self.name,
                              stage=record.get("stage", "?"),
                              event=record["event"])
        self._export_stage()
        # the CI crash lever: a planned kill/stall fires at this exact seq
        faultinject.on_step(FAULT_SLOT, seq)
        return seq

    def _export_stage(self) -> None:
        if self._m_stage is None:
            return
        st = self.state()
        idx = 0 if st.stage == "IDLE" else 1 + STAGES.index(st.stage)
        self._m_stage.set(idx, pipeline=self.name)

    def begin_run(self, **data) -> int:
        """Open the next run; only legal from IDLE."""
        if self.state().stage != "IDLE":
            raise IllegalTransition(
                f"run {self.run} is still open at stage {self.stage}; "
                "finish it (terminal commit) before beginning a new run")
        self.run += 1
        self.stage, self.stage_committed, self.stage_data = None, False, {}
        self._append({"event": "run", "run": self.run, "data": data})
        return self.run

    def enter(self, stage: str, **data) -> int:
        """Journal the start of ``stage`` work. Legality: TRAIN first,
        then along :data:`_NEXT` edges; re-entering the same uncommitted
        stage is allowed (a resumed process restarts the stage's work)."""
        if stage not in STAGES:
            raise IllegalTransition(f"unknown stage {stage!r}")
        if self.run == 0 or self.run in self.terminal:
            raise IllegalTransition(
                f"no open run to enter {stage} in (begin_run() first)")
        if self.stage is None:
            legal = ("TRAIN",)
        elif self.stage_committed:
            legal = _NEXT[self.stage]
        elif self.stage == "PROMOTE":
            # an ENTERED promote that cannot complete (candidate weights
            # lost before the commit) may still be re-decided: the run has
            # not decided until a terminal COMMIT lands
            legal = ("PROMOTE", "ROLLBACK")
        else:
            legal = (self.stage,)  # resume: re-enter the crashed stage
        if stage not in legal:
            raise IllegalTransition(
                f"cannot enter {stage} from "
                f"{self.stage or 'run start'}"
                f"{'' if self.stage_committed or not self.stage else ' (uncommitted)'}; "
                f"legal: {legal}")
        if stage in TERMINAL_STAGES and self.run in self.terminal:
            raise AlreadyDecided(
                f"run {self.run} already committed {self.terminal[self.run]}")
        self.stage, self.stage_committed = stage, False
        self.stage_data = dict(data)
        return self._append({"event": "enter", "run": self.run,
                             "stage": stage, "data": data})

    def commit(self, stage: str, **data) -> int:
        """Journal the completion of ``stage``. Terminal stages enforce
        the single-decision rule: a run that already committed PROMOTE or
        ROLLBACK refuses a second terminal commit."""
        if self.stage != stage or self.stage_committed:
            raise IllegalTransition(
                f"commit({stage}) without a matching open enter "
                f"(current: {self.stage}, committed="
                f"{self.stage_committed})")
        if stage in TERMINAL_STAGES:
            if self.run in self.terminal:
                raise AlreadyDecided(
                    f"run {self.run} already committed "
                    f"{self.terminal[self.run]}")
            self.terminal[self.run] = stage
            if self._m_runs is not None:
                self._m_runs.inc(pipeline=self.name, outcome=stage.lower())
        self.stage_committed = True
        self.stage_data = dict(data)
        return self._append({"event": "commit", "run": self.run,
                             "stage": stage, "data": data})

    def note(self, message: str, **data) -> int:
        """Observability-only record (canary ramp steps, operator stops);
        replay ignores it."""
        return self._append({"event": "note", "run": self.run,
                             "stage": self.stage, "message": message,
                             "data": data})
