"""Incident flight recorder: one bounded, auditable bundle per recovery.

When the elastic supervisor decides restart/shrink/fail (including
partition resolutions) the operator's first question is *why* — and
today the evidence is scattered across per-incarnation log files, four
disjoint metric registries and in-memory trace rings that die with the
processes.  :class:`IncidentRecorder` assembles everything into one
``incident_<generation>_<seq>/`` directory at decision time:

- ``incident.json`` — the schema'd manifest (``SCHEMA_VERSION``):
  victim, decision ladder with per-rung reasons, world before/after,
  per-worker last committed step, checkpoint restore point, fault-plan
  echo, bounds;
- ``metrics.prom`` — the final fleet metrics snapshot (the
  ``FleetRegistry`` union at the moment of the decision);
- ``spans/<source>.jsonl`` — the last-N spans of every worker span
  stream plus the supervisor's own ring, in ``SpanFileWriter`` format —
  the bundle stays ``merge_chrome_traces``-loadable;
- ``logs.jsonl`` — the last-N structured log lines from the
  supervisor's active :class:`~deeplearning4j_tpu_torch.observe.log.LogRing`;
- ``logs/slot<N>.log`` — the byte-capped tail of each victim's captured
  output.

Every list is bounded (``max_spans`` per source, ``max_log_lines``,
``max_log_bytes``) — a flight recorder that can fill the checkpoint
volume is itself an incident.  ``tools/validate_incident.py`` lints a
bundle against this schema + these bounds, and the CI chaos tests run
it over the bundles their injected kills produce.

The port's copy of the JAX package's stdlib-only ``observe/incident.py``:
the same bundle layout and manifest.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

SCHEMA_VERSION = 1
KIND = "elastic_incident"
DECISIONS = ("restart", "shrink", "fail")

DEFAULT_MAX_SPANS = 200        # per span source
DEFAULT_MAX_LOG_LINES = 256    # supervisor structured-log tail
DEFAULT_MAX_LOG_BYTES = 16384  # per victim stdout/stderr tail
_PLAN_CAP = 16384              # fault-plan file echo


def bundle_name(generation: int, seq: int) -> str:
    return f"incident_{int(generation):03d}_{int(seq):03d}"


class IncidentRecorder:
    """Writes incident bundles under ``directory``.  Hold ``None``
    instead of an instance to disable — every call site is a single
    ``is None`` check, the ``enable_tracing()`` pattern."""

    def __init__(self, directory: str, *,
                 max_spans: int = DEFAULT_MAX_SPANS,
                 max_log_lines: int = DEFAULT_MAX_LOG_LINES,
                 max_log_bytes: int = DEFAULT_MAX_LOG_BYTES):
        self.directory = str(directory)
        self.max_spans = int(max_spans)
        self.max_log_lines = int(max_log_lines)
        self.max_log_bytes = int(max_log_bytes)
        # seed the sequence past every bundle already on disk: a re-run
        # supervisor restarts generation numbering at 1, and a collision
        # would silently mix a previous run's evidence (its spans/ and
        # logs/ files) into the new incident's bundle
        self._seq = self._existing_max_seq()
        self.bundles: List[str] = []

    def _existing_max_seq(self) -> int:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return 0
        seqs = [0]
        for name in names:
            parts = name.split("_")
            if len(parts) == 3 and parts[0] == "incident":
                try:
                    seqs.append(int(parts[2]))
                except ValueError:
                    continue
        return max(seqs)

    # ------------------------------------------------------------- helpers
    def _tail_span_file(self, src_path: str, dst_path: str) -> int:
        """Copy one ``SpanFileWriter`` stream keeping its meta line and
        the LAST ``max_spans`` complete span lines; returns the span
        count (0 = nothing readable)."""
        meta_line = None
        spans: List[str] = []
        try:
            with open(src_path, encoding="utf-8") as fh:
                for line in fh:
                    if not line.endswith("\n"):
                        continue  # torn tail (writer SIGKILLed mid-write)
                    if meta_line is None and '"meta"' in line:
                        meta_line = line
                        continue
                    spans.append(line)
                    if len(spans) > self.max_spans:
                        spans.pop(0)
        except OSError:
            return 0
        if meta_line is None and not spans:
            return 0
        with open(dst_path, "w", encoding="utf-8") as fh:
            if meta_line is not None:
                fh.write(meta_line)
            fh.writelines(spans)
        return len(spans)

    def _write_live_spans(self, dst_path: str, label: str, spans,
                          extra_meta: Optional[Dict[str, Any]]) -> int:
        """Serialize a live recorder's last-N spans in SpanFileWriter
        format (meta line + one line per span)."""
        from deeplearning4j_tpu_torch.observe.fleet import SpanFileWriter
        done = [s for s in spans if s.end_ns is not None][-self.max_spans:]
        writer = SpanFileWriter(dst_path, label=label,
                                extra_meta=extra_meta)
        try:
            for s in done:
                writer.add(s)
        finally:
            writer.close()
        return len(done)

    # -------------------------------------------------------------- record
    def record(self, *, job_id: str, generation: int, ts_ms: int,
               decision: str, reason: str, backoff_s: float,
               ladder: Sequence[Dict[str, Any]],
               victim: Dict[str, Any], dead_slots: Sequence[int],
               world_before: Sequence[int], world_after: Sequence[int],
               workers: Sequence[Dict[str, Any]],
               checkpoint: Dict[str, Any],
               fault_plan_env: Optional[str] = None,
               metrics_text: Optional[str] = None,
               span_files: Sequence[str] = (),
               live_spans: Optional[Tuple[str, list]] = None,
               log_tails: Optional[Dict[int, str]] = None) -> str:
        """Assemble one bundle; returns its directory path.  Must never
        fail recovery: callers wrap it (a broken flight recorder is an
        error log line, not a second incident)."""
        self._seq += 1
        bundle = os.path.join(self.directory,
                              bundle_name(generation, self._seq))
        os.makedirs(bundle, exist_ok=True)
        files: Dict[str, Optional[str]] = {
            "metrics": None, "spans_dir": None, "logs": None,
            "log_tail_dir": None}

        if metrics_text is not None:
            with open(os.path.join(bundle, "metrics.prom"), "w",
                      encoding="utf-8") as fh:
                fh.write(metrics_text)
            files["metrics"] = "metrics.prom"

        span_dir = os.path.join(bundle, "spans")
        wrote_spans = False
        for src in span_files:
            os.makedirs(span_dir, exist_ok=True)
            dst = os.path.join(span_dir, os.path.basename(src))
            if self._tail_span_file(src, dst) or os.path.exists(dst):
                wrote_spans = True
        if live_spans is not None:
            label, spans = live_spans
            if spans:
                os.makedirs(span_dir, exist_ok=True)
                self._write_live_spans(
                    os.path.join(span_dir, "supervisor.jsonl"),
                    label, spans, {"role": "supervisor"})
                wrote_spans = True
        if wrote_spans:
            files["spans_dir"] = "spans"

        from deeplearning4j_tpu_torch.observe.log import get_active_hub
        hub = get_active_hub()
        if hub is not None:
            records = hub.ring.records()[-self.max_log_lines:]
            if records:
                with open(os.path.join(bundle, "logs.jsonl"), "w",
                          encoding="utf-8") as fh:
                    for rec in records:
                        fh.write(rec.to_json() + "\n")
                files["logs"] = "logs.jsonl"

        if log_tails:
            tail_dir = os.path.join(bundle, "logs")
            os.makedirs(tail_dir, exist_ok=True)
            for slot, text in sorted(log_tails.items()):
                data = (text or "").encode(errors="replace")
                data = data[-self.max_log_bytes:]
                with open(os.path.join(tail_dir, f"slot{int(slot)}.log"),
                          "wb") as fh:
                    fh.write(data)
            files["log_tail_dir"] = "logs"

        plan: Optional[Dict[str, Any]] = None
        if fault_plan_env:
            plan = {"env": fault_plan_env, "content": None}
            if os.path.exists(fault_plan_env):
                try:
                    with open(fault_plan_env, encoding="utf-8") as fh:
                        plan["content"] = fh.read(_PLAN_CAP)
                except OSError:
                    pass

        manifest = {
            "schema": SCHEMA_VERSION, "kind": KIND,
            "job_id": str(job_id), "generation": int(generation),
            "seq": self._seq, "ts_ms": int(ts_ms),
            "decision": {"action": str(decision), "reason": str(reason),
                         "backoff_s": float(backoff_s),
                         "ladder": [dict(r) for r in ladder]},
            "victim": dict(victim),
            "dead_slots": [int(s) for s in dead_slots],
            "world": {"before": [int(s) for s in world_before],
                      "after": [int(s) for s in world_after]},
            "workers": [dict(w) for w in workers],
            "checkpoint": dict(checkpoint),
            "fault_plan": plan,
            "bounds": {"max_spans": self.max_spans,
                       "max_log_lines": self.max_log_lines,
                       "max_log_bytes": self.max_log_bytes},
            "files": files,
        }
        # the manifest lands LAST: its presence certifies a complete bundle
        with open(os.path.join(bundle, "incident.json"), "w",
                  encoding="utf-8") as fh:
            json.dump(manifest, fh, indent=1, sort_keys=True)
        self.bundles.append(bundle)
        return bundle


# ---------------------------------------------------------------------------
# on-demand capture — the /debug/capture?seconds=N mini bundle
# ---------------------------------------------------------------------------

CAPTURE_KIND = "debug_capture"
DEFAULT_MAX_COST_ENTRIES = 50  # cost-ledger slice bound


def capture_bundle(*, seconds: float, tracer=None, metrics=None,
                   cost=None, sampler=None,
                   max_spans: int = DEFAULT_MAX_SPANS,
                   max_cost_entries: int = DEFAULT_MAX_COST_ENTRIES
                   ) -> Dict[str, Any]:
    """Assemble the on-demand mini incident bundle: the last
    ``seconds`` of completed spans as a Chrome trace (straight from the
    active recorder's ring — tail-sampling never thins it), the metrics
    exposition snapshot, a bounded cost-ledger slice, and the tail
    sampler's accounting.  The full flight recorder answers "why did
    recovery act"; this answers "what is this process doing RIGHT NOW"
    without restarting anything.  Same bounds discipline
    (``max_spans``, ``max_cost_entries``), echoed in the payload so a
    truncated capture can never masquerade as a complete one."""
    from deeplearning4j_tpu_torch.observe.export import to_chrome_trace
    from deeplearning4j_tpu_torch.observe.trace import get_active_tracer
    if tracer is None:
        tracer = get_active_tracer()
    seconds = max(float(seconds), 0.0)
    max_spans = int(max_spans)

    spans: List[Any] = []
    total_done = 0
    if tracer is not None:
        import time as _time
        cutoff_ns = _time.perf_counter_ns() - int(seconds * 1e9)
        done = [s for s in tracer.recorder.spans()
                if s.end_ns is not None]
        windowed = [s for s in done if s.end_ns >= cutoff_ns]
        total_done = len(windowed)
        spans = windowed[-max_spans:]

    bundle: Dict[str, Any] = {
        "schema": SCHEMA_VERSION, "kind": CAPTURE_KIND,
        "seconds": seconds,
        "bounds": {"max_spans": max_spans,
                   "max_cost_entries": int(max_cost_entries),
                   "span_count": len(spans),
                   "spans_truncated": total_done > len(spans)},
        "trace": to_chrome_trace(
            spans, service=getattr(tracer, "service",
                                   "deeplearning4j_tpu")),
        "metrics": metrics.exposition() if metrics is not None else None,
        "cost": None,
        "sampler": None,
    }
    if cost is not None:
        bundle["cost"] = {"recent": cost.recent(int(max_cost_entries)),
                          "totals": cost.describe()}
    if sampler is not None and hasattr(sampler, "describe"):
        bundle["sampler"] = sampler.describe()
    return bundle
