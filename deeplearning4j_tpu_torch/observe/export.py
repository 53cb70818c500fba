"""Trace exporters: Chrome trace-event JSON and a terminal text timeline.

The JSON form follows the Trace Event Format (the ``chrome://tracing`` /
Perfetto input): one complete (``"ph": "X"``) event per span with
microsecond timestamps normalized to the earliest span, metadata events
naming the process and threads, and flow arrows (``"s"``/``"f"``) drawn
for span links — e.g. from an HTTP request span to the device batch that
served it on the dispatcher thread.

The text form is the same data for people without a browser: a
time-ordered, nesting-indented listing with durations, suitable for
dumping at the end of a CLI run.

A copy of the JAX package's ``observe/export.py``: for the same spans the
Chrome JSON is the reference's, byte for byte, and so is the merged fleet
timeline of ``merge_chrome_traces`` (which reads ``observe/fleet.py``'s
span files).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.observe.trace import Span


def _zlib_flow_id(src: str, dst: str) -> int:
    """Stable positive flow id from the two span ids (ids are hex strings;
    fold them — collisions across a single trace are practically nil)."""
    return (int(src, 16) ^ (int(dst, 16) << 1)) & 0x7FFFFFFF


def to_chrome_trace(spans: Sequence[Span], *,
                    service: str = "deeplearning4j_tpu") -> dict:
    """Render completed spans as a Trace Event Format object."""
    pid = os.getpid()
    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": service},
    }]
    done = [s for s in spans if s.end_ns is not None]
    if not done:
        return {"traceEvents": events, "displayTimeUnit": "ms"}
    base = min(s.start_ns for s in done)
    by_id = {s.span_id: s for s in done}

    named_threads = set()
    for s in done:
        if s.thread_id not in named_threads:
            named_threads.add(s.thread_id)
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": s.thread_id, "args": {"name": s.thread_name},
            })

    for s in sorted(done, key=lambda sp: sp.start_ns):
        ts = (s.start_ns - base) / 1e3
        args = {"trace_id": s.trace_id, "span_id": s.span_id}
        if s.parent_id:
            args["parent_id"] = s.parent_id
        if s.error:
            args["error"] = s.error
        for k, v in s.attrs.items():
            args[str(k)] = sanitize_attr(v)
        events.append({
            "name": s.name, "cat": s.category, "ph": "X",
            "ts": ts, "dur": max((s.end_ns - s.start_ns) / 1e3, 0.0),
            "pid": pid, "tid": s.thread_id, "args": args,
        })
        # flow arrows: linked span → this span (only when the source is
        # still in the ring buffer; a dropped source just loses its arrow)
        for link in s.links:
            src = by_id.get(link.span_id)
            if src is None:
                continue
            fid = _zlib_flow_id(src.span_id, s.span_id)
            events.append({
                "name": "link", "cat": "flow", "ph": "s", "id": fid,
                "ts": (src.start_ns - base) / 1e3, "pid": pid,
                "tid": src.thread_id,
            })
            events.append({
                "name": "link", "cat": "flow", "ph": "f", "bp": "e",
                "id": fid, "ts": ts, "pid": pid, "tid": s.thread_id,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path, spans: Sequence[Span], *,
                       service: str = "deeplearning4j_tpu") -> dict:
    """Write the Chrome trace JSON; returns the object written."""
    obj = to_chrome_trace(spans, service=service)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(obj, fh)
    return obj


def sanitize_attr(v):
    """THE attr-value rule for every exporter (inline trace, worker span
    files, merged fleet trace): non-finite floats become their repr —
    bare NaN/Infinity tokens are not strict JSON and chrome://tracing
    rejects the whole file — and non-primitives degrade to ``str``."""
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    if isinstance(v, (int, float, bool, str, type(None))):
        return v
    return str(v)


def _sanitize_args(rec_args: dict) -> dict:
    return {str(k): sanitize_attr(v) for k, v in rec_args.items()}


def merge_chrome_traces(sources: Sequence, *, out=None) -> dict:
    """Stitch per-process span streams into ONE Chrome/Perfetto timeline.

    ``sources`` mixes two forms:

    - a path to a ``SpanFileWriter`` JSONL file (a worker's crash-durable
      span stream), or
    - ``{"label": str, "spans": [Span], "anchor": (perf_ns, epoch_us)}``
      for a live recorder (the supervisor's own ring; anchor defaults to
      this process's ``EPOCH_ANCHOR``).

    Clock alignment: ``perf_counter_ns`` is per-process, so every source
    carries its own anchor pair ``(perf_ns_at_import, epoch_us_at_import)``
    and each span maps to wall-clock micros as
    ``epoch_us = anchor_epoch_us + (start_ns - anchor_perf_ns)/1e3``; the
    merged timeline is normalized to the earliest aligned span.  Sources
    without an anchor (torn meta line) are skipped — a mis-aligned row
    is worse than a missing one.

    Rendering: one Chrome ``pid`` row per source (process_name = the
    source label, e.g. ``slot 2 gen 1``), ``X`` events per span,
    ``category == "decision"`` spans as instant events (``ph: "i"`` —
    the supervisor's restart/shrink/fail calls), and flow arrows for
    span links resolved ACROSS sources — a ``dcn_recv`` linking the
    sender's ``dcn_send`` renders as an arrow between worker rows.
    """
    from deeplearning4j_tpu_torch.observe.fleet import read_span_file
    from deeplearning4j_tpu_torch.observe.trace import EPOCH_ANCHOR

    norm = []  # (label, anchor, [span dicts])
    for src in sources:
        if isinstance(src, (str, os.PathLike)):
            try:
                parsed = read_span_file(str(src))
            except OSError:
                continue
            if parsed["anchor"] is None or not parsed["spans"]:
                continue
            norm.append((parsed["label"], parsed["anchor"], parsed["spans"]))
        else:
            spans = [{
                "name": s.name, "cat": s.category, "trace": s.trace_id,
                "span": s.span_id, "parent": s.parent_id,
                "start_ns": s.start_ns, "end_ns": s.end_ns,
                "tid": s.thread_id, "tname": s.thread_name,
                "attrs": s.attrs, "error": s.error,
                "links": [{"trace": l.trace_id, "span": l.span_id}
                          for l in s.links],
            } for s in src["spans"] if s.end_ns is not None]
            if not spans:
                continue
            norm.append((src.get("label", "process"),
                         tuple(src.get("anchor", EPOCH_ANCHOR)), spans))

    events: List[dict] = []
    if not norm:
        obj = {"traceEvents": events, "displayTimeUnit": "ms"}
        if out is not None:
            with open(out, "w", encoding="utf-8") as fh:
                json.dump(obj, fh)
        return obj

    def aligned_us(anchor, ns: int) -> float:
        return anchor[1] + (ns - anchor[0]) / 1e3

    base = min(aligned_us(anchor, rec["start_ns"])
               for _, anchor, spans in norm for rec in spans)

    # global span index for cross-process flow resolution
    by_id: Dict[str, tuple] = {}
    for pid, (_, anchor, spans) in enumerate(norm, start=1):
        for rec in spans:
            by_id[rec["span"]] = (pid, rec["tid"],
                                  max(0.0, aligned_us(anchor,
                                                      rec["start_ns"]) - base),
                                  rec["name"])

    for pid, (label, anchor, spans) in enumerate(norm, start=1):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": str(label)}})
        named = set()
        for rec in sorted(spans, key=lambda r: r["start_ns"]):
            tid = int(rec["tid"])
            if tid not in named:
                named.add(tid)
                events.append({
                    "name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid,
                    "args": {"name": str(rec.get("tname", tid))}})
            ts = max(0.0, aligned_us(anchor, rec["start_ns"]) - base)
            args = {"trace_id": rec["trace"], "span_id": rec["span"]}
            if rec.get("parent"):
                args["parent_id"] = rec["parent"]
            if rec.get("error"):
                args["error"] = rec["error"]
            args.update(_sanitize_args(rec.get("attrs") or {}))
            if rec.get("cat") == "decision":
                # supervisor decisions: a point in time, not an interval
                events.append({"name": rec["name"], "cat": "decision",
                               "ph": "i", "s": "p", "ts": ts, "pid": pid,
                               "tid": tid, "args": args})
            else:
                dur = max((rec["end_ns"] - rec["start_ns"]) / 1e3, 0.0)
                events.append({"name": rec["name"],
                               "cat": str(rec.get("cat", "app")),
                               "ph": "X", "ts": ts, "dur": dur, "pid": pid,
                               "tid": tid, "args": args})
            for link in rec.get("links") or ():
                src_loc = by_id.get(link.get("span"))
                if src_loc is None:
                    continue  # source dropped/killed: the arrow is lost
                src_pid, src_tid, src_ts, _ = src_loc
                fid = _zlib_flow_id(link["span"], rec["span"])
                events.append({"name": "link", "cat": "flow", "ph": "s",
                               "id": fid, "ts": src_ts, "pid": src_pid,
                               "tid": src_tid})
                events.append({"name": "link", "cat": "flow", "ph": "f",
                               "bp": "e", "id": fid, "ts": ts, "pid": pid,
                               "tid": tid})
    obj = {"traceEvents": events, "displayTimeUnit": "ms"}
    if out is not None:
        with open(out, "w", encoding="utf-8") as fh:
            json.dump(obj, fh)
    return obj


def text_timeline(spans: Sequence[Span], *, limit: Optional[int] = None,
                  attrs: bool = True) -> str:
    """Compact terminal rendering: start offset, duration, nesting depth.

    ::

        [+     0.000ms    12.40ms] train_step  iteration=1 batch=32
        [+     0.312ms     9.80ms]   kernel_build
    """
    done = sorted((s for s in spans if s.end_ns is not None),
                  key=lambda sp: sp.start_ns)
    if limit is not None:
        done = done[-limit:]
    if not done:
        return "(no spans recorded)"
    base = done[0].start_ns
    by_id: Dict[str, Span] = {s.span_id: s for s in done}

    def depth(s: Span) -> int:
        d, seen = 0, set()
        while s.parent_id and s.parent_id in by_id and s.span_id not in seen:
            seen.add(s.span_id)
            s = by_id[s.parent_id]
            d += 1
        return d

    lines = []
    for s in done:
        off = (s.start_ns - base) / 1e6
        dur = (s.end_ns - s.start_ns) / 1e6
        line = (f"[+{off:10.3f}ms {dur:9.3f}ms] "
                f"{'  ' * depth(s)}{s.name}")
        if s.error:
            line += f"  !{s.error}"
        if attrs and s.attrs:
            line += "  " + " ".join(f"{k}={v}" for k, v in s.attrs.items())
        if s.links:
            # the Chrome exporter's flow arrows, in text: name the linked
            # source span when it is still in the window, else its id —
            # dispatcher coalescing / DCN exchanges stay visible on a
            # terminal
            tags = []
            for link in s.links:
                src = by_id.get(link.span_id)
                tags.append(f"<-{src.name}" if src is not None
                            else f"<-{link.span_id[:8]}")
            line += "  [" + " ".join(tags) + "]"
        lines.append(line)
    return "\n".join(lines)
