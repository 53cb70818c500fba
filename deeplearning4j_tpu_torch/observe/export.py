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
Chrome JSON is the reference's, byte for byte. ``merge_chrome_traces``
(the fleet stitching across processes) reads ``observe/fleet.py``'s span
files and comes with that module.
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
    """THE attr-value rule for every exporter: non-finite floats become their repr —
    bare NaN/Infinity tokens are not strict JSON and chrome://tracing
    rejects the whole file — and non-primitives degrade to ``str``."""
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    if isinstance(v, (int, float, bool, str, type(None))):
        return v
    return str(v)


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
