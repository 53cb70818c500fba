"""The port's fleet observability and incident recorder on the CPU against
the JAX package: span files, ``merge_chrome_traces``, metrics snapshot
files and their federation, the fleet metrics server, tail sampling,
incident bundles and ``capture_bundle``.

Both packages get the same spans (fixed ids and times) and the same
metric histories. Files must be equal byte for byte, but for each
process's clock anchor in a span file's meta line (its import time),
which is masked; the merged Chrome trace of the same files is equal
exactly; a capture's window and timestamps are masked. Servers bind port
0 and are stopped in ``finally``.
"""

import json
import os
import time
import types

import pytest

from deeplearning4j_tpu.observe import cost as jcost
from deeplearning4j_tpu.observe import export as jexport
from deeplearning4j_tpu.observe import fleet as jfleet
from deeplearning4j_tpu.observe import incident as jincident
from deeplearning4j_tpu.observe import metrics as jmetrics
from deeplearning4j_tpu.observe import slo as jslo
from deeplearning4j_tpu.observe import trace as jtrace
from deeplearning4j_tpu_torch.observe import cost as tcost
from deeplearning4j_tpu_torch.observe import export as texport
from deeplearning4j_tpu_torch.observe import fleet as tfleet
from deeplearning4j_tpu_torch.observe import incident as tincident
from deeplearning4j_tpu_torch.observe import metrics as tmetrics
from deeplearning4j_tpu_torch.observe import slo as tslo
from deeplearning4j_tpu_torch.observe import trace as ttrace
from deeplearning4j_tpu_torch.util import fsio as tfsio
from test_torch_http_serving import TIMEOUT_S

PORT = types.SimpleNamespace(name="port", fleet=tfleet, export=texport, trace=ttrace,
                             metrics=tmetrics, incident=tincident, cost=tcost, slo=tslo)
REF = types.SimpleNamespace(name="ref", fleet=jfleet, export=jexport, trace=jtrace,
                            metrics=jmetrics, incident=jincident, cost=jcost, slo=jslo)
SIDES = (PORT, REF)
ANCHOR = (10_000_000_000, 1_700_000_000_000_000)  # (perf ns, epoch µs) of a live source


def spans_of(side, base_ns=ANCHOR[0], shift=0):
    """A fixed trace: a request, its queue wait, a batch linking it, a
    decision, an errored span, a NaN attribute, an open span."""
    S = side.trace.Span

    def span(name, sid, parent, t0, t1, cat="serve", trace="a" * 32, **attrs):
        s = S(name, trace_id=trace, span_id=sid, parent_id=parent,
              start_ns=base_ns + shift + t0, category=cat, attrs=attrs)
        s.end_ns = None if t1 is None else base_ns + shift + t1
        s.thread_id, s.thread_name = 7, "handler-7"
        return s

    req = span("http_request", "1" * 16, None, 0, 9_000_000, model="m", status=200)
    wait = span("queue_wait", "2" * 16, "1" * 16, 1_000, 2_000_000, model="m")
    batch = span("batch_execute", "3" * 16, None, 2_000_000, 8_000_000,
                 trace="b" * 32, rows=1, score=float("nan"))
    batch.add_link(req.context)
    batch.thread_id, batch.thread_name = 9, "ParallelInference"
    decision = span("restart", "4" * 16, None, 9_500_000, 9_500_000, cat="decision",
                    trace="c" * 32, slot=2)
    broken = span("forward", "5" * 16, "3" * 16, 2_100_000, 7_000_000, trace="b" * 32)
    broken.error = "RuntimeError: boom"
    open_span = span("still_open", "6" * 16, None, 9_600_000, None, trace="d" * 32)
    return [req, wait, batch, decision, broken, open_span]


def masked_lines(path):
    """A span file's lines, the meta line's clock anchor and pid masked."""
    with open(path) as f:
        lines = f.read().splitlines(keepends=True)
    meta = json.loads(lines[0])
    for k in ("anchor_perf_ns", "anchor_epoch_us", "pid"):
        meta[k] = "*"
    return [json.dumps(meta)] + lines[1:]


def _span_file(side, path):
    writer = side.fleet.SpanFileWriter(path, label="slot 1 gen 0",
                                       extra_meta={"slot": 1, "nan": float("nan")})
    try:
        for s in spans_of(side):
            if s.end_ns is not None:
                writer.add(s)
    finally:
        writer.close()
    return masked_lines(path)


def test_span_files_equal_the_reference(tmp_path):
    port = _span_file(PORT, str(tmp_path / "p.jsonl"))
    ref = _span_file(REF, str(tmp_path / "r.jsonl"))
    assert port == ref and len(port) == 6
    for path in (tmp_path / "p.jsonl", tmp_path / "r.jsonl"):
        got, want = tfleet.read_span_file(str(path)), jfleet.read_span_file(str(path))
        assert got == want and len(got["spans"]) == 5


def _merge_sources(tmp_path):
    """Two workers' span files (one written by each package, on clocks
    apart), a torn one, a missing path, and a live source."""
    files = []
    for i, side in enumerate(SIDES):
        path = str(tmp_path / f"w{i}.jsonl")
        writer = side.fleet.SpanFileWriter(path, label=f"slot {i} gen 1")
        for s in spans_of(side, shift=i * 123_456):
            if s.end_ns is not None:
                writer.add(s)
        writer.close()
        files.append(path)
    torn = str(tmp_path / "torn.jsonl")
    with open(files[0]) as f:
        text = f.read()
    with open(torn, "w") as f:
        f.write(text[:-20])  # a writer killed mid-line
    return files + [torn, str(tmp_path / "missing.jsonl")]


def test_merged_fleet_trace_equals_the_reference(tmp_path):
    paths = _merge_sources(tmp_path)
    got = {}
    for side in SIDES:
        live = {"label": "supervisor", "spans": spans_of(side, shift=5_000),
                "anchor": ANCHOR}
        out = str(tmp_path / f"merged_{side.name}.json")
        obj = side.export.merge_chrome_traces(paths + [live], out=out)
        with open(out, "rb") as f:
            got[side.name] = (obj, f.read())
    assert got["port"] == got["ref"]
    events = got["port"][0]["traceEvents"]
    assert sum(e["ph"] == "M" and e["name"] == "process_name" for e in events) == 4
    assert {e["ph"] for e in events} == {"M", "X", "i", "s", "f"}
    empty = (texport.merge_chrome_traces([]), jexport.merge_chrome_traces([]))
    assert empty[0] == empty[1] == {"traceEvents": [], "displayTimeUnit": "ms"}


def worker_registry(side, slot):
    """A worker's registry: a counter, a gauge and a histogram, values set
    by the slot."""
    m = side.metrics.MetricsRegistry()
    m.counter("train_steps_total", "steps", ("model",)).inc(10 + slot, model="lm")
    m.gauge("elastic_world_size", "world").set(4)
    m.histogram("step_seconds", "step", ("model",), buckets=(0.1, 1.0)).observe(
        0.05 * (slot + 1), model="lm")
    return m


def _federated(side, tmp_path):
    fleet = side.fleet.FleetRegistry(max_series=40)
    for slot in range(3):
        path = str(tmp_path / f"{side.name}_slot{slot}.prom")
        assert side.fleet.MetricsFileExporter(worker_registry(side, slot), path).export()
        fleet.set_source(slot, path, {"slot": slot, "host": slot // 2, "generation": 1})
    fleet.set_source(9, str(tmp_path / "never_written.prom"), {"slot": 9})
    bad = str(tmp_path / f"{side.name}_bad.prom")
    with open(bad, "w") as f:
        f.write('x{a="1" 3\n')
    fleet.set_source(10, bad, {"slot": 10})
    fleet.counter("elastic_restarts_total", "restarts").inc()
    first = fleet.exposition()
    tight = side.fleet.FleetRegistry(max_series=4)
    for key, (path, labels) in fleet.sources().items():
        tight.set_source(key, path, labels)
    tight.remove_source(10)
    return first, tight.exposition(), sorted(fleet.sources())


def test_federated_exposition_equals_the_reference(tmp_path):
    port, ref = _federated(PORT, tmp_path), _federated(REF, tmp_path)
    assert port == ref
    assert 'slot="2"' in port[0] and 'slot="9"' not in port[0]
    assert "fleet_federation_dropped_series_total" in port[1]


def test_metrics_file_export_is_atomic(tmp_path):
    path = str(tmp_path / "m.prom")
    tfsio.atomic_write_text(path, "a 1\n", fsync=True)
    tfsio.atomic_write_text(path, "a 2\n")
    with open(path) as f:
        assert f.read() == "a 2\n"
    assert os.listdir(str(tmp_path)) == ["m.prom"]
    assert not tfleet.MetricsFileExporter(tmetrics.MetricsRegistry(),
                                          str(tmp_path / "no" / "dir.prom")).export()


def _fleet_server(side, tmp_path):
    import http.client

    fleet = side.fleet.FleetRegistry()
    path = str(tmp_path / f"{side.name}_w.prom")
    side.fleet.MetricsFileExporter(worker_registry(side, 0), path).export()
    fleet.set_source(0, path, {"slot": 0, "host": 0, "generation": 0})
    slos = side.slo.load_slos({"slos": [{"name": "avail", "sli": "availability",
                                         "metric": "train_steps_total",
                                         "error_labels": {"model": "x"}}]})
    server = side.fleet.FleetMetricsServer(fleet, slo=slos)
    out = []
    try:
        server.start()
        for p in ("/metrics", "/healthz", "/alerts", "/slo", "/nope"):
            conn = http.client.HTTPConnection(server.host, server.port, timeout=TIMEOUT_S)
            try:
                conn.request("GET", p)
                resp = conn.getresponse()
                body = resp.read()
                if p == "/slo":
                    body = json.loads(body)
                    body.pop("now")
                out.append((resp.status, resp.getheader("Content-Type"), body))
            finally:
                conn.close()
    finally:
        server.stop()
    return out


def test_fleet_metrics_server_answers_as_the_reference(tmp_path):
    port, ref = _fleet_server(PORT, tmp_path), _fleet_server(REF, tmp_path)
    assert port == ref
    assert [s for s, _, _ in port] == [200, 200, 404, 200, 404]


class _ListSink:
    def __init__(self):
        self.spans = []

    def add(self, span):
        self.spans.append((span.trace_id, span.name))


def _sampled(side):
    sink = _ListSink()
    metrics = side.metrics.MetricsRegistry()
    sampler = side.fleet.TailSampler(sink, slow_ms={"http_request": 5.0},
                                     probability=0.3, max_bytes=4000, metrics=metrics,
                                     exemplar_source=lambda: {"e" * 32})
    S = side.trace.Span
    t = 0
    for i in range(12):
        trace = (("e" if i == 4 else f"{i:x}") * 32)[:32]
        root = S("http_request", trace_id=trace, span_id=f"{i:016x}", parent_id=None,
                 start_ns=t)
        child = S("forward", trace_id=trace, span_id=f"{i + 100:016x}",
                  parent_id=root.span_id, start_ns=t + 10)
        child.end_ns = t + 20
        if i == 7:
            child.error = "boom"
        root.end_ns = t + (9_000_000 if i in (2, 9) else 1_000_000)
        sampler.add(child)
        sampler.add(root)
        t += 10_000_000
    sampler.flush_trace("f" * 32)
    return sink.spans, sampler.describe(), metrics.exposition()


def test_tail_sampler_keeps_what_the_reference_keeps():
    port, ref = _sampled(PORT), _sampled(REF)
    assert port == ref
    reasons = port[1]["keep_reasons"]
    assert {"slow", "error", "exemplar"} <= set(reasons)


def _incident(side, tmp_path, span_files, plan):
    d = str(tmp_path / f"incidents_{side.name}")
    rec = side.incident.IncidentRecorder(d, max_spans=3, max_log_lines=5,
                                         max_log_bytes=16)
    bundle = rec.record(
        job_id="job", generation=2, ts_ms=123456, decision="restart", reason="slot 1 died",
        backoff_s=1.5, ladder=[{"rung": "restart", "ok": True}],
        victim={"slot": 1, "signal": 9}, dead_slots=[1], world_before=[0, 1, 2],
        world_after=[0, 1, 2], workers=[{"slot": 0, "step": 40}],
        checkpoint={"step": 40, "path": "ckpt"}, fault_plan_env=plan,
        metrics_text="a_total 1\n", span_files=span_files,
        live_spans=("supervisor", spans_of(side)),
        log_tails={1: "x" * 40 + "tail!", 0: ""})
    files = {}
    for root, _, names in os.walk(bundle):
        for n in names:
            p = os.path.join(root, n)
            rel = os.path.relpath(p, bundle)
            files[rel] = (masked_lines(p) if rel == "spans/supervisor.jsonl"
                          else open(p, "rb").read())
    return os.path.basename(bundle), files, rec.bundles == [bundle]


def test_incident_bundles_equal_the_reference(tmp_path):
    span_files = _merge_sources(tmp_path)[:3]
    plan = str(tmp_path / "plan.json")
    with open(plan, "w") as f:
        json.dump({"faults": []}, f)
    port = _incident(PORT, tmp_path, span_files, plan)
    ref = _incident(REF, tmp_path, span_files, plan)
    assert port == ref
    name, files, _ = port
    assert name == "incident_002_001"
    manifest = json.loads(files["incident.json"])
    assert manifest["files"] == {"metrics": "metrics.prom", "spans_dir": "spans",
                                 "logs": None, "log_tail_dir": "logs"}
    assert files["logs/slot1.log"] == b"x" * 11 + b"tail!"


def _captured(side):
    tracer = side.trace.Tracer()
    now = time.perf_counter_ns()
    for s in spans_of(side, base_ns=now - 20_000_000):
        tracer.recorder.add(s)
    old = spans_of(side, base_ns=now - 600_000_000_000)[0]
    tracer.recorder.add(old)  # ten minutes ago: outside the window
    metrics = side.metrics.MetricsRegistry()
    ledger = side.cost.CostLedger(metrics)
    ledger.record_batch("m", span_ms=4.0, compile_ms=0.0,
                        requests=[("a" * 32, 1), ("b" * 32, 3)])
    ledger.bill("a" * 32, model="m", priority="1")
    sampler = side.fleet.TailSampler(None)
    bundle = side.incident.capture_bundle(seconds=60, tracer=tracer, metrics=metrics,
                                          cost=ledger, sampler=sampler, max_spans=3)
    # the metrics by value (the port's help text names kernel builds where
    # the reference's names XLA's compiles)
    bundle["metrics"] = tmetrics.parse_prometheus_text(bundle["metrics"])
    return bundle


def test_capture_bundle_equals_the_reference():
    port, ref = _captured(PORT), _captured(REF)
    assert repr(port) == repr(ref)
    assert port["bounds"] == {"max_spans": 3, "max_cost_entries": 50, "span_count": 3,
                              "spans_truncated": True}
    assert port["kind"] == "debug_capture" and port["cost"]["recent"]
