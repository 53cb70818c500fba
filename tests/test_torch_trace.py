"""Tracing in the port on the CPU against the JAX package.

The port's ``observe/trace.py``, ``export.py`` and ``log.py`` are copies of
the reference's stdlib-only modules, so every check here is exact: span
nesting, errors and the ring buffer's drop accounting give the same
records in both packages; ``parse_traceparent`` the same verdicts; for the
same recorded spans the Chrome JSON is the reference's byte for byte and
``text_timeline`` its text. The build hook (``observe/buildhook.py``, the
counterpart of ``jaxhook.py``) is driven with ``nvcc`` stubbed: a real
build becomes one ``kernel_build`` span nested where it ran, a library
found built none. A metric exemplar carries the open span's trace id, as
the reference's does.
"""

import json
import threading
import time
import types

import numpy as np
import pytest

from deeplearning4j_tpu.observe import export as jexport
from deeplearning4j_tpu.observe import log as jlog
from deeplearning4j_tpu.observe import metrics as jmetrics
from deeplearning4j_tpu.observe import trace as jtrace
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.observe import buildhook
from deeplearning4j_tpu_torch.observe import export as texport
from deeplearning4j_tpu_torch.observe import log as tlog
from deeplearning4j_tpu_torch.observe import metrics as tmetrics
from deeplearning4j_tpu_torch.observe import trace as ttrace
from deeplearning4j_tpu_torch.util import compile_cache


@pytest.fixture(autouse=True)
def _tracing_off():
    yield
    ttrace.disable_tracing()
    jtrace.disable_tracing()
    tlog.disable_structured_logging()
    jlog.disable_structured_logging()


def _scenario(pkg):
    """One recording program; returns its records with the random ids
    replaced by their order of first appearance."""
    tr = pkg.Tracer(pkg.TraceRecorder(capacity=5))
    with tr.span("outer", attrs={"k": 1}) as outer:
        with tr.span("inner", category="serve") as inner:
            inner.set_attribute("rows", 3)
        with pytest.raises(ValueError):
            with tr.span("bad"):
                raise ValueError("boom")
        assert tr.current_context().span_id == outer.span_id
    assert tr.current_context() is None
    now = time.perf_counter_ns()
    tr.record("after", now - 10, now, parent=outer.context,
              links=[inner.context])
    for i in range(3):  # overflows the ring of 5
        with tr.span(f"tail{i}"):
            pass
    ids = {}

    def norm(x):
        return None if x is None else ids.setdefault(x, len(ids))

    recs = [(s.name, s.category, norm(s.trace_id), norm(s.span_id),
             norm(s.parent_id), s.error, dict(s.attrs),
             [norm(l.span_id) for l in s.links], s.end_ns >= s.start_ns)
            for s in tr.recorder.spans()]
    return recs, tr.recorder.dropped, tr.recorder.total_recorded, len(tr.recorder)


def test_span_nesting_errors_and_ring_buffer_match_the_reference():
    port, ref = _scenario(ttrace), _scenario(jtrace)
    assert port == ref
    recs, dropped, total, kept = port
    assert (dropped, total, kept) == (2, 7, 5)
    assert [r[0] for r in recs] == ["outer", "after", "tail0", "tail1", "tail2"]
    assert recs[1][4] == recs[0][3]  # "after" is parented by outer
    assert recs[0][5] is None


def test_exception_is_noted_on_its_span():
    tr = ttrace.Tracer()
    with pytest.raises(KeyError):
        with tr.span("bad"):
            raise KeyError("lost")
    (sp,) = tr.recorder.spans()
    assert sp.error == "KeyError: 'lost'" and sp.end_ns is not None


@pytest.mark.parametrize("header", [
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    " 00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-00 ",
    "ff-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-00000000000000000000000000000000-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-0000000000000000-01",
    "00-0af7651916cd43dd8448eb211c8031zz-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331",
    "", None])
def test_traceparent_parses_as_the_reference(header):
    got, want = ttrace.parse_traceparent(header), jtrace.parse_traceparent(header)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.trace_id, got.span_id) == (want.trace_id, want.span_id)
        # the round trip: a parsed context writes the header back
        assert ttrace.parse_traceparent(got.traceparent()).span_id == got.span_id
        assert got.traceparent() == want.traceparent()


def test_context_is_handed_across_threads_explicitly():
    tr = ttrace.enable_tracing(jax_hook=False)
    seen = {}
    with ttrace.span("request") as req:
        ctx = req.context
        assert ttrace.current_traceparent() == ctx.traceparent()
        assert ttrace.current_span_ids() == (ctx.trace_id, ctx.span_id)

        def worker():
            # contextvars do not leak into a thread: no parent here...
            seen["ctx"] = tr.current_context()
            # ...until the work item hands it over
            with tr.span("work", parent=ctx) as sp:
                seen["work"] = sp
            t = time.perf_counter_ns()
            seen["rec"] = tr.record("queue_wait", t - 5, t, parent=ctx)

        th = threading.Thread(target=worker, name="worker-1")
        th.start()
        th.join()
    assert seen["ctx"] is None
    for sp in (seen["work"], seen["rec"]):
        assert (sp.trace_id, sp.parent_id) == (ctx.trace_id, ctx.span_id)
        assert sp.thread_name == "worker-1"
    assert ttrace.current_span_ids() == (None, None)
    ttrace.disable_tracing()
    with ttrace.span("off") as sp:
        assert sp is None


def _recorded_spans():
    """Port spans from two threads, with links, errors and odd attributes."""
    tr = ttrace.Tracer()
    with tr.span("inference_request", category="serve",
                 attrs={"model": "lm", "rows": 2, "ratio": float("nan"),
                        "shape": (2, 16), "ok": True, "none": None}) as req:
        ctx = req.context
        box = {}

        def dispatcher():
            t = time.perf_counter_ns()
            tr.record("queue_wait", t - 2000, t, parent=ctx, category="serve")
            with tr.span("batch_execute", category="serve",
                         attrs={"rows": 2, "inf": float("-inf")}) as sp:
                sp.add_link(ctx)
                sp.add_link(ttrace.SpanContext("f" * 32, "e" * 16))  # dropped
                box["b"] = sp
            with pytest.raises(RuntimeError):
                with tr.span("failed"):
                    raise RuntimeError("device lost")

        th = threading.Thread(target=dispatcher, name="ParallelInference")
        th.start()
        th.join()
    open_span = tr.start_span("never_closed")  # not exported
    return tr.recorder.spans() + [open_span]


def _as_reference(spans):
    out = []
    for s in spans:
        j = jtrace.Span(s.name, trace_id=s.trace_id, span_id=s.span_id,
                        parent_id=s.parent_id, start_ns=s.start_ns,
                        category=s.category, attrs=s.attrs)
        j.end_ns, j.thread_id, j.thread_name, j.error = (
            s.end_ns, s.thread_id, s.thread_name, s.error)
        j.links = [jtrace.SpanContext(l.trace_id, l.span_id) for l in s.links]
        out.append(j)
    return out


def test_chrome_trace_and_timeline_equal_the_reference(tmp_path):
    spans = _recorded_spans()
    ref = _as_reference(spans)
    got = json.dumps(texport.to_chrome_trace(spans))
    assert got == json.dumps(jexport.to_chrome_trace(ref))
    assert json.dumps(texport.to_chrome_trace(spans, service="svc")) == \
        json.dumps(jexport.to_chrome_trace(ref, service="svc"))
    texport.write_chrome_trace(tmp_path / "t.json", spans)
    jexport.write_chrome_trace(tmp_path / "j.json", ref)
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    events = json.loads(got)["traceEvents"]
    assert sum(e["ph"] == "s" for e in events) == 1  # one surviving link
    for kw in ({}, {"limit": 2}, {"attrs": False}):
        assert texport.text_timeline(spans, **kw) == jexport.text_timeline(ref, **kw)
    assert texport.text_timeline([]) == jexport.text_timeline([])
    for v in (float("nan"), 1.5, "s", None, True, (1, 2), object):
        assert texport.sanitize_attr(v) == jexport.sanitize_attr(v)


@pytest.fixture
def stub_nvcc(monkeypatch, tmp_path):
    """``nvcc`` replaced by a stub that writes the library file: the build
    path runs end to end on a machine without the toolkit."""
    calls = []

    def run(cmd, capture_output=True, text=True):
        calls.append(cmd)
        time.sleep(0.01)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"\x7fELF stub")
        return types.SimpleNamespace(returncode=0, stdout="ptxas info", stderr="")

    monkeypatch.setattr(ck, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(ck, "subprocess", types.SimpleNamespace(run=run))
    monkeypatch.setattr(ck, "_build_dir", None)
    return calls


def test_build_hook_records_each_real_build(stub_nvcc, tmp_path):
    cache = tmp_path / "kernels"
    assert compile_cache.enable_persistent_compile_cache(str(cache)) == str(cache)
    assert compile_cache.persistent_compile_cache_dir() == str(cache)
    assert ck.build_dir() == str(cache)
    with pytest.raises(ValueError, match="cannot retarget"):
        compile_cache.enable_persistent_compile_cache(str(tmp_path / "other"))
    reg = tmetrics.MetricsRegistry()
    tr = ttrace.enable_tracing(metrics=reg, jax_hook=True)
    assert buildhook.hook_installed()
    with tr.span("batch_execute") as batch:
        path = ck.build("fused_adam.cu")
    assert path.startswith(str(cache)) and len(stub_nvcc) == 1
    ck.build("fused_adam.cu")  # found built: no build, no span
    assert len(stub_nvcc) == 1
    spans = [s for s in tr.recorder.spans() if s.name == "kernel_build"]
    assert len(spans) == 1
    sp = spans[0]
    assert (sp.category, sp.parent_id, sp.trace_id) == (
        "compile", batch.span_id, batch.trace_id)
    assert tr.compile_count == tr.thread_compile_count() == 1
    assert tr.thread_compile_seconds() >= 0.01
    parsed = tmetrics.parse_prometheus_text(reg.exposition())
    assert parsed["kernel_builds_total"][()] == 1.0
    assert parsed["kernel_build_seconds_total"][()] >= 0.01
    ttrace.disable_tracing()
    ck.build("lstm_sequence.cu")  # a real build with no tracer: no span
    assert len(stub_nvcc) == 2 and len(tr.recorder) == 2


def test_exemplars_carry_the_open_span_s_trace_id():
    """C12 wired back: a histogram observed under an open span names the
    span's trace, in the reference's exposition grammar."""
    out = {}
    for name, trace, metrics in (("port", ttrace, tmetrics),
                                 ("ref", jtrace, jmetrics)):
        reg = metrics.MetricsRegistry()
        h = reg.histogram("latency_seconds", "x", ("model",), buckets=(0.1, 1.0))
        h.observe(0.05, model="a")  # no span yet: no exemplar
        assert not metrics.exemplar_trace_ids(reg)
        trace.enable_tracing(jax_hook=False)
        with trace.span("req") as sp:
            h.observe(0.5, model="a")
        trace.disable_tracing()
        assert metrics.exemplar_trace_ids(reg) == {sp.trace_id}
        text = reg.exposition().replace(sp.trace_id, "T")
        out[name] = [" ".join(line.split()[:-1]) if "# {" in line else line
                     for line in text.splitlines()]  # drop the timestamp
    assert out["port"] == out["ref"]


def test_structured_logs_carry_the_span_ids():
    got = {}
    for name, trace, log in (("port", ttrace, tlog), ("ref", jtrace, jlog)):
        hub = log.enable_structured_logging(bridge_stdlib=False, capacity=2)
        tr = trace.enable_tracing(jax_hook=False)
        with tr.span("req") as sp:
            rec = log.get_logger("serving.breaker").warning(
                "tripped", reason="x", loss=float("nan"), arr=np.float32(2.5))
        log.get_logger("a").info("one")
        log.get_logger("a").info("two")
        d = rec.to_dict()
        assert (d["trace_id"], d["span_id"]) == (sp.trace_id, sp.span_id)
        got[name] = ({k: v for k, v in d.items()
                      if k not in ("ts", "trace_id", "span_id")},
                     hub.ring.dropped, len(hub.ring))
        trace.disable_tracing()
        log.disable_structured_logging()
    assert got["port"] == got["ref"]
    assert got["port"][0]["loss"] == "nan" and got["port"][1:] == (1, 2)
