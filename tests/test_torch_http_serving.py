"""The port's HTTP front end on the CPU against the JAX package: the wire
codec, admission, brownout, ``ModelServer`` and ``ModelServingClient``.

Both packages serve the same models: duck models (numpy in, numpy or a
bf16 array out) for the status and header contract, and the small MLP
(Dense 8→16 tanh, softmax output) and a 2-layer, d 32, vocab 64, T 16
``TransformerLM`` with the JAX networks' weights carried across. Each
request goes to both servers; the status, the headers (``Date``,
``Server`` and the per-request ids and device ms masked) and the bodies
must agree: the same bytes where no model arithmetic is in the answer,
outputs within 1e-5 where there is (f32, summation order only), a bf16
LM answer within the registry tests' bf16 limit (a bf16 forward rounds
in another order). Every server binds port 0, has client timeouts, and
is stopped in ``finally``; every thread join is bounded; fault plans,
brownouts and alert clocks are injected, so no test waits on the wall
clock for a decision.
"""

import contextlib
import http.client
import json
import re
import struct
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.observe import metrics as jmetrics
from deeplearning4j_tpu.observe import trace as jtrace
from deeplearning4j_tpu.parallel import time_source as jts
from deeplearning4j_tpu.serving import admission as jadm
from deeplearning4j_tpu.serving import brownout as jbro
from deeplearning4j_tpu.serving import client as jcli
from deeplearning4j_tpu.serving import registry as jreg
from deeplearning4j_tpu.serving import server as jsrv
from deeplearning4j_tpu.streaming import codec as jcodec
from deeplearning4j_tpu.util import faultinject as jfi
from deeplearning4j_tpu_torch.observe import metrics as tmetrics
from deeplearning4j_tpu_torch.observe import trace as ttrace
from deeplearning4j_tpu_torch.parallel import time_source as tts
from deeplearning4j_tpu_torch.serving import admission as tadm
from deeplearning4j_tpu_torch.serving import brownout as tbro
from deeplearning4j_tpu_torch.serving import client as tcli
from deeplearning4j_tpu_torch.serving import registry as treg
from deeplearning4j_tpu_torch.serving import server as tsrv
from deeplearning4j_tpu_torch.streaming import codec as tcodec
from deeplearning4j_tpu_torch.util import faultinject as tfi
from test_torch_inference_supervision import N_IN, mlp_pair
from test_torch_serving_registry import BF16_LOGP_TOL, LM, T, lm_pair

F32_TOL = 1e-5
TOOK = re.compile(r"took \d+\.\d+s")
TIMEOUT_S = 10.0  # every client's socket timeout

PORT = types.SimpleNamespace(name="port", srv=tsrv, reg=treg, cli=tcli, codec=tcodec,
                             metrics=tmetrics, trace=ttrace, fi=tfi, adm=tadm,
                             bro=tbro, ts=tts, net=1)
REF = types.SimpleNamespace(name="ref", srv=jsrv, reg=jreg, cli=jcli, codec=jcodec,
                            metrics=jmetrics, trace=jtrace, fi=jfi, adm=jadm,
                            bro=jbro, ts=jts, net=0)
SIDES = (PORT, REF)


# ----------------------------------------------------------------- models
class Doubler:
    """Numpy in, numpy out: 2x."""

    def output(self, x):
        return np.asarray(x, np.float32) * 2.0


class Slow(Doubler):
    """Sleeps before answering (the deadline cases)."""

    def __init__(self, seconds):
        self.seconds = seconds

    def output(self, x):
        time.sleep(self.seconds)
        return super().output(x)


class Bf16Doubler:
    """A bf16 answer: a bf16 jax array in the reference, a bf16 tensor in
    the port, of the same values."""

    def __init__(self, side):
        self.side = side

    def output(self, x):
        y = np.asarray(x, np.float32) * 2.0 + 0.1
        if self.side is REF:
            return jnp.asarray(y, jnp.bfloat16)
        return torch.from_numpy(y).to(torch.bfloat16)


def _mlp(side):
    return mlp_pair(1)[side.net]


# ---------------------------------------------------------------- serving
@contextlib.contextmanager
def serving(side, models, *, registry_kw=None, fallback=None, **server_kw):
    """A started server of ``side`` over a registry holding ``models``
    (``[(name, model, register kwargs)]``); stopped in ``finally``."""
    metrics = side.metrics.MetricsRegistry()
    kw = dict(metrics=metrics, warmup="off", wait_ms=0.0, max_batch_size=4)
    kw.update(registry_kw or {})
    reg = side.reg.ModelRegistry(**kw)
    server = None
    try:
        for name, model, rkw in models:
            reg.register(name, model, **rkw)
        if fallback is not None:
            reg.set_fallback(*fallback)
        server = side.srv.ModelServer(reg, metrics=metrics, **server_kw)
        server.start()
        yield server
    finally:
        if server is not None:
            server.stop(drain=False)
        reg.shutdown()


MASKED = {"Date", "Server", "X-Trace-Id", "Traceparent", "X-Device-Ms"}


def call(server, path, body=None, headers=None, method=None):
    """One request on a fresh connection: ``(status, headers, body)``,
    the headers Title-Cased with the per-request values masked."""
    conn = http.client.HTTPConnection(server.host, server.port, timeout=TIMEOUT_S)
    try:
        conn.request(method or ("GET" if body is None else "POST"), path,
                     body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        hdrs = {k.title(): ("*" if k.title() in MASKED else v)
                for k, v in resp.getheaders()}
        return resp.status, hdrs, data
    finally:
        conn.close()


def both(models_of, requests, **kw):
    """Each request of ``requests`` (``(path, body, headers)``) sent to a
    server of each side; returns ``{side: [(status, headers, body)]}``."""
    got = {}
    for side in SIDES:
        with serving(side, models_of(side), **kw) as server:
            got[side.name] = [call(server, *r) for r in requests]
    return got


def counted(server, n, timeout_s=TIMEOUT_S):
    """Waits (bounded) until the server has counted ``n`` predicts: it
    counts a request after writing its answer, so a client can read the
    answer before the count lands."""
    deadline = time.monotonic() + timeout_s
    while server._m_requests.total() < n and time.monotonic() < deadline:
        time.sleep(0.001)
    assert server._m_requests.total() == n


def json_body(inputs, **extra):
    return json.dumps({"inputs": inputs, **extra}).encode()


def frame(x):
    return jcodec.serialize_array(x), {"Content-Type": "application/octet-stream"}


def assert_same_json(a, b, tol=F32_TOL):
    """Equal JSON, floats within ``tol`` (relative)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (a, b)
        for k in a:
            assert_same_json(a[k], b[k], tol)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same_json(x, y, tol)
    elif isinstance(a, float) and not isinstance(a, bool):
        assert b == pytest.approx(a, rel=tol, abs=1e-7)
    elif isinstance(a, str) and isinstance(b, str):
        # a late synchronous answer's error names its measured seconds
        assert TOOK.sub("took *s", a) == TOOK.sub("took *s", b)
    else:
        assert a == b


def assert_same_responses(got, tol=F32_TOL):
    for (ps, ph, pb), (rs, rh, rb) in zip(got["port"], got["ref"]):
        assert (ps, ph.keys()) == (rs, rh.keys()), (ps, ph, rs, rh)
        for k in ph:
            if k != "Content-Length" or ph.get("Content-Type") != "application/json":
                assert ph[k] == rh[k], (k, ph, rh)
        if ph.get("Content-Type") == "application/json":
            assert_same_json(json.loads(pb), json.loads(rb), tol)
        elif ph.get("Content-Type") == "application/octet-stream":
            p, r = tcodec.deserialize_array(pb), jcodec.deserialize_array(rb)
            assert pb[:4 + struct.unpack(">I", pb[:4])[0]] == \
                rb[:4 + struct.unpack(">I", rb[:4])[0]]  # the header
            np.testing.assert_allclose(p, np.asarray(r, np.float32), rtol=tol, atol=1e-7)
        else:
            assert pb == rb


# ------------------------------------------------------------------ codec
CODEC_ARRAYS = {
    "float32": lambda r: r.normal(size=(3, 5)).astype(np.float32),
    "float64": lambda r: r.normal(size=(2, 2, 3)),
    "float16": lambda r: r.normal(size=(4,)).astype(np.float16),
    "int64": lambda r: r.integers(-9, 9, (2, 6)),
    "int32": lambda r: r.integers(0, 50257, (1, 7)).astype(np.int32),
    "uint8": lambda r: r.integers(0, 255, (5, 1)).astype(np.uint8),
    "bool": lambda r: r.normal(size=(3, 3)) > 0,
    "empty": lambda r: np.zeros((0, 4), np.float32),
    "scalar": lambda r: np.float32(2.5),
    "strided": lambda r: r.normal(size=(4, 6)).astype(np.float32)[:, ::2],
}


@pytest.mark.parametrize("case", sorted(CODEC_ARRAYS))
def test_codec_frames_equal_the_reference(case, rng):
    a = CODEC_ARRAYS[case](rng)
    frame_ref = jcodec.serialize_array(a)
    assert tcodec.serialize_array(a) == frame_ref
    back = tcodec.deserialize_array(frame_ref)
    ref_back = jcodec.deserialize_array(frame_ref)
    assert back.dtype == ref_back.dtype and back.shape == ref_back.shape
    np.testing.assert_array_equal(back, ref_back)


@pytest.mark.parametrize("shape", [(2, 3), (1, 16, 64), (7,)])
def test_a_bf16_answer_s_frame_equals_the_reference_s(shape, rng):
    """A bf16 answer of the same values: the reference's bf16 numpy array
    and the port's bf16 tensor, brought to the host by the dispatcher's
    ``host_answer``, write the same bytes; so do slices of them."""
    from deeplearning4j_tpu_torch.parallel.inference import host_answer

    x = rng.normal(size=shape).astype(np.float32) * 30
    ref = np.asarray(jnp.asarray(x, jnp.bfloat16))
    got = host_answer(torch.from_numpy(x).to(torch.bfloat16))
    assert isinstance(got, tcodec.BFloat16Array) and got.dtype == np.float32
    assert tcodec.serialize_array(got) == jcodec.serialize_array(ref)
    assert tcodec.serialize_array(got[:1]) == jcodec.serialize_array(ref[:1])
    assert tcodec.serialize_array(got.copy()) == jcodec.serialize_array(ref)
    # arithmetic leaves the mark behind: its values need not be bf16
    assert type(got * 3) is np.ndarray and type(got + got) is np.ndarray
    assert json.dumps(got.tolist()) == json.dumps(ref.tolist())


def test_a_bf16_frame_decodes_to_f32_values_in_the_port(rng):
    """C20 (ROADMAP §C, a departure kept): without ``ml_dtypes`` the port
    decodes a ``"bfloat16"`` frame to f32 (marked, so it encodes back to
    the same frame) where the reference gives a bf16 array; the values
    are equal."""
    ref = np.asarray(jnp.asarray(rng.normal(size=(3, 4)), jnp.bfloat16))
    data = jcodec.serialize_array(ref)
    got = tcodec.deserialize_array(data)
    assert str(jcodec.deserialize_array(data).dtype) == "bfloat16"
    assert got.dtype == np.float32 and isinstance(got, tcodec.BFloat16Array)
    np.testing.assert_array_equal(got, ref.astype(np.float32))
    assert tcodec.serialize_array(got) == data
    # the reference reads the port's frame as its own bf16 array
    np.testing.assert_array_equal(jcodec.deserialize_array(tcodec.serialize_array(got)), ref)


@pytest.mark.parametrize("masks", [False, True])
def test_dataset_frames_equal_the_reference(masks, rng):
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet

    x = rng.normal(size=(4, 3, 2)).astype(np.float32)
    y = rng.normal(size=(4, 3, 1)).astype(np.float32)
    m = (rng.normal(size=(4, 3)) > 0).astype(np.float32) if masks else None
    data = jcodec.serialize_dataset(JDataSet(x, y, m, m))
    assert tcodec.serialize_dataset(TDataSet(x, y, m, m)) == data
    back = tcodec.deserialize_dataset(data)
    assert isinstance(back, TDataSet)
    for a, b in ((back.features, x), (back.labels, y), (back.features_mask, m),
                 (back.labels_mask, m)):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(np.asarray(a), b)


# -------------------------------------------------------------- admission
def _admission_run(side):
    metrics = side.metrics.MetricsRegistry()
    ctrl = side.adm.AdmissionController(2, retry_after_s=0.25, metrics=metrics)
    log = []
    a = ctrl.admit()
    b = ctrl.admit()
    try:
        ctrl.admit()
    except side.adm.AdmissionRejected as e:
        log.append(("rejected", str(e), e.retry_after_s))
    log.append(("inflight", ctrl.inflight))
    a.release()
    a.release()  # idempotent
    with ctrl.admit():
        log.append(("inflight", ctrl.inflight))
    ctrl.record_rejection("brownout")
    ctrl.begin_drain()
    try:
        ctrl.admit()
    except side.adm.Draining as e:
        log.append(("draining", str(e), ctrl.draining))
    log.append(("idle", ctrl.wait_idle(0.0)))
    b.release()
    log.append(("idle", ctrl.wait_idle(0.0), ctrl.inflight))
    with pytest.raises(ValueError):
        side.adm.AdmissionController(0)
    return log, metrics.exposition()


def test_admission_matches_the_reference():
    assert _admission_run(PORT) == _admission_run(REF)


# --------------------------------------------------------------- brownout
class _FakeAdmission:
    max_inflight = 10

    def __init__(self):
        self.inflight = 0


class _FakeAlerts:
    def __init__(self):
        self.rules = []

    def firing(self):
        return list(self.rules)


BROWNOUT_SCRIPT = [  # (advance s, inflight, firing rules)
    (0.0, 0, []), (0.5, 9, []), (0.6, 9, []), (0.5, 9, []), (1.0, 2, []),
    (2.0, 2, ["latency_burn"]), (2.0, 0, ["other"]), (3.0, 0, []), (2.1, 0, []),
    (0.1, 10, []), (1.0, 10, []), (0.2, 0, []),
]


def _brownout_run(side):
    clock = side.ts.ManualTimeSource(0)
    adm, alerts = _FakeAdmission(), _FakeAlerts()
    metrics = side.metrics.MetricsRegistry()
    ctrl = side.bro.BrownoutController(
        admission=adm, alerts=alerts, watch_rules=("latency_burn",),
        enter_after_s=1.0, exit_after_s=5.0, shed_below=0, time_source=clock,
        metrics=metrics)
    states = []
    for dt, inflight, firing in BROWNOUT_SCRIPT:
        clock.advance(dt)
        adm.inflight, alerts.rules = inflight, firing
        active = ctrl.observe()
        states.append((active, ctrl.should_shed(0), ctrl.should_shed(1),
                       metrics.exposition()))
    return states, ctrl.describe()


def test_brownout_state_machine_matches_the_reference():
    port, ref = _brownout_run(PORT), _brownout_run(REF)
    assert port == ref
    assert [t["active"] for t in ref[1]["transitions"]] == [True, False, True]
    with pytest.raises(ValueError):
        tbro.BrownoutController(saturation=0.0)


# ----------------------------------------------------------------- server
def _duck_models(side):
    return [("duck", Doubler(), {}), ("duck", Doubler(), {"activate": False}),
            ("slow", Slow(0.05), {}), ("slow", Slow(0.05), {"activate": False}),
            ("mlp", _mlp(side), {})]


PREDICT_CASES = {
    "json": ("/v1/models/duck/predict", json_body([[1.0, 2.0], [3.0, 4.5]]), {}),
    "json_pinned_live": ("/v1/models/duck:1/predict", json_body([[1.0]]), {}),
    "json_pinned_other": ("/v1/models/duck:2/predict", json_body([[1.0, -2.0]]), {}),
    "binary_f32": ("/v1/models/duck/predict", *frame(np.arange(6, dtype=np.float32)
                                                     .reshape(2, 3))),
    "binary_int64": ("/v1/models/duck/predict", *frame(np.arange(4).reshape(1, 4))),
    "mlp_json": ("/v1/models/mlp/predict",
                 json_body(np.linspace(-1, 1, 2 * N_IN).reshape(2, N_IN).tolist()), {}),
    "mlp_binary": ("/v1/models/mlp/predict",
                   *frame(np.linspace(-2, 1, 3 * N_IN, dtype=np.float32).reshape(3, N_IN))),
    "deadline_504": ("/v1/models/slow:2/predict", json_body([[1.0]]),
                     {"X-Deadline-Ms": "1"}),
    "deadline_body_504": ("/v1/models/slow:2/predict", json_body([[1.0]], deadline_ms=1), {}),
    "bad_json_400": ("/v1/models/duck/predict", b"{not json", {}),
    "no_inputs_400": ("/v1/models/duck/predict", json.dumps({"x": 1}).encode(), {}),
    "scalar_400": ("/v1/models/duck/predict", json_body(3.0), {}),
    "bad_deadline_400": ("/v1/models/duck/predict", json_body([[1.0]]),
                         {"X-Deadline-Ms": "soon"}),
    "truncated_frame_400": ("/v1/models/duck/predict", b"\x00\x00",
                            {"Content-Type": "application/octet-stream"}),
    "unknown_model_404": ("/v1/models/nope/predict", json_body([[1.0]]), {}),
    "unknown_version_404": ("/v1/models/duck:9/predict", json_body([[1.0]]), {}),
    "colon_name_404": ("/v1/models/du:ck/predict", json_body([[1.0]]), {}),
    "bad_path_404": ("/v1/predict", json_body([[1.0]]), {}),
}


@pytest.fixture(scope="module")
def duck_servers():
    """One server of each side over the duck models and the MLP, shared by
    the cases that leave no state behind them."""
    with contextlib.ExitStack() as stack:
        yield {side.name: stack.enter_context(serving(side, _duck_models(side)))
               for side in SIDES}


def on_servers(servers, requests):
    return {name: [call(server, *r) for r in requests] for name, server in servers.items()}


@pytest.mark.parametrize("case", sorted(PREDICT_CASES))
def test_predict_responses_match_the_reference(case, duck_servers):
    got = on_servers(duck_servers, [PREDICT_CASES[case]])
    assert_same_responses(got)
    status = got["port"][0][0]
    want = int(case[-3:]) if case[-3:].isdigit() else 200
    assert status == want, got["port"]


GET_PATHS = ["/healthz", "/readyz", "/livez", "/livez?verbose=1", "/v1/models/duck",
             "/v1/models/nope", "/alerts", "/slo", "/nowhere",
             "/debug/capture?seconds=x"]


def test_get_endpoints_match_the_reference(duck_servers):
    got = on_servers(duck_servers, [(p, None, {}) for p in GET_PATHS])
    assert_same_responses(got)
    assert [s for s, _, _ in got["port"]] == [200, 200, 200, 200, 200, 404, 404, 404,
                                              404, 400]


def _listing(side):
    with serving(side, _duck_models(side)) as server:
        call(server, *PREDICT_CASES["json"])
        counted(server, 1)
        status, _, body = call(server, "/v1/models")
        listing = json.loads(body)
        capture = json.loads(call(server, "/debug/capture?seconds=60")[2])
    return status, untimed(listing), capture


def untimed(listing):
    """A model listing without its registration timestamps."""
    for m in listing["models"] if "models" in listing else [listing]:
        for v in m["versions"]:
            v.pop("registered_at", None)
    return listing


def test_model_listing_and_capture_match_the_reference():
    port, ref = _listing(PORT), _listing(REF)
    assert port[0] == ref[0] == 200
    assert_same_json(port[1]["models"], ref[1]["models"])
    assert port[1]["cost"].keys() == ref[1]["cost"].keys()
    # no tracer: the capture holds the metrics alone
    for cap in (port[2], ref[2]):
        cap["metrics"] = sorted(tmetrics.parse_prometheus_text(cap["metrics"]))
    assert port[2] == ref[2]


TIMED = re.compile(r"seconds|device_ms")


def masked_exposition(text):
    """Every series' labels, and the values of those that count events
    (not time): trace ids, timestamps and timings masked."""
    parsed = tmetrics.parse_prometheus_text(text)
    return {name: {k: (None if TIMED.search(name) else v) for k, v in series.items()}
            for name, series in parsed.items()}


def test_metrics_exposition_matches_the_reference():
    requests = [PREDICT_CASES[c] for c in ("json", "json_pinned_other", "binary_f32",
                                           "bad_json_400", "unknown_model_404",
                                           "deadline_504", "mlp_json")]
    got, scraped = {}, {}
    for side in SIDES:
        with serving(side, _duck_models(side)) as server:
            got[side.name] = [call(server, *r) for r in requests]
            counted(server, len(requests))
            scraped[side.name] = call(server, "/metrics")[2].decode()
    assert_same_responses(got)
    port, ref = (masked_exposition(scraped[s]) for s in ("port", "ref"))
    assert port == ref
    assert port["serving_requests_total"][(("model", "duck"), ("status", "200"))] == 3
    assert port["serving_requests_total"][(("model", "_unknown"), ("status", "404"))] == 1


def _faulted(side, faults, requests, **kw):
    side.fi.set_plan(side.fi.FaultPlan.parse({"faults": faults}))
    try:
        with serving(side, _duck_models(side), **kw) as server:
            out = []
            for r in requests:
                try:
                    out.append(call(server, *r))
                except (http.client.RemoteDisconnected, ConnectionResetError) as e:
                    out.append(type(e).__name__)
            counted(server, sum(r[1] is not None for r in requests))
            metrics = masked_exposition(server.metrics.exposition())
            return out, metrics
    finally:
        side.fi.set_plan(None)


def test_injected_admission_rejection_and_dropped_response_match_the_reference():
    faults = [{"type": "reject_admission", "model": "duck", "step": 1},
              {"type": "drop_response", "model": "duck", "step": 2}]
    req = PREDICT_CASES["json"]
    port, ref = (_faulted(s, faults, [req] * 4) for s in SIDES)
    assert port[1] == ref[1]
    assert [r if isinstance(r, str) else r[0] for r in port[0]] == \
        [r if isinstance(r, str) else r[0] for r in ref[0]] == \
        [200, 429, "RemoteDisconnected", 200]
    assert port[0][1][1]["Retry-After"] == ref[0][1][1]["Retry-After"] == "0.050"
    assert port[1]["serving_dropped_responses_total"][(("model", "duck"),)] == 1


def test_a_dead_dispatcher_and_draining_answer_503_as_the_reference():
    faults = [{"type": "crash_forward", "model": "duck", "step": 0}]
    req = PREDICT_CASES["json"]
    port, ref = (_faulted(s, faults, [req, req, ("/readyz", None, {}),
                                      ("/livez", None, {})]) for s in SIDES)
    assert_same_responses({"port": port[0], "ref": ref[0]})
    assert [r[0] for r in port[0]] == [503, 503, 503, 503]
    assert port[0][0][1]["Retry-After"] == "0.050"
    for side in SIDES:
        with serving(side, _duck_models(side)) as server:
            server.admission.begin_drain()
            got = [call(server, *req), call(server, "/readyz")]
        assert [g[0] for g in got] == [503, 503]
        assert json.loads(got[0][2]) == {"error": "server is draining"}
        assert json.loads(got[1][2]) == {"ready": False, "reason": "draining"}


def test_brownout_sheds_and_degrades_as_the_reference():
    """An engaged brownout (admission saturation at 1 of 1, entered at
    once) sheds priority 0 with 429 + ``Retry-After``, and serves an
    un-pinned request on the fallback version with ``X-Degraded``."""
    requests = [(*PREDICT_CASES["json"][:2], {"X-Priority": "0"}),
                (*PREDICT_CASES["json"][:2], {"X-Priority": "2"}),
                PREDICT_CASES["json_pinned_live"]]
    got = {}
    for side in SIDES:
        clock = side.ts.ManualTimeSource(0)
        with serving(side, _duck_models(side), fallback=("duck", [2]), max_inflight=1,
                     brownout={"saturation": 1.0, "enter_after_s": 0.0,
                               "time_source": clock}) as server:
            # hold the one admission slot: the front door sees saturation
            slot = server.admission.admit()
            try:
                got[side.name] = [call(server, *r) for r in requests]
            finally:
                slot.release()
            got[side.name].append(call(server, "/livez?verbose=1"))
    assert_same_responses(got)
    shed, degraded, pinned, health = got["port"]
    assert (shed[0], shed[1]["Retry-After"]) == (429, "0.250")
    # admitted work past the shed check still needs a slot: 429 overflow
    assert degraded[0] == 429 and pinned[0] == 429
    assert json.loads(health[2])["status"] == "degraded"  # the brownout holds


def test_brownout_degrades_to_the_fallback_version_as_the_reference():
    requests = [PREDICT_CASES["json"], PREDICT_CASES["json_pinned_live"]]
    got = {}
    for side in SIDES:
        bro = side.bro.BrownoutController(enter_after_s=0.0,
                                          time_source=side.ts.ManualTimeSource(0))
        bro._pressure = lambda: "held"  # engaged at the first request
        with serving(side, _duck_models(side), fallback=("duck", [2]),
                     brownout=bro) as server:
            got[side.name] = [call(server, *r) for r in requests]
    assert_same_responses(got)
    (deg, dh, body), (pin, ph, _) = got["port"]
    assert (deg, dh["X-Degraded"], json.loads(body)["version"]) == (200, "brownout", 2)
    assert pin == 200 and "X-Degraded" not in ph


@pytest.mark.parametrize("binary", [False, True])
def test_lm_answers_match_the_reference(binary, rng):
    """The LM served in f32 (v1) and bf16 (v2) through both servers; int64
    ids in a binary frame answer as the same ids in f32 (the port's pad
    buffers are keyed by dtype), and v2's binary answer is a bf16 frame."""
    ids = rng.integers(0, LM["vocab_size"], (1, T))
    sample = rng.integers(0, LM["vocab_size"], (2, T)).astype(np.float32)

    def models(side):
        net = lm_pair(1)[side.net]
        return [("lm", net, {}), ("lm", net, {"activate": False, "dtype_policy": "bf16",
                                               "sample_input": sample})]

    enc = frame if binary else (lambda x: (json_body(np.asarray(x, np.float32).tolist()), {}))
    requests = [("/v1/models/lm/predict", *enc(ids.astype(np.float32))),
                ("/v1/models/lm:2/predict", *enc(ids.astype(np.float32)))]
    if binary:
        requests.append(("/v1/models/lm/predict", *frame(ids)))
    got = both(models, requests)
    f32 = [(got[s][0], got[s][-1]) for s in ("port", "ref")]
    assert_same_responses({"port": [got["port"][0]], "ref": [got["ref"][0]]})
    for first, last in f32:
        assert first[2] == last[2] or not binary  # int64 ids: the same answer
    (ps, ph, pb), (rs, rh, rb) = got["port"][1], got["ref"][1]
    assert (ps, rs, ph["Content-Type"]) == (200, 200, rh["Content-Type"])
    if binary:
        assert pb[:40] == rb[:40]  # the header: "dtype": "bfloat16", the shape
        p, r = tcodec.deserialize_array(pb), jcodec.deserialize_array(rb)
        assert isinstance(p, tcodec.BFloat16Array) and str(r.dtype) == "bfloat16"
    else:
        p, r = (np.asarray(json.loads(b)["outputs"], np.float64) for b in (pb, rb))
    logp = np.abs(np.log(np.asarray(p, np.float64)) - np.log(np.asarray(r, np.float64)))
    assert float(logp.max()) <= BF16_LOGP_TOL


def test_a_bf16_answer_crosses_the_wire_byte_for_byte():
    """A bf16 model's binary answer is the reference's frame byte for
    byte, and its JSON answer the same floats."""
    x = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    requests = [("/v1/models/bf/predict", *frame(x)), ("/v1/models/bf:1/predict", *frame(x)),
                ("/v1/models/bf/predict", json_body(x.tolist()), {})]
    got = both(lambda side: [("bf", Bf16Doubler(side), {})], requests)
    for p, r in zip(got["port"], got["ref"]):
        assert p == r
    header = got["port"][0][2][4:4 + struct.unpack(">I", got["port"][0][2][:4])[0]]
    assert json.loads(header) == {"dtype": "bfloat16", "shape": [3, 4]}


# ----------------------------------------------------------------- client
def _client_run(side, faults, policy_kw, calls):
    metrics = side.metrics.MetricsRegistry()
    sleeps = []
    side.fi.set_plan(side.fi.FaultPlan.parse({"faults": faults}))
    try:
        with serving(side, _duck_models(side)) as server:
            client = side.cli.ModelServingClient(
                server.url, timeout=TIMEOUT_S, metrics=metrics, sleep=sleeps.append,
                retry=side.cli.RetryPolicy(**policy_kw) if policy_kw is not None else None)
            out = []
            try:
                for kind, args, kw in calls:
                    try:
                        res = getattr(client, kind)(*args, **kw)
                        out.append(np.asarray(res).tolist() if kind == "predict" else
                                   untimed(res) if kind == "model" else res)
                    except side.cli.ServingError as e:
                        out.append(("ServingError", e.status, e.message, e.retry_after_s))
            finally:
                client.close()
            budget = client.retry_budget
    finally:
        side.fi.set_plan(None)
    return out, sleeps, budget, masked_exposition(metrics.exposition())


CLIENT_CALLS = [("predict", ("duck", [[1.0, 2.0]]), {}),
                ("predict", ("duck", [[3.0]]), {"version": 2}),
                ("predict", ("duck", np.ones((2, 2), np.float32)), {"binary": True}),
                ("predict", ("nope", [[1.0]]), {}),
                ("predict", ("duck", [[5.0]]), {"priority": 2, "deadline_ms": 5000}),
                ("healthy", (), {}), ("ready", (), {}), ("model", ("duck",), {})]


@pytest.mark.parametrize("case", ["plain", "retry"])
def test_client_matches_the_reference(case):
    """Predicts (JSON and binary), errors, probes; with a ``RetryPolicy``
    a dropped response is reconnected and retried, and 429s back off
    with the server's ``Retry-After`` as a floor, under the budget."""
    faults = [{"type": "drop_response", "model": "duck", "step": 1},
              {"type": "reject_admission", "model": "duck", "step": 3},
              {"type": "reject_admission", "model": "duck", "step": 4}]
    policy = None if case == "plain" else dict(max_retries=3, base_s=0.01)
    runs = {}
    for side in SIDES:
        runs[side.name] = _client_run(side, faults if case == "retry" else [], policy,
                                      CLIENT_CALLS)
    assert runs["port"] == runs["ref"]
    out, sleeps, budget, metrics = runs["port"]
    assert out[3][:2] == ("ServingError", 404)
    if case == "retry":
        # the dropped answer on a kept-alive connection: one reconnect
        assert metrics["client_reconnects_total"][()] == 1
        assert metrics["client_retries_total"] == {(("reason", "429"),): 2}
        assert len(sleeps) == 2 and min(sleeps) >= 0.05  # Retry-After's floor


def test_binary_predict_and_metrics_scrape_through_the_client(rng):
    x = rng.normal(size=(2, N_IN)).astype(np.float32)
    got = {}
    for side in SIDES:
        with serving(side, _duck_models(side)) as server:
            client = side.cli.ModelServingClient(server.url, timeout=TIMEOUT_S)
            try:
                got[side.name] = (client.predict("mlp", x, binary=True),
                                  client.predict("mlp", x),
                                  sorted(client.metrics()),
                                  [m["name"] for m in client.models()])
            finally:
                client.close()
    (pb, pj, pm, pn), (rb, rj, rm, rn) = got["port"], got["ref"]
    np.testing.assert_allclose(pb, rb, rtol=F32_TOL, atol=1e-7)
    np.testing.assert_allclose(pj, rj, rtol=F32_TOL, atol=1e-7)
    assert (pm, pn) == (rm, rn)


def test_retry_delays_equal_the_reference():
    for kw in ({}, {"base_s": 0.2, "factor": 3.0, "jitter": 0.5}, {"jitter": 0.0}):
        tp, jp = tcli.RetryPolicy(**kw), jcli.RetryPolicy(**kw)
        for attempt in range(1, 6):
            for seed, hint in (("", None), ("/v1/models/m/predict", 0.5)):
                assert tp.delay(attempt, hint, seed) == jp.delay(attempt, hint, seed)


class Gated(Doubler):
    """Its first call waits for ``release``; later calls answer at once."""

    def __init__(self):
        self.release, self.calls = threading.Event(), 0

    def output(self, x):
        self.calls += 1
        if self.calls == 1:
            self.release.wait(TIMEOUT_S)
        return super().output(x)


def test_hedged_predict_counts_as_the_reference():
    """The first request is held past the hedge window: one hedge fires
    and answers first (a pinned version runs on the handler threads, so
    the duplicate does not queue behind the original)."""
    counts = {}
    for side in SIDES:
        metrics = side.metrics.MetricsRegistry()
        gated = Gated()
        with serving(side, [("m", Doubler(), {}), ("m", gated, {"activate": False})]) as server:
            client = side.cli.ModelServingClient(
                server.url, timeout=TIMEOUT_S, metrics=metrics,
                retry=side.cli.RetryPolicy(hedge_after_s=0.05))
            try:
                out = client.predict("m", [[1.0, 2.0]], version=2)
            finally:
                gated.release.set()
                client.close()
            assert server.admission.wait_idle(TIMEOUT_S)  # the original finishes
        counts[side.name] = (np.asarray(out).tolist(), masked_exposition(metrics.exposition()))
    assert counts["port"] == counts["ref"]
    assert counts["port"][1]["client_hedges_total"][()] == 1
    assert counts["port"][1]["client_hedge_wins_total"][()] == 1


def _traced_spans(side):
    tracer = side.trace.enable_tracing()
    try:
        with serving(side, _duck_models(side)) as server:
            client = side.cli.ModelServingClient(server.url, timeout=TIMEOUT_S)
            try:
                client.predict("duck", [[1.0]])
                trace_id = client.last_trace_id
            finally:
                client.close()
        spans = tracer.recorder.spans()
    finally:
        side.trace.disable_tracing()
    ours = {s.span_id for s in spans if s.trace_id == trace_id}
    # the batch runs in a trace of its own, linked to the requests it served
    spans = [s for s in spans if s.span_id in ours
             or any(ln.span_id in ours for ln in s.links)]
    by_id = {s.span_id: s for s in spans}
    parent = {s.name: (by_id[s.parent_id].name if s.parent_id in by_id else None)
              for s in spans}
    linked = {s.name: sorted(by_id[ln.span_id].name for ln in s.links
                             if ln.span_id in by_id) for s in spans}
    return parent, linked


def test_a_traced_request_links_client_server_and_dispatcher_as_the_reference():
    port, ref = _traced_spans(PORT), _traced_spans(REF)
    assert port == ref
    parent, linked = port
    assert parent["http_request"] == "client_predict"
    assert parent["inference_request"] == "http_request"
    assert parent["queue_wait"] == "inference_request"
    assert linked["batch_execute"] == ["inference_request"]


def test_stop_severs_keep_alive_connections():
    """A persistent connection gets no answer after ``stop()``."""
    for side in SIDES:
        with serving(side, _duck_models(side)) as server:
            conn = http.client.HTTPConnection(server.host, server.port, timeout=TIMEOUT_S)
            try:
                conn.request("GET", "/healthz")
                assert conn.getresponse().read() == b'{"status": "ok"}'
                server.stop(drain=True, drain_timeout_s=1.0)
                with pytest.raises((http.client.HTTPException, OSError)):
                    conn.request("GET", "/healthz")
                    conn.getresponse().read()
            finally:
                conn.close()
        assert server._httpd is None
        server._thread.join(TIMEOUT_S)
        assert not server._thread.is_alive()
