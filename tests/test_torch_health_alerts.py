"""The port's health, listener, alert and SLO modules on the CPU against
the JAX package.

- ``TrainingWatchdog``: the same events (check, iteration, epoch, value,
  message) at the same steps, from scripted scores, gradient norms and a
  manual clock, and from real networks with the JAX weights carried
  across: the parameter scan and the gradient probe (norms within 1e-5
  relative: f64 sums of the same f32 gradients, in another order), and
  example 26's diverging run (SGD at lr 1000 on MSE), which must raise at
  the reference's step; ``EarlyStoppingTrainer`` ends that run as an
  "Error" termination in both packages (C13).
- ``TraceListener``: the same series after the same fits, the timings
  masked, the score within 1e-5 relative.
- ``ServingHealth``: the same report for the same registry states.
- Alerts and SLOs: ``examples/alert_rules.json``,
  ``serving_alert_rules.json``, ``elastic_alert_rules.json`` and
  ``slo_config.json`` load to the same rules in both packages; the same
  metric histories on a ``ManualTimeSource`` give the same notifications,
  rule states, exposition and ``/slo`` payload; ``WebhookSink`` posts the
  same bodies to a loopback server.

No test waits on the wall clock: every clock is injected, every server
binds port 0 and is stopped in ``finally``.
"""

import http.server
import json
import os
import threading
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JIter
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Sgd as JSgd
from deeplearning4j_tpu.observe import alerts as jalerts
from deeplearning4j_tpu.observe import health as jhealth
from deeplearning4j_tpu.observe import listener as jlistener
from deeplearning4j_tpu.observe import metrics as jmetrics
from deeplearning4j_tpu.observe import slo as jslo
from deeplearning4j_tpu.observe import trace as jtrace
from deeplearning4j_tpu.optimize import earlystopping as jes
from deeplearning4j_tpu.parallel import time_source as jts
from deeplearning4j_tpu.serving import admission as jadm
from deeplearning4j_tpu.serving import brownout as jbro
from deeplearning4j_tpu.serving import registry as jreg
from deeplearning4j_tpu.serving import server as jsrv
from deeplearning4j_tpu.util import faultinject as jfi
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as TDataSet
from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator as TIter
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration as TNNC
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TMLN
from deeplearning4j_tpu_torch.nn.updaters import Sgd as TSgd
from deeplearning4j_tpu_torch.observe import alerts as talerts
from deeplearning4j_tpu_torch.observe import health as thealth
from deeplearning4j_tpu_torch.observe import listener as tlistener
from deeplearning4j_tpu_torch.observe import metrics as tmetrics
from deeplearning4j_tpu_torch.observe import slo as tslo
from deeplearning4j_tpu_torch.observe import trace as ttrace
from deeplearning4j_tpu_torch.optimize import earlystopping as tes
from deeplearning4j_tpu_torch.parallel import time_source as tts
from deeplearning4j_tpu_torch.serving import admission as tadm
from deeplearning4j_tpu_torch.serving import brownout as tbro
from deeplearning4j_tpu_torch.serving import registry as treg
from deeplearning4j_tpu_torch.serving import server as tsrv
from deeplearning4j_tpu_torch.util import faultinject as tfi
from deeplearning4j_tpu_torch.util.convert import load_reference_params
from test_torch_conv_family import jax_init, to_np
from test_torch_http_serving import Doubler, call, counted, masked_exposition, serving
from test_torch_inference_supervision import N_IN, mlp_pair

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")
RULE_FILES = ("alert_rules.json", "serving_alert_rules.json", "elastic_alert_rules.json")
NORM_RTOL = 1e-5

PORT = types.SimpleNamespace(name="port", health=thealth, alerts=talerts, slo=tslo,
                             listener=tlistener, metrics=tmetrics, trace=ttrace, ts=tts,
                             es=tes, reg=treg, adm=tadm, bro=tbro, srv=tsrv, fi=tfi,
                             nnc=TNNC, L=TL, sgd=TSgd, ds=TDataSet, it=TIter, net=1)
REF = types.SimpleNamespace(name="ref", health=jhealth, alerts=jalerts, slo=jslo,
                            listener=jlistener, metrics=jmetrics, trace=jtrace, ts=jts,
                            es=jes, reg=jreg, adm=jadm, bro=jbro, srv=jsrv, fi=jfi,
                            nnc=JNNC, L=JL, sgd=JSgd, ds=JDataSet, it=JIter, net=0)
SIDES = (PORT, REF)


def events_of(wd):
    return [(e.check, e.iteration, e.epoch, e.value, e.message, e.model_name)
            for e in wd.events]


# --------------------------------------------------------------- watchdog
class _Scored:
    """A duck model whose score the script sets."""

    score_ = 0.0
    params = None


NAN = float("nan")
SCORE_SCRIPTS = {  # (score, step seconds, gradient norm or None)
    "divergence": [(1.0, 1.0, None), (0.9, 1.0, None)] + [(1.0 + i, 1.0, None)
                                                          for i in range(8)],
    "nan_loss": [(1.0, 1.0, None), (NAN, 1.0, None), (0.5, 1.0, None), (float("inf"), 1.0, None)],
    "stall": [(1.0, 1.0, None)] * 7 + [(1.0, 25.0, None), (1.0, 1.0, None)],
    "gradients": [(1.0, 1.0, g) for g in (1.0, 1.1, 0.9, 1.0, 1.2, 500.0, 1.0, 1e-6,
                                          NAN, 0.0)],
    "zero_baseline": [(1.0, 1.0, g) for g in (0.0,) * 5 + (1e-9, 0.0)],
}


def _watchdog_script(side, script, action):
    now = [0.0]
    raised = []
    wd = side.health.TrainingWatchdog(
        model_name="m", action=action, divergence_windows=3, grad_warmup=3,
        stall_min_history=5, clock=lambda: now[0],
        metrics=side.metrics.MetricsRegistry())
    model = _Scored()
    wd.on_epoch_start(model)
    for i, (score, dt, norm) in enumerate(script):
        now[0] += dt
        model.score_ = score
        try:
            wd.iteration_done(model, i, 0)
            if norm is not None:
                wd.observe_gradient_norm(norm)
        except side.health.WatchdogAlarm as e:
            raised.append((i, str(e), e.event.check))
    wd.on_epoch_end(model)
    return events_of(wd), raised, wd._m_events.expose()


@pytest.mark.parametrize("action", ["log", "raise"])
@pytest.mark.parametrize("script", sorted(SCORE_SCRIPTS))
def test_watchdog_fires_as_the_reference(script, action):
    port = _watchdog_script(PORT, SCORE_SCRIPTS[script], action)
    ref = _watchdog_script(REF, SCORE_SCRIPTS[script], action)
    assert repr(port) == repr(ref)  # repr: NaN values compare equal
    assert port[0], "the script must fire"
    assert bool(port[1]) == (action == "raise")


def test_watchdog_callbacks_and_unknown_checks_as_the_reference():
    for side in SIDES:
        seen = []
        wd = side.health.TrainingWatchdog(actions={"nan_loss": seen.append})
        model = _Scored()
        model.score_ = NAN
        wd.iteration_done(model, 0, 0)
        assert [e.check for e in seen] == ["nan_loss"]
        with pytest.raises(ValueError, match="unknown watchdog checks"):
            side.health.TrainingWatchdog(actions={"nope": "log"})
        bad = side.health.TrainingWatchdog(action="shout")
        with pytest.raises(ValueError, match="unknown watchdog action"):
            bad.iteration_done(model, 0, 0)


def _mlp_data(rng_seed=3):
    rng = np.random.default_rng(rng_seed)
    x = rng.normal(size=(6, N_IN)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    return x, y


def _poison(side, net, layer, name):
    """A NaN in one parameter of ``net``, as each package stores it."""
    if side is PORT:
        with torch.no_grad():
            net.params[layer][name][0] = float("nan")
    else:
        group = dict(net.params[layer])
        group[name] = group[name].at[0].set(float("nan"))
        net.params[layer] = group


def _checked_mlp(side):
    """The parameter scan and gradient probe over three steps of the MLP
    (the weights shared by both packages), a NaN planted before the
    third. Returns the events and the probe's gradient norms."""
    j, t = mlp_pair(1)
    net = t if side is PORT else j
    saved = to_np(j.params)
    x, y = _mlp_data()
    norms = []
    wd = side.health.TrainingWatchdog(check_params_every=1, gradient_batch=side.ds(x, y),
                                      grad_warmup=1)
    observe = wd.observe_gradient_norm
    wd.observe_gradient_norm = lambda n: (norms.append(float(n)), observe(n))[1]
    try:
        for i in range(3):
            if i == 2:
                _poison(side, net, 1, "b")
            wd.iteration_done(net, i, 0)
    finally:
        if side is PORT:
            load_reference_params(t, saved)
        else:
            j.params = jax_params(saved)
    return [(e[0], e[1], e[4]) for e in events_of(wd)], norms


def jax_params(saved):
    import jax.numpy as jnp
    return [{k: jnp.asarray(v) for k, v in g.items()} for g in saved]


def test_parameter_scan_and_gradient_probe_match_the_reference():
    (p_events, p_norms), (r_events, r_norms) = _checked_mlp(PORT), _checked_mlp(REF)
    assert p_events == r_events
    assert ("nan_params", 2, "parameter 'b' contains non-finite values") in p_events
    np.testing.assert_allclose(p_norms[:2], r_norms[:2], rtol=NORM_RTOL)
    assert np.isnan(p_norms[2]) and np.isnan(r_norms[2])


def test_the_scan_reads_each_tensor_s_flag_in_one_transfer():
    """One host read for the scan and one for the probe, however many
    tensors: the flags and the f64 sums are stacked where they lie."""
    flags = thealth._all_finite([torch.ones(3), torch.tensor([1.0, float("inf")]),
                                 np.zeros(2), torch.zeros(0)])
    assert flags == [True, False, True, True]
    sq = thealth._sum_squares_f64([torch.full((3,), 2.0), np.array([1.0, 1.0])])
    assert sq == 14.0 and thealth._sum_squares_f64([]) == 0.0


# ------------------------------------------------ example 26's diverging run
def _diverging_conf(side):
    return (side.nnc.builder().seed(1).updater(side.sgd(1000.0)).list()
            .layer(side.L.DenseLayer(n_in=8, n_out=16, activation="tanh"))
            .layer(side.L.OutputLayer(n_in=16, n_out=1, activation="identity", loss="mse"))
            .build())


_DIVERGING = {}


def diverging_net(side):
    """Example 26's explosive MLP, the JAX weights in both packages."""
    if "ref" not in _DIVERGING:
        _DIVERGING["ref"] = to_np(jax_init(JMLN, _diverging_conf(REF)).params)
    if side is REF:
        net = jax_init(JMLN, _diverging_conf(REF))
        net.params = jax_params(_DIVERGING["ref"])
        return net
    return load_reference_params(TMLN(_diverging_conf(PORT), device="cpu").init(),
                                 _DIVERGING["ref"])


def diverging_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = x @ rng.normal(size=(8, 1)).astype(np.float32)
    return x, y


def _diverging_fit(side):
    net = diverging_net(side)
    x, y = diverging_data()
    wd = side.health.TrainingWatchdog(action="raise", divergence_windows=3,
                                      model_name="diverging")
    side.health.attach_observability(net, trace=False, watchdog=wd)
    with pytest.raises(side.health.WatchdogAlarm) as alarm:
        net.fit(side.it(side.ds(x, y), 16), epochs=50)
    return alarm.value.event.check, alarm.value.event.iteration, alarm.value.event.epoch


def test_the_diverging_run_raises_at_the_reference_s_step():
    port, ref = _diverging_fit(PORT), _diverging_fit(REF)
    assert port == ref
    assert port[0] in ("nan_loss", "loss_divergence")


def _early_stopped(side):
    net = diverging_net(side)
    x, y = diverging_data()
    side.health.attach_observability(net, trace=False,
                                     watchdog={"action": "raise", "divergence_windows": 3})
    cfg = side.es.EarlyStoppingConfiguration(
        epoch_termination_conditions=[side.es.MaxEpochsTerminationCondition(50)],
        score_calculator=side.es.DataSetLossCalculator([side.ds(x, y)]))
    result = side.es.EarlyStoppingTrainer(cfg, net, side.it(side.ds(x, y), 16)).fit()
    return result.termination_reason, result.termination_details, result.total_epochs


def test_early_stopping_ends_a_watchdog_alarm_as_an_error_termination():
    """C13 wired back: the reference's "Error" termination, the alarm's
    message as its details, at the same epoch."""
    port, ref = _early_stopped(PORT), _early_stopped(REF)
    assert port == ref
    assert port[0] == "Error"


def test_attach_observability_as_the_reference():
    for side in SIDES:
        model = _Scored()
        model.listeners = []
        got = side.health.attach_observability(
            model, metrics=side.metrics.MetricsRegistry(), model_name="x",
            watchdog={"check_params_every": 4})
        assert [type(g).__name__ for g in got] == ["TraceListener", "TrainingWatchdog"]
        assert got[1].model_name == "x" and got[1].check_params_every == 4
        assert model.listeners == got
        assert side.health.attach_observability(model, trace=False) == []


# ----------------------------------------------------------- TraceListener
def _listened(side):
    j, t = mlp_pair(2)
    net = t if side is PORT else j
    saved = to_np(j.params)
    metrics = side.metrics.MetricsRegistry()
    tracer = side.trace.Tracer()
    lst = side.listener.TraceListener(tracer, metrics, "mlp")
    net.listeners.append(lst)
    x, y = _mlp_data(5)
    try:
        net.fit(side.it(side.ds(x, y), 3), epochs=2)
    finally:
        net.listeners.remove(lst)
        if side is PORT:
            load_reference_params(t, saved)
        else:
            j.params = jax_params(saved)
        for attr in ("iteration", "epoch"):
            setattr(net, attr, 0)
    spans = [(s.name, s.attrs) for s in tracer.recorder.spans()]
    return masked_exposition(metrics.exposition()), spans


def test_trace_listener_exports_as_the_reference():
    (p_series, p_spans), (r_series, r_spans) = _listened(PORT), _listened(REF)
    p_score = p_series.pop("training_score")
    r_score = r_series.pop("training_score")
    assert p_series == r_series
    assert p_score.keys() == r_score.keys()
    for k in p_score:
        assert p_score[k] == pytest.approx(r_score[k], rel=1e-5)
    # a window opens at each epoch's start: one span a step
    assert p_spans == r_spans and len(p_spans) == 4
    assert p_series["training_steps_total"][(("model", "mlp"),)] == 4


# ------------------------------------------------------------ ServingHealth
def _health_reports(side):
    reports = []
    metrics = side.metrics.MetricsRegistry()
    reg = side.reg.ModelRegistry(metrics=metrics, warmup="off", wait_ms=0.0,
                                 breaker=dict(failure_threshold=1, window_s=60.0,
                                              cooldown_s=30.0, half_open_probes=1))
    try:
        health = side.health.ServingHealth(registry=reg)
        reports.append(health.report().to_dict())
        reg.register("a", Doubler())
        reg.register("a", Doubler(), activate=False)
        adm = side.adm.AdmissionController(2)
        bro = side.bro.BrownoutController(admission=adm, enter_after_s=0.0,
                                          time_source=side.ts.ManualTimeSource(0))
        probe = lambda: side.health.HealthCheck("custom", True, "fine")  # noqa: E731
        health = side.health.ServingHealth(registry=reg, admission=adm, brownout=bro,
                                           extra_probes=[probe])
        reports.append(health.report().to_dict())
        slots = [adm.admit(), adm.admit()]
        bro.observe()
        reports.append(health.report().to_dict())
        for s in slots:
            s.release()
        adm.begin_drain()
        side.fi.set_plan(side.fi.FaultPlan.parse(
            {"faults": [{"type": "crash_forward", "model": "a", "step": 0}]}))
        with pytest.raises(Exception):
            reg.predict("a", np.ones((1, 2), np.float32))
        reports.append(health.report().to_dict())
    finally:
        side.fi.set_plan(None)
        reg.shutdown()
    return reports


def test_serving_health_reports_match_the_reference():
    port, ref = _health_reports(PORT), _health_reports(REF)
    assert port == ref
    assert [r["status"] for r in port] == ["degraded", "ok", "degraded", "down"]


# ------------------------------------------------------------ alerts, SLOs
@pytest.mark.parametrize("name", RULE_FILES)
def test_rule_files_load_as_the_reference(name):
    path = os.path.join(EXAMPLES, name)
    port = [r.describe() for r in talerts.load_rules(path)]
    assert port == [r.describe() for r in jalerts.load_rules(path)]
    with open(path) as f:
        assert port == [r.describe() for r in talerts.load_rules(json.load(f))]


def test_slo_config_loads_as_the_reference():
    path = os.path.join(EXAMPLES, "slo_config.json")
    port, ref = tslo.load_slos(path), jslo.load_slos(path)
    assert port.describe() == ref.describe()
    assert [r.describe() for r in port.rules()] == [r.describe() for r in ref.rules()]
    for bad in ({"slos": [{"name": "x", "sli": "nope", "metric": "m"}]},
                {"slos": [{"name": "x", "sli": "latency", "metric": "m"}] * 2}):
        with pytest.raises(ValueError) as pe:
            tslo.load_slos(bad)
        with pytest.raises(ValueError) as je:
            jslo.load_slos(bad)
        assert str(pe.value) == str(je.value)


CUSTOM_RULES = [
    {"type": "threshold", "name": "depth", "metric": "queue_depth", "op": ">=",
     "value": 3, "for_s": 20, "labels": {"model": "a"}},
    {"type": "absence", "name": "exporter_gone", "metric": "heartbeat"},
    {"type": "rate_of_change", "name": "surge", "metric": "requests_total", "op": ">",
     "value": 0.5, "window_s": 30},
]

# (seconds advanced, requests ok, requests 429, requests 500, queue depth,
#  heartbeat present, latency observations in seconds)
TRAFFIC = [(0, 0, 0, 0, 0, True, ()), (10, 100, 0, 0, 1, True, (0.01,) * 5),
           (10, 50, 40, 2, 3, True, (0.3,) * 4), (10, 10, 60, 0, 4, True, (0.5,) * 6),
           (10, 10, 30, 0, 4, False, (0.01,)), (15, 5, 0, 0, 2, False, (0.02,) * 2),
           (400, 500, 0, 0, 0, True, (0.01,) * 40), (10, 600, 0, 0, 0, True, ()),
           (3600, 2000, 0, 0, 0, True, (0.01,) * 10), (60, 10, 0, 0, 0, True, ())]


def _alert_run(side, rules_spec):
    metrics = side.metrics.MetricsRegistry()
    clock = side.ts.ManualTimeSource(0)
    seen = []
    rules = side.alerts.load_rules(rules_spec)
    slos = side.slo.load_slos(os.path.join(EXAMPLES, "slo_config.json"))
    mgr = side.alerts.AlertManager(
        metrics, rules + slos.rules(),
        [side.alerts.LogSink(), side.alerts.CallbackSink(lambda n: seen.append(n.to_dict()))],
        time_source=clock)
    req = metrics.counter("serving_requests_total", "", ("model", "status"))
    lat = metrics.histogram("serving_request_latency_seconds", "", ("model",))
    depth = metrics.gauge("queue_depth", "", ("model",))
    total = metrics.counter("requests_total", "")
    rejected = metrics.counter("serving_admission_rejections_total", "", ("reason",))
    rounds = []
    for dt, ok, r429, r500, q, beat, lats in TRAFFIC:
        clock.advance(dt)
        req.inc(ok, model="mnist", status="200")
        if r429:
            req.inc(r429, model="mnist", status="429")
            rejected.inc(r429, reason="overflow")
        if r500:
            req.inc(r500, model="mnist", status="500")
        total.inc(ok + r429 + r500)
        depth.set(q, model="a")
        if beat:
            metrics.gauge("heartbeat", "").set(1)
        elif metrics.get("heartbeat") is not None:
            metrics._metrics.pop("heartbeat")
        for s in lats:
            lat.observe(s, model="mnist")
        notes = mgr.evaluate_once()
        rounds.append(([n.to_dict() for n in notes], mgr.firing()))
    status = slos.status(metrics=metrics, alerts=mgr)
    return rounds, seen, mgr.describe(), masked_exposition(metrics.exposition()), status


@pytest.mark.parametrize("rules", ["alert_rules.json", "custom"])
def test_alert_manager_and_slo_status_match_the_reference(rules):
    spec = CUSTOM_RULES if rules == "custom" else os.path.join(EXAMPLES, rules)
    port, ref = _alert_run(PORT, spec), _alert_run(REF, spec)
    assert repr(port) == repr(ref)
    fired = [n["rule"] for n in port[1] if n["state"] == "firing"]
    resolved = [n["rule"] for n in port[1] if n["state"] == "resolved"]
    assert fired and sorted(set(fired)) == sorted(fired)  # each fires once
    assert set(resolved) <= set(fired)


def test_burn_rate_alert_fires_once_and_resolves_over_http():
    """Example 26's loop over HTTP: injected admission rejections (429)
    burn ``alert_rules.json``'s error budget; on a manual clock the rule
    fires once and resolves after recovery traffic; ``/alerts`` and
    ``/slo`` report it, the same in both packages."""
    got = {}
    for side in SIDES:
        clock = side.ts.ManualTimeSource(0)
        seen = []
        side.fi.set_plan(side.fi.FaultPlan.parse({"faults": [
            {"type": "reject_admission", "model": "m", "step": s} for s in range(2, 8)]}))
        try:
            with serving(side, [("m", Doubler(), {})], max_inflight=4,
                         slo=side.slo.load_slos(os.path.join(EXAMPLES, "slo_config.json"))
                         ) as server:
                mgr = side.alerts.AlertManager(
                    server.metrics, side.alerts.load_rules(
                        os.path.join(EXAMPLES, "alert_rules.json")),
                    [side.alerts.CallbackSink(seen.append)], time_source=clock)
                server.alerts = mgr
                body = json.dumps({"inputs": [[1.0]]}).encode()
                mgr.evaluate_once()
                statuses = []
                for phase, n in (("burst", 10), ("recovery", 200)):
                    clock.advance(30)
                    statuses += [call(server, "/v1/models/m/predict", body)[0]
                                 for _ in range(n)]
                    counted(server, len(statuses))
                    mgr.evaluate_once()
                    if phase == "burst":
                        alerts_mid = json.loads(call(server, "/alerts")[2])
                clock.advance(3600)
                mgr.evaluate_once()
                clock.advance(60)
                mgr.evaluate_once()
                slo = json.loads(call(server, "/slo")[2])
                alerts_end = json.loads(call(server, "/alerts")[2])
        finally:
            side.fi.set_plan(None)
        got[side.name] = (statuses, [(n.rule, n.state) for n in seen], alerts_mid,
                          alerts_end, slo)
    assert repr(got["port"]) == repr(got["ref"])
    statuses, notes, mid, end, slo = got["port"]
    assert statuses.count(429) == 6
    burn = [n for n in notes if n[0] == "predict_slo_burn"]
    assert burn == [("predict_slo_burn", "firing"), ("predict_slo_burn", "resolved")]
    assert "predict_slo_burn" in mid["firing"] and "predict_slo_burn" not in end["firing"]
    assert [s["name"] for s in slo["slos"]] == ["predict_latency_mnist",
                                                "predict_availability"]


class _Collector(http.server.BaseHTTPRequestHandler):
    bodies: list = []
    statuses: list = []

    def log_message(self, *a):
        pass

    def do_POST(self):
        n = int(self.headers.get("Content-Length", "0"))
        type(self).bodies.append((self.headers.get("Content-Type"), self.rfile.read(n)))
        code = type(self).statuses.pop(0) if type(self).statuses else 200
        self.send_response(code)
        self.send_header("Content-Length", "0")
        self.end_headers()


def test_webhook_sink_posts_the_reference_s_bodies_on_loopback():
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Collector)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/hook"
    try:
        got = {}
        for side in SIDES:
            _Collector.bodies.clear()
            _Collector.statuses[:] = [500]  # the first attempt fails, the retry lands
            sleeps = []
            sink = side.alerts.WebhookSink(url, retries=2, backoff_s=0.5, timeout_s=5.0,
                                           sleep=sleeps.append)
            note = side.alerts.Notification("r", "page", "firing", 2.5, "burning", 12.0)
            sink.notify(note)
            dead = side.alerts.WebhookSink(url, retries=1, sleep=sleeps.append,
                                           post=lambda u, b: 503)
            dead.notify(note)
            got[side.name] = (list(_Collector.bodies), sleeps, sink.delivered, sink.failed,
                              dead.failed, dead.last_error)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(10.0)
    assert got["port"] == got["ref"]
    bodies, sleeps, delivered, failed, dead_failed, last = got["port"]
    assert len(bodies) == 2 and json.loads(bodies[1][1])["rule"] == "r"
    assert (sleeps, delivered, failed, dead_failed, last) == ([0.5, 0.5], 1, 0, 1, "HTTP 503")


def test_alert_manager_thread_starts_and_stops():
    for side in SIDES:
        mgr = side.alerts.AlertManager(side.metrics.MetricsRegistry(), [], interval_s=0.01,
                                       time_source=side.ts.ManualTimeSource(0))
        try:
            assert mgr.start() is mgr and mgr.start() is mgr
        finally:
            mgr.stop()
        assert mgr._thread is None
        rule = side.alerts.ThresholdRule("x", "m", ">", 1)
        with pytest.raises(ValueError, match="duplicate rule names"):
            side.alerts.AlertManager(side.metrics.MetricsRegistry(), [rule, rule])
