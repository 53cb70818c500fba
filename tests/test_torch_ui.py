"""The port's training UI on the CPU against the JAX package's: the stats
storages, ``StatsListener``, the UI server and the remote router, the
modules, ``OneTimeLogger``, ``ui/components.py`` and ``eval/tools.py``.

- Storages: the same records in both packages' storages answer every
  query equally; a ``FileStatsStorage`` written by one package reloads in
  the other.
- ``StatsListener``: three steps of a float64 classifier in both packages
  (the JAX side under x64, weights carried across), reports at iterations
  1, 2 and 3. Each statistic within 1e-5 relative of the reference's
  (relative to the tensor's mean magnitude for the mean, which may sit
  near 0); histogram counts equal; the score, learning rates, minibatch
  size, memory keys and static information equal; no gradient or update
  statistics in either (neither network keeps its gradients).
- Server: a port server and a JAX-package server on 127.0.0.1, port 0,
  attached to storages holding the same records, answer every endpoint
  with equal JSON; the remote router posts into the port's server; a
  disabled remote answers 403. Every request has a 10 s timeout and every
  server stops in a ``finally``.
- Modules: the t-SNE, activations, calibration and evaluation modules'
  routes and panels equal the reference's on the same inputs; the
  timeline page byte for byte.
- Components and ``eval/tools.py``: the HTML of every chart kind and of the
  ROC, multi-class ROC, binary ROC and calibration pages byte for byte.
"""

import contextlib
import json
import logging
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.eval import calibration as jcal
from deeplearning4j_tpu.eval import evaluation as jev
from deeplearning4j_tpu.eval import roc as jroc
from deeplearning4j_tpu.eval import tools as jtools
from deeplearning4j_tpu.optimize import listeners as jl
from deeplearning4j_tpu.ui import components as jc
from deeplearning4j_tpu.ui import modules as jm
from deeplearning4j_tpu.ui import remote as jremote
from deeplearning4j_tpu.ui import server as jserver
from deeplearning4j_tpu.ui import stats as jstats
from deeplearning4j_tpu.ui import storage as jst
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.eval import calibration as tcal
from deeplearning4j_tpu_torch.eval import evaluation as tev
from deeplearning4j_tpu_torch.eval import roc as troc
from deeplearning4j_tpu_torch.eval import tools as ttools
from deeplearning4j_tpu_torch.optimize import listeners as tl
from deeplearning4j_tpu_torch.ui import components as tc
from deeplearning4j_tpu_torch.ui import modules as tm
from deeplearning4j_tpu_torch.ui import remote as tremote
from deeplearning4j_tpu_torch.ui import server as tserver
from deeplearning4j_tpu_torch.ui import stats as tstats
from deeplearning4j_tpu_torch.ui import storage as tst
from test_torch_conv_family import jax_init, to_np
from test_torch_earlystopping import PORT, REF, clf_conf, data

STAT_TOL = 1e-5
SID = "sess1"


@contextlib.contextmanager
def x64():
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", before)


def get(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as r:
        return json.loads(r.read())


# -------------------------------------------------------------- storages
def _records(st):
    return [st.Persistable("s1", "T", "w0", 1.0, {"info": 1}),
            st.Persistable("s1", "T", "w0", 2.0, {"score": 0.5, "iteration": 1}),
            st.Persistable("s1", "T", "w1", 3.0, {"score": 0.4, "iteration": 2}),
            st.Persistable("s2", "U", "w0", 4.0, {"score": 0.3})]


def _fill(st, storage):
    static, *updates = _records(st)
    storage.put_static_info(static)
    for p in updates:
        storage.put_update(p)
    return storage


def _answers(storage):
    d = lambda p: None if p is None else (p.session_id, p.type_id, p.worker_id,  # noqa: E731
                                          p.timestamp, p.data)
    return {
        "sessions": storage.list_session_ids(),
        "types": storage.list_type_ids_for_session("s1"),
        "workers": storage.list_worker_ids_for_session("s1"),
        "workers_t": storage.list_worker_ids_for_session("s1", "T"),
        "static": d(storage.get_static_info("s1", "T", "w0")),
        "statics": [d(p) for p in storage.get_all_static_infos("s1", "T")],
        "n": storage.get_num_update_records_for("s1"),
        "latest": d(storage.get_latest_update("s1", "T", "w1")),
        "latest_all": [d(p) for p in storage.get_latest_update_all_workers("s1", "T")],
        "after": [d(p) for p in storage.get_all_updates_after("s1", "T", 1.5)],
        "times": storage.get_all_update_times("s1", "T", "w0"),
    }


def test_in_memory_storages_answer_alike():
    events = {"j": [], "t": []}
    got, want = tst.InMemoryStatsStorage(), jst.InMemoryStatsStorage()
    for st, s, key in ((tst, got, "t"), (jst, want, "j")):
        class L(st.StatsStorageListener):
            def notify(self, e, _k=key):
                events[_k].append((e.kind, e.session_id, e.type_id, e.worker_id))
        s.register_stats_storage_listener(L())
        _fill(st, s)
    assert _answers(got) == _answers(want)
    assert events["t"] == events["j"] and events["t"]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_file_storage_reloads_in_the_other_package(tmp_path, writer):
    w, r = (tst, jst) if writer == "port" else (jst, tst)
    path = str(tmp_path / "stats.jsonl")
    s = _fill(w, w.FileStatsStorage(path))
    s.close()
    back = r.FileStatsStorage(path)
    same = _fill(w, w.InMemoryStatsStorage())
    assert _answers(back) == _answers(same)
    back.close()


# ---------------------------------------------------------- StatsListener
def _stats_run(side, net, cfg_module, storage, bins=None):
    cfg = cfg_module.StatsUpdateConfiguration(collect_histograms=bins is not None,
                                              histogram_bin_count=bins or 20)
    net.set_listeners(cfg_module.StatsListener(storage, cfg, session_id=SID,
                                               worker_id="w0"))
    x, y = data(n=24, seed=3, dtype=np.float64)
    for i in range(0, 24, 8):
        net.fit(side.ds(x[i:i + 8], y[i:i + 8]))
    return storage


@pytest.fixture(scope="module")
def stats_runs():
    """(port storage, reference storage) after the same three steps, with
    histograms of 7 bins."""
    with x64():
        j = jax_init(REF.mln, clf_conf(REF, dtype="float64"))
        t = PORT.mln(clf_conf(PORT, dtype="float64")).init()
        from deeplearning4j_tpu_torch.util.convert import load_reference_params
        load_reference_params(t, to_np(j.params))
        want = _stats_run(REF, j, jstats, jst.InMemoryStatsStorage(), bins=7)
    got = _stats_run(PORT, t, tstats, tst.InMemoryStatsStorage(), bins=7)
    return got, want


def test_stats_listener_reports_as_the_reference(stats_runs):
    got_s, want_s = stats_runs
    got = got_s.get_all_updates_after(SID, tstats.TYPE_ID, -1.0)
    want = want_s.get_all_updates_after(SID, jstats.TYPE_ID, -1.0)
    assert [p.data["iteration"] for p in got] == [p.data["iteration"] for p in want] == [1, 2, 3]
    for g, w in zip(got, want):
        g, w = g.data, w.data
        assert set(g) == set(w)
        assert g["score"] == pytest.approx(w["score"], rel=STAT_TOL)
        assert g["minibatch_size"] == w["minibatch_size"] == 8
        assert g["learning_rates"] == w["learning_rates"] and g["learning_rates"]
        assert g["gradient_stats"] == w["gradient_stats"] == {}
        assert g["update_stats"] == w["update_stats"] == {}
        assert set(g["memory"]) == set(w["memory"])
        assert set(g["param_stats"]) == set(w["param_stats"]) == {"0_W", "0_b", "1_W", "1_b"}
        for name, ws in w["param_stats"].items():
            gs = g["param_stats"][name]
            scale = ws["mean_magnitude"]
            for k in tstats.SCALARS:
                assert abs(gs[k] - ws[k]) <= STAT_TOL * max(abs(ws[k]), scale), (name, k)
            assert gs["histogram"]["counts"] == ws["histogram"]["counts"]
            np.testing.assert_allclose(gs["histogram"]["edges"], ws["histogram"]["edges"],
                                       rtol=STAT_TOL, atol=STAT_TOL * scale)
    gi = got_s.get_all_static_infos(SID, tstats.TYPE_ID)
    wi = want_s.get_all_static_infos(SID, jstats.TYPE_ID)
    assert len(gi) == len(wi) == 1
    for k in ("model_class", "n_layers", "n_params", "backend"):
        assert gi[0].data[k] == wi[0].data[k]


def test_stats_listener_reads_once_a_report(monkeypatch):
    """Every statistic and the score come back in one transfer."""
    import torch

    t = PORT.mln(clf_conf(PORT)).init()
    reads = []
    real = torch.Tensor.cpu

    def counted(self, *a, **k):
        reads.append(tuple(self.shape))
        return real(self, *a, **k)

    storage = tst.InMemoryStatsStorage()
    cfg = tstats.StatsUpdateConfiguration(collect_histograms=True, report_iterations=2)
    t.set_listeners(tstats.StatsListener(storage, cfg, session_id=SID))
    x, y = data(n=8)
    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    for _ in range(4):
        t.fit(DataSet(x, y))
    monkeypatch.undo()
    assert storage.get_num_update_records_for(SID) == 2
    assert len(reads) == 2 and all(len(s) == 1 for s in reads)


def test_histogram_matches_jnp_histogram_on_ties():
    import torch

    # one length, so that the reference compiles its histogram once
    for a in (np.resize([0.0, 0.0, 1.0, 0.5, 0.25, 1.0], 64), np.full(64, 3.0),
              np.random.default_rng(0).normal(size=64)):
        counts, edges = tstats.histogram(torch.tensor(a, dtype=torch.float32), 4)
        jc_, je = jax.numpy.histogram(jax.numpy.asarray(a, np.float32), bins=4)
        assert counts.tolist() == np.asarray(jc_).tolist()
        np.testing.assert_allclose(edges.numpy(), np.asarray(je), rtol=1e-7)


# ------------------------------------------------------------------ server
@contextlib.contextmanager
def serving(server):
    port = server.start()
    try:
        yield f"http://127.0.0.1:{port}"
    finally:
        server.stop()


def test_server_endpoints_answer_as_the_reference(stats_runs):
    got_s, _ = stats_runs
    # the same records in a reference storage
    same = jst.InMemoryStatsStorage()
    for p in got_s.get_all_static_infos(SID, tstats.TYPE_ID):
        same.put_static_info(jst.Persistable.from_json(p.to_json()))
    for p in got_s.get_all_updates_after(SID, tstats.TYPE_ID, -1.0):
        same.put_update(jst.Persistable.from_json(p.to_json()))
    ts, js_ = tserver.UIServer(port=0), jserver.UIServer(port=0)
    ts.attach(got_s)
    js_.attach(same)
    paths = ["/train/sessions", f"/train/overview/{SID}", f"/train/model/{SID}",
             f"/train/model/{SID}/0", f"/train/model/{SID}/1", "/i18n", "/i18n/de",
             "/i18n/xx"]
    with serving(ts) as tb, serving(js_) as jb:
        for path in paths:
            assert get(tb, path) == get(jb, path), path
        with urllib.request.urlopen(tb + "/train", timeout=10) as r:
            t_html = r.read()
        with urllib.request.urlopen(jb + "/train", timeout=10) as r:
            assert t_html == r.read()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(tb + "/nothing", timeout=10)
        assert e.value.code == 404
    assert ts._httpd is None and js_._httpd is None


def test_remote_router_posts_into_the_port_server():
    storage = tst.InMemoryStatsStorage()
    server = tserver.UIServer(port=0)
    server.attach(storage)
    server.enable_remote_listener()
    with serving(server) as base:
        router = tremote.RemoteUIStatsStorageRouter(base, retries=1, timeout=10)
        router.put_static_info(tst.Persistable("remote", tstats.TYPE_ID, "w9", 1.0, {"a": 1}))
        router.put_update(tst.Persistable("remote", tstats.TYPE_ID, "w9", 5.0,
                                          {"iteration": 1, "score": 0.7}))
        assert "remote" in get(base, "/train/sessions")
        assert get(base, "/train/overview/remote")["scores"] == [0.7]
    assert storage.get_static_info("remote", tstats.TYPE_ID, "w9").data == {"a": 1}


def test_disabled_remote_answers_403():
    server = tserver.UIServer(port=0)
    with serving(server) as base:
        loud = tremote.RemoteUIStatsStorageRouter(base, retries=1, timeout=10,
                                                  raise_on_error=True)
        with pytest.raises(ConnectionError, match="403"):
            loud.put_update(tst.Persistable("s", "T", "w", 1.0, {}))
        tremote.RemoteUIStatsStorageRouter(base, retries=1, timeout=10).put_update(
            tst.Persistable("s", "T", "w", 1.0, {}))


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_connection_info_addresses(pkg):
    m = tremote if pkg == "port" else jremote
    u = m.UiConnectionInfo("host1", 9000, path="train", use_https=True, session_id="s1")
    assert u.get_first_part() == "https://host1:9000"
    assert u.get_full_address() == "https://host1:9000/train/"
    assert u.get_full_address("remote") == "https://host1:9000/train/remote/?sid=s1"


def test_server_records_requests_in_a_metrics_registry():
    from deeplearning4j_tpu_torch.observe.metrics import (MetricsRegistry, exemplar_trace_ids,
                                                          parse_prometheus_text)

    reg = MetricsRegistry()
    server = tserver.UIServer(port=0, metrics=reg)
    with serving(server) as base:
        get(base, "/train/sessions")
        get(base, "/i18n")
    parsed = parse_prometheus_text(reg.exposition())
    counts = parsed["http_requests_total"]
    assert counts[(("path", "/train/sessions"), ("server", "ui"), ("status", "200"))] == 1.0
    assert counts[(("path", "/i18n"), ("server", "ui"), ("status", "200"))] == 1.0
    assert not exemplar_trace_ids(reg)  # no span was open: no exemplar


# ----------------------------------------------------------------- modules
class Meta:
    def __init__(self, i):
        self.i = i

    def get_location(self):
        return f"eval.csv:{self.i}"


def _evaluation(ev):
    e = ev.Evaluation(top_n=2)
    labels = np.eye(3)[[0, 0, 1, 2]]
    preds = np.array([[0.8, 0.1, 0.1], [0.1, 0.8, 0.1], [0.1, 0.8, 0.1], [0.6, 0.3, 0.1]])
    e.eval(labels, preds, record_meta_data=[Meta(i) for i in range(4)])
    return e


def _calibration(cal):
    rng = np.random.default_rng(2)
    p = rng.dirichlet(np.ones(3), 40)
    e = cal.EvaluationCalibration()
    e.eval(np.eye(3)[rng.integers(0, 3, 40)], p)
    return e


MODULE_ROUTES = {
    "evaluation": ["/evaluation", "/evaluation/errors", "/evaluation/by-actual/0",
                   "/evaluation/by-predicted/1", "/evaluation/cell/2/0",
                   "/evaluation/panel", "/evaluation/nope"],
    "calibration": ["/calibration", "/calibration/reliability/1", "/calibration/residual",
                    "/calibration/residual/2", "/calibration/probabilities",
                    "/calibration/probabilities/0", "/calibration/panel",
                    "/calibration/reliability/7"],
}


@pytest.mark.parametrize("name", sorted(MODULE_ROUTES))
def test_modules_answer_as_the_reference(name):
    if name == "evaluation":
        got, want = tm.EvaluationModule(_evaluation(tev)), jm.EvaluationModule(_evaluation(jev))
    else:
        got, want = (tm.CalibrationModule(_calibration(tcal)),
                     jm.CalibrationModule(_calibration(jcal)))
    for path in MODULE_ROUTES[name]:
        assert json.loads(json.dumps(got.handle(path))) == \
            json.loads(json.dumps(want.handle(path))), path


def test_tsne_module_over_the_server():
    coords = np.random.default_rng(1).normal(size=(20, 2)).tolist()
    labels = ["a"] * 10 + ["b"] * 10
    server = tserver.UIServer(port=0)
    mod = tm.TsneModule()
    tm.register_module(server, mod)
    with serving(server) as base:
        req = urllib.request.Request(
            base + "/tsne", method="POST",
            data=json.dumps({"name": "s1", "coords": coords, "labels": labels}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 200
        assert get(base, "/tsne") == ["s1"]
        assert len(get(base, "/tsne/s1")["coords"]) == 20
    ref = jm.TsneModule()
    ref.upload("s1", coords, labels)
    assert mod.render_svg("s1") == ref.render_svg("s1")


def test_activations_module_on_a_port_network():
    from deeplearning4j_tpu.nn import layers as JL
    from deeplearning4j_tpu_torch.nn import layers as PL
    from deeplearning4j_tpu_torch.util.convert import load_reference_params

    def conf(s, L):
        return (s.nnc.builder().seed(1).list()
                .layer(L.ConvolutionLayer(n_out=4, kernel_size=(3, 3), activation="relu",
                                          name="conv"))
                .layer(L.DenseLayer(n_out=8, activation="relu"))
                .layer(L.OutputLayer(n_out=2))
                .set_input_type(s.it.convolutional(8, 8, 1)).build())

    j = jax_init(REF.mln, conf(REF, JL))
    t = load_reference_params(PORT.mln(conf(PORT, PL)).init(), to_np(j.params))
    rng = np.random.default_rng(3)
    sample = rng.normal(size=(2, 8, 8, 1)).astype(np.float32)
    got, want = (tm.ConvolutionalListenerModule(sample_input=sample, frequency=1),
                 jm.ConvolutionalListenerModule(sample_input=sample, frequency=1))
    got.iteration_done(t, 1, 0)
    want.iteration_done(j, 1, 0)
    assert got.latest["iteration"] == want.latest["iteration"]
    assert set(got.latest["layers"]) == set(want.latest["layers"])
    for name, w in want.latest["layers"].items():
        g = got.latest["layers"][name]
        assert g["shape"] == w["shape"]
        np.testing.assert_allclose([g["mean"], g["std"]] + g.get("channel_means", []),
                                   [w["mean"], w["std"]] + w.get("channel_means", []),
                                   rtol=1e-5, atol=1e-6)
    assert got.handle("/activations") == (200, got.latest)


def test_timeline_page_byte_for_byte():
    class Stats:
        phase_times = {"fit": [0.5, 0.7], "split": [0.1]}

    assert tm.timeline_html(Stats()) == jm.timeline_html(Stats())


def test_one_time_logger_logs_each_message_once():
    records = []
    h = logging.Handler()
    h.emit = lambda r: records.append(r.getMessage())
    logger = logging.getLogger(tl.__name__)
    logger.addHandler(h)
    level = logger.level
    logger.setLevel(logging.INFO)
    try:
        tl.OneTimeLogger.reset()
        tl.OneTimeLogger.warn("only once %s", "x")
        tl.OneTimeLogger.warn("only once %s", "x")
        tl.OneTimeLogger.info("another")
        tl.OneTimeLogger.info("another")
        assert records == ["only once x", "another"]
        tl.OneTimeLogger.reset()
        tl.OneTimeLogger.info("another")
        assert records[-1] == "another" and len(records) == 3
    finally:
        logger.removeHandler(h)
        logger.setLevel(level)
    assert tl.OneTimeLogger is not jl.OneTimeLogger


# ---------------------------------------------------- components and tools
def _charts(c):
    style = c.StyleChart(width=500, height=240)
    line = c.ChartLine("line", style).add_series("a", [0, 1, 2], [1.0, 0.5, 0.25])
    line.add_series("b", [0, 1, 2], [0.2, 0.4, 0.9])
    scatter = c.ChartScatter("scatter").add_series("p", [0.1, 0.4], [0.3, -0.2])
    hist = c.ChartHistogram.from_values(np.random.default_rng(0).normal(size=50), 6, "h")
    bars = c.ChartHorizontalBar("bars").add_bar("x", 3.0).add_bar("y", 1.5)
    area = c.ChartStackedArea("area").set_x_values([0, 1, 2]).add_series("s", [1, 2, 3])
    timeline = c.ChartTimeline("tl").add_lane("w0", [(0.0, 1.0, "fit"), (1.0, 1.5, "eval")])
    acc = c.DecoratorAccordion("more", True, c.ComponentText("inside <b>"))
    table = c.ComponentTable(["k", "v"], [["a", 1], ["b & c", 2.5]])
    return [line, scatter, hist, bars, area, timeline, acc, table,
            c.ComponentDiv(line, table)]


def test_components_render_byte_for_byte():
    for g, w in zip(_charts(tc), _charts(jc)):
        assert g.render() == w.render()
        assert g.to_json() == w.to_json()
    assert (tc.ComponentDiv(*_charts(tc)).render_page("p")
            == jc.ComponentDiv(*_charts(jc)).render_page("p"))


def _rocs(r):
    rng = np.random.default_rng(7)
    probs = rng.dirichlet(np.ones(3), 30)
    labels = np.eye(3)[rng.integers(0, 3, 30)]
    binary = r.ROC()
    binary.eval(labels[:, :1], probs[:, :1])
    multi = r.ROCMultiClass()
    multi.eval(labels, probs)
    per = r.ROCBinary()
    per.eval(labels, probs)
    return binary, multi, per


def test_eval_tools_pages_byte_for_byte(tmp_path):
    for g, w in zip(_rocs(troc), _rocs(jroc)):
        assert ttools.roc_chart_to_html(g, ["a", "b", "c"]) == \
            jtools.roc_chart_to_html(w, ["a", "b", "c"])
    multi = _rocs(troc)[1]
    ttools.export_roc_charts_to_html_file(multi, str(tmp_path / "roc.html"))
    assert (tmp_path / "roc.html").read_text() == ttools.roc_chart_to_html(multi)
    for cls in range(3):
        assert ttools.calibration_chart_to_html(_calibration(tcal), cls) == \
            jtools.calibration_chart_to_html(_calibration(jcal), cls)
    with pytest.raises(TypeError):
        ttools.roc_chart_to_html(object())
