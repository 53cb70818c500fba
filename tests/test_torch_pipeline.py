"""The port's continuous-training pipeline against the JAX package's on the
CPU.

- The journal: each package replays the other's file to the same state,
  resume point and history (timestamps and tokens masked); a second owner
  fences the first in both (``StalePipelineError``), a zombie line written
  past the fence is left out of both replays, and a torn last line is
  skipped by both and repaired by the next owner.
- The canary: both controllers over both registries (the MLP pair below
  with carried weights, warm-up off) on a ``ManualTimeSource`` serve the
  same versions request by request, ramp, shadow and decide alike; an
  alarm and a firing alert roll both back with the same reason.
- The gate: loss within 1e-5 relative, accuracy equal, the same verdict.
- The trainer: two mini-epochs of ``ContinuousTrainer`` from carried
  weights within 1e-5 × each tensor's largest entry, on example 27's MLP
  (Dense 16 relu, softmax 2) and on a narrow TBPTT LSTM (2 × LSTM(16),
  T 40, TBPTT 10).
- Example 27's promote cycle and rollback cycle (the inverted stream):
  the two packages' journals hold the same event sequence (timestamps,
  tokens masked; the gate's numbers within 1e-5 relative).
- ``PipelineConfig.parse`` and ``lint`` on ``examples/pipeline_config.json``
  and on error specs: the same fields and messages.
- One subprocess of the port's CLI killed mid-canary by a fault plan
  resumes to exactly one PROMOTE.
The reference's runs are cached (``functools.lru_cache``) and shared by
the cases.
"""

import copy
import functools
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from deeplearning4j_tpu import pipeline as R
from deeplearning4j_tpu.datasets.dataset import DataSet as RDataSet
from deeplearning4j_tpu.nn.conf import InputType as RIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as RNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as RDense
from deeplearning4j_tpu.nn.layers import LSTMLayer as RLSTM
from deeplearning4j_tpu.nn.layers import OutputLayer as ROut
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as RRnnOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as RMLN
from deeplearning4j_tpu.nn.updaters import Adam as RAdam
from deeplearning4j_tpu.observe.metrics import MetricsRegistry as RMetrics
from deeplearning4j_tpu.parallel.time_source import ManualTimeSource as RClock
from deeplearning4j_tpu.serving import ModelRegistry as RRegistry
from deeplearning4j_tpu_torch import pipeline as P
from deeplearning4j_tpu_torch.datasets.dataset import DataSet as PDataSet
from deeplearning4j_tpu_torch.nn.conf import InputType as PIT
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration as PNNC
from deeplearning4j_tpu_torch.nn.layers import DenseLayer as PDense
from deeplearning4j_tpu_torch.nn.layers import LSTMLayer as PLSTM
from deeplearning4j_tpu_torch.nn.layers import OutputLayer as POut
from deeplearning4j_tpu_torch.nn.layers import RnnOutputLayer as PRnnOut
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as PMLN
from deeplearning4j_tpu_torch.nn.updaters import Adam as PAdam
from deeplearning4j_tpu_torch.observe.metrics import MetricsRegistry as PMetrics
from deeplearning4j_tpu_torch.parallel.time_source import ManualTimeSource as PClock
from deeplearning4j_tpu_torch.serving import ModelRegistry as PRegistry
from deeplearning4j_tpu_torch.util.convert import export_params, load_reference_params
from test_torch_conv_family import jax_init, to_np
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "examples", "pipeline_config.json")
TOL = 1e-5
MASKED = ("ts", "token")

REF = dict(P=R, DataSet=RDataSet, NNC=RNNC, IT=RIT, Dense=RDense, LSTM=RLSTM, Out=ROut,
           RnnOut=RRnnOut, MLN=RMLN, Adam=RAdam, Metrics=RMetrics, Clock=RClock,
           Registry=RRegistry)
PORT = dict(P=P, DataSet=PDataSet, NNC=PNNC, IT=PIT, Dense=PDense, LSTM=PLSTM, Out=POut,
            RnnOut=PRnnOut, MLN=PMLN, Adam=PAdam, Metrics=PMetrics, Clock=PClock,
            Registry=PRegistry)


def masked(records):
    return [{k: v for k, v in r.items() if k not in MASKED} for r in records]


# ------------------------------------------------------------------ journal
def write_journal(pkg, directory):
    sm = pkg.PipelineStateMachine(directory, name="m")
    sm.begin_run(source="stream")
    sm.enter("TRAIN")
    sm.commit("TRAIN", candidate_version=2, examples=64, score=0.5)
    sm.enter("EVAL", candidate_version=2)
    sm.note("gate measured", value=0.25)
    sm.commit("EVAL", passed=True, candidate=0.4, baseline=0.5)
    sm.enter("CANARY", candidate_version=2)
    return sm


def read_state(pkg, directory):
    sm = pkg.PipelineStateMachine(directory, name="m")
    point = sm.resume_point()
    return (point.to_dict() if point else None, masked(sm.stage_history()),
            sm.decided(), sm.open_empty_run(), sm.run)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_replays_the_other_s_journal(writer, tmp_path):
    w, r = (P, R) if writer == "port" else (R, P)
    write_journal(w, str(tmp_path / "a"))
    write_journal(w, str(tmp_path / "b"))
    assert read_state(r, str(tmp_path / "a")) == read_state(w, str(tmp_path / "b"))
    # the reader finishes the run; the writer's package replays the decision
    sm = r.PipelineStateMachine(str(tmp_path / "a"), name="m")
    sm.commit("CANARY", decision="promote")
    sm.enter("PROMOTE", candidate_version=2)
    sm.commit("PROMOTE", version=2)
    with pytest.raises(r.IllegalTransition):
        sm.enter("ROLLBACK")
    back = w.PipelineStateMachine(str(tmp_path / "a"), name="m")
    assert back.decided(1) == "PROMOTE" and back.resume_point() is None
    assert masked(back.journal.records()) == masked(
        r.PipelineJournal(str(tmp_path / "a")).records())


@pytest.mark.parametrize("first", ["port", "reference"])
def test_fencing_and_zombie_lines_as_the_reference(first, tmp_path):
    a_pkg, b_pkg = (P, R) if first == "port" else (R, P)
    d = str(tmp_path)
    a = a_pkg.PipelineStateMachine(d, name="m")
    a.begin_run()
    a.enter("TRAIN")
    b = b_pkg.PipelineStateMachine(d, name="m")  # fences a
    with pytest.raises(a_pkg.StalePipelineError):
        a.note("zombie")
    # a zombie's line slipping past the owner check: valid JSON, its
    # token fenced with a snapshot that does not hold its seq
    with open(os.path.join(d, "pipeline_journal.jsonl"), "a") as fh:
        fh.write(json.dumps({"event": "commit", "run": 1, "stage": "TRAIN", "seq": 99,
                             "token": a.token, "ts": 0.0, "data": {}}) + "\n")
    b.commit("TRAIN", aborted="fenced")
    got = {name: masked(pkg.PipelineJournal(d).records())
           for name, pkg in (("port", P), ("reference", R))}
    assert got["port"] == got["reference"]
    assert [r["seq"] for r in got["port"]] == [1, 2, 3]
    raw = masked(P.PipelineJournal(d).records(eligible_only=False))
    assert raw == masked(R.PipelineJournal(d).records(eligible_only=False))
    assert [r["seq"] for r in raw] == [1, 2, 99, 3]


@pytest.mark.parametrize("repairer", ["port", "reference"])
def test_torn_last_line_skipped_and_repaired_by_either(repairer, tmp_path):
    d = str(tmp_path)
    sm = P.PipelineStateMachine(d, name="m")
    sm.begin_run()
    sm.enter("TRAIN")
    with open(os.path.join(d, "pipeline_journal.jsonl"), "a") as fh:
        fh.write('{"event": "commit", "run": 1, "sta')  # the crash mid-write
    torn = {name: masked(pkg.PipelineJournal(d).records())
            for name, pkg in (("port", P), ("reference", R))}
    assert torn["port"] == torn["reference"] and len(torn["port"]) == 2
    pkg = P if repairer == "port" else R
    again = pkg.PipelineStateMachine(d, name="m")
    assert again.resume_point().to_dict() == {"run": 1, "stage": "TRAIN",
                                              "committed": False, "data": {}}
    again.commit("TRAIN", candidate_version=2)
    after = {name: masked(p.PipelineJournal(d).records())
             for name, p in (("port", P), ("reference", R))}
    assert after["port"] == after["reference"]
    assert [(r["event"], r.get("stage")) for r in after["port"]] == [
        ("run", None), ("enter", "TRAIN"), ("commit", "TRAIN")]


# ------------------------------------------------------------------ networks
N_IN = 8
W_TRUE = np.random.default_rng(7).normal(size=(N_IN, 2)).astype(np.float32)


def ex27_data(rng, n, garbage=False):
    x = rng.normal(size=(n, N_IN)).astype(np.float32)
    labels = (x @ W_TRUE).argmax(1)
    if garbage:
        labels = 1 - labels
    return x, np.eye(2, dtype=np.float32)[labels]


def ex27_conf(k, seed=1):
    return (k["NNC"].builder().seed(seed).list()
            .layer(k["Dense"](n_out=16, activation="relu"))
            .layer(k["Out"](n_out=2))
            .set_input_type(k["IT"].feed_forward(N_IN)).build())


LSTM_VOCAB, LSTM_T, LSTM_TBPTT = 8, 40, 10


def lstm_conf(k):
    return (k["NNC"].builder().seed(12345).l2(1e-4).weight_init("xavier")
            .updater(k["Adam"](0.005)).list()
            .layer(k["LSTM"](n_out=16, activation="tanh"))
            .layer(k["LSTM"](n_out=16, activation="tanh"))
            .layer(k["RnnOut"](n_out=LSTM_VOCAB, loss="mcxent", activation="softmax"))
            .set_input_type(k["IT"].recurrent(LSTM_VOCAB))
            .backprop_type("TruncatedBPTT").t_bptt_length(LSTM_TBPTT).build())


def lstm_data(rng, n):
    ids = rng.integers(0, LSTM_VOCAB, (n, LSTM_T + 1))
    eye = np.eye(LSTM_VOCAB, dtype=np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]]


NETS = {"mlp": (ex27_conf, ex27_data), "lstm": (lstm_conf, lstm_data)}


def net_pair(kind, seed=1):
    """(reference network, port network with its weights)."""
    conf = NETS[kind][0]
    ref = jax_init(RMLN, conf(REF) if kind == "lstm" else ex27_conf(REF, seed))
    port = PMLN(conf(PORT) if kind == "lstm" else ex27_conf(PORT, seed), device="cpu").init()
    return ref, load_reference_params(port, to_np(ref.params))


def assert_params_close(port, ref_params, what):
    got_params = export_params(port)
    keyed = got_params.items() if isinstance(got_params, dict) else enumerate(got_params)
    for k, named in keyed:
        for n, got in named.items():
            want = np.asarray(ref_params[k][n])
            scale = max(float(np.abs(want).max()), 1e-30)
            assert np.abs(np.asarray(got) - want).max() <= TOL * scale, (what, k, n)


# ------------------------------------------------------------------ gate
@functools.lru_cache(maxsize=None)
def gate_readings(pkg_name):
    ref, port = net_pair("mlp", seed=1)
    ref2, port2 = net_pair("mlp", seed=2)
    k = REF if pkg_name == "reference" else PORT
    nets = (ref, ref2) if pkg_name == "reference" else (port, port2)
    eval_set = k["DataSet"](*ex27_data(np.random.default_rng(43), 64))
    out = {}
    for metric in ("loss", "accuracy"):
        gate = k["P"].EvalGate(eval_set, metric=metric, rel_margin=0.02, batch_size=16)
        out[metric] = (gate.measure(nets[0]), gate.evaluate(nets[1], nets[0]).to_dict())
    return out


@pytest.mark.parametrize("metric", ["loss", "accuracy"])
def test_gate_measures_as_the_reference(metric):
    (pm, pres), (rm, rres) = gate_readings("port")[metric], gate_readings("reference")[metric]
    assert abs(pm - rm) <= TOL * max(1.0, abs(rm))
    for key in ("candidate", "baseline", "threshold"):
        assert abs(pres[key] - rres[key]) <= TOL * max(1.0, abs(rres[key])), key
    assert pres["passed"] == rres["passed"] and pres["metric"] == rres["metric"]


# ------------------------------------------------------------------ trainer
@functools.lru_cache(maxsize=None)
def mini_epochs(kind):
    """Two mini-epochs of ContinuousTrainer in both packages from the
    same weights over the same stream items: (port net, reference params,
    both packages' stats)."""
    ref, port = net_pair(kind)
    rng = np.random.default_rng(5)
    items = [NETS[kind][1](rng, 8) for _ in range(4)]
    stats = {}
    for name, k, net in (("reference", REF, ref), ("port", PORT, port)):
        buf = k["P"].StreamBuffer()
        for x, y in items[:2]:
            buf.put(k["DataSet"](x, y))
        for x, y in items[2:]:
            buf.put((x, y))  # tuples rebatched like DataSets
        trainer = k["P"].ContinuousTrainer(net, buf, batch_size=8,
                                           batches_per_mini_epoch=2, take_timeout_s=1.0)
        stats[name] = [trainer.train_mini_epoch() for _ in range(2)]
        with pytest.raises(k["P"].StreamStuck):
            k["P"].ContinuousTrainer(net, buf, take_timeout_s=0.01).train_mini_epoch()
    return port, to_np(ref.params), stats


@pytest.mark.parametrize("kind", ["mlp", "lstm"])
def test_two_mini_epochs_match_the_reference(kind):
    port, ref_params, stats = mini_epochs(kind)
    assert_params_close(port, ref_params, kind)
    for p, r in zip(stats["port"], stats["reference"]):
        assert (p["examples"], p["batches"], p["mini_epoch"]) == (
            r["examples"], r["batches"], r["mini_epoch"])
        assert abs(p["score"] - r["score"]) <= TOL * max(1.0, abs(r["score"]))


def test_stream_buffer_blocks_and_closes_as_the_reference():
    def run(k):
        buf = k["P"].StreamBuffer(capacity=2)
        buf.put(1)
        buf.put(2)
        t = threading.Thread(target=buf.put, args=(3,))
        t.start()
        first = buf.take(1, timeout_s=1)
        t.join(5)
        got = (first, buf.take(5, timeout_s=0.01), buf.take(5, timeout_s=0.01), len(buf))
        buf.close()
        with pytest.raises(RuntimeError) as e:
            buf.put(4)
        return got, buf.total_in, str(e.value)

    assert run(PORT) == run(REF)


# ------------------------------------------------------------------ canary
def canary_run(k, mode):
    """Two versions of the MLP pair behind one registry; a controller over
    the config's schedule on a manual clock, 4 requests a tick."""
    ref1, port1 = net_pair("mlp", seed=1)
    ref2, port2 = net_pair("mlp", seed=2)
    nets = (ref1, ref2) if k is REF else (port1, port2)
    reg = k["Registry"](wait_ms=0.5, warmup="off")
    try:
        reg.register("m", model=nets[0])
        reg.register("m", model=nets[1], activate=False)
        clock = k["Clock"](0)
        x = ex27_data(np.random.default_rng(9), 2)[0]
        events = []

        class Alerts:
            def firing(self):
                return ["burn"] if clock.current_time_millis() >= 12000 else []

        ctl = k["P"].CanaryController(
            reg, "m", 2, schedule=json.load(open(CONFIG))["canary"]["schedule"],
            time_source=clock, shadow_sample=0.5, divergence_threshold=1.0,
            alerts=Alerts() if mode == "alert" else None,
            on_event=lambda kind, detail: events.append((kind, detail)))
        ctl.start()
        served = []
        for tick in range(12):
            served += [reg.predict_versioned("m", x)[1] for _ in range(4)]
            if mode == "alarm" and tick == 1:
                ctl.report_alarm("operator stop")
            clock.advance(seconds=3)
            if ctl.tick() is not None:
                break
        return (served, events, ctl.decision, ctl.reason, ctl.shadow_final,
                reg.get_traffic_split("m"), reg.shadow_state("m"))
    finally:
        reg.shutdown()


@functools.lru_cache(maxsize=None)
def reference_canary(mode):
    return canary_run(REF, mode)


@pytest.mark.parametrize("mode", ["promote", "alarm", "alert"])
def test_canary_picks_and_decides_as_the_reference(mode):
    port, ref = canary_run(PORT, mode), reference_canary(mode)
    assert port == ref
    assert port[2] == ("promote" if mode == "promote" else "rollback")
    assert 2 in port[0] and 1 in port[0]


def test_canary_schedule_errors_as_the_reference():
    for spec in ([], [{"fraction": 0.5, "hold_s": 1}, {"fraction": 0.25, "hold_s": 1}],
                 [{"fraction": 1.5, "hold_s": 1}], [{"fraction": 0.5, "hold_s": -1}]):
        with pytest.raises(ValueError) as p:
            P.parse_schedule(spec)
        with pytest.raises(ValueError) as r:
            R.parse_schedule(spec)
        assert str(p.value) == str(r.value)


# ------------------------------------------------------------------ cycles
E2E_CONFIG = json.load(open(CONFIG))


def cycles_run(k, state_dir):
    """Example 27's promote cycle and its garbage-stream rollback cycle."""
    ref, port = net_pair("mlp", seed=1)
    baseline = ref if k is REF else port
    metrics, clock = k["Metrics"](), k["Clock"](0)
    reg = k["Registry"](metrics=metrics, wait_ms=0.5, warmup="off")
    eval_x, eval_y = ex27_data(np.random.default_rng(43), 64)
    eval_set = k["DataSet"](eval_x, eval_y)
    summaries = []
    try:
        reg.register("model", model=baseline)
        for garbage in (False, True):
            rng = np.random.default_rng(11 + garbage)
            buffer = k["P"].StreamBuffer()
            for _ in range(6):
                buffer.put(k["DataSet"](*ex27_data(rng, 16, garbage=garbage)))

            def wait(poll_s):
                for i in range(4):
                    reg.predict("model", eval_x[2 * i:2 * i + 2])
                clock.advance(seconds=6)

            pipe = k["P"].ContinuousPipeline(
                reg, "model", state_dir, config=k["P"].PipelineConfig.parse(CONFIG),
                buffer=buffer, eval_set=eval_set, metrics=metrics, time_source=clock,
                sample_input=eval_x[:1], canary_wait=wait)
            summaries.append(pipe.run_cycle())
        records = k["P"].PipelineJournal(state_dir).records()
    finally:
        reg.shutdown()
    return summaries, records


@functools.lru_cache(maxsize=None)
def reference_cycles(state_dir):
    return cycles_run(REF, state_dir)


def flatten(d, prefix=""):
    out = {}
    for key, v in d.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{key}."))
        else:
            out[prefix + key] = v
    return out


def test_example_27_cycles_journal_as_the_reference(tmp_path_factory):
    port_sum, port_recs = cycles_run(PORT, str(tmp_path_factory.mktemp("port")))
    ref_sum, ref_recs = reference_cycles(str(tmp_path_factory.mktemp("reference")))
    assert [s["outcome"] for s in port_sum] == ["PROMOTE", "ROLLBACK"]
    assert [(s["run"], s["outcome"], s["live_version"]) for s in port_sum] == [
        (s["run"], s["outcome"], s["live_version"]) for s in ref_sum]
    port_recs, ref_recs = masked(port_recs), masked(ref_recs)
    assert len(port_recs) == len(ref_recs)
    for p, r in zip(port_recs, ref_recs):
        pd, rd = flatten(p.pop("data")), flatten(r.pop("data"))
        assert p == r
        assert set(pd) == set(rd), (p, set(pd) ^ set(rd))
        for key, want in rd.items():
            got = pd[key]
            if key.endswith("candidate_path"):
                assert (got is None) == (want is None)
            elif isinstance(want, float):
                assert abs(got - want) <= TOL * max(1.0, abs(want)), (p, key)
            elif key != "detail":  # the gate's text prints its floats
                assert got == want, (p, key)


# ------------------------------------------------------------------ config
BAD_SPECS = [{"nope": 1}, {"train": {"batch_size": 0}}, {"gate": {"metric": "vibes"}},
             {"canary": {"schedule": []}}, {"canary": {"shadow_sample": 2}}, {"cycles": 0},
             {"train": {"watchdog": "explode"}}, {"name": ""}, {"train": {"bogus": 1}},
             {"gate": {"rel_margin": -1}}, {"canary": {"max_divergences": -1}},
             {"canary": {"abort_on_alerts": "all"}}, {"canary": {"poll_s": 0}},
             {"canary": {"schedule": [{"fraction": 0.5}]}}, [1, 2],
             {"train": {"take_timeout_s": 0}}, {"canary": {"divergence_threshold": -1}}]


@pytest.mark.parametrize("i", range(len(BAD_SPECS)))
def test_config_errors_carry_the_reference_s_messages(i):
    spec = BAD_SPECS[i]
    with pytest.raises(ValueError) as p:
        P.PipelineConfig.parse(copy.deepcopy(spec))
    with pytest.raises(ValueError) as r:
        R.PipelineConfig.parse(copy.deepcopy(spec))
    assert str(p.value) == str(r.value)


LINT_SPECS = [CONFIG, {}, {"canary": {"shadow_sample": 0, "max_divergences": 3}},
              {"canary": {"schedule": [{"fraction": 0.5, "hold_s": 0}]}},
              {"train": {"watchdog": "off"}}, json.dumps({"name": "x", "cycles": 3})]


@pytest.mark.parametrize("i", range(len(LINT_SPECS)))
def test_config_parse_and_lint_as_the_reference(i):
    p, r = P.PipelineConfig.parse(LINT_SPECS[i]), R.PipelineConfig.parse(LINT_SPECS[i])
    assert vars(p) == vars(r) and p.lint() == r.lint()


# ------------------------------------------------------------------ the CLI
def test_port_cli_killed_mid_canary_resumes_to_one_promote(tmp_path):
    from deeplearning4j_tpu_torch.util import model_serializer

    rng = np.random.default_rng(5)
    net = PMLN(ex27_conf(PORT), device="cpu").init()
    net.fit(PDataSet(*ex27_data(rng, 128)), epochs=3)
    model_path, data_path = str(tmp_path / "model.zip"), str(tmp_path / "data.npz")
    model_serializer.write_model(net, model_path)
    x, y = ex27_data(rng, 160)
    np.savez(data_path, features=x, labels=y)
    config = copy.deepcopy(E2E_CONFIG)
    config["train"]["take_timeout_s"] = 0.3
    config["canary"]["schedule"] = [{"fraction": 0.25, "hold_s": 0.2},
                                    {"fraction": 0.5, "hold_s": 0.2}]
    config_path, state = str(tmp_path / "pipeline.json"), str(tmp_path / "state")
    json.dump(config, open(config_path, "w"))
    # journal seq 8 is the canary's first ramp note
    plan = json.dumps({"faults": [{"type": "kill", "worker": "pipeline", "step": 8}]})
    argv = [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "pipeline",
            "--modelPath", model_path, "--dataPath", data_path, "--config", config_path,
            "--state-dir", state, "--cycles", "1", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    env.pop("DL4J_TPU_FAULT_PLAN", None)
    first = subprocess.run(argv, env=dict(env, DL4J_TPU_FAULT_PLAN=plan), timeout=300,
                           capture_output=True, text=True)
    assert first.returncode == -9, (first.returncode, first.stderr[-2000:])
    mid = P.PipelineJournal(state).records()
    assert any((r.get("stage"), r.get("event")) == ("CANARY", "enter") for r in mid)
    assert not any(r.get("stage") in ("PROMOTE", "ROLLBACK") for r in mid)
    second = subprocess.run(argv, env=env, timeout=300, capture_output=True, text=True)
    assert second.returncode == 0, (second.stdout[-2000:], second.stderr[-2000:])
    assert "run 1: PROMOTE" in second.stdout
    final = P.PipelineJournal(state).records()
    assert [(r["run"], r["stage"]) for r in final if r.get("event") == "commit"
            and r.get("stage") in ("PROMOTE", "ROLLBACK")] == [(1, "PROMOTE")]
    # the resumed process re-ramped the canary it died in: step 0 twice
    assert sum(r.get("message") == "canary ramp" and r["data"]["step"] == 0
               for r in final) == 2
