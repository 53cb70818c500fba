"""The port's training listeners on the CPU against the JAX package's.

One small classifier (dense 6 tanh, softmax 3, Adam(0.05)) built by both
packages with the JAX network's weights carried across takes the same
three steps, one batch a ``fit`` (three iterations, three epochs), with
each listener attached to both. Printed and collected values (scores,
parameter and gradient statistics) within 1e-6 relative; the texts around
them, the iteration numbers, the CSV's layout, the checkpoint file names,
their rotation and the evaluation counts equal; a checkpoint reloaded
equal to the parameters it saved, in either package. The throughput and
ETA listeners' times are the host's and not compared, only their form.
"""

import functools
import json
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.eval.calibration import EvaluationCalibration as JCal
from deeplearning4j_tpu.eval.roc import ROCMultiClass as JROC
from deeplearning4j_tpu.optimize import listeners as jl
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.eval.calibration import EvaluationCalibration
from deeplearning4j_tpu_torch.eval.roc import ROCMultiClass
from deeplearning4j_tpu_torch.optimize import listeners as tl
from deeplearning4j_tpu_torch.util.convert import load_reference_params
from test_torch_conv_family import to_np
from test_torch_earlystopping import PORT, clf_conf, data, iters, pair

TOL = 1e-6
FLOAT = re.compile(r"-?\d+\.\d+(?:e[-+]\d+)?|nan|inf")


def batches():
    x, y = data(n=24, seed=4)
    return [(x[i:i + 8], y[i:i + 8]) for i in range(0, 24, 8)]


@functools.lru_cache(maxsize=None)
def _reference():
    """One JAX network, its initial parameters and updater state: each
    run resets it rather than building (and compiling) another."""
    j, _ = pair(clf_conf)
    return j, to_np(j.params), to_np(j.updater_states)


def fresh_pair():
    """(JAX network, port network), both at the same initial weights, at
    iteration 0 with zero updater state."""
    j, params, upd = _reference()
    j.params = jax.tree_util.tree_map(jnp.asarray, params)
    j.updater_states = jax.tree_util.tree_map(jnp.asarray, upd)
    j.iteration, j.epoch = 0, 0
    t = load_reference_params(PORT.mln(clf_conf(PORT)).init(), params)
    return j, t


def run(listener_pair):
    """Three one-batch fits of each package's network with its listener;
    returns the networks."""
    j, t = fresh_pair()
    j.set_listeners(listener_pair[0])
    t.set_listeners(listener_pair[1])
    for x, y in batches():
        j.fit(JDataSet(x, y))
        t.fit(DataSet(x, y))
    return j, t


def floats(text):
    return [float(v) for v in FLOAT.findall(text)]


def same_text(got, want):
    """Equal texts but for their decimal numbers, which agree within TOL,
    and an object's repr (its package and address; the class name stays)."""
    obj = re.compile(r"<[\w.]*?(\w+) object at 0x[0-9a-f]+>")
    got, want = obj.sub(r"<\1>", got), obj.sub(r"<\1>", want)
    assert FLOAT.sub("#", got) == FLOAT.sub("#", want), (got, want)
    np.testing.assert_allclose(floats(got), floats(want), rtol=TOL, atol=1e-12)


def printers():
    return [], []


def test_score_iteration_listener():
    got, want = printers()
    run((jl.ScoreIterationListener(1, printer=want.append),
         tl.ScoreIterationListener(1, printer=got.append)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        same_text(g, w)
    assert got[0].startswith("Score at iteration 1 is ")


def test_performance_and_time_listeners_report_in_the_reference_form():
    got, want = printers()
    run((jl.ComposableIterationListener(
            jl.PerformanceListener(1, report_score=True, printer=want.append),
            jl.TimeIterationListener(3, frequency=1, printer=want.append)),
         tl.ComposableIterationListener([
             tl.PerformanceListener(1, report_score=True, printer=got.append),
             tl.TimeIterationListener(3, frequency=1, printer=got.append)])))
    shape = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]\d+)?")
    assert [shape.sub("#", g) for g in got] == [shape.sub("#", w) for w in want]
    perf = [g for g in got if "batches/sec" in g]
    assert len(perf) == 2
    for g, w in zip(perf, [w for w in want if "batches/sec" in w]):
        assert float(g.rsplit("score ", 1)[1]) == pytest.approx(
            float(w.rsplit("score ", 1)[1]), rel=TOL)
    assert got[-1].startswith("iteration 3/3; ETA ")


def test_collect_scores_and_the_csv(tmp_path):
    jc, tc = jl.CollectScoresIterationListener(), tl.CollectScoresIterationListener()
    run((jc, tc))
    assert [i for i, _ in tc.scores] == [i for i, _ in jc.scores] == [1, 2, 3]
    np.testing.assert_allclose([s for _, s in tc.scores], [s for _, s in jc.scores],
                               rtol=TOL)
    jc.export_scores(tmp_path / "j.csv", ";")
    tc.export_scores(tmp_path / "t.csv", ";")
    jt = (tmp_path / "j.csv").read_text().splitlines()
    tt = (tmp_path / "t.csv").read_text().splitlines()
    assert tt[0] == jt[0] == "iteration;score" and len(tt) == len(jt) == 4
    for g, w in zip(tt[1:], jt[1:]):
        gi, gs = g.split(";")
        wi, ws = w.split(";")
        assert gi == wi and float(gs) == pytest.approx(float(ws), rel=TOL)


@pytest.mark.parametrize("mode", ["default", "evaluations", "iteration"])
def test_evaluative_listener_and_its_callback(mode):
    x, y = data(n=16, seed=9)
    jit, tit = iters(x, y)
    kw = {}
    if mode == "evaluations":
        kw = dict(evaluations=[JROC, JCal]), dict(evaluations=[ROCMultiClass,
                                                               EvaluationCalibration])
    elif mode == "iteration":
        kw = dict(unit="iteration", frequency=2), dict(unit="iteration", frequency=2)
    else:
        kw = {}, {}
    got, want = printers()
    je = jl.EvaluativeListener(jit, printer=want.append, **kw[0])
    te = tl.EvaluativeListener(tit, printer=got.append, **kw[1])
    seen = {"j": [], "t": []}
    je.set_callback(lambda lst, evs, m: seen["j"].append(len(evs)))
    te.set_callback(lambda lst, evs, m: seen["t"].append(len(evs)))
    run((je, te))
    assert seen["t"] == seen["j"] and len(seen["t"]) == {"default": 3, "evaluations": 3,
                                                         "iteration": 1}[mode]
    assert len(te.evaluations) == len(je.evaluations)
    for g, w in zip(got, want):
        same_text(g, w)
    if mode == "evaluations":
        for tevs, jevs in zip(te.evaluations, je.evaluations):
            for c in range(3):
                assert tevs[0]._single(c).calculate_auc() == pytest.approx(
                    jevs[0]._single(c).calculate_auc(), rel=TOL)


def test_param_and_gradient_listener():
    min_max = True
    x, y = data(n=8, seed=5)
    got, want = printers()
    run((jl.ParamAndGradientIterationListener(
            1, print_min_max=min_max, gradient_batch=JDataSet(x, y), printer=want.append),
         tl.ParamAndGradientIterationListener(
            1, print_min_max=min_max, gradient_batch=(x, y), printer=got.append)))
    assert len(got) == len(want) == 4  # the header and 3 rows
    assert got[0] == want[0]
    assert got[0].split("\t")[:4] == ["iteration", "score", "0_W_mean_mag",
                                      "0_W_min" if min_max else "0_b_mean_mag"]
    for g, w in zip(got[1:], want[1:]):
        gs, ws = g.split("\t"), w.split("\t")
        assert gs[0] == ws[0] and len(gs) == len(ws)
        np.testing.assert_allclose([float(v) for v in gs[1:]], [float(v) for v in ws[1:]],
                                   rtol=TOL, atol=1e-9)


def test_sleepy_listener_sleeps_as_the_reference():
    with mock.patch("time.sleep") as slept:
        run((jl.SleepyTrainingListener(2.0, 5.0), tl.SleepyTrainingListener(2.0, 5.0)))
    waits = [c.args[0] for c in slept.call_args_list]
    assert waits == [0.002, 0.005] * 6  # each package: 3 iterations, 3 epochs


def test_checkpoints_names_rotation_and_reload(tmp_path):
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jc = jl.CheckpointListener(jdir, save_every_n_iterations=1, keep_last=2, keep_every_n=2)
    tc = tl.CheckpointListener(tdir, save_every_n_iterations=1, keep_last=2, keep_every_n=2)
    saved = []

    class Snapshot:
        def iteration_done(self, model, iteration, epoch):
            saved.append({k: {n: v.clone() for n, v in named.items()}
                          for k, named in model.params.items()})

    j, t = fresh_pair()
    j.set_listeners(jc)
    t.set_listeners(tc, Snapshot())
    for x, y in batches():
        j.fit(JDataSet(x, y))
        t.fit(DataSet(x, y))
    names = sorted(p.name for p in tdir.iterdir())
    # checkpoint 1 rotated out (keep_last 2; 1 is not a multiple of 2)
    assert names == sorted(p.name for p in jdir.iterdir()) == [
        "checkpoint_2_iter_2_epoch_1.zip", "checkpoint_3_iter_3_epoch_2.zip"]
    avail = tl.CheckpointListener.available_checkpoints(tdir)
    assert [(c["number"], c["iteration"], c["epoch"]) for c in avail] == [
        (c["number"], c["iteration"], c["epoch"])
        for c in jl.CheckpointListener.available_checkpoints(jdir)]
    assert tc.last_checkpoint().name == jc.last_checkpoint().name
    back = tl.CheckpointListener.load_checkpoint(tdir, 2, device="cpu")
    for k, named in saved[1].items():
        for n, v in named.items():
            assert torch.equal(back.params[k][n], v)
    assert tl.CheckpointListener.load_checkpoint(tdir, device="cpu").iteration == 3
    # the JAX package reads the port's checkpoint, the port the JAX package's
    ref = jl.CheckpointListener.load_checkpoint(tdir, 3)
    np.testing.assert_array_equal(np.asarray(ref.params[0]["W"]), saved[2][0]["W"].numpy())
    other = tl.CheckpointListener.load_checkpoint(jdir, 3, device="cpu")
    np.testing.assert_allclose(other.params[0]["W"].numpy(), np.asarray(j.params[0]["W"]),
                               rtol=0, atol=0)
    with pytest.raises(FileNotFoundError, match="no checkpoint number 1"):
        tl.CheckpointListener.load_checkpoint(tdir, 1, device="cpu")
    with pytest.raises(ValueError):
        tl.CheckpointListener(tdir)


def test_checkpoint_every_epoch_keeps_all(tmp_path):
    jc = jl.CheckpointListener(tmp_path / "j", save_every_n_epochs=2)
    tc = tl.CheckpointListener(tmp_path / "t", save_every_n_epochs=2)
    run((jc, tc))
    assert [p.name for p in tc._checkpoints()] == [p.name for p in jc._checkpoints()] == [
        "checkpoint_1_iter_2_epoch_2.zip"]


def test_profiler_listener_writes_a_chrome_trace(tmp_path):
    prof = tl.ProfilerListener(tmp_path / "prof", start_iteration=1, n_iterations=1)
    t = PORT.mln(clf_conf(PORT)).init()
    t.set_listeners(prof)
    for x, y in batches():
        t.fit(DataSet(x, y))
    assert prof.last_error is None and prof.trace_path is not None
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("addmm" in e.get("name", "") or "mm" in e.get("name", "") for e in events)
    prof.reset()
    assert not prof._done
    prof.close(t)  # nothing open: nothing happens
