"""Early stopping in the port on the CPU against the JAX package.

Every termination condition on the same score sequences (its verdicts
equal); every score calculator on networks built by both packages with
the JAX network's weights carried across (float32; each score within
1e-6 relative, classification metrics equal), the VAE's
reconstruction-probability draws handed to both packages
(``tests/torch_putin.py``); the savers (an in-memory clone that training
leaves alone, the zips that either package reads); ``EarlyStoppingTrainer``
on a float64 ``MultiLayerNetwork`` and ``ComputationGraph`` (the JAX side
under ``jax.enable_x64``): reason, details, best epoch and epoch count
equal, every held-out score within 1e-9 relative; the
``EarlyStoppingListener`` hook sequence equal; and the parallel trainer's
refusal.
"""

import functools
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JListIt
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import vae_distributions as JD
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.optimize import earlystopping as jes
from deeplearning4j_tpu.util import model_serializer as jms
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import vae_distributions as TD
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.optimize import earlystopping as tes
from deeplearning4j_tpu_torch.util.convert import export_params, load_reference_params
from test_torch_conv_family import jax_init, to_np
from torch_putin import PutIn

CALC_TOL, TRAIN_TOL = 1e-6, 1e-9
N_IN = 4


class Side:
    def __init__(self, nnc, it, layers, dists, adam, mln, graph, ds, list_it, es):
        self.nnc, self.it, self.L, self.D, self.adam = nnc, it, layers, dists, adam
        self.mln, self.graph, self.ds, self.list_it, self.es = mln, graph, ds, list_it, es


REF = Side(JNNC, JIT, JL, JD, JAdam, JMLN, JGraph, JDataSet, JListIt, jes)
PORT = Side(NeuralNetConfiguration, InputType, L, TD, Adam,
            lambda c: MultiLayerNetwork(c, device="cpu"),
            lambda c: ComputationGraph(c, device="cpu"), DataSet, ListDataSetIterator, tes)


# ------------------------------------------------------------- networks
def clf_conf(s, kind="mln", n_out=3, dtype="float32", lr=0.05, loss="mcxent",
             activation="softmax"):
    b = s.nnc.builder().seed(5).dtype(dtype).updater(s.adam(lr))
    dense = s.L.DenseLayer(n_out=6, activation="tanh")
    out = s.L.OutputLayer(n_out=n_out, activation=activation, loss=loss)
    if kind == "mln":
        return (b.list().layer(dense).layer(out)
                .set_input_type(s.it.feed_forward(N_IN)).build())
    return (b.graph_builder().add_inputs("in").set_input_types(s.it.feed_forward(N_IN))
            .add_layer("dense", dense, "in").add_layer("out", out, "dense")
            .set_outputs("out").build())


def ae_vae_conf(s, kind="mln", vae_dist=None):
    """Autoencoder → VAE → softmax output (the VAE's distribution a
    Bernoulli, or ``vae_dist``)."""
    ae = s.L.AutoEncoderLayer(n_out=5, corruption_level=0.25)
    kw = {} if vae_dist is None else {"reconstruction_distribution": vae_dist}
    vae = s.L.VariationalAutoencoderLayer(n_out=3, encoder_layer_sizes=(4,),
                                          decoder_layer_sizes=(4,), **kw)
    return (s.nnc.builder().seed(3).updater(s.adam(1e-2)).list()
            .layer(ae).layer(vae)
            .layer(s.L.OutputLayer(n_out=3, loss="mcxent", activation="softmax"))
            .set_input_type(s.it.feed_forward(N_IN)).build())


def reg_conf(s, kind="mln"):
    return clf_conf(s, kind, n_out=2, loss="mse", activation="identity")


def binary_conf(s, kind="mln"):
    return clf_conf(s, kind, n_out=2)


def sigmoid_conf(s, kind="mln"):
    return clf_conf(s, kind, activation="sigmoid", loss="xent")


def vae_loss_conf(s, kind="mln"):
    return ae_vae_conf(s, kind, s.D.LossFunctionWrapper(loss="mse"))


@functools.lru_cache(maxsize=None)
def scoring_pair(conf_fn, kind="mln"):
    """:func:`pair`, made once for the calculators, which only read the
    networks (the JAX network's compiled forward is reused)."""
    return pair(conf_fn, kind)


def pair(conf_fn, kind="mln"):
    """(JAX network, port network with its weights)."""
    j = jax_init(REF.mln if kind == "mln" else REF.graph, conf_fn(REF, kind))
    t = (PORT.mln if kind == "mln" else PORT.graph)(conf_fn(PORT, kind)).init()
    return j, load_reference_params(t, to_np(j.params))


def data(n=24, n_out=3, seed=0, dtype=np.float32, regression=False, unit=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, N_IN))
    if unit:
        x = rng.random((n, N_IN))
    if regression:
        y = x[:, :n_out] * 0.5 + 0.1 * rng.normal(size=(n, n_out))
    else:
        idx = rng.integers(0, n_out, n)
        x[np.arange(n), idx % N_IN] += 1.5
        y = np.eye(n_out)[idx]
    return x.astype(dtype), y.astype(dtype)


def iters(x, y, batch=8):
    return (REF.list_it(REF.ds(x, y), batch), PORT.list_it(PORT.ds(x, y), batch))


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


# ---------------------------------------------------------- calculators
CALCULATORS = {
    "loss_average": (lambda s, it: s.es.DataSetLossCalculator(it), clf_conf, {}),
    "loss_total": (lambda s, it: s.es.DataSetLossCalculator(it, average=False), clf_conf, {}),
    "accuracy": (lambda s, it: s.es.ClassificationScoreCalculator(it), clf_conf, {}),
    "f1": (lambda s, it: s.es.ClassificationScoreCalculator(it, "f1"), clf_conf, {}),
    "mcc": (lambda s, it: s.es.ClassificationScoreCalculator(it, "MCC"), clf_conf, {}),
    "regression_mse": (lambda s, it: s.es.RegressionScoreCalculator(it),
                       reg_conf,
                       {"regression": True, "n_out": 2}),
    "regression_r2": (lambda s, it: s.es.RegressionScoreCalculator(it, "R2"),
                      reg_conf,
                      {"regression": True, "n_out": 2}),
    "roc": (lambda s, it: s.es.ROCScoreCalculator(it),
            binary_conf, {"n_out": 2}),
    "roc_multiclass_auprc": (lambda s, it: s.es.ROCScoreCalculator(it, "multiclass", "auprc"),
                             clf_conf, {}),
    "roc_binary": (lambda s, it: s.es.ROCScoreCalculator(it, "binary"),
                   sigmoid_conf, {}),
    "autoencoder_mse": (lambda s, it: s.es.AutoencoderScoreCalculator(it, 0),
                        ae_vae_conf, {"unit": True}),
    "autoencoder_mae": (lambda s, it: s.es.AutoencoderScoreCalculator(it, 0, "mae"),
                        ae_vae_conf, {"unit": True}),
    "vae_recon_error": (lambda s, it: s.es.VAEReconErrorScoreCalculator(it, 1),
                        vae_loss_conf,
                        {"unit": True}),
}


LAYER_CALCULATORS = ("autoencoder_mse", "autoencoder_mae", "vae_recon_error")
CALCULATOR_CASES = [(name, kind) for name in sorted(CALCULATORS)
                    for kind in (("mln",) if name in LAYER_CALCULATORS else ("mln", "graph"))]


@pytest.mark.parametrize("name,kind", CALCULATOR_CASES)
def test_score_calculator_matches_the_reference(name, kind):
    make, conf_fn, data_kw = CALCULATORS[name]
    j, t = scoring_pair(conf_fn, kind)
    x, y = data(**data_kw)
    jit, tit = iters(x, y)
    want = make(REF, jit).calculate_score(j)
    got = make(PORT, tit).calculate_score(t)
    assert rel(got, want) <= CALC_TOL, (got, want)


def _ae_graph_conf(s, kind="graph"):
    return (s.nnc.builder().seed(3).updater(s.adam(1e-2)).graph_builder()
            .add_inputs("in").set_input_types(s.it.feed_forward(N_IN))
            .add_layer("dense", s.L.DenseLayer(n_out=6, activation="tanh"), "in")
            .add_layer("ae", s.L.AutoEncoderLayer(n_out=5), "dense")
            .add_layer("out", s.L.OutputLayer(n_out=3, loss="mcxent",
                                              activation="softmax"), "ae")
            .set_outputs("out").build())


def test_layer_calculators_on_a_graph_vertex():
    j, t = pair(_ae_graph_conf, "graph")
    x, y = data(unit=True)
    jit, tit = iters(x, y)
    want = jes.AutoencoderScoreCalculator(jit, "ae").calculate_score(j)
    got = tes.AutoencoderScoreCalculator(tit, "ae").calculate_score(t)
    assert rel(got, want) <= CALC_TOL


@pytest.mark.parametrize("log_prob", [True, False])
def test_vae_reconstruction_probability_with_handed_draws(monkeypatch, log_prob):
    j, t = scoring_pair(ae_vae_conf)
    x, y = data(unit=True)
    jit, tit = iters(x, y)
    put = PutIn(monkeypatch)
    want = jes.VAEReconProbScoreCalculator(jit, 1, num_samples=2,
                                           log_prob=log_prob).calculate_score(j)
    got = tes.VAEReconProbScoreCalculator(tit, 1, num_samples=2,
                                          log_prob=log_prob).calculate_score(t)
    assert len(put.drawn) == 6 and put.port_calls == 6  # 3 batches x 2 samples
    assert rel(got, want) <= CALC_TOL


def test_calculators_refuse_as_the_reference():
    for es in (jes, tes):
        with pytest.raises(ValueError, match="roc_type"):
            es.ROCScoreCalculator([], roc_type="pr")
        with pytest.raises(ValueError, match="metric"):
            es.ROCScoreCalculator([], metric="f1")
        assert np.isnan(es.DataSetLossCalculator([]).calculate_score(None))


# ----------------------------------------------------------- conditions
SCORES = [1.0, 0.8, 0.85, 0.79, float("nan"), 0.9, 0.95, 0.7, float("inf"), 0.2]


def _epoch_conditions(es):
    return [es.MaxEpochsTerminationCondition(4),
            es.ScoreImprovementEpochTerminationCondition(2),
            es.ScoreImprovementEpochTerminationCondition(1, min_improvement=0.05),
            es.BestScoreEpochTerminationCondition(0.75)]


def _iteration_conditions(es):
    return [es.InvalidScoreIterationTerminationCondition(),
            es.MaxScoreIterationTerminationCondition(0.9)]


@pytest.mark.parametrize("i", range(4))
def test_epoch_conditions_decide_as_the_reference(i):
    verdicts = []
    for es in (jes, tes):
        c = _epoch_conditions(es)[i]
        c.initialize()
        verdicts.append([c.terminate(e, s) for e, s in enumerate(SCORES)])
        c.initialize()  # a new fit starts afresh
        verdicts.append([c.terminate(e, s) for e, s in enumerate(SCORES)])
    assert verdicts[0] == verdicts[1] == verdicts[2] == verdicts[3]


@pytest.mark.parametrize("i", range(2))
def test_iteration_conditions_decide_as_the_reference(i):
    got = [[_iteration_conditions(es)[i].terminate(s) for s in SCORES]
           for es in (jes, tes)]
    assert got[0] == got[1]


def test_max_time_condition_reads_the_clock_as_the_reference():
    got = []
    for es in (jes, tes):
        clock = iter([0.0, 1.0, 1.99, 2.0])
        with mock.patch("time.monotonic", lambda: next(clock)):
            c = es.MaxTimeIterationTerminationCondition(2.0)
            got.append([c.terminate(0.0) for _ in range(3)])
    assert got[0] == got[1] == [False, False, True]


# --------------------------------------------------------------- savers
def test_in_memory_saver_keeps_a_clone_training_leaves_alone():
    _, t = pair(clf_conf)
    x, y = data()
    saver = tes.InMemoryModelSaver()
    saver.save_best_model(t, 0.5)
    saver.save_latest_model(t, 0.5)
    t.fit(x, y)
    best = saver.get_best_model()
    assert best is not t and saver.get_latest_model() is not t
    assert not torch.equal(best.params[0]["W"], t.params[0]["W"])
    assert best.params[0]["W"].device == t.params[0]["W"].device
    assert tes.InMemoryModelSaver().get_best_model() is None


def test_local_file_saver_zips_read_both_ways(tmp_path):
    _, t = pair(clf_conf)
    x, y = data()
    saver = tes.LocalFileModelSaver(tmp_path / "es")
    assert saver.get_best_model() is None and saver.get_latest_model() is None
    saver.save_best_model(t, 0.3)
    t.fit(x, y)
    saver.save_latest_model(t, 0.2)
    assert sorted(p.name for p in (tmp_path / "es").iterdir()) == [
        "bestModel.zip", "latestModel.zip"]
    latest = saver.get_latest_model()
    assert latest.device.type == "cpu"
    for k, named in t.params.items():
        for n, v in named.items():
            assert torch.equal(latest.params[k][n], v)
    ref = jms.restore_model(tmp_path / "es" / "bestModel.zip")
    best = saver.get_best_model()
    np.testing.assert_array_equal(np.asarray(ref.params[0]["W"]),
                                  best.params[0]["W"].numpy())
    # a saver that wrote nothing reads on the device it was given
    assert tes.LocalFileModelSaver(tmp_path / "es", device="cpu").get_best_model() is not None


# -------------------------------------------------------------- trainer
class Recorder:
    def __init__(self):
        self.calls = []

    def on_start(self, config, model):
        self.calls.append(("start",))

    def on_epoch(self, epoch, score, config, model):
        self.calls.append(("epoch", epoch, score))

    def on_completion(self, result):
        self.calls.append(("done", result.termination_reason, result.total_epochs))


TRAINER_CASES = {
    # held-out loss stops improving by 0.02 an epoch: a ScoreImprovement stop
    "improvement": dict(epochs=lambda es: [es.MaxEpochsTerminationCondition(12),
                                           es.ScoreImprovementEpochTerminationCondition(
                                               1, min_improvement=0.02)],
                        iterations=lambda es: [], every=1),
    # the first epoch's last training score (1.016) is above 0.95: an
    # iteration stop before any evaluation
    "iteration": dict(epochs=lambda es: [es.MaxEpochsTerminationCondition(12)],
                      iterations=lambda es: [
                          es.InvalidScoreIterationTerminationCondition(),
                          es.MaxScoreIterationTerminationCondition(0.95)],
                      every=2),
    "max_epochs": dict(epochs=lambda es: [es.MaxEpochsTerminationCondition(5)],
                       iterations=lambda es: [es.InvalidScoreIterationTerminationCondition()],
                       every=2, save_last=True),
}


def _train(s, net, case, saver_dir=None):
    c = TRAINER_CASES[case]
    x, y = data(n=32, dtype=np.float64, seed=1)
    hx, hy = data(n=16, dtype=np.float64, seed=2)
    cfg = s.es.EarlyStoppingConfiguration(
        score_calculator=s.es.DataSetLossCalculator(s.list_it(s.ds(hx, hy), 8)),
        epoch_termination_conditions=c["epochs"](s.es),
        iteration_termination_conditions=c["iterations"](s.es),
        evaluate_every_n_epochs=c["every"], save_last_model=c.get("save_last", False),
        model_saver=None if saver_dir is None else s.es.LocalFileModelSaver(saver_dir))
    trainer = s.es.EarlyStoppingTrainer(cfg, net, s.list_it(s.ds(x, y), 8))
    rec = Recorder()
    trainer.set_listener(rec)
    return trainer.fit(), rec.calls


@functools.lru_cache(maxsize=None)
def _reference_run(case, kind):
    # x64 for every thread: the JAX package's fit moves each batch to the
    # device from its prefetch thread, where a thread-local
    # ``jax.enable_x64`` would not reach (the batch would arrive in f32)
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        j = jax_init(REF.mln if kind == "mln" else REF.graph,
                     clf_conf(REF, kind, dtype="float64", lr=0.1))
        init = to_np(j.params)
        result, calls = _train(REF, j, case)
        best = to_np(result.best_model.params)
    finally:
        jax.config.update("jax_enable_x64", before)
    return init, result, calls, best


@pytest.mark.parametrize("kind", ["mln", "graph"])
@pytest.mark.parametrize("case", sorted(TRAINER_CASES))
def test_trainer_matches_the_reference_in_float64(case, kind, tmp_path):
    init, want, want_calls, want_best = _reference_run(case, kind)
    t = (PORT.mln if kind == "mln" else PORT.graph)(
        clf_conf(PORT, kind, dtype="float64", lr=0.1)).init()
    load_reference_params(t, init)
    got, calls = _train(PORT, t, case, tmp_path / "saved" if case == "max_epochs" else None)
    assert (got.termination_reason, got.termination_details, got.best_model_epoch,
            got.total_epochs) == (want.termination_reason, want.termination_details,
                                  want.best_model_epoch, want.total_epochs)
    assert sorted(got.score_vs_epoch) == sorted(want.score_vs_epoch)
    for e, v in want.score_vs_epoch.items():
        assert rel(got.score_vs_epoch[e], v) <= TRAIN_TOL
    if want.score_vs_epoch:
        assert rel(got.best_model_score, want.best_model_score) <= TRAIN_TOL
    else:  # no evaluation ran
        assert got.best_model_score == want.best_model_score == float("inf")
    # the listener hears the same hooks with the same scores
    assert [c[:2] for c in calls] == [c[:2] for c in want_calls]
    assert calls[-1] == want_calls[-1]
    for c, w in zip(calls, want_calls):
        if c[0] == "epoch":
            assert rel(c[2], w[2]) <= TRAIN_TOL
    best = export_params(got.best_model)
    items = best.items() if isinstance(best, dict) else enumerate(best)
    for k, named in items:
        for n, v in named.items():
            np.testing.assert_allclose(v, want_best[k][n], rtol=1e-7, atol=1e-9)
    if case == "max_epochs":
        assert got.best_model.device.type == "cpu"
        assert (tmp_path / "saved" / "latestModel.zip").exists()


def test_parallel_trainer_refuses_with_the_missing_module():
    """The parallel trainer refused while ``parallel/trainer.py`` was
    missing; now it trains through the ParallelWrapper. On a world of one
    CPU rank (``make_mesh`` opens it) its epochs, scores and parameters are
    EarlyStoppingTrainer's, the same step on DTensors of the mesh; the
    4-rank world against the reference is
    ``tests/test_torch_parallel_trainer.py``."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(3)
    x = rng.normal(size=(48, N_IN)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 48)]

    def run(trainer, net, **kw):
        cfg = tes.EarlyStoppingConfiguration(
            score_calculator=tes.DataSetLossCalculator(
                ListDataSetIterator(DataSet(x[32:], y[32:]), 8)),
            epoch_termination_conditions=[tes.MaxEpochsTerminationCondition(2)])
        return trainer(cfg, net, ListDataSetIterator(DataSet(x[:32], y[:32]), 8), **kw).fit()

    _, net = pair(clf_conf)
    twin = load_reference_params(PORT.mln(clf_conf(PORT)).init(), export_params(net))
    try:
        got = run(tes.EarlyStoppingParallelTrainer, net, mesh=make_mesh(device_type="cpu"))
    finally:
        dist.destroy_process_group()
    want = run(tes.EarlyStoppingTrainer, twin)
    assert got.total_epochs == want.total_epochs == 2
    assert got.score_vs_epoch == pytest.approx(want.score_vs_epoch, rel=TRAIN_TOL)
    for k, named in enumerate(export_params(net)):
        for n, v in named.items():
            np.testing.assert_allclose(v, export_params(twin)[k][n], rtol=1e-7, atol=1e-9)


def test_trainer_propagates_an_exception_from_an_epoch():
    class Boom(RuntimeError):
        pass

    class Net:
        score_ = 0.0

        def fit(self, iterator, epochs=1):
            raise Boom("diverged")

    cfg = tes.EarlyStoppingConfiguration(score_calculator=tes.DataSetLossCalculator([]))
    with pytest.raises(Boom):
        tes.EarlyStoppingTrainer(cfg, Net(), []).fit()
