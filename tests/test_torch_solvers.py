"""The port's full-batch solvers, ``Solver`` and hyperparameter search on the
CPU, against the JAX package's.

Every case of ``tests/test_solvers.py`` runs on the port's classes. Then
the two packages side by side: each optimizer on a float64 quadratic and on
Rosenbrock (the JAX package under ``jax.enable_x64``), score history and
result within 1e-10 relative (the same branches; only the order of float64
sums differs); ``Solver`` per algorithm on a small float64 classifier with
the JAX network's weights carried across, score history within 1e-9
relative and the same iteration count; the search spaces and searches,
the same trials for the same seed; the ``Solver``'s configuration fields,
their JSON equal both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.conf.network import MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize import hpo as jhpo
from deeplearning4j_tpu.optimize import solvers as js
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn import layers as PL
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.optimize import hpo
from deeplearning4j_tpu_torch.optimize.solvers import (
    BackTrackLineSearch,
    ConjugateGradient,
    LBFGS,
    LineGradientDescent,
    Solver,
    StochasticGradientDescent,
)
from deeplearning4j_tpu_torch.util.convert import load_reference_params

HIST_TOL, SOLVER_TOL = 1e-10, 1e-9
ALGOS = ["stochastic_gradient_descent", "line_gradient_descent",
         "conjugate_gradient", "lbfgs"]


def _quadratic(scales, dtype=torch.float32):
    """f(x) = 0.5 * sum(scales * x^2) — condition number = max/min scale."""
    s = torch.as_tensor(scales, dtype=dtype)

    def vag(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = 0.5 * torch.sum(s * x * x)
            (g,) = torch.autograd.grad(f, x)
        return f.detach(), g
    return vag


def _rosenbrock():
    def vag(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)
            (g,) = torch.autograd.grad(f, x)
        return f.detach(), g
    return vag


# ------------------------------------------- the reference's cases, ported
class TestBackTrackLineSearch:
    def test_full_step_when_sufficient(self):
        vag = _quadratic([1.0, 1.0])
        x = torch.tensor([1.0, -2.0])
        score, grad = vag(x)
        ls = BackTrackLineSearch(lambda p: vag(p)[0], max_iterations=5)
        step = ls.optimize(x, float(score), grad, grad)
        assert step > 0
        assert float(vag(x - step * grad)[0]) < float(score)

    def test_backtracks_on_overshoot(self):
        vag = _quadratic([100.0])
        x = torch.tensor([1.0])
        score, grad = vag(x)
        ls = BackTrackLineSearch(lambda p: vag(p)[0], max_iterations=10)
        step = ls.optimize(x, float(score), grad, grad)
        assert 0 < step < 1.0
        assert float(vag(x - step * grad)[0]) < float(score)

    def test_zero_for_ascent_direction(self):
        vag = _quadratic([1.0])
        x = torch.tensor([1.0])
        score, grad = vag(x)
        ls = BackTrackLineSearch(lambda p: vag(p)[0])
        assert ls.optimize(x, float(score), grad, -grad) == 0.0


class TestOptimizers:
    @pytest.mark.parametrize("cls", [LineGradientDescent, ConjugateGradient, LBFGS])
    def test_quadratic_convergence(self, cls):
        vag = _quadratic([1.0, 10.0, 100.0])
        opt = cls(max_iterations=200, line_search_iterations=10)
        x = opt.optimize(vag, torch.tensor([5.0, -3.0, 2.0]))
        assert float(vag(x)[0]) < 1e-4
        hist = opt.score_history
        assert all(b <= a + 1e-6 + 1e-6 * abs(a) for a, b in zip(hist, hist[1:]))

    def test_lbfgs_beats_gd_on_rosenbrock(self):
        def final(cls):
            opt = cls(max_iterations=80, line_search_iterations=15,
                      termination_conditions=[])
            return float(_rosenbrock()(opt.optimize(_rosenbrock(), torch.zeros(6)))[0])

        assert final(LBFGS) < final(LineGradientDescent) * 0.5

    def test_lbfgs_rosenbrock(self):
        opt = LBFGS(m=6, max_iterations=400, line_search_iterations=20,
                    termination_conditions=[])
        x = opt.optimize(_rosenbrock(), torch.zeros(4))
        assert float(_rosenbrock()(x)[0]) < 1e-3
        np.testing.assert_allclose(x.numpy(), np.ones(4), atol=0.05)

    def test_sgd_descends(self):
        vag = _quadratic([1.0, 2.0])
        opt = StochasticGradientDescent(learning_rate=0.1, max_iterations=50)
        assert float(vag(opt.optimize(vag, torch.tensor([4.0, 4.0])))[0]) < 0.1


def _classifier(s, algo, dtype="float32", n=256, seed=0):
    rng = np.random.default_rng(seed)
    y_idx = rng.integers(0, 3, n)
    x = rng.normal(size=(n, 8))
    x[np.arange(n), y_idx] += 3.0  # separable signal
    np_dtype = np.float64 if dtype == "float64" else np.float32
    x, y = x.astype(np_dtype), np.eye(3, dtype=np_dtype)[y_idx]
    conf = (s["nnc"].builder().seed(7).dtype(dtype).optimization_algo(algo)
            .list()
            .layer(s["L"].DenseLayer(n_out=16, activation="tanh"))
            .layer(s["L"].OutputLayer(n_out=3, activation="softmax",
                                      loss="negativeloglikelihood"))
            .set_input_type(s["it"].feed_forward(8))
            .build())
    return conf, x, y


REF = {"nnc": JNNC, "L": JL, "it": JIT}
PORT = {"nnc": NeuralNetConfiguration, "L": PL, "it": InputType}


class TestModelSolver:
    def _net_and_data(self, algo):
        conf, x, y = _classifier(PORT, algo)
        return MultiLayerNetwork(conf, device="cpu").init(), DataSet(x, y)

    @pytest.mark.parametrize("algo", ["lbfgs", "conjugate_gradient",
                                      "line_gradient_descent"])
    def test_solver_trains_classifier(self, algo):
        net, ds = self._net_and_data(algo)
        solver = Solver(net, max_iterations=60)
        assert solver.algo == algo
        final = solver.optimize(ds)
        assert final < solver.score_history[0]
        assert net.evaluate(ListDataSetIterator(ds, 128)).accuracy() > 0.9

    def test_builder(self):
        net, ds = self._net_and_data("lbfgs")
        s = (Solver.Builder().model(net).configure(net.conf.global_conf)
             .max_iterations(5).build())
        assert s.algo == "lbfgs"
        s.optimize(ds)

    def test_unknown_algo_raises(self):
        net, ds = self._net_and_data("lbfgs")
        with pytest.raises(ValueError):
            Solver(net, algo="newton").optimize(ds)


class TestHpo:
    def test_spaces_sample_in_range(self):
        rng = np.random.default_rng(0)
        assert hpo.Choice("a", "b").sample(rng) in ("a", "b")
        assert 2 <= hpo.IntRange(2, 5).sample(rng) <= 5
        assert 0.1 <= hpo.Uniform(0.1, 0.2).sample(rng) < 0.2
        assert 1e-4 <= hpo.LogUniform(1e-4, 1e-1).sample(rng) < 1e-1
        assert hpo.IntRange(1, 3).grid_values() == [1, 2, 3]

    def test_random_search_finds_planted_optimum(self):
        calls = []

        def score_fn(model, p):
            return (np.log10(p["lr"]) + 2) ** 2 + (0.5 if p["width"] == 8 else 0.0)

        rs = hpo.RandomSearch({"lr": hpo.LogUniform(1e-4, 1e0),
                               "width": hpo.Choice(8, 16)},
                              lambda p: calls.append(p) or p, score_fn)
        best = rs.optimize(n_trials=40, seed=1)
        assert len(rs.trials) == 40 and len(calls) == 40
        assert best.params["width"] == 16
        assert 3e-3 < best.params["lr"] < 3e-2

    def test_grid_search_enumerates_product(self):
        gs = hpo.GridSearch({"a": hpo.Choice(1, 2), "b": hpo.IntRange(0, 2)},
                            lambda p: p, lambda m, p: p["a"] * 10 + p["b"])
        best = gs.optimize()
        assert len(gs.trials) == 6
        assert best.params == {"a": 1, "b": 0}
        with pytest.raises(NotImplementedError, match="continuous"):
            hpo.GridSearch({"u": hpo.Uniform(0, 1)}, lambda p: p,
                           lambda m, p: 0.0).optimize()

    def test_end_to_end_tiny_training_search(self):
        rng = np.random.default_rng(0)
        cls = rng.integers(0, 2, 64)
        x = rng.normal(size=(64, 4)).astype(np.float32)
        x[np.arange(64), cls] += 2.0
        y = np.eye(2, dtype=np.float32)[cls]

        def model_fn(p):
            conf = (NeuralNetConfiguration.builder().seed(0)
                    .updater(Adam(p["lr"])).list()
                    .layer(PL.DenseLayer(n_in=4, n_out=p["width"], activation="relu"))
                    .layer(PL.OutputLayer(n_in=p["width"], n_out=2))
                    .build())
            net = MultiLayerNetwork(conf, device="cpu").init()
            for _ in range(10):
                net.fit(x, y)
            return net

        def score_fn(net, p):
            return 1.0 - net.evaluate(ListDataSetIterator(DataSet(x, y), 32)).accuracy()

        best = hpo.GridSearch({"lr": hpo.Choice(1e-5, 5e-2), "width": hpo.Choice(8)},
                              model_fn, score_fn, keep_models=True).optimize()
        assert best.params["lr"] == 5e-2
        assert best.score < 0.2
        assert best.model is not None


# --------------------------------------------------- parity with the JAX package
def _jax_quadratic(scales):
    s = jnp.asarray(scales, jnp.float64)

    @jax.jit
    def vag(x):
        return jax.value_and_grad(lambda x: 0.5 * jnp.sum(s * x * x))(x)
    return vag


def _jax_rosenbrock():
    @jax.jit
    def vag(x):
        return jax.value_and_grad(lambda x: jnp.sum(
            100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2))(x)
    return vag


# Rosenbrock runs 25 iterations: further along its curved valley CG and
# L-BFGS amplify the last-bit differences of float64 sums (each package
# sums in its own order) about threefold an iteration, so that two correct
# runs drift apart past 1e-10 by iteration 30
PROBLEMS = {
    "quadratic": (lambda: _quadratic([1.0, 10.0, 100.0], torch.float64),
                  lambda: _jax_quadratic([1.0, 10.0, 100.0]), [5.0, -3.0, 2.0], 60),
    "rosenbrock": (_rosenbrock, _jax_rosenbrock, [0.0, 0.0, 0.0, 0.0, 0.0], 25),
}
OPTIMIZERS = {
    "sgd": lambda m, n: m.StochasticGradientDescent(learning_rate=1e-3, max_iterations=n),
    "line_gd": lambda m, n: m.LineGradientDescent(max_iterations=n, line_search_iterations=10),
    "cg": lambda m, n: m.ConjugateGradient(max_iterations=n, line_search_iterations=10),
    "lbfgs": lambda m, n: m.LBFGS(max_iterations=n, line_search_iterations=10),
}


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_the_reference_in_float64(problem, name):
    """Score history within 1e-10 relative, or 1e-10 of the first score
    where a score has fallen towards 0 (the quadratic's last scores are
    differences of order-1 terms); the result within 1e-10."""
    from deeplearning4j_tpu_torch.optimize import solvers as ps

    port_fn, ref_fn, x0, n = PROBLEMS[problem]
    port_opt, ref_opt = OPTIMIZERS[name](ps, n), OPTIMIZERS[name](js, n)
    x = port_opt.optimize(port_fn(), torch.tensor(x0, dtype=torch.float64))
    with jax.enable_x64(True):
        xr = np.asarray(ref_opt.optimize(ref_fn(), jnp.asarray(x0, jnp.float64)))
    want = ref_opt.score_history
    assert len(port_opt.score_history) == len(want) > 2
    np.testing.assert_allclose(port_opt.score_history, want, rtol=HIST_TOL,
                               atol=HIST_TOL * abs(want[0]))
    np.testing.assert_allclose(x.numpy(), xr, rtol=HIST_TOL, atol=HIST_TOL)
    assert port_opt.final_score == pytest.approx(ref_opt.final_score, rel=HIST_TOL,
                                                 abs=HIST_TOL * abs(want[0]))


@pytest.fixture(scope="module")
def reference_solves():
    """Each algorithm's reference ``Solver`` run on the float64 classifier:
    ``{algo: (initial params, score history, final params)}``."""
    out = {}
    with jax.enable_x64(True):
        for algo in ALGOS:
            conf, x, y = _classifier(REF, algo, "float64", n=64)
            net = JMLN(conf).init()
            init = jax.tree_util.tree_map(np.asarray, net.params)
            s = js.Solver(net, max_iterations=12)
            s.optimize(JDataSet(x, y))
            out[algo] = (init, list(s.score_history),
                         jax.tree_util.tree_map(np.asarray, net.params))
    return out


@pytest.mark.parametrize("algo", ALGOS)
def test_solver_matches_the_reference_on_a_float64_network(algo, reference_solves):
    init, want_hist, want_params = reference_solves[algo]
    conf, x, y = _classifier(PORT, algo, "float64", n=64)
    net = load_reference_params(MultiLayerNetwork(conf, device="cpu").init(), init)
    s = Solver(net, max_iterations=12)
    final = s.optimize(DataSet(x, y))
    assert len(s.score_history) == len(want_hist)
    np.testing.assert_allclose(s.score_history, want_hist, rtol=SOLVER_TOL, atol=0)
    assert final == s.score_history[-1]
    for i, named in enumerate(want_params):
        for n, arr in named.items():
            got = net.params[i][n]
            assert got.dtype == torch.float64
            np.testing.assert_allclose(got.numpy(), arr, rtol=1e-7, atol=1e-9)


def _pooled(algo):
    """A convolution, a max pool (a layer with no parameters) and a
    softmax output."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(16, 6, 6, 1)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    conf = (NeuralNetConfiguration.builder().seed(3).optimization_algo(algo).list()
            .layer(PL.ConvolutionLayer(n_out=2, kernel_size=(3, 3), activation="tanh"))
            .layer(PL.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(PL.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.convolutional(6, 6, 1)).build())
    return conf, x, y


@pytest.mark.parametrize("make", [lambda: _classifier(PORT, "lbfgs", n=64),
                                  lambda: _pooled("lbfgs")], ids=["dense", "pooled"])
def test_solver_writes_in_place_and_keeps_the_device(make):
    conf, x, y = make()
    net = MultiLayerNetwork(conf, device="cpu").init()
    before = {(k, n): t.clone() for k, named in net.params.items() for n, t in named.items()}
    tensors = {(k, n): t for k, named in net.params.items() for n, t in named.items()}
    s = Solver(net, max_iterations=3)
    s.optimize(DataSet(x, y))
    assert s.score_history[-1] < s.score_history[0]
    for (k, n), t in tensors.items():
        assert net.params[k][n] is t and t.device.type == "cpu"
        assert not torch.equal(t, before[(k, n)])


@pytest.mark.parametrize("seed", [0, 3])
def test_random_and_grid_search_draw_the_reference_trials(seed):
    def space(m):
        return {"lr": m.LogUniform(1e-4, 1e-2), "n_out": m.Choice(100, 500),
                "k": m.IntRange(1, 4), "drop": m.Uniform(0.1, 0.5)}

    def run(m):
        rs = m.RandomSearch(space(m), lambda p: p, lambda _, p: p["lr"] * p["k"])
        best = rs.optimize(n_trials=6, seed=seed)
        gs = m.GridSearch({"lr": m.Choice(1e-3, 1e-2), "n_out": m.Choice(100, 500)},
                          lambda p: p, lambda _, p: p["lr"] / p["n_out"])
        gbest = gs.optimize()
        return ([t.params for t in rs.trials], best.params,
                [t.params for t in gs.trials], gbest.params, repr(best))

    assert run(hpo) == run(jhpo)


def test_solver_settings_read_and_write_as_the_reference():
    jconf, _, _ = _classifier(REF, "lbfgs")
    tconf = (NeuralNetConfiguration.builder().seed(7).optimization_algo("lbfgs")
             .max_num_line_search_iterations(7).list()
             .layer(PL.DenseLayer(n_out=16, activation="tanh"))
             .layer(PL.OutputLayer(n_out=3, activation="softmax",
                                   loss="negativeloglikelihood"))
             .set_input_type(InputType.feed_forward(8)).build())
    jconf.global_conf.max_num_line_search_iterations = 7
    assert tconf.to_dict() == jconf.to_dict()
    back = MultiLayerConfiguration.from_json(jconf.to_json())
    assert back.global_conf.optimization_algo == "lbfgs"
    assert back.global_conf.max_num_line_search_iterations == 7
    assert JMLC.from_json(tconf.to_json()).to_dict() == jconf.to_dict()
    net = MultiLayerNetwork(back, device="cpu").init()
    s = Solver(net)
    assert s.algo == "lbfgs"
