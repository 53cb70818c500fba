"""Layerwise pretraining in the port against the JAX package.

The VAE's reconstruction distributions (Bernoulli with the sigmoid and
with a clipped activation, Gaussian, Exponential, the loss-function
wrapper over each loss it takes, a composite of three): each example's
negative log probability and its gradient (``jax.vjp``) within 1e-5 ×
max(1, the largest entry), the mean, the samples from the same handed
draws (``tests/torch_putin.py``: the JAX package's ``jax.random`` and the
port's ``nn/dropout.py`` draws replaced by one numpy sequence), the
score arrays, the serde both ways and the reference's refusals. The
pre-outputs hold exact zeros, where the stable Bernoulli form's
``max(l, 0)`` splits its gradient in half and ``|l|``'s is +1, and the
loss wrapper's MAE meets its labels exactly.

Then the layers on the same numpy weights in both packages: the VAE's
forward (the encoder mean), ``pretrain_loss`` and its gradients (2
samples, the same ε), ``reconstruction_log_probability`` (3 samples),
``reconstruction_error``, the zero decoder columns whose pre-outputs are
exactly 0 (``pXZb``'s gradient at the ties); the autoencoder's
``pretrain_loss`` and gradients with the same corruption mask, under MSE
and under XENT (resolved, as in the reference, to its logits form with
no activation named).

Then pretraining: a stacked network (autoencoder → VAE → softmax output,
Adam, l2 1e-3, which the pretrain step must not add) pretrained layer by
layer for 3 steps in both packages, as a ``MultiLayerNetwork`` and as a
``ComputationGraph`` whose autoencoder reads two inputs (concatenated),
with and without ``FusedUpdaterHelper`` (its plain version on the CPU):
the parameters, both Adam moments and ``score_`` within 1e-5 × each
tensor's largest entry; a ``fit`` after it continues from the pretrain's
Adam moments as the reference's does; ``iteration`` stays 0. The model
zip of a VAE with a nested composite distribution loads both ways.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import base as jbase
from deeplearning4j_tpu.nn.layers import vae_distributions as JD
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.util import model_serializer as jms
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import base as tbase
from deeplearning4j_tpu_torch.nn.layers import vae_distributions as TD
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    export_updater_state,
    load_reference_params,
)
from test_torch_conv_family import _close, _json, jax_init, to_np
from torch_putin import PutIn

TOL, STEP_TOL = 1e-5, 1e-5
N, D = 6, 12


@pytest.fixture(autouse=True)
def _clean_seams():
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    yield
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()


# ------------------------------------------------------------ distributions
def _dists(pkg):
    """``{case: (distribution, data kind)}`` of one package's module."""
    return {
        "bernoulli": (pkg.BernoulliReconstructionDistribution(), "binary"),
        "bernoulli_clipped": (pkg.BernoulliReconstructionDistribution(
            activation="hardsigmoid"), "binary"),
        "gaussian": (pkg.GaussianReconstructionDistribution(), "real"),
        "gaussian_tanh": (pkg.GaussianReconstructionDistribution(activation="tanh"),
                          "real"),
        "exponential": (pkg.ExponentialReconstructionDistribution(), "positive"),
        **{f"loss_{loss}": (pkg.LossFunctionWrapper(loss=loss, activation=act), kind)
           for loss, act, kind in (("mse", "identity", "real"), ("l2", "tanh", "real"),
                                   ("mae", "identity", "real"), ("l1", "identity", "real"),
                                   ("xent", "sigmoid", "unit"),
                                   ("mcxent", "softmax", "onehot"),
                                   ("negativeloglikelihood", "softmax", "onehot"))},
        "composite": (pkg.CompositeReconstructionDistribution(distributions=[
            (4, pkg.BernoulliReconstructionDistribution()),
            (3, pkg.GaussianReconstructionDistribution(activation="tanh")),
            (5, pkg.LossFunctionWrapper(loss="mse"))]), "mixed"),
    }


DIST_CASES = list(_dists(TD))


def _data(kind, n=N, d=D, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        return (rng.random((n, d)) < 0.4).astype(np.float32)
    if kind == "positive":
        return rng.exponential(1.0, (n, d)).astype(np.float32)
    if kind == "unit":
        return rng.random((n, d)).astype(np.float32)
    if kind == "onehot":
        return np.eye(d, dtype=np.float32)[rng.integers(0, d, n)]
    if kind == "mixed":
        return np.concatenate([_data("binary", n, 4, seed), _data("real", n, 3, seed),
                               _data("real", n, 5, seed)], axis=1)
    return rng.standard_normal((n, d)).astype(np.float32)


def _pre_out(dist, x, seed=2):
    """Pre-outputs of the distribution's input size, with exact zeros, the
    hardsigmoid's lower bound -2.5 and, for a loss over an identity,
    entries equal to the labels. A clipped Bernoulli's pre-outputs stay
    below 2.5: its upper clip 1 - 1e-10 is 1.0 in f32, so an activation
    that reaches 1 gives -log p = inf in both packages (ROADMAP §C)."""
    size = dist.distribution_input_size(x.shape[1])
    p = np.random.default_rng(seed).normal(0, 1.5, (x.shape[0], size)).astype(np.float32)
    if getattr(dist, "activation", None) == "hardsigmoid":
        p = np.minimum(p, 2.4).astype(np.float32)
    p[0, :] = 0.0
    p[1, :3] = [2.4, -2.5, 0.0]
    if size == x.shape[1]:
        p[2, :4] = x[2, :4]
    return p


@pytest.mark.parametrize("case", DIST_CASES)
def test_distribution_matches_the_reference(case):
    jd, kind = _dists(JD)[case]
    td, _ = _dists(TD)[case]
    x = _data(kind)
    pre = _pre_out(td, x)
    assert td.distribution_input_size(D) == jd.distribution_input_size(D)
    assert td.has_loss_function() == jd.has_loss_function()
    cot = np.random.default_rng(3).standard_normal(N).astype(np.float32)
    scored = hasattr(td, "score_array") and td.has_loss_function()

    @jax.jit
    def reference(x_, p_, cot_):  # one compile, where op by op is many
        out, pull = jax.vjp(lambda p: jd.example_neg_log_prob(x_, p), p_)
        mean = jd.generate_at_mean(p_)
        return out, pull(cot_)[0], mean, jd.score_array(x_, mean) if scored else None

    out, jgrad, mean, score = reference(x, pre, cot)
    leaf = torch.tensor(pre, requires_grad=True)
    tout = td.example_neg_log_prob(torch.from_numpy(x), leaf)
    (tgrad,) = torch.autograd.grad(tout, leaf, torch.from_numpy(cot))
    _close(tout, out, TOL)
    _close(tgrad, jgrad, TOL)
    _close(td.generate_at_mean(torch.from_numpy(pre)), mean, TOL)
    if scored:
        _close(td.score_array(torch.from_numpy(x), torch.from_numpy(np.array(mean))),
               score, TOL)


@pytest.mark.parametrize("case", ["bernoulli", "gaussian", "exponential", "loss_mse",
                                  "composite"])
def test_distribution_samples_from_the_same_draws(case, monkeypatch):
    jd, kind = _dists(JD)[case]
    td, _ = _dists(TD)[case]
    pre = _pre_out(td, _data(kind))
    putin = PutIn(monkeypatch, seed=4)
    want = np.asarray(jd.generate_random(jax.random.PRNGKey(0), jnp.asarray(pre)))
    gen = torch.Generator()
    got = td.generate_random(gen, torch.from_numpy(pre))
    # the loss wrapper's "sample" is its mean: it draws nothing
    assert putin.port_calls == len(putin.drawn) == (0 if case == "loss_mse" else
                                                    2 if case == "composite" else 1)
    _close(got, want, TOL)


def test_distribution_serde_reads_both_ways():
    for case, (td, _) in _dists(TD).items():
        jd = _dists(JD)[case][0]
        assert _json(td.to_dict()) == _json(jd.to_dict()), case
        back = TD.ReconstructionDistribution.from_dict(_json(jd.to_dict()))
        there = JD.ReconstructionDistribution.from_dict(_json(td.to_dict()))
        assert type(back).__name__ == type(jd).__name__ == type(there).__name__
        assert _json(back.to_dict()) == _json(there.to_dict())
    for v in ("bernoulli", "Gaussian", "exponential", TD.LossFunctionWrapper()):
        assert type(TD.resolve_reconstruction(v)).__name__ == \
            type(JD.resolve_reconstruction(v if isinstance(v, str) else JD.LossFunctionWrapper())
                 ).__name__


def test_distribution_refusals_are_the_references():
    for pkg in (JD, TD):
        with pytest.raises(ValueError, match="non-empty"):
            pkg.CompositeReconstructionDistribution(distributions=[])
        comp = pkg.CompositeReconstructionDistribution(
            distributions=[(2, pkg.BernoulliReconstructionDistribution())])
        with pytest.raises(ValueError, match="Invalid input size"):
            comp.distribution_input_size(3)
        with pytest.raises(ValueError, match="score array"):
            comp.score_array(np.zeros((1, 2), np.float32), np.zeros((1, 2), np.float32))
        with pytest.raises(ValueError, match="unsupported loss"):
            pkg._loss_score_array("hinge", np.zeros((1, 2), np.float32),
                                  np.zeros((1, 2), np.float32))
        with pytest.raises(ValueError, match="Unknown reconstruction"):
            pkg.resolve_reconstruction("poisson")


# ------------------------------------------------------------------- layers
def _vae_pair(recon="bernoulli", num_samples=2, pkg_recon=None):
    kw = dict(n_in=D, n_out=3, encoder_layer_sizes=(8, 7), decoder_layer_sizes=(7, 8),
              num_samples=num_samples, activation="leakyrelu")
    jr = recon if pkg_recon is None else pkg_recon[0]
    tr = recon if pkg_recon is None else pkg_recon[1]
    jl = JL.VariationalAutoencoderLayer(reconstruction_distribution=jr, **kw)
    tl = L.VariationalAutoencoderLayer(reconstruction_distribution=tr, **kw)
    assert tl.param_shapes() == jl.param_shapes()
    assert list(tl.param_shapes()) == list(jl.param_shapes())
    rng = np.random.default_rng(7)
    params = {n: (0.4 * rng.standard_normal(s)).astype(np.float32)
              for n, s in jl.param_shapes().items()}
    return jl, tl, params


VAE_RECONS = {
    "bernoulli": ("bernoulli", "binary"),
    "gaussian": ("gaussian", "real"),
    "composite": (None, "mixed"),
}


def _recon_pair(name):
    if name == "composite":
        return (_dists(JD)["composite"][0], _dists(TD)["composite"][0])
    return None


def _grads(jfn, tfn, params):
    """The loss and gradients of both, the reference's under one
    ``jax.jit`` (its handed draws are taken at the trace)."""
    jloss, jg = jax.jit(jax.value_and_grad(jfn))(
        {n: jnp.asarray(a) for n, a in params.items()})
    leaves = {n: torch.tensor(a, requires_grad=True) for n, a in params.items()}
    tloss = tfn(leaves)
    tg = dict(zip(leaves, torch.autograd.grad(tloss, list(leaves.values()))))
    return float(jloss), jg, float(tloss.detach()), tg


@pytest.mark.parametrize("name", list(VAE_RECONS))
def test_vae_matches_the_reference(name, monkeypatch):
    recon, kind = VAE_RECONS[name]
    jl, tl, params = _vae_pair(recon or "bernoulli", pkg_recon=_recon_pair(name))
    x = _data(kind)
    tp = {n: torch.from_numpy(a) for n, a in params.items()}
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    _close(tl.forward(tp, torch.from_numpy(x)), jl.forward(jp, jnp.asarray(x))[0], TOL)
    putin = PutIn(monkeypatch, seed=5)
    jloss, jg, tloss, tg = _grads(
        lambda p: jl.pretrain_loss(p, jnp.asarray(x), jax.random.PRNGKey(1)),
        lambda p: tl.pretrain_loss(p, torch.from_numpy(x), torch.Generator()), params)
    assert len(putin.drawn) == putin.port_calls == 2
    assert abs(tloss - jloss) <= TOL * max(1.0, abs(jloss))
    for n in params:
        _close(tg[n], jg[n], TOL)
    putin = PutIn(monkeypatch, seed=6)
    want = jax.jit(lambda p, x_: jl.reconstruction_log_probability(
        p, x_, jax.random.PRNGKey(2), 3))(jp, x)
    got = tl.reconstruction_log_probability(tp, torch.from_numpy(x), torch.Generator(), 3)
    assert len(putin.drawn) == putin.port_calls == 3
    _close(got, want, TOL)
    z = np.random.default_rng(8).standard_normal((N, 3)).astype(np.float32)
    _close(tl.generate(tp, torch.from_numpy(z)), jl.generate(jp, jnp.asarray(z)), TOL)
    # no generator: ε = 0, and the single sample is divided by num_samples
    _close(tl.pretrain_loss(tp, torch.from_numpy(x), None),
           jl.pretrain_loss(jp, jnp.asarray(x), None), TOL)


def test_vae_loss_function_configuration_and_refusals():
    recon = (JD.LossFunctionWrapper(loss="mse", activation="tanh"),
             TD.LossFunctionWrapper(loss="mse", activation="tanh"))
    jl, tl, params = _vae_pair(pkg_recon=recon)
    x = _data("real")
    tp = {n: torch.from_numpy(a) for n, a in params.items()}
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    assert tl.has_loss_function() and jl.has_loss_function()
    _close(tl.reconstruction_error(tp, torch.from_numpy(x)),
           jl.reconstruction_error(jp, jnp.asarray(x)), TOL)
    with pytest.raises(ValueError, match="LossFunctionWrapper"):
        tl.reconstruction_log_probability(tp, torch.from_numpy(x), torch.Generator())
    bl, bt, bp = _vae_pair()
    tbp = {n: torch.from_numpy(a) for n, a in bp.items()}
    with pytest.raises(ValueError, match="loss-function configuration"):
        bt.reconstruction_error(tbp, torch.from_numpy(x))
    with pytest.raises(ValueError, match="num_samples"):
        bt.reconstruction_log_probability(tbp, torch.from_numpy(x), torch.Generator(), 0)


def test_vae_bias_gradient_at_exact_zero_pre_outputs(monkeypatch):
    """Zero decoder columns and a zero ``pXZb`` make the Bernoulli
    pre-outputs exactly 0 there: ``max(l, 0)``'s gradient splits (0.5) and
    ``|l|``'s is +1, so ``pXZb``'s gradient there is the reference's."""
    jl, tl, params = _vae_pair(num_samples=1)
    params["pXZW"][:, :5] = 0.0
    params["pXZb"][:] = 0.0
    x = _data("binary")
    putin = PutIn(monkeypatch, seed=9)
    _, jg, _, tg = _grads(
        lambda p: jl.pretrain_loss(p, jnp.asarray(x), jax.random.PRNGKey(3)),
        lambda p: tl.pretrain_loss(p, torch.from_numpy(x), torch.Generator()), params)
    assert putin.port_calls == 1
    np.testing.assert_allclose(tg["pXZb"].numpy(), np.asarray(jg["pXZb"]), rtol=0,
                               atol=1e-6)
    # at l = 0 the true derivative of -log p is 0.5 - x; the reference's
    # subgradients give max's 0.5, -x, and -0.5 from softplus(-|l|) with
    # |l|'s +1: -x (a mean over the batch), which the port keeps
    np.testing.assert_allclose(tg["pXZb"].numpy()[:5], (-x[:, :5]).mean(0),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("loss", ["mse", "xent"])
def test_autoencoder_matches_the_reference(loss, monkeypatch):
    kw = dict(n_in=D, n_out=5, corruption_level=0.3, loss=loss)
    jl, tl = JL.AutoEncoderLayer(**kw), L.AutoEncoderLayer(**kw)
    assert tl.param_shapes() == jl.param_shapes()
    rng = np.random.default_rng(10)
    params = {n: (0.5 * rng.standard_normal(s)).astype(np.float32)
              for n, s in jl.param_shapes().items()}
    x = _data("unit")
    putin = PutIn(monkeypatch, seed=11)
    jloss, jg, tloss, tg = _grads(
        lambda p: jl.pretrain_loss(p, jnp.asarray(x), jax.random.PRNGKey(4)),
        lambda p: tl.pretrain_loss(p, torch.from_numpy(x), torch.Generator()), params)
    assert putin.port_calls == len(putin.drawn) == 1
    assert 0 < putin.drawn[0][1].mean() < 1
    assert abs(tloss - jloss) <= TOL * max(1.0, abs(jloss))
    for n in params:
        _close(tg[n], jg[n], TOL)
    tp = {n: torch.from_numpy(a) for n, a in params.items()}
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    _close(tl.decode(tp, tl.encode(tp, torch.from_numpy(x))),
           jl.decode(jp, jl.encode(jp, jnp.asarray(x))), TOL)
    _close(tl.pretrain_loss(tp, torch.from_numpy(x), None).reshape(1),
           np.asarray(jl.pretrain_loss(jp, jnp.asarray(x), None)).reshape(1), TOL)


# -------------------------------------------------------------- pretraining
def _stacked(pkg, nnc, it, adam, graph=False):
    """Autoencoder → VAE (composite-free Bernoulli) → softmax output;
    Adam(1e-2), l2 1e-3. The graph's autoencoder reads two inputs of 6."""
    ae = pkg.AutoEncoderLayer(n_in=D, n_out=8, corruption_level=0.25)
    vae = pkg.VariationalAutoencoderLayer(n_out=3, encoder_layer_sizes=(6,),
                                          decoder_layer_sizes=(6,), num_samples=2)
    out = pkg.OutputLayer(n_out=3, loss="mcxent", activation="softmax")
    b = nnc.builder().seed(3).updater(adam(1e-2)).l2(1e-3)
    if not graph:
        return (b.list().layer(ae).layer(vae).layer(out)
                .set_input_type(it.feed_forward(D)).build())
    return (b.graph_builder().add_inputs("a", "b")
            .set_input_types(it.feed_forward(D // 2), it.feed_forward(D // 2))
            .add_layer("ae", ae, "a", "b").add_layer("vae", vae, "ae")
            .add_layer("out", out, "vae").set_outputs("out").build())


def _pretrain_batches():
    rng = np.random.default_rng(12)
    return [rng.random((N, D)).astype(np.float32) for _ in range(3)]


def _feed(batches, graph, lib):
    """The batches as the network takes them: one DataSet a batch (two
    inputs for the graph)."""
    if lib == "jax":
        from deeplearning4j_tpu.datasets.dataset import DataSet as JDS
        from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
        ds, mds = JDS, JMDS
    else:
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet as ds
        from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet as mds
    if graph:
        return [mds([b[:, :D // 2], b[:, D // 2:]], [b]) for b in batches]
    return [ds(b, b) for b in batches]


def _items(tree):
    return tree.items() if isinstance(tree, dict) else enumerate(tree)


@functools.lru_cache(maxsize=None)
def _reference_pretrain(graph):
    """The JAX network's layer-by-layer pretraining (3 steps a layer) and
    one fit after it, with the draws each layer's step took: ``(start
    weights, draws by layer, scores by layer, params, updater states, fit
    score, params after the fit)``."""
    jnet = jax_init(JGraph if graph else JMLN, _stacked(JL, JNNC, JIT, JAdam, graph))
    start = to_np(jnet.params)
    draws, scores = [], []
    with pytest.MonkeyPatch.context() as mp:
        for key in (["ae", "vae"] if graph else [0, 1]):
            putin = PutIn(mp, seed=13)
            jnet.pretrain_layer(key, _feed(_pretrain_batches(), graph, "jax"))
            draws.append(list(putin.drawn))
            scores.append(float(jnet.score_))
    params, upd = to_np(jnet.params), to_np(jnet.updater_states)
    jnet.fit(*_fit_batch(graph))
    return start, draws, scores, params, upd, float(jnet.score_), to_np(jnet.params)


def _fit_batch(graph):
    b = _pretrain_batches()[0]
    y = np.eye(3, dtype=np.float32)[np.arange(N) % 3]
    return ([b[:, :D // 2], b[:, D // 2:]] if graph else b), y


@pytest.mark.parametrize("graph", [False, True], ids=["multilayer", "graph"])
@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused_helper"])
def test_pretrain_layer_by_layer_matches_the_reference(graph, fused, monkeypatch):
    start, draws, scores, want_p, want_u, fit_score, fit_p = _reference_pretrain(graph)
    conf = _stacked(L, NeuralNetConfiguration, InputType, Adam, graph)
    net = load_reference_params(
        (ComputationGraph if graph else MultiLayerNetwork)(conf, device="cpu").init(), start)
    if fused:
        thelpers.set_helper("updater", ck.FusedUpdaterHelper())
    for key, drawn, score in zip(["ae", "vae"] if graph else [0, 1], draws, scores):
        putin = PutIn(monkeypatch)
        putin.drawn = drawn  # the JAX step drew at its trace, once
        net.pretrain_layer(key, _feed(_pretrain_batches(), graph, "port"))
        assert putin.port_calls == 3 * len(drawn) > 0
        assert abs(net.score_ - score) <= STEP_TOL * abs(score)
    assert net.iteration == 0
    got_p, got_u = export_params(net), export_updater_state(net)
    for key, named in _items(want_p):
        for n, w in named.items():
            np.testing.assert_allclose(got_p[key][n], w, rtol=0,
                                       atol=STEP_TOL * np.abs(w).max(), err_msg=f"{key}/{n}")
            for slot, ws in want_u[key][n].items():
                np.testing.assert_allclose(got_u[key][n][slot], ws, rtol=0,
                                           atol=STEP_TOL * max(np.abs(ws).max(), 1e-30),
                                           err_msg=f"{key}/{n}/{slot}")
    # the output layer does not pretrain, and the l2 never reached a step
    out_key = "out" if graph else 2
    np.testing.assert_array_equal(got_p[out_key]["W"], start[out_key]["W"])
    # a fit after the pretraining continues from its Adam moments
    net.fit(*_fit_batch(graph))
    assert abs(net.score_ - fit_score) <= STEP_TOL * abs(fit_score)
    got_p = export_params(net)
    for key, named in _items(fit_p):
        for n, w in named.items():
            np.testing.assert_allclose(got_p[key][n], w, rtol=0,
                                       atol=STEP_TOL * np.abs(w).max(),
                                       err_msg=f"fit {key}/{n}")


def test_pretrain_of_a_single_vae_network(monkeypatch):
    """The VaeMNISTAnomaly shape at a small size: one VAE layer, no output
    layer, ``pretrain`` over 2 epochs of an array."""
    def conf_of(pkg, nnc, it, adam):
        return (nnc.builder().seed(4).updater(adam(1e-3)).l2(1e-4).weight_init("xavier")
                .list().layer(pkg.VariationalAutoencoderLayer(
                    n_out=4, encoder_layer_sizes=(10, 10), decoder_layer_sizes=(10, 10),
                    activation="leakyrelu", pzx_activation="identity",
                    reconstruction_distribution=pkg.BernoulliReconstructionDistribution(
                        activation="sigmoid")))
                .set_input_type(it.feed_forward(D)).build())
    jnet = jax_init(JMLN, conf_of(JL, JNNC, JIT, JAdam))
    net = load_reference_params(MultiLayerNetwork(
        conf_of(L, NeuralNetConfiguration, InputType, Adam), device="cpu").init(),
        to_np(jnet.params))
    assert len(net.params[0]) == 14
    x = _data("binary", n=8)
    putin = PutIn(monkeypatch, seed=14)
    jnet.pretrain(x, epochs=2)
    net.pretrain(x, epochs=2)
    assert putin.port_calls == 2 * len(putin.drawn) == 2
    assert abs(net.score_ - float(jnet.score_)) <= STEP_TOL * abs(float(jnet.score_))
    for n, w in to_np(jnet.params)[0].items():
        np.testing.assert_allclose(export_params(net)[0][n], w, rtol=0,
                                   atol=STEP_TOL * np.abs(w).max(), err_msg=n)
    dense = (NeuralNetConfiguration.builder().list()
             .layer(L.DenseLayer(n_out=3)).layer(L.OutputLayer(n_out=2))
             .set_input_type(InputType.feed_forward(D)).build())
    with pytest.raises(ValueError, match="pretrain_loss"):
        MultiLayerNetwork(dense, device="cpu").init().pretrain_layer(0, x)


def test_vae_serde_and_zip_read_both_ways(tmp_path, monkeypatch):
    """A VAE over a nested composite distribution, one pretrain step in,
    through the configuration JSON and the model zip both ways."""
    def conf_of(pkg, dist_pkg, nnc, it, adam):
        comp = _dists(dist_pkg)["composite"][0]
        return (nnc.builder().seed(5).updater(adam(1e-3)).list()
                .layer(pkg.VariationalAutoencoderLayer(
                    n_out=3, encoder_layer_sizes=(6,), decoder_layer_sizes=(6,),
                    reconstruction_distribution=comp))
                .layer(pkg.OutputLayer(n_out=2))
                .set_input_type(it.feed_forward(D)).build())
    jconf = conf_of(JL, JD, JNNC, JIT, JAdam)
    conf = conf_of(L, TD, NeuralNetConfiguration, InputType, Adam)
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    layer = tbase.layer_from_dict(_json(jconf.layers[0].to_dict()))
    assert isinstance(layer.reconstruction_distribution,
                      TD.CompositeReconstructionDistribution)
    assert type(jbase.layer_from_dict(_json(conf.layers[0].to_dict()))
                .reconstruction_distribution).__name__ == "CompositeReconstructionDistribution"
    jnet = jax_init(JMLN, jconf)
    PutIn(monkeypatch, seed=15)
    jnet.pretrain_layer(0, _data("mixed"))
    jzip, pzip = tmp_path / "jax.zip", tmp_path / "port.zip"
    jms.write_model(jnet, jzip)
    net = MultiLayerNetwork.load(jzip, device="cpu")
    assert json.loads(net.conf.to_json()) == json.loads(jnet.conf.to_json())
    for n, w in to_np(jnet.params)[0].items():
        np.testing.assert_array_equal(export_params(net)[0][n], w)
        for slot, ws in to_np(jnet.updater_states)[0][n].items():
            np.testing.assert_array_equal(export_updater_state(net)[0][n][slot], ws)
    net.save(pzip)
    back = jms.restore_multi_layer_network(pzip)
    assert json.loads(back.conf.to_json()) == json.loads(jnet.conf.to_json())
    for n, w in export_params(net)[0].items():
        np.testing.assert_array_equal(np.asarray(back.params[0][n]), w)
