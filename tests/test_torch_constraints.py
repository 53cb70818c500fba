"""The port's constraints, weight noise and gradient normalization against
the JAX package's, on the same numpy inputs.

- every constraint x scope (weights, bias, all; explicit ``param_names``
  and ``dimensions``) on a Dense ``W`` [n_in, n_out], an HWIO conv ``W``,
  an LSTM's ``W`` and ``RW`` [H, 4H+3] and their biases, and the
  wrapper branch of ``apply_constraints``: within 1e-6 of each tensor's
  largest entry;
- ``WeightNoise`` (additive, multiplicative, with and without the bias)
  and ``DropConnect`` with put-in draws (``tests/torch_putin.py``): within
  1e-6 relative; ``DropConnect`` refuses a schedule in both;
- the five ``normalize_gradients`` modes (and none): within 1e-6;
- the serde of each, read in both directions; a fit step keeps the
  parameter tensors (and the updater state's) the same objects.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import constraints as JC
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn import weightnoise as JW
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import LSTMLayer as JLSTM
from deeplearning4j_tpu.nn.weights import Distribution as JDist
from deeplearning4j_tpu_torch.nn import constraints as PC
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn import updaters as PU
from deeplearning4j_tpu_torch.nn import weightnoise as PW
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer,
    DenseLayer,
    LSTMLayer,
    OutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.train_step import dropout_generator
from deeplearning4j_tpu_torch.nn.weights import Distribution as PDist
from torch_putin import PutIn

TOL = 1e-6

LAYERS = {
    "dense": (lambda: JDense(n_in=5, n_out=4), lambda: DenseLayer(n_in=5, n_out=4)),
    "conv_hwio": (lambda: JConv(n_in=3, n_out=4, kernel_size=(3, 2)),
                  lambda: ConvolutionLayer(n_in=3, n_out=4, kernel_size=(3, 2))),
    "lstm": (lambda: JLSTM(n_in=3, n_out=4), lambda: LSTMLayer(n_in=3, n_out=4)),
}
CONSTRAINTS = {
    "MaxNorm": lambda m, **k: m.MaxNormConstraint(max_norm=0.6, **k),
    "MinMaxNorm": lambda m, **k: m.MinMaxNormConstraint(min_norm=0.8, max_norm=1.1,
                                                        rate=0.7, **k),
    "UnitNorm": lambda m, **k: m.UnitNormConstraint(**k),
    "NonNegative": lambda m, **k: m.NonNegativeConstraint(**k),
}
SCOPES = {"weights": dict(scope="weights"), "bias": dict(scope="bias"),
          "all": dict(scope="all"), "param_names": dict(param_names=("W",)),
          "dimensions": dict(scope="all", dimensions=(0,))}


def _params(layer, seed=0):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in layer.param_shapes().items()}


def _close(got, want, what):
    for n, w in want.items():
        np.testing.assert_allclose(np.asarray(got[n]), np.asarray(w), rtol=0,
                                   atol=TOL * max(1.0, np.abs(w).max()),
                                   err_msg=f"{what}/{n}")


@pytest.mark.parametrize("scope", list(SCOPES))
@pytest.mark.parametrize("constraint", list(CONSTRAINTS))
@pytest.mark.parametrize("layer", list(LAYERS))
def test_constraint_matches_reference(layer, constraint, scope):
    jl, tl = LAYERS[layer][0](), LAYERS[layer][1]()
    jl.constraints = [CONSTRAINTS[constraint](JC, **SCOPES[scope])]
    tl.constraints = [CONSTRAINTS[constraint](PC, **SCOPES[scope])]
    p = _params(tl)
    assert set(p) == set(_params(jl))
    want = JC.apply_constraints(jl, {n: jnp.asarray(v) for n, v in p.items()})
    got = PC.apply_constraints(tl, {n: torch.from_numpy(v) for n, v in p.items()})
    _close({n: t.numpy() for n, t in got.items()}, want, f"{layer} {constraint} {scope}")
    changed = {n for n in p if not np.array_equal(np.asarray(want[n]), p[n])}
    if scope == "bias":
        assert changed <= {"b"}
    if scope == "weights":
        assert "b" not in changed


def test_norm_reduces_every_axis_but_the_last():
    """HWIO conv W is reduced over H, W and I (not torch's OIHW view), an
    LSTM RW [H, 4H+3] over axis 0, a bias over its one axis."""
    c = PC.UnitNormConstraint(scope="all")
    w = torch.randn(3, 2, 5, 4)
    out = c.apply(w)
    np.testing.assert_allclose(torch.sqrt((out * out).sum((0, 1, 2))).numpy(), 1.0,
                               atol=1e-5)
    rw = torch.randn(4, 19)
    np.testing.assert_allclose(torch.sqrt((c.apply(rw) ** 2).sum(0)).numpy(), 1.0,
                               atol=1e-5)
    b = torch.randn(7)
    np.testing.assert_allclose(float(torch.sqrt((c.apply(b) ** 2).sum())), 1.0, atol=1e-5)


def test_wrapper_branch_constrains_both_halves_as_the_reference():
    jinner = JDense(n_in=3, n_out=2, constraints=[JC.MaxNormConstraint(max_norm=0.3)])
    tinner = DenseLayer(n_in=3, n_out=2, constraints=[PC.MaxNormConstraint(max_norm=0.3)])
    rng = np.random.default_rng(1)
    halves = {f"{pre}{n}": rng.standard_normal(s).astype(np.float32)
              for pre in ("f_", "b_") for n, s in (("W", (3, 2)), ("b", (2,)))}
    plain = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in (("W", (3, 2)), ("b", (2,)))}
    for p in (halves, plain):
        want = JC.apply_constraints(types.SimpleNamespace(layer=jinner, constraints=None),
                                    {n: jnp.asarray(v) for n, v in p.items()})
        got = PC.apply_constraints(types.SimpleNamespace(layer=tinner, constraints=None),
                                   {n: torch.from_numpy(v) for n, v in p.items()})
        _close({n: t.numpy() for n, t in got.items()}, want, "wrapper")
    bare = {"W": torch.ones(2)}
    assert PC.apply_constraints(types.SimpleNamespace(), bare) is bare


@pytest.mark.parametrize("name", list(CONSTRAINTS))
def test_constraint_serde_reads_both_ways(name):
    j = CONSTRAINTS[name](JC, param_names=("W", "RW"), dimensions=(0, 1))
    t = CONSTRAINTS[name](PC, param_names=("W", "RW"), dimensions=(0, 1))
    assert t.to_dict() == j.to_dict()
    assert PC.LayerConstraint.from_dict(j.to_dict()) == t
    assert JC.LayerConstraint.from_dict(t.to_dict()) == j
    assert PC.constraints_from_config([j.to_dict(), t]) == [t, t]
    assert PC.constraints_from_config(None) is None
    with pytest.raises(ValueError, match="rate"):
        PC.MinMaxNormConstraint(rate=0.0)


WEIGHT_NOISE = {
    "additive": lambda m, d: m.WeightNoise(distribution=d(kind="normal", mean=0.1,
                                                          std=0.05)),
    "multiplicative_bias": lambda m, d: m.WeightNoise(
        distribution=d(kind="normal", mean=1.0, std=0.2), additive=False,
        apply_to_bias=True),
    "default": lambda m, d: m.WeightNoise(),
    "dropconnect": lambda m, d: m.DropConnect(p=0.8),
    "dropconnect_bias": lambda m, d: m.DropConnect(p=0.6, apply_to_bias=True),
}


@pytest.mark.parametrize("layer", list(LAYERS))
@pytest.mark.parametrize("name", list(WEIGHT_NOISE))
def test_weight_noise_matches_reference_with_put_in_draws(monkeypatch, name, layer):
    jl, tl = LAYERS[layer][0](), LAYERS[layer][1]()
    jw, tw = WEIGHT_NOISE[name](JW, JDist), WEIGHT_NOISE[name](PW, PDist)
    p = _params(tl, seed=2)
    putin = PutIn(monkeypatch, seed=8)
    want = jw.apply(jl, {n: jnp.asarray(v) for n, v in p.items()},
                    jax.random.PRNGKey(0), True)
    got = tw.apply(tl, {n: torch.from_numpy(v) for n, v in p.items()},
                   dropout_generator(0, "cpu"), True)
    _close({n: t.numpy() for n, t in got.items()}, want, name)
    noised = set(tl.weight_param_names()) | (set(tl.bias_param_names())
                                              if tw.apply_to_bias else set())
    assert putin.port_calls == len(putin.drawn) == len(noised)
    for n in set(p) - noised:
        assert np.array_equal(got[n].numpy(), p[n])
    clean = {n: torch.from_numpy(v) for n, v in p.items()}
    assert tw.apply(tl, clean, dropout_generator(0, "cpu"), False) is clean
    assert tw.apply(tl, clean, None, True) is clean
    assert tw.to_dict() == jw.to_dict()
    assert PW.IWeightNoise.from_dict(jw.to_dict()).to_dict() == jw.to_dict()
    assert JW.IWeightNoise.from_dict(tw.to_dict()).to_dict() == jw.to_dict()


def test_weight_noise_other_distributions_draw_from_the_generator():
    tl = DenseLayer(n_in=4, n_out=3)
    wn = PW.WeightNoise(distribution=PDist(kind="uniform", lower=0.5, upper=0.6),
                        additive=False)
    w = torch.ones(4, 3)
    a = wn.apply(tl, {"W": w}, dropout_generator(1, "cpu"), True)["W"]
    b = wn.apply(tl, {"W": w}, dropout_generator(1, "cpu"), True)["W"]
    assert torch.equal(a, b) and 0.5 <= a.min() and a.max() <= 0.6


def test_dropconnect_refuses_a_schedule_and_a_bad_probability():
    for W, U in ((JW, JU), (PW, PU)):
        with pytest.raises(ValueError, match="schedules"):
            W.DropConnect(p=U.ExponentialSchedule(initial_value=0.5, gamma=0.9))
        with pytest.raises(ValueError, match="retain probability"):
            W.DropConnect(p=0.0)
    w = torch.ones(3, 2)
    assert PW.DropConnect(p=1.0).apply_param(w, dropout_generator(0, "cpu")) is w


@pytest.mark.parametrize("mode", [None, "none", "renormalize_l2_per_layer",
                                  "renormalize_l2_per_param_type",
                                  "clip_elementwise_absolute_value",
                                  "clip_l2_per_layer", "clip_l2_per_param_type"])
@pytest.mark.parametrize("threshold", [0.5, 50.0])
def test_normalize_gradients_matches_reference(mode, threshold):
    rng = np.random.default_rng(3)
    g = {"W": rng.standard_normal((6, 5)).astype(np.float32),
         "RW": rng.standard_normal((5, 23)).astype(np.float32),
         "b": rng.standard_normal(20).astype(np.float32) * 0.1}
    want = JU.normalize_gradients({n: jnp.asarray(v) for n, v in g.items()}, mode,
                                  threshold)
    got = PU.normalize_gradients({n: torch.from_numpy(v) for n, v in g.items()}, mode,
                                 threshold)
    assert set(got) == set(g)
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), np.asarray(w), rtol=TOL, atol=TOL,
                                   err_msg=f"{mode} {n}")
    with pytest.raises(ValueError, match="Unknown gradient normalization"):
        PU.normalize_gradients({"W": torch.ones(2)}, "clip_everything")


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused"])
def test_constraints_write_into_the_same_tensors(fused):
    """The parameters stay the same objects (and, with the fused updater,
    which updates its state in place, the state's tensors too)."""
    if fused:
        thelpers.set_helper("updater", ck.FusedUpdaterHelper())
    conf = (NeuralNetConfiguration.builder().seed(2).updater(PU.Adam(0.5))
            .constrain_all_parameters(PC.MaxNormConstraint(max_norm=0.1))
            .list().layer(DenseLayer(n_out=4)).layer(OutputLayer(n_out=2))
            .set_input_type(InputType.feed_forward(3)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    before = {(i, n): t for i, named in net.params.items() for n, t in named.items()}
    slots = {(i, n): dict(s) for i, named in net.updater_states.items()
             for n, s in named.items()}
    x = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)
    try:
        net.fit(x, np.eye(2, dtype=np.float32)[[0, 1, 0, 1]])
    finally:
        thelpers.clear_helper("updater")
    for (i, n), t in before.items():
        assert net.params[i][n] is t
        assert not fused or all(net.updater_states[i][n][s] is v
                                for s, v in slots[(i, n)].items())
        norms = torch.sqrt((t * t).sum(0 if t.ndim == 1 else tuple(range(t.ndim - 1))))
        assert (norms <= 0.1 + 1e-6).all()
    assert dict(net.named_parameters())["0/W"] is before[(0, "W")]
