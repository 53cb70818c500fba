"""The port's dropout variants (``nn/dropout.py``) against the JAX
package's, on the same inputs and the same put-in draws
(``tests/torch_putin.py``): every ``IDropout``, keep probability 1,
``train=False``, scheduled probabilities (the clamp included), the serde
read in both directions, ``resolve_dropout``, ``DropoutLayer``'s default,
a network with a ``DropoutLayer`` over one fit step, the draws of a TBPTT
fit (one set a chunk), and the inference entry points, which never draw.

Tolerance: 1e-6 relative (float32 both ways; the same masks and noise,
the scalars rounded to float32 as the reference's traced ones are).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import dropout as JD
from deeplearning4j_tpu.nn import tick as jtick
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import DropoutLayer as JDropoutLayer
from deeplearning4j_tpu.nn.layers import LSTMLayer as JLSTM
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.layers import RnnOutputLayer as JRnnOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import dropout as PD
from deeplearning4j_tpu_torch.nn import tick as ptick
from deeplearning4j_tpu_torch.nn import updaters as PU
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    DenseLayer,
    DropoutLayer,
    LSTMLayer,
    OutputLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.train_step import dropout_generator
from deeplearning4j_tpu_torch.util.convert import export_params, load_reference_params
from torch_putin import PutIn

RTOL = 1e-6
STEP_TOL = 2e-5
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731

# (name, the JAX package's instance, the port's), each at a p or rate
# that draws
VARIANTS = {
    "Dropout": lambda m: m.Dropout(0.7),
    "AlphaDropout": lambda m: m.AlphaDropout(0.8),
    "GaussianDropout": lambda m: m.GaussianDropout(0.4),
    "GaussianNoise": lambda m: m.GaussianNoise(0.2),
    "SpatialDropout": lambda m: m.SpatialDropout(0.6),
}
SHAPES = {"dense": (6, 5), "sequence": (3, 4, 5), "image": (2, 3, 4, 5)}


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(jd, pd_, x, key=None):
    """The JAX package's ``apply`` (drawing), then the port's (replaying)."""
    want = np.asarray(jd.apply(jnp.asarray(x), jax.random.PRNGKey(0) if key is None
                               else key, True))
    got = pd_.apply(torch.from_numpy(x), dropout_generator(0, "cpu"), True)
    return got.numpy(), want


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", list(VARIANTS))
def test_every_variant_matches_reference_with_put_in_draws(monkeypatch, name, shape):
    if name == "SpatialDropout" and shape == "dense":
        for m, x in ((JD, jnp.zeros(SHAPES[shape])), (PD, torch.zeros(SHAPES[shape]))):
            with pytest.raises(ValueError, match="rank>=3"):
                VARIANTS[name](m).apply(
                    x, jax.random.PRNGKey(0) if m is JD else dropout_generator(0, "cpu"),
                    True)
        return
    putin = PutIn(monkeypatch, seed=3)
    got, want = _both(VARIANTS[name](JD), VARIANTS[name](PD), _x(SHAPES[shape]))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    assert putin.port_calls == len(putin.drawn) == 1
    if name == "SpatialDropout":  # one draw a (batch, channel), channels last
        s = SHAPES[shape]
        assert putin.drawn[0][1].shape == (s[0],) + (1,) * (len(s) - 2) + (s[-1],)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_inference_and_no_generator_are_the_identity(monkeypatch, name):
    putin = PutIn(monkeypatch)
    d = VARIANTS[name](PD)
    x = torch.from_numpy(_x((2, 3, 4)))
    assert d.apply(x, dropout_generator(0, "cpu"), False) is x
    assert d.apply(x, None, True) is x
    assert VARIANTS[name](JD).apply(jnp.asarray(x.numpy()), jax.random.PRNGKey(0),
                                    False) is not None
    assert putin.port_calls == 0 and putin.drawn == []


@pytest.mark.parametrize("name", ["Dropout", "AlphaDropout", "SpatialDropout"])
def test_keep_probability_one_draws_nothing(monkeypatch, name):
    putin = PutIn(monkeypatch)
    cls = getattr(PD, name)
    x = torch.from_numpy(_x((2, 3, 4)))
    assert cls(1.0).apply(x, dropout_generator(0, "cpu"), True) is x
    assert PD.GaussianDropout(0.0).apply(x, dropout_generator(0, "cpu"), True) is x
    assert PD.GaussianNoise(0.0).apply(x, dropout_generator(0, "cpu"), True) is x
    assert putin.port_calls == 0
    for m in (JD, PD):
        with pytest.raises(ValueError, match="retain probability"):
            getattr(m, name)(0.0)
        with pytest.raises(ValueError, match="rate"):
            m.GaussianDropout(1.0)


# a schedule inside the valid range, and ones the clamp must catch: the
# keep probability above 1 (clamped to 1), the rate above 1 (clamped to
# 1 - 1e-6), a negative stddev (clamped to 0)
SCHEDULED = {
    "Dropout": (lambda m: m.Dropout(m_u(m).ExponentialSchedule(
        initial_value=0.9, gamma=0.5)), (3, 1)),
    "Dropout clamped": (lambda m: m.Dropout(m_u(m).ExponentialSchedule(
        initial_value=1.5, gamma=0.99)), (2, 0)),
    "AlphaDropout": (lambda m: m.AlphaDropout(m_u(m).StepSchedule(
        schedule_type="epoch", initial_value=0.9, decay_rate=0.5, step=1.0)), (7, 2)),
    "GaussianDropout clamped": (lambda m: m.GaussianDropout(m_u(m).ExponentialSchedule(
        initial_value=2.0, gamma=0.9)), (1, 0)),
    "GaussianNoise clamped": (lambda m: m.GaussianNoise(m_u(m).ExponentialSchedule(
        initial_value=-0.5, gamma=0.9)), (1, 0)),
    "SpatialDropout": (lambda m: m.SpatialDropout(m_u(m).ExponentialSchedule(
        schedule_type="epoch", initial_value=0.8, gamma=0.9)), (0, 3)),
}


def m_u(m):
    return JU if m is JD else PU


@pytest.mark.parametrize("name", list(SCHEDULED))
def test_schedules_evaluate_at_the_tick_with_the_clamp(monkeypatch, name):
    make, (it, ep) = SCHEDULED[name]
    PutIn(monkeypatch, seed=5)
    x = _x((2, 3, 4))
    with jtick.schedule_tick(jnp.float32(it), jnp.float32(ep)):
        want = np.asarray(make(JD).apply(jnp.asarray(x), jax.random.PRNGKey(0), True))
    with ptick.schedule_tick(it, ep):
        got = make(PD).apply(torch.from_numpy(x), dropout_generator(0, "cpu"),
                             True).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    assert ptick.current_schedule_tick() == (0.0, 0.0)


def test_tick_is_thread_local_and_nests():
    import threading
    seen = []
    with ptick.schedule_tick(4, 1):
        with ptick.schedule_tick(5, 2):
            seen.append(ptick.current_schedule_tick())
        seen.append(ptick.current_schedule_tick())
        t = threading.Thread(target=lambda: seen.append(ptick.current_schedule_tick()))
        t.start()
        t.join()
    assert seen == [(5.0, 2.0), (4.0, 1.0), (0.0, 0.0)]


@pytest.mark.parametrize("name", list(VARIANTS) + list(SCHEDULED))
def test_serde_reads_both_ways(name):
    make = VARIANTS[name] if name in VARIANTS else SCHEDULED[name][0]
    jd, pd_ = make(JD), make(PD)
    assert pd_.to_dict() == jd.to_dict()
    assert PD.IDropout.from_dict(jd.to_dict()).to_dict() == jd.to_dict()
    assert JD.IDropout.from_dict(pd_.to_dict()).to_dict() == jd.to_dict()


def test_resolve_dropout_as_the_reference():
    for v in (None, 0.0, -1.0, 1.0, 2.0):
        assert PD.resolve_dropout(v) is None and JD.resolve_dropout(v) is None
    assert PD.resolve_dropout(0.25) == PD.Dropout(0.25)
    a = PD.AlphaDropout(0.5)
    assert PD.resolve_dropout(a) is a
    sched = PU.ExponentialSchedule(initial_value=0.5, gamma=0.9)
    assert PD.resolve_dropout(sched).to_dict() == \
        JD.resolve_dropout(JU.ExponentialSchedule(initial_value=0.5, gamma=0.9)).to_dict()


def test_dropout_layer_defaults_to_one_half():
    def conf(pkg, net_dropout):
        j = pkg == "jax"
        b, dense, drop, out, it = ((JNNC.builder(), JDense, JDropoutLayer, JOut, JIT) if j
                                   else (NeuralNetConfiguration.builder(), DenseLayer,
                                         DropoutLayer, OutputLayer, InputType))
        if net_dropout is not None:
            b = b.dropout(net_dropout)
        return (b.list().layer(dense(n_out=4)).layer(drop())
                .layer(out(n_out=2)).set_input_type(it.feed_forward(3)).build())

    for net_dropout, want in ((None, 0.5), (0.8, 0.8)):
        jc, tc = conf("jax", net_dropout), conf("port", net_dropout)
        assert tc.layers[1].dropout == jc.layers[1].dropout == want
        assert tc.to_dict() == jc.to_dict()
        assert MultiLayerConfiguration.from_json(jc.to_json()).to_dict() == jc.to_dict()


def _dropout_layer_conf(pkg):
    j = pkg == "jax"
    b, dense, drop, out, it, adam = (
        (JNNC.builder(), JDense, JDropoutLayer, JOut, JIT, JU.Adam) if j else
        (NeuralNetConfiguration.builder(), DenseLayer, DropoutLayer, OutputLayer,
         InputType, PU.Adam))
    return (b.seed(3).updater(adam(1e-2)).list()
            .layer(dense(n_out=8, activation="tanh"))
            .layer(drop(dropout=(JD if j else PD).GaussianDropout(0.3)))
            .layer(dense(n_out=8, activation="relu", dropout=0.75))
            .layer(out(n_out=3)).set_input_type(it.feed_forward(5)).build())


def test_network_with_a_dropout_layer_matches_reference_over_a_step(monkeypatch):
    jnet = JaxMLN(_dropout_layer_conf("jax")).init()
    tnet = load_reference_params(
        MultiLayerNetwork(_dropout_layer_conf("port"), device="cpu").init(),
        to_np(jnet.params))
    putin = PutIn(monkeypatch, seed=6)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    jnet.fit(x, y)
    tnet.fit(x, y)
    # the dropout layer's Gaussian noise, then the dense layer's input mask
    assert [k for k, _ in putin.drawn] == ["normal", "bernoulli"]
    assert putin.port_calls == 2
    np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=STEP_TOL)
    for i, named in enumerate(to_np(jnet.params)):
        for n, w in named.items():
            np.testing.assert_allclose(export_params(tnet)[i][n], w, rtol=STEP_TOL,
                                       atol=STEP_TOL, err_msg=f"{i}/{n}")


def test_inference_entry_points_never_draw(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("an inference entry point drew")

    tnet = MultiLayerNetwork(_dropout_layer_conf("port"), device="cpu").init()
    monkeypatch.setattr(PD, "bernoulli", refuse)
    monkeypatch.setattr(PD, "normal", refuse)
    x = _x((4, 5))
    y = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    tnet.output(x)
    tnet.feed_forward(x)
    tnet.evaluate(DataSet(x, y))
    tnet.score(DataSet(x, y))
    tnet.compute_gradient_and_score(x, y)
    with pytest.raises(AssertionError, match="drew"):
        tnet.fit(x, y)


def _tbptt_conf(pkg):
    j = pkg == "jax"
    b, lstm, dense, out, it, adam = (
        (JNNC.builder(), JLSTM, JDense, JRnnOut, JIT, JU.Adam) if j else
        (NeuralNetConfiguration.builder(), LSTMLayer, DenseLayer, RnnOutputLayer,
         InputType, PU.Adam))
    return (b.seed(5).updater(adam(1e-2)).list()
            .layer(lstm(n_out=6, dropout=0.5))  # the LSTM ignores its dropout
            .layer(dense(n_out=6, activation="tanh", dropout=0.8))
            .layer(out(n_out=4)).set_input_type(it.recurrent(3))
            .backprop_type("TruncatedBPTT").t_bptt_length(3).build())


def test_tbptt_draws_once_a_chunk_and_matches_reference(monkeypatch):
    jnet = JaxMLN(_tbptt_conf("jax")).init()
    tnet = load_reference_params(
        MultiLayerNetwork(_tbptt_conf("port"), device="cpu").init(),
        to_np(jnet.params))
    putin = PutIn(monkeypatch, seed=7)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, 6))]
    jnet.fit(JDataSet(x, y))
    tnet.fit(DataSet(x, y))
    assert tnet.iteration == jnet.iteration == 2
    # the JAX package's chunk step compiles once and draws once; the port
    # draws the dense layer's mask in each of its 2 chunks
    assert [a.shape for _, a in putin.drawn] == [(2, 3, 6)]
    assert putin.port_calls == 2
    np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=STEP_TOL)
    for i, named in enumerate(to_np(jnet.params)):
        for n, w in named.items():
            np.testing.assert_allclose(export_params(tnet)[i][n], w, rtol=STEP_TOL,
                                       atol=STEP_TOL, err_msg=f"{i}/{n}")


def test_dropout_generator_is_seeded_apart_from_init():
    conf = _dropout_layer_conf("port")
    a = MultiLayerNetwork(conf, device="cpu").init()
    b = MultiLayerNetwork(_dropout_layer_conf("port"), device="cpu").init()
    assert torch.equal(a.dropout_generator.get_state(), b.dropout_generator.get_state())
    init_gen = torch.Generator().manual_seed(conf.global_conf.seed)
    assert not torch.equal(a.dropout_generator.get_state(), init_gen.get_state())
    c = MultiLayerNetwork(_dropout_layer_conf("port"), device="cpu").init(seed=99)
    assert not torch.equal(a.dropout_generator.get_state(), c.dropout_generator.get_state())
    assert a.dropout_generator.device.type == "cpu"


def test_draws_refuse_a_generator_on_another_device():
    gen = torch.Generator()  # on the CPU
    with pytest.raises(ValueError, match="cannot draw"):
        PD.bernoulli(0.5, (2, 2), gen, "cuda")
    with pytest.raises(ValueError, match="cannot draw"):
        PD.normal((2, 2), gen, "meta")
    assert PD.bernoulli(0.5, (3,), gen, "cpu").dtype == torch.bool
    assert PD.normal((3,), gen, "cpu", torch.float64).dtype == torch.float64
