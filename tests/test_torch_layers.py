"""Each layer of the port against the JAX reference, with copied params.

Inputs and parameters are made with numpy from a seed and fed to both.
Tolerance rtol 1e-5 / atol 1e-6: both compute in float32 on the CPU, and
only the order of the sums (XLA vs ATen) differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import activations as jact
from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import norm as jnorm
from deeplearning4j_tpu.nn.layers import output as jout
from deeplearning4j_tpu.nn.vertices import ElementWiseVertex as JEW
from deeplearning4j_tpu_torch.nn import activations as tact
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TIT
from deeplearning4j_tpu_torch.nn.layers import attention as tatt
from deeplearning4j_tpu_torch.nn.layers import core as tcore
from deeplearning4j_tpu_torch.nn.layers import norm as tnorm
from deeplearning4j_tpu_torch.nn.layers import output as tout
from deeplearning4j_tpu_torch.nn.vertices import ElementWiseVertex as TEW

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _clean_seams():
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    yield
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    thelpers.set_auto_flash_attention(True)


def _pair(jlayer, tlayer, rng, it_j, it_t):
    """Infer shapes on both, draw numpy params of the reference's shapes
    (matrices at std 1/sqrt(fan_in), so activations stay of order 1 and
    the absolute tolerance means what it says)."""
    jlayer.set_n_in(it_j)
    tlayer.set_n_in(it_t)
    assert tlayer.param_shapes() == jlayer.param_shapes()
    p = {n: rng.normal(0, 1 / np.sqrt(s[0]) if len(s) == 2 else 0.5, s)
         .astype(np.float32) for n, s in jlayer.param_shapes().items()}
    return ({n: jnp.asarray(a) for n, a in p.items()},
            {n: torch.from_numpy(a.copy()) for n, a in p.items()})


def _check(t_out, j_out):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["identity", "relu", "tanh", "sigmoid",
                                  "gelu", "gelu_tanh", "softmax"])
def test_activations(name, rng):
    x = rng.normal(0, 2, (4, 7, 33)).astype(np.float32)
    _check(tact.resolve(name)(torch.from_numpy(x)), jact.resolve(name)(x))


def test_gelu_is_exact_not_tanh(rng):
    x = torch.from_numpy(rng.normal(0, 2, 1000).astype(np.float32))
    exact, approx = tact.gelu(x), tact.gelu_tanh(x)
    assert (exact - approx).abs().max() > 1e-4  # they are different functions
    _check(approx, jact.gelu_tanh(x.numpy()))


def test_layer_norm_biased_variance_eps(rng):
    x = rng.normal(3, 2, (2, 5, 16)).astype(np.float32)
    jl, tl = jnorm.LayerNormalizationLayer(), tnorm.LayerNormalizationLayer()
    assert tl.eps == jl.eps == 1e-3
    jp, tp = _pair(jl, tl, rng, JIT.recurrent(16), TIT.recurrent(16))
    _check(tl.forward(tp, torch.from_numpy(x)), jl.forward(jp, x)[0])


@pytest.mark.parametrize("act", ["relu", "gelu", "identity"])
def test_dense(act, rng):
    x = rng.normal(0, 1, (3, 6, 12)).astype(np.float32)
    jl = jcore.DenseLayer(n_out=9, activation=act)
    tl = tcore.DenseLayer(n_out=9, activation=act)
    jp, tp = _pair(jl, tl, rng, JIT.recurrent(12), TIT.recurrent(12))
    _check(tl.forward(tp, torch.from_numpy(x)), jl.forward(jp, x)[0])


@pytest.mark.parametrize("trailing_one", [False, True])
def test_embedding_sequence_float_tokens(trailing_one, rng):
    ids = rng.integers(0, 50, (3, 8)).astype(np.float32)
    if trailing_one:
        ids = ids[..., None]  # [N,T,1] is accepted
    jl = jcore.EmbeddingSequenceLayer(n_in=50, n_out=16)
    tl = tcore.EmbeddingSequenceLayer(n_in=50, n_out=16)
    jp, tp = _pair(jl, tl, rng, JIT.recurrent(1, 8), TIT.recurrent(1, 8))
    _check(tl.forward(tp, torch.from_numpy(ids)), jl.forward(jp, ids)[0])


def test_embedding_rejects_out_of_range_ids(rng):
    tl = tcore.EmbeddingSequenceLayer(n_in=10, n_out=4)
    tp = {"W": torch.zeros(10, 4)}
    with pytest.raises(ValueError, match="token ids"):
        tl.forward(tp, torch.tensor([[3.0, 10.0]]))


@pytest.mark.parametrize("ids", [[-1, 0], [-4, 3]], ids=["-1,0", "-4,3"])
def test_embedding_wraps_negative_ids_as_the_reference(ids):
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    jl = jcore.EmbeddingSequenceLayer(n_in=4, n_out=3)
    tl = tcore.EmbeddingSequenceLayer(n_in=4, n_out=3)
    idx = np.array([ids], np.float32)
    want = np.asarray(jl.forward({"W": jnp.asarray(w)}, jnp.asarray(idx))[0])
    got = tl.forward({"W": torch.from_numpy(w)}, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[0], w[[i % 4 for i in ids]])
    with pytest.raises(ValueError, match="token ids"):
        tl.forward({"W": torch.from_numpy(w)}, torch.tensor([[-5.0, 0.0]]))
    with tcore.unchecked_token_ids():  # no read of the ids: the wrap is a torch.where
        np.testing.assert_array_equal(
            tl.forward({"W": torch.from_numpy(w)}, torch.from_numpy(idx)).numpy(), want)


def test_positional(rng):
    x = rng.normal(0, 1, (2, 9, 16)).astype(np.float32)
    jl = jcore.PositionalEmbeddingLayer(n_in=16, max_len=32)
    tl = tcore.PositionalEmbeddingLayer(n_in=16, max_len=32)
    jp, tp = _pair(jl, tl, rng, JIT.recurrent(16), TIT.recurrent(16))
    _check(tl.forward(tp, torch.from_numpy(x)), jl.forward(jp, x)[0])


@pytest.mark.parametrize("causal_cls", [False, True])
@pytest.mark.parametrize("t", [8, 128])
def test_self_attention(causal_cls, t, rng):
    """Head-major fused QKV, both seams empty. At T=128/Dh=64 the causal
    layer goes through the port's auto-flash path (the kernel's plain
    version on the CPU); at T=8 through the einsum math."""
    x = rng.normal(0, 1, (2, t, 128)).astype(np.float32)
    kw = dict(n_heads=2, head_size=64)
    if causal_cls:
        jl, tl = jatt.CausalSelfAttentionLayer(**kw), tatt.CausalSelfAttentionLayer(**kw)
    else:
        jl, tl = jatt.SelfAttentionLayer(**kw), tatt.SelfAttentionLayer(**kw)
    jp, tp = _pair(jl, tl, rng, JIT.recurrent(128), TIT.recurrent(128))
    _check(tl.forward(tp, torch.from_numpy(x)), jl.forward(jp, x)[0])


def test_self_attention_padding_mask(rng):
    x = rng.normal(0, 1, (2, 8, 32)).astype(np.float32)
    mask = np.ones((2, 8), np.float32)
    mask[1, 5:] = 0
    jl = jatt.SelfAttentionLayer(n_heads=4)
    tl = tatt.SelfAttentionLayer(n_heads=4)
    jp, tp = _pair(jl, tl, rng, JIT.recurrent(32), TIT.recurrent(32))
    _check(tl.forward(tp, torch.from_numpy(x), mask=torch.from_numpy(mask)),
           jl.forward(jp, x, mask=mask)[0])


def test_rnn_output_layer(rng):
    x = rng.normal(0, 1, (2, 5, 24)).astype(np.float32)
    jl = jout.RnnOutputLayer(n_out=40, activation="softmax")
    tl = tout.RnnOutputLayer(n_out=40, activation="softmax")
    jp, tp = _pair(jl, tl, rng, JIT.recurrent(24, 5), TIT.recurrent(24, 5))
    assert (tl.output_type(TIT.recurrent(24, 5)).kind
            == jl.output_type(JIT.recurrent(24, 5)).kind == "rnn")
    _check(tl.forward(tp, torch.from_numpy(x)), jl.forward(jp, x)[0])


@pytest.mark.parametrize("op", ["add", "average", "subtract", "product", "max"])
def test_elementwise_vertex(op, rng):
    xs = [rng.normal(0, 1, (3, 4)).astype(np.float32) for _ in range(2)]
    _check(TEW(op=op).forward([torch.from_numpy(a) for a in xs]),
           JEW(op=op).forward([jnp.asarray(a) for a in xs]))


def test_xavier_init_matches_in_distribution():
    """Init draws differ from jax's by construction; the scheme's scale
    must not: the std of a 256x512 xavier draw is within 2% of
    sqrt(2 / (fan_in + fan_out))."""
    from deeplearning4j_tpu_torch.nn.weights import init_weight
    gen = torch.Generator().manual_seed(0)
    w = init_weight(gen, (256, 512), "xavier", 256, 512)
    assert abs(w.std().item() / np.sqrt(2.0 / 768) - 1) < 0.02
    u = init_weight(gen, (256, 512), "xavier_uniform", 256, 512)
    assert u.abs().max().item() <= np.sqrt(6.0 / 768)
    jw = jax.random.normal(jax.random.PRNGKey(0), (256, 512)) * np.sqrt(2.0 / 768)
    assert abs(float(jnp.std(jw)) / w.std().item() - 1) < 0.03


@pytest.mark.parametrize("scheme", [
    "distribution", "zero", "ones", "sigmoid_uniform", "normal", "lecun_normal",
    "uniform", "xavier", "xavier_uniform", "xavier_fan_in", "xavier_legacy",
    "relu", "relu_uniform", "identity", "lecun_uniform",
    "var_scaling_normal_fan_in", "var_scaling_normal_fan_out",
    "var_scaling_normal_fan_avg", "var_scaling_uniform_fan_in",
    "var_scaling_uniform_fan_out", "var_scaling_uniform_fan_avg"])
def test_weight_schemes_match_reference_moments(scheme):
    """Every WeightInit scheme: mean and std of a 256x384 draw agree with
    the reference's draw (different generators) within 5% / 0.01 abs."""
    from deeplearning4j_tpu.nn.weights import Distribution as JDist
    from deeplearning4j_tpu.nn.weights import init_weight as j_init
    from deeplearning4j_tpu_torch.nn.weights import Distribution as TDist
    from deeplearning4j_tpu_torch.nn.weights import init_weight as t_init
    shape = (256, 256) if scheme == "identity" else (256, 384)
    kw = dict(kind="truncated_normal", mean=0.1, std=0.3)
    jw = np.asarray(j_init(jax.random.PRNGKey(3), shape, scheme, 256, 384,
                           distribution=JDist(**kw)))
    tw = t_init(torch.Generator().manual_seed(3), shape, scheme, 256, 384,
                distribution=TDist(**kw)).numpy()
    assert tw.shape == jw.shape and tw.dtype == jw.dtype
    np.testing.assert_allclose([tw.mean(), tw.std(), np.abs(tw).max() > 0],
                               [jw.mean(), jw.std(), np.abs(jw).max() > 0],
                               rtol=0.05, atol=0.01)
