"""The port's convolution, pooling and preprocessor specs on the CPU against
the JAX package's, on the same numpy inputs and weights.

Each case checks the forward and, through a random cotangent, the
gradients with respect to the input (and the weights): ``jax.vjp`` on the
reference's side, ``torch.autograd.grad`` on the port's. Tolerance 1e-5 x
max(1, the largest entry of the reference's result): float32 both ways,
and ``F.conv2d`` sums its windows in another order than XLA's
convolution. The images are neither square nor symmetric, and the kernels
not square, so a transposed axis or a flatten in the wrong order fails.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import preprocessors as jpp
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import preprocessors as pp
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer,
    DenseLayer,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.conv import conv_out_size, same_pads
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.convert import load_reference_params

TOL = 1e-5
H, W, CIN, COUT, N = 11, 9, 3, 5, 2  # odd, non-square images
KERNEL = (3, 2)


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _vjp_both(jfn, tfn, args, seed=0):
    """Forward and gradients of both functions of ``args`` (numpy), with
    one random cotangent; returns ``(jax_out, port_out, jax_grads,
    port_grads)``."""
    out, pull = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    cot = np.random.default_rng(seed).standard_normal(out.shape).astype(np.float32)
    jgrads = pull(jnp.asarray(cot))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    tout = tfn(*leaves)
    tgrads = torch.autograd.grad(tout, leaves, torch.from_numpy(cot))
    return out, tout, jgrads, tgrads


CONV_CASES = list(itertools.product(("truncate", "same"), (1, 2), (0, 1), (1, 2)))


@pytest.mark.parametrize("mode,stride,padding,dilation", CONV_CASES)
def test_convolution_forward_and_gradients(mode, stride, padding, dilation):
    kw = dict(n_in=CIN, n_out=COUT, kernel_size=KERNEL, stride=(stride, stride),
              padding=(padding, padding), dilation=(dilation, dilation),
              convolution_mode=mode, activation="tanh")
    jl, tl = JConv(**kw), ConvolutionLayer(**kw)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, H, W, CIN)).astype(np.float32)
    w = rng.standard_normal((*KERNEL, CIN, COUT)).astype(np.float32)
    b = rng.standard_normal(COUT).astype(np.float32)
    out, tout, jg, tg = _vjp_both(
        lambda x_, w_, b_: jl.forward({"W": w_, "b": b_}, x_)[0],
        lambda x_, w_, b_: tl.forward({"W": w_, "b": b_}, x_), (x, w, b))
    it = InputType.convolutional(H, W, CIN)
    expected = tl.output_type(it)
    assert tout.shape == (N, expected.height, expected.width, COUT)
    assert tl.output_type(it) == InputType(**JConv(**kw).output_type(
        JIT.convolutional(H, W, CIN)).to_dict())
    _close(tout, out)
    for got, ref in zip(tg, jg):
        _close(got, ref)


def test_same_pads_follow_xla():
    """The "same" split: the larger half on the high side, as
    ``lax.padtype_to_pads`` computes it, dilation included."""
    from jax import lax
    for size, k, s, d in itertools.product((7, 8, 11), (2, 3, 5), (1, 2, 3), (1, 2)):
        eff = k + (k - 1) * (d - 1)
        assert same_pads(size, k, s, d) == tuple(
            lax.padtype_to_pads((size,), (eff,), (s,), "SAME")[0])
        assert conv_out_size(size, k, s, 0, d, "same") == -(-size // s)


POOL_CASES = list(itertools.product(("max", "avg", "sum", "pnorm"),
                                    ("truncate", "same"), (1, 2)))


@pytest.mark.parametrize("pooling,mode,stride", POOL_CASES)
def test_subsampling_forward_and_gradients(pooling, mode, stride):
    kw = dict(pooling_type=pooling, kernel_size=KERNEL, stride=(stride, stride),
              padding=(1, 1), convolution_mode=mode, pnorm=3 if stride == 2 else 2)
    jl, tl = JPool(**kw), SubsamplingLayer(**kw)
    x = np.random.default_rng(2).standard_normal((N, H, W, CIN)).astype(np.float32)
    out, tout, jg, tg = _vjp_both(lambda x_: jl.forward({}, x_)[0],
                                  lambda x_: tl.forward({}, x_), (x,))
    it = InputType.convolutional(H, W, CIN)
    assert tl.output_type(it).to_dict() == jl.output_type(
        JIT.convolutional(H, W, CIN)).to_dict()
    _close(tout, out)
    _close(tg[0], jg[0])


def test_subsampling_rejects_an_unknown_type():
    with pytest.raises(ValueError, match="Unknown pooling type"):
        SubsamplingLayer(pooling_type="median").forward({}, torch.zeros(1, 4, 4, 1))


# spec, the input's shape, the input type
SPECS = [
    ("identity", (4, 6), InputType.feed_forward(6)),
    ("zero_mean", (4, 6), InputType.feed_forward(6)),
    ("unit_variance", (4, 6), InputType.feed_forward(6)),
    ("standardize", (4, 3, 6), InputType.recurrent(6, 3)),
    ("zero_mean|unit_variance", (4, 6), InputType.feed_forward(6)),
    ("cnn_to_ff", (4, 3, 2, 5), InputType.convolutional(3, 2, 5)),
    ("ff_to_cnn:3,2,5", (4, 30), InputType.feed_forward(30)),
    ("rnn_to_ff", (4, 3, 6), InputType.recurrent(6, 3)),
    ("ff_to_rnn:3", (12, 6), InputType.feed_forward(6)),
    ("cnn_to_rnn", (4, 3, 2, 5), InputType.convolutional(3, 2, 5)),
    ("rnn_to_cnn:2,3,1", (4, 3, 6), InputType.recurrent(6, 3)),
    ("reshape:5,6", (4, 30), InputType.feed_forward(30)),
    ("reshape:3,2,5", (4, 30), InputType.feed_forward(30)),
    ("reshape:30", (4, 5, 6), InputType.recurrent(6, 5)),
]


@pytest.mark.parametrize("spec,shape,it", SPECS, ids=[s[0] for s in SPECS])
def test_preprocessor_spec(spec, shape, it):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    x[..., 0] = 2.5  # a column of zero variance: _safe_std maps it to 1
    out, tout, jg, tg = _vjp_both(lambda x_: jpp.apply(spec, x_),
                                  lambda x_: pp.apply(spec, x_), (x,))
    _close(tout, out)
    _close(tg[0], jg[0])
    assert np.isfinite(tg[0].numpy()).all()
    ref_it = jpp.output_type(spec, JIT(**it.to_dict()))
    assert pp.output_type(spec, it).to_dict() == ref_it.to_dict()


def test_binomial_sampling_is_seeded_and_straight_through():
    x = torch.rand(64, 8, requires_grad=True)
    a, b = pp.apply("binomial_sampling:7", x), pp.apply("binomial_sampling:7", x)
    assert torch.equal(a, b) and set(a.unique().tolist()) <= {0.0, 1.0}
    assert not torch.equal(a, pp.apply("binomial_sampling:8", x))
    (g,) = torch.autograd.grad(a.sum(), x)
    assert torch.equal(g, torch.ones_like(x))
    assert pp.output_type("binomial_sampling", InputType.feed_forward(8)) == \
        InputType.feed_forward(8)


def test_kinds_not_ported_raise():
    # image sequences (cnn_seq) are ported: a rank-4 reshape gives one
    assert pp.output_type("reshape:2,3,2,5", InputType.feed_forward(60)) == \
        InputType.recurrent_convolutional(3, 2, 5, 2)
    # cnn3d is ported: a volume flattens as the reference's does
    assert InputType.convolutional3d(2, 3, 4, 1).flat_size() == \
        JIT.convolutional3d(2, 3, 4, 1).flat_size() == 24
    with pytest.raises(ValueError, match="unknown InputType kind"):
        InputType(kind="cnn4d")
    with pytest.raises(ValueError, match="unknown preprocessor"):
        pp.apply("nope", torch.zeros(2, 2))


def _explicit_spec_net(pkg_layers, builder, input_type, dense, out):
    conv, pool = pkg_layers
    return (builder.seed(5).list()
            .input_pre_processor(0, "ff_to_cnn:6,5,2")
            .layer(conv(n_out=3, kernel_size=(3, 2), activation="relu"))
            .layer(pool(pooling_type="avg", kernel_size=(2, 2), stride=(1, 1)))
            .input_pre_processor(2, "cnn_to_ff|standardize")
            .layer(dense(n_out=7, activation="tanh"))
            .layer(out(n_out=4))
            .set_input_type(input_type).build())


def test_explicit_preprocessors_in_a_network():
    """``input_pre_processor`` overrides the inferred reshape; the net's
    output and shapes match the reference's."""
    jconf = _explicit_spec_net((JConv, JPool), JNNC.builder(),
                               JIT.feed_forward(60), JDense, JOut)
    tconf = _explicit_spec_net((ConvolutionLayer, SubsamplingLayer),
                               NeuralNetConfiguration.builder(),
                               InputType.feed_forward(60), DenseLayer, OutputLayer)
    assert [l.n_in for l in tconf.layers if hasattr(l, "n_in")] == \
        [l.n_in for l in jconf.layers if hasattr(l, "n_in")]
    jnet = JaxMLN(jconf)
    jnet.init()
    net = load_reference_params(MultiLayerNetwork(tconf, device="cpu").init(),
                                jax.tree_util.tree_map(np.asarray, jnet.params))
    x = np.random.default_rng(4).standard_normal((5, 60)).astype(np.float32)
    _close(net.output(x), jnet.output(x))
