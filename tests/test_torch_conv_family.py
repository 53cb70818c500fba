"""The rest of the port's convolution family against the JAX package's.

``Convolution1DLayer``, ``Deconvolution2DLayer``,
``DepthwiseConvolution2DLayer``, ``SeparableConvolution2DLayer``,
``ZeroPadding1DLayer``, ``CropLayer``, ``SpaceToDepthLayer``,
``SpaceToBatchLayer``, ``UpsamplingLayer``, ``Upsampling1DLayer`` and
``Subsampling1DLayer``, each on the same numpy inputs and weights in both
packages: the forward within 1e-6 and, through one random cotangent, the
gradients of the input and of every parameter within 1e-5 (``jax.vjp``
on the reference's side), each times max(1, the largest entry of the
reference's result); float32 both ways, where ``F.conv2d`` sums its
windows in another order than XLA's convolution. The images are neither
square nor symmetric, and the kernels not square, so a transposed axis
or a channel order fails. Each layer's ``output_type`` equals the
reference's and its configuration JSON reads both ways.

The transposed convolution's cases cover strides 1 to 3, padding past
``k - 1`` (a crop of the full output) and "same" mode at an odd and an
even total padding on the two axes of one kernel, which the reference
splits ``tot // 2`` low and the rest high. Then the two networks the
card phase trains, at a small size: a 1-D one (``Convolution1DLayer``,
``ZeroPadding1DLayer``, ``Subsampling1DLayer``, ``Upsampling1DLayer``,
``MaskLayer``, ``RnnLossLayer``, with a step mask) and a 2-D one (the 2-D
layers above into a ``CnnLossLayer``), from the same weights: the
``output``, the score and 3 Adam steps (parameters and both moments)
match the reference's.
"""

import itertools
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import base as jbase
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import base as tbase
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    export_updater_state,
    load_reference_params,
)

FWD_TOL, GRAD_TOL, STEP_TOL = 1e-6, 1e-5, 1e-5
H, W, CIN, N, T = 11, 9, 3, 2, 11
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


def jax_init(net_cls, conf):
    """The JAX network of ``conf``, initialized with its normal and
    uniform draws taken from numpy (seeded): ``jax.random`` compiles a
    draw for every new shape, which is most of the cost of a reference
    init on the CPU, and any weights serve for parity."""
    rng = np.random.default_rng(11)

    def normal(key, shape=(), dtype=np.float32):
        return jnp.asarray(rng.standard_normal(tuple(shape)), dtype)

    def uniform(key, shape=(), dtype=np.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(rng.uniform(minval, maxval, tuple(shape)), dtype)

    with mock.patch.object(jax.random, "normal", normal), \
            mock.patch.object(jax.random, "uniform", uniform):
        return net_cls(conf).init()


def _close(got, ref, tol):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _json(d):
    return json.loads(json.dumps(d))


def check_layer(jl, tl, x, it_j, it_t, seed=0):
    """Shapes, forward, gradients, output type and JSON of one layer pair
    on input ``x`` (numpy) with random parameters of the reference's
    shapes."""
    jl.set_n_in(it_j)
    tl.set_n_in(it_t)
    assert tl.param_shapes() == jl.param_shapes()
    rng = np.random.default_rng(seed)
    names = sorted(jl.param_shapes())
    ps = [(0.5 * rng.standard_normal(jl.param_shapes()[n])).astype(np.float32)
          for n in names]
    y_shape = jax.eval_shape(lambda x_, *p: jl.forward(dict(zip(names, p)), x_)[0],
                             x, *ps).shape
    cot = rng.standard_normal(y_shape).astype(np.float32)

    @jax.jit
    def reference(x_, cot_, *p):  # one compile, where op by op is several
        out, pull = jax.vjp(lambda *a: jl.forward(dict(zip(names, a[1:])), a[0])[0],
                            x_, *p)
        return out, pull(cot_)

    out, jgrads = reference(x, cot, *ps)
    leaves = [torch.tensor(a, requires_grad=True) for a in [x, *ps]]
    tout = tl.forward(dict(zip(names, leaves[1:])), leaves[0])
    tgrads = torch.autograd.grad(tout, leaves, torch.from_numpy(cot))
    _close(tout, out, FWD_TOL)
    for got, ref in zip(tgrads, jgrads):
        _close(got, ref, GRAD_TOL)
    assert _json(tl.output_type(it_t).to_dict()) == \
        _json(jl.output_type(it_j).to_dict())
    assert tuple(tout.shape)[1:] == tl.output_type(it_t).batch_shape(1)[1:]
    from_ref = tbase.layer_from_dict(_json(jl.to_dict()))
    from_port = jbase.layer_from_dict(_json(tl.to_dict()))
    assert type(from_ref) is type(tl) and type(from_port) is type(jl)
    assert _json(from_ref.to_dict()) == _json(tl.to_dict()) == _json(jl.to_dict())
    assert _json(from_port.to_dict()) == _json(jl.to_dict())


def _images(seed=1, h=H, w=W, c=CIN, n=N):
    return np.random.default_rng(seed).standard_normal((n, h, w, c)).astype(np.float32)


def _seq(seed=2, t=T, c=CIN, n=N):
    return np.random.default_rng(seed).standard_normal((n, t, c)).astype(np.float32)


def _cnn(h=H, w=W, c=CIN):
    return JIT.convolutional(h, w, c), InputType.convolutional(h, w, c)


def _rnn(t=T, c=CIN):
    return JIT.recurrent(c, t), InputType.recurrent1d(c, t)


# --------------------------------------------------------------- 1-D layers
CONV1D_CASES = [("truncate", 1, 0, 1), ("truncate", 2, 1, 1), ("truncate", 1, 2, 2),
                ("same", 1, 0, 1), ("same", 2, 0, 1), ("same", 1, 0, 2)]


@pytest.mark.parametrize("mode,stride,padding,dilation", CONV1D_CASES)
def test_convolution1d(mode, stride, padding, dilation):
    kw = dict(n_out=4, kernel_size=3, stride=stride, padding=padding,
              dilation=dilation, convolution_mode=mode, activation="tanh")
    check_layer(JL.Convolution1DLayer(**kw), L.Convolution1DLayer(**kw), _seq(),
                *_rnn())


POOL1D_CASES = list(itertools.product(("max", "avg", "sum", "pnorm"),
                                      ("truncate", "same")))


@pytest.mark.parametrize("pooling,mode", POOL1D_CASES)
def test_subsampling1d(pooling, mode):
    kw = dict(pooling_type=pooling, kernel_size=3, stride=2, padding=1,
              convolution_mode=mode, pnorm=3)
    check_layer(JL.Subsampling1DLayer(**kw), L.Subsampling1DLayer(**kw), _seq(),
                *_rnn())


@pytest.mark.parametrize("layer,kw", [
    ("ZeroPadding1DLayer", dict(padding=(1, 3))),
    ("ZeroPadding1DLayer", dict(padding=(0, 2))),
    ("Upsampling1DLayer", dict(size=3)),
])
def test_padding_and_upsampling1d(layer, kw):
    check_layer(getattr(JL, layer)(**kw), getattr(L, layer)(**kw), _seq(), *_rnn())


# ------------------------------------------------ transposed convolution
DECONV_CASES = (list(itertools.product(("truncate",), (1, 2, 3), (0, 1, 2)))
                + list(itertools.product(("same",), (1, 2, 3), (0,))))


@pytest.mark.parametrize("mode,stride,padding", DECONV_CASES)
def test_deconvolution2d(mode, stride, padding):
    """Kernel (3, 2): in "same" mode the total padding ``s + k - 2`` is
    odd on one axis and even on the other, at every stride."""
    kw = dict(n_out=4, kernel_size=(3, 2), stride=(stride, stride),
              padding=(padding, padding), convolution_mode=mode,
              activation="tanh")
    check_layer(JL.Deconvolution2DLayer(**kw), L.Deconvolution2DLayer(**kw),
                _images(h=5, w=4), *_cnn(5, 4))


# ---------------------------------------- depthwise and separable convolution
GROUPED_CASES = [(1, "truncate", 1, 0), (2, "same", 2, 0), (2, "truncate", 2, 1),
                 (3, "same", 1, 0)]


@pytest.mark.parametrize("dm,mode,stride,padding", GROUPED_CASES)
def test_depthwise_convolution2d(dm, mode, stride, padding):
    kw = dict(depth_multiplier=dm, kernel_size=(3, 2), stride=(stride, stride),
              padding=(padding, padding), convolution_mode=mode,
              activation="identity")
    check_layer(JL.DepthwiseConvolution2DLayer(**kw),
                L.DepthwiseConvolution2DLayer(**kw), _images(), *_cnn())


@pytest.mark.parametrize("dm,mode,stride,padding", GROUPED_CASES)
def test_separable_convolution2d(dm, mode, stride, padding):
    kw = dict(n_out=5, depth_multiplier=dm, kernel_size=(3, 2),
              stride=(stride, stride), padding=(padding, padding),
              convolution_mode=mode, activation="sigmoid")
    check_layer(JL.SeparableConvolution2DLayer(**kw),
                L.SeparableConvolution2DLayer(**kw), _images(), *_cnn())


def test_depthwise_channel_order_is_feature_group_order():
    """Output channel g·dm + m is input channel g through filter m: with
    a kernel that is 1 at the centre for filter m and 0 elsewhere, output
    channel g·dm + m equals (m + 1) × input channel g."""
    dm = 2
    layer = L.DepthwiseConvolution2DLayer(n_in=CIN, depth_multiplier=dm,
                                          kernel_size=(1, 1), has_bias=False,
                                          activation="identity")
    w = torch.zeros((1, 1, 1, CIN * dm))
    for g in range(CIN):
        for m in range(dm):
            w[0, 0, 0, g * dm + m] = m + 1
    x = torch.from_numpy(_images())
    y = layer.forward({"W": w}, x)
    for g in range(CIN):
        for m in range(dm):
            assert torch.equal(y[..., g * dm + m], (m + 1) * x[..., g])


# ---------------------------------------------- crops, blocks, upsampling
@pytest.mark.parametrize("layer,kw,h,w", [
    ("CropLayer", dict(crop=(1, 2, 0, 3)), H, W),
    ("CropLayer", dict(crop=(2, 1)), H, W),
    ("SpaceToDepthLayer", dict(block_size=2), 8, 6),
    ("SpaceToDepthLayer", dict(block_size=3), 6, 9),
    ("SpaceToBatchLayer", dict(blocks=(2, 3), padding=(1, 0, 0, 3)), 7, 6),
    ("SpaceToBatchLayer", dict(blocks=(2, 2), padding=(1, 1)), 8, 6),
    ("UpsamplingLayer", dict(size=(2, 3)), H, W),
    ("UpsamplingLayer", dict(size=2), H, W),
])
def test_reshaping_layers(layer, kw, h, w):
    check_layer(getattr(JL, layer)(**kw), getattr(L, layer)(**kw),
                _images(h=h, w=w), *_cnn(h, w))


def test_space_to_depth_and_batch_orders():
    """The reference's orders, written out: channel (bi·b + bj)·C + c and
    batch (bi·bw + bj)·N + n, neither of which ``F.pixel_unshuffle``
    gives."""
    x = torch.arange(2 * 4 * 6 * 3, dtype=torch.float32).reshape(2, 4, 6, 3)
    y = L.SpaceToDepthLayer(block_size=2).forward({}, x)
    z = L.SpaceToBatchLayer(blocks=(2, 3)).forward({}, x)
    for bi, bj, c in itertools.product(range(2), range(2), range(3)):
        assert torch.equal(y[:, :, :, (bi * 2 + bj) * 3 + c], x[:, bi::2, bj::2, c])
    for bi, bj, n in itertools.product(range(2), range(3), range(2)):
        assert torch.equal(z[(bi * 3 + bj) * 2 + n], x[n, bi::2, bj::3])


# ------------------------------------------------ networks of these layers
def _conv1d_net(pkg, nnc, it, t_in=12):
    return (nnc.builder().seed(4).updater(pkg.Adam(1e-2)).list()
            .layer(pkg.L.Convolution1DLayer(n_out=6, kernel_size=5, activation="elu"))
            .layer(pkg.L.ZeroPadding1DLayer(padding=(2, 2)))
            .layer(pkg.L.Subsampling1DLayer(pooling_type="max", kernel_size=2, stride=2))
            .layer(pkg.L.Upsampling1DLayer(size=2))
            .layer(pkg.L.MaskLayer())
            .layer(pkg.L.Convolution1DLayer(n_out=4, kernel_size=1, activation="identity"))
            .layer(pkg.L.RnnLossLayer(loss="mcxent", activation="softmax"))
            .set_input_type(it.recurrent(3, t_in)).build())


def _conv2d_net(pkg, nnc, it):
    return (nnc.builder().seed(4).updater(pkg.Adam(1e-2)).list()
            .layer(pkg.L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                          convolution_mode="same", activation="relu6"))
            .layer(pkg.L.DepthwiseConvolution2DLayer(depth_multiplier=2, kernel_size=(3, 3),
                                                     convolution_mode="same",
                                                     activation="swish"))
            .layer(pkg.L.SeparableConvolution2DLayer(n_out=6, kernel_size=(3, 3),
                                                     convolution_mode="same",
                                                     activation="mish"))
            .layer(pkg.L.SpaceToDepthLayer(block_size=2))
            .layer(pkg.L.Deconvolution2DLayer(n_out=4, kernel_size=(2, 2), stride=(2, 2),
                                              activation="identity"))
            .layer(pkg.L.CropLayer(crop=(1, 1, 1, 1)))
            .layer(pkg.L.ZeroPaddingLayer(padding=(1, 1)))
            .layer(pkg.L.UpsamplingLayer(size=(2, 2)))
            .layer(pkg.L.ConvolutionLayer(n_out=3, kernel_size=(1, 1), activation="identity"))
            .layer(pkg.L.CnnLossLayer(loss="mcxent", activation="softmax"))
            .set_input_type(it.convolutional(8, 6, 2)).build())


class _Pkg:
    def __init__(self, layers, adam):
        self.L, self.Adam = layers, adam


JPKG, TPKG = _Pkg(JL, JAdam), _Pkg(L, Adam)


def _net_data(kind):
    rng = np.random.default_rng(8)
    if kind == "conv1d":
        x = rng.standard_normal((4, 12, 3)).astype(np.float32)
        y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (4, 12))]
        mask = np.ones((4, 12), np.float32)
        mask[1, 9:] = 0.0
        mask[3, 6:] = 0.0
        return x, y, mask
    x = rng.standard_normal((3, 8, 6, 2)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (3, 16, 12))]
    return x, y, None


@pytest.mark.parametrize("kind", ["conv1d", "conv2d"])
def test_network_of_the_family_matches_the_reference(kind):
    build = _conv1d_net if kind == "conv1d" else _conv2d_net
    jconf, conf = build(JPKG, JNNC, JIT), build(TPKG, NeuralNetConfiguration, InputType)
    assert conf.num_params() == jconf.num_params()
    jnet = jax_init(JMLN, jconf)
    net = load_reference_params(MultiLayerNetwork(conf, device="cpu").init(),
                                to_np(jnet.params))
    x, y, mask = _net_data(kind)
    _close(net.output(x, mask=mask), jnet.output(x, mask=mask), FWD_TOL)
    for _ in range(3):
        jnet.fit(x, y, features_mask=mask)
        net.fit(x, y, features_mask=mask)
        np.testing.assert_allclose(net.score_, float(jnet.score_), rtol=STEP_TOL)
    ref, ref_upd = to_np(jnet.params), to_np(jnet.updater_states)
    upd = export_updater_state(net)
    for i, named in enumerate(export_params(net)):
        for n, got in named.items():
            want = ref[i][n]
            np.testing.assert_allclose(got, want, rtol=0, err_msg=f"{i}/{n}",
                                       atol=STEP_TOL * np.abs(want).max())
            for slot, s in upd[i][n].items():
                want_s = np.asarray(ref_upd[i][n][slot])
                np.testing.assert_allclose(s, want_s, rtol=0, err_msg=f"{i}/{n}/{slot}",
                                           atol=STEP_TOL * max(np.abs(want_s).max(), 1e-30))
