"""The CNN layers that came with ResNet-50, in the port against the JAX
package: LocalResponseNormalization (within 1e-6; DL4J's ``alpha`` is not
divided by ``n`` as ``F.local_response_norm`` divides it), ZeroPadding
(exact), GlobalPooling (max, avg, sum and pnorm over images and
sequences, with and without a sequence mask, within 1e-6, and the
gradient of each beside ``jax.vjp``'s), ActivationLayer, their output
types and their configuration JSON both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.layers import ActivationLayer as JAct
from deeplearning4j_tpu.nn.layers import GlobalPoolingLayer as JGP
from deeplearning4j_tpu.nn.layers import LocalResponseNormalizationLayer as JLRN
from deeplearning4j_tpu.nn.layers import ZeroPaddingLayer as JZP
from deeplearning4j_tpu.nn.layers.base import layer_from_dict as j_from_dict
from deeplearning4j_tpu_torch.nn.conf import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer,
    GlobalPoolingLayer,
    LocalResponseNormalizationLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.base import layer_from_dict

TOL = 1e-6


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _serde(jl, tl):
    assert tl.to_dict() == jl.to_dict()
    assert layer_from_dict(jl.to_dict()) == tl
    assert j_from_dict(tl.to_dict()) == jl


@pytest.mark.parametrize("kw", [{}, {"k": 1.0, "n": 3, "alpha": 0.5, "beta": 0.6}],
                         ids=["defaults", "alexnet_like"])
def test_lrn_matches_reference(kw):
    x = 3.0 * _x((2, 4, 5, 7))
    jl, tl = JLRN(**kw), LocalResponseNormalizationLayer(**kw)
    got = tl.forward({}, torch.from_numpy(x))
    _close(got, jl.forward({}, x)[0])
    _serde(jl, tl)
    # torch's own LRN divides alpha by n: a different function
    n = kw.get("n", 5)
    theirs = F.local_response_norm(torch.from_numpy(x).permute(0, 3, 1, 2), n,
                                   alpha=kw.get("alpha", 1e-4), beta=kw.get("beta", 0.75),
                                   k=kw.get("k", 2.0)).permute(0, 2, 3, 1)
    assert not torch.allclose(theirs, got, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("padding", [(2, 1), (1, 0, 3, 2)], ids=["hw", "tblr"])
def test_zero_padding_is_exact(padding):
    x = _x((2, 4, 5, 3))
    jl, tl = JZP(padding=padding), ZeroPaddingLayer(padding=padding)
    got = tl.forward({}, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jl.forward({}, x)[0]))
    it = JIT.convolutional(4, 5, 3)
    assert tl.output_type(InputType.convolutional(4, 5, 3)).to_dict() == \
        jl.output_type(it).to_dict()
    _serde(jl, tl)


POOLS = ["max", "avg", "sum", "pnorm"]
MASK = np.array([[1, 1, 0, 0, 0, 0], [1, 1, 1, 1, 1, 1], [1, 1, 1, 1, 0, 0]],
                np.float32)


@pytest.mark.parametrize("pt", POOLS)
@pytest.mark.parametrize("kind", ["cnn", "rnn", "rnn_masked"])
def test_global_pooling_matches_reference(pt, kind):
    x = _x((3, 4, 5, 2) if kind == "cnn" else (3, 6, 4), seed=1)
    mask = MASK if kind == "rnn_masked" else None
    kw = {"pooling_type": pt, "pnorm": 3} if pt == "pnorm" else {"pooling_type": pt}
    jl, tl = JGP(**kw), GlobalPoolingLayer(**kw)

    def jf(a):
        return jl.forward({}, a, mask=None if mask is None else jnp.asarray(mask))[0]

    want, vjp = jax.vjp(jf, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tl.forward({}, xt, mask=None if mask is None else torch.from_numpy(mask))
    _close(got.detach(), want)
    dy = _x(tuple(got.shape), seed=2)
    (gt,) = torch.autograd.grad(got, xt, torch.from_numpy(dy))
    _close(gt, vjp(jnp.asarray(dy))[0], 1e-5)
    it = (JIT.convolutional(4, 5, 2) if kind == "cnn" else JIT.recurrent(4, 6))
    assert tl.output_type(InputType.from_dict(it.to_dict())).to_dict() == \
        jl.output_type(it).to_dict()
    _serde(jl, tl)


def test_activation_layer_matches_reference():
    x = _x((3, 5))
    for act in ("relu", "tanh", "sigmoid", "softmax"):
        jl, tl = JAct(activation=act), ActivationLayer(activation=act)
        _close(tl.forward({}, torch.from_numpy(x)), jl.forward({}, x)[0])
        _serde(jl, tl)
