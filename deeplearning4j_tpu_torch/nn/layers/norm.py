"""Normalization layers: BatchNormalization, LocalResponseNormalization and
LayerNormalization.

Counterpart of ``deeplearning4j_tpu/nn/layers/norm.py``.

BatchNormalization keeps DL4J's semantics and the reference's arithmetic.
Its running mean and variance are layer *state* (``init_state``), not
parameters: a train forward normalizes with the batch's moments and
returns the new running values, ``running = decay·running +
(1 − decay)·batch`` (``decay`` weighs the OLD value, the opposite of
torch's ``momentum``), which the network writes over the old ones once
per update. The variance is the BIASED one, computed in two passes (the
mean, then the mean of the squared deviations, whose tensor of deviations
the normalization reuses), as ``jnp.var`` does;
``F.batch_norm`` would feed the unbiased variance into the running value,
so it is not used. ``eps`` sits inside the square root. The moments run
over every axis but the last (NHWC images, ``[N, F]`` rows), the running
statistics stay float32 as in the reference, and the activation comes
after the affine step. With ``lock_gamma_beta`` the layer has no
parameters and applies ``gamma_init``/``beta_init`` as constants. A bf16
or f16 activation (mixed precision) takes the reference's single-pass
f32-accumulated moments (:func:`_lowp_moments`) and is normalized in its
own type; the running statistics stay float32.

LocalResponseNormalization is DL4J's: ``y = x / (k + alpha·Σ x²)^beta``
over a window of ``n`` channels (half-window ``n // 2``, zero-padded),
with ``alpha`` NOT divided by ``n`` as
``torch.nn.functional.local_response_norm`` divides it.

LayerNormalization normalizes over the last axis with the biased variance
and eps = 1e-3 (Keras's default, not torch's 1e-5); a bf16 or f16
activation takes :func:`_lowp_moments` too, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import dtensor as _dt
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer

LOW_PRECISION = (torch.bfloat16, torch.float16)


class _LowpMoments(torch.autograd.Function):
    """``(mean, var)`` of a low-precision tensor over ``dims``, both f32;
    saves only the input (in its own type) and the f32 mean."""

    @staticmethod
    def forward(ctx, x, dims, keepdim):
        cnt = math.prod(x.shape[d] for d in dims)
        mean = torch.sum(x, dim=dims, keepdim=keepdim, dtype=torch.float32) / cnt
        # the square in f32 (E[x²] − E[x]² needs its resolution; f16 would
        # overflow at |x| > 256); the widened copy is freed at once
        raw = torch.sum(x.float().square_(), dim=dims, keepdim=keepdim) / cnt
        raw = raw - torch.square(mean)
        ctx.save_for_backward(x, mean, raw > 0)
        ctx.dims, ctx.keepdim, ctx.cnt = dims, keepdim, cnt
        return mean, torch.clamp_min(raw, 0.0)

    @staticmethod
    def backward(ctx, g_mean, g_var):
        x, mean, positive = ctx.saved_tensors
        gv = torch.where(positive, g_var, 0.0)
        gm = g_mean - 2.0 * mean * gv  # var = E[x²] − mean²
        if not ctx.keepdim:
            for d in sorted(d % x.ndim for d in ctx.dims):
                gm, gv = gm.unsqueeze(d), gv.unsqueeze(d)
        # (gm + 2·gv·x) / cnt in f32, written once in x's type: the
        # operands meet in f32 inside the one kernel, with no f32 copy of x
        gx = torch.empty_like(x)
        torch.addcmul(gm / ctx.cnt, x, gv * (2.0 / ctx.cnt), out=gx)
        return gx, None, None


def _lowp_moments(x, dims, keepdim: bool = False):
    """f32-accumulated mean and biased variance of a bf16/f16 ``x`` over
    ``dims`` without keeping a widened copy of it, the reference's
    ``_lowp_moments`` (``deeplearning4j_tpu/nn/layers/norm.py:26-48``): the
    mean summed in f32, the square taken in f32, ``max(E[x²] − E[x]², 0)``.
    Both come back f32."""
    dims = tuple(dims) if isinstance(dims, (tuple, list)) else (dims,)
    return _LowpMoments.apply(x, dims, keepdim)


@register_layer
@dataclasses.dataclass
class BatchNormalizationLayer(Layer):
    """Batch norm over the channel/feature (last) axis (DL4J
    BatchNormalization)."""

    n_in: int = 0  # feature/channel count
    decay: float = 0.9
    eps: float = 1e-5
    is_minibatch: bool = True
    lock_gamma_beta: bool = False
    gamma_init: float = 1.0
    beta_init: float = 0.0

    def set_n_in(self, input_type: InputType) -> None:
        if not self.n_in:
            if input_type.kind == "cnn":
                self.n_in = input_type.channels
            else:
                self.n_in = input_type.flat_size()

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def param_shapes(self):
        if self.lock_gamma_beta:
            return {}
        return {"gamma": (self.n_in,), "beta": (self.n_in,)}

    def init_params(self, gen, dtype=torch.float32, device=None):
        if self.lock_gamma_beta:
            return {}
        return {"gamma": torch.full((self.n_in,), float(self.gamma_init),
                                    dtype=dtype, device=device),
                "beta": torch.full((self.n_in,), float(self.beta_init),
                                   dtype=dtype, device=device)}

    def init_state(self, device=None):
        return {"mean": torch.zeros((self.n_in,), dtype=torch.float32,
                                    device=device),
                "var": torch.ones((self.n_in,), dtype=torch.float32,
                                  device=device)}

    def forward_state(self, params, state, x, *, mask=None, train=False,
                      gen=None):
        if train:
            axes = tuple(range(x.ndim - 1))
            if x.dtype in LOW_PRECISION:
                # single pass, f32-accumulated; normalized in x's own type
                mean, var32 = _lowp_moments(x, axes)
                d = x - mean.to(x.dtype)
                var = var32.to(x.dtype)
            else:
                mean = _dt.mean(x, axes)
                d = x - mean
                # two passes, biased
                var = var32 = _dt.mean(torch.square(d), axes)
            new_state = {
                "mean": (self.decay * state["mean"]
                         + (1 - self.decay) * mean.detach().float()),
                "var": (self.decay * state["var"]
                        + (1 - self.decay) * var32.detach().float()),
            }
        else:
            d = x - state["mean"].to(x.dtype)
            var = state["var"].to(x.dtype)
            new_state = state
        xhat = d / torch.sqrt(var + self.eps)
        if not self.lock_gamma_beta:
            xhat = xhat * params["gamma"] + params["beta"]
        elif self.gamma_init != 1.0 or self.beta_init != 0.0:
            xhat = xhat * self.gamma_init + self.beta_init
        return self.act_fn()(xhat), new_state


@register_layer
@dataclasses.dataclass
class LocalResponseNormalizationLayer(Layer):
    """LRN across channels (DL4J LocalResponseNormalization)."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        n, c = int(self.n), x.shape[-1]
        half = n // 2
        padded = F.pad(x * x, (half, half))  # zeros on both sides of C
        win = sum(padded[..., i:i + c] for i in range(n))
        return x / (self.k + self.alpha * win) ** self.beta


@register_layer
@dataclasses.dataclass
class LayerNormalizationLayer(Layer):
    """Layer normalization over the last (feature) axis."""

    n_in: int = 0
    eps: float = 1e-3

    def set_n_in(self, input_type: InputType) -> None:
        if not self.n_in:
            self.n_in = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def param_shapes(self):
        return {"gamma": (self.n_in,), "beta": (self.n_in,)}

    def init_params(self, gen, dtype=torch.float32, device=None):
        return {"gamma": torch.ones((self.n_in,), dtype=dtype, device=device),
                "beta": torch.zeros((self.n_in,), dtype=dtype, device=device)}

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        if x.dtype in LOW_PRECISION:
            mean, var = _lowp_moments(x, -1, keepdim=True)
            xhat = ((x - mean.to(x.dtype))
                    * (1.0 / torch.sqrt(var + self.eps)).to(x.dtype))
        else:
            mean = x.mean(dim=-1, keepdim=True)
            var = x.var(dim=-1, unbiased=False, keepdim=True)
            xhat = (x - mean) / torch.sqrt(var + self.eps)
        return self.act_fn()(xhat * params["gamma"] + params["beta"])
