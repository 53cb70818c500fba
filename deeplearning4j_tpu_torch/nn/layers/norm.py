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
parameters and applies ``gamma_init``/``beta_init`` as constants. The
reference's single-pass bf16 moments wait for mixed precision.

LocalResponseNormalization is DL4J's: ``y = x / (k + alpha·Σ x²)^beta``
over a window of ``n`` channels (half-window ``n // 2``, zero-padded),
with ``alpha`` NOT divided by ``n`` as
``torch.nn.functional.local_response_norm`` divides it.

LayerNormalization normalizes over the last axis with the biased variance
and eps = 1e-3 (Keras's default, not torch's 1e-5).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


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
            mean = x.mean(dim=axes)
            d = x - mean
            var = torch.square(d).mean(dim=axes)  # two passes, biased
            new_state = {
                "mean": (self.decay * state["mean"]
                         + (1 - self.decay) * mean.detach().float()),
                "var": (self.decay * state["var"]
                        + (1 - self.decay) * var.detach().float()),
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
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, unbiased=False, keepdim=True)
        xhat = (x - mean) / torch.sqrt(var + self.eps)
        return self.act_fn()(xhat * params["gamma"] + params["beta"])
