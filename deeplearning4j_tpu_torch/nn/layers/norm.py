"""Layer normalization.

Counterpart of ``LayerNormalizationLayer`` in
``deeplearning4j_tpu/nn/layers/norm.py``: normalization over the last axis
with the BIASED variance (``jnp.var``; torch's ``var`` defaults to the
unbiased one) and eps = 1e-3 (Keras's default, not torch's 1e-5).
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


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
