"""Denoising autoencoder layer (DL4J ``nn/conf/layers/AutoEncoder.java``).

Counterpart of ``deeplearning4j_tpu/nn/layers/autoencoder.py``. The
parameters are DL4J's ``PretrainParamInitializer``'s: ``W``, ``b`` (the
encoder) and ``vb`` (the visible bias; the decoder uses ``Wᵀ``). In a
network the forward is the encoder; ``pretrain_loss`` is the denoising
objective that layerwise pretraining minimizes: the input corrupted by
zeroing each entry with probability ``corruption_level`` (a keep mask
from ``nn/dropout.py``'s ``bernoulli``, as the reference's
``where(bernoulli(rng, 1 - level), x, 0)``), encoded, decoded, and the
layer's loss of the reconstruction against the clean input.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn import dropout as _dropout
from deeplearning4j_tpu_torch.nn import losses as loss_mod
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, matmul, register_layer


@register_layer
@dataclasses.dataclass
class AutoEncoderLayer(Layer):
    n_in: int = 0
    n_out: int = 0
    corruption_level: float = 0.3
    sparsity: float = 0.0
    loss: str = "mse"

    def __post_init__(self):
        if self.activation is None:
            self.activation = "sigmoid"

    def is_pretrain_layer(self) -> bool:
        return True

    def set_n_in(self, input_type: InputType) -> None:
        if not self.n_in:
            self.n_in = input_type.flat_size()

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,), "vb": (self.n_in,)}

    def init_params(self, gen, dtype=torch.float32, device=None):
        return {
            "W": self._init_w(gen, (self.n_in, self.n_out), self.n_in, self.n_out,
                              dtype, device),
            "b": self._init_b((self.n_out,), dtype, device),
            "vb": torch.zeros((self.n_in,), dtype=dtype, device=device),
        }

    def encode(self, params, x):
        return self.act_fn()(matmul(x, params["W"]) + params["b"])

    def decode(self, params, h):
        return self.act_fn()(matmul(h, params["W"].T) + params["vb"])

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        return self.encode(params, x)

    def pretrain_loss(self, params, x, gen: Optional[torch.Generator]):
        """The loss of the reconstruction of the corrupted input (corrupted
        only with a generator and a positive ``corruption_level``)."""
        if self.corruption_level > 0 and gen is not None:
            keep = _dropout.bernoulli(1.0 - self.corruption_level, x.shape, gen,
                                      x.device)
            corrupted = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
        else:
            corrupted = x
        recon = self.decode(params, self.encode(params, corrupted))
        fn, _ = loss_mod.resolve(self.loss, None)
        return fn(x, recon)
