"""Output and loss layers: the forward, and the loss the network trains on.

Counterpart of ``deeplearning4j_tpu/nn/layers/output.py``. ``OutputLayer``
is ``act(x @ W + b)``, softmax by default, per timestep over a [N,T,C]
sequence (``RnnOutputLayer``). ``LossLayer`` has no parameters and
identity as its default activation; ``RnnLossLayer`` is the same over a
sequence and ``CnnLossLayer`` scores each pixel of an NHWC map, its mask
broadcast over H and W. ``CenterLossOutputLayer`` adds ``lambda_`` times
half the mean squared distance of each example's input from its class
centre (the rows of ``cL``); the centres learn by gradient, as in the
reference (``alpha`` is carried for the configuration). ``compute_loss``
takes the layer's INPUT and feeds the loss the pre-activation (logits)
when the loss's canonical activation is the layer's (softmax + MCXENT is
one fused, stable ``log_softmax``), as DL4J's ``BaseOutputLayer`` does.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn import losses as loss_mod
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, matmul, register_layer
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer


@register_layer
@dataclasses.dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head. Default MCXENT+softmax."""

    loss: str = "mcxent"

    def __post_init__(self):
        if self.activation is None:
            self.activation = "softmax"

    def has_loss(self) -> bool:
        return True

    def compute_loss(self, params, x, labels, mask=None):
        """Loss from this layer's INPUT activations (pre-dense)."""
        pre = self._preact(params, x)
        fn, wants_logits = loss_mod.resolve(self.loss, self.activation)
        out = pre if wants_logits else self.act_fn()(pre)
        return fn(labels, out, mask=mask)


@register_layer
@dataclasses.dataclass
class RnnOutputLayer(OutputLayer):
    """Per-timestep dense + loss head over [N,T,*]; per-timestep masks are
    honoured in the loss mean."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def set_n_in(self, input_type: InputType) -> None:
        if not self.n_in:
            self.n_in = input_type.size


@register_layer
@dataclasses.dataclass
class LossLayer(Layer):
    """The loss alone, no parameters (DL4J LossLayer)."""

    loss: str = "mcxent"

    def __post_init__(self):
        if self.activation is None:
            self.activation = "identity"

    def has_loss(self) -> bool:
        return True

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        return self.act_fn()(x)

    def _scored(self, x):
        fn, wants_logits = loss_mod.resolve(self.loss, self.activation)
        return fn, (x if wants_logits else self.act_fn()(x))

    def compute_loss(self, params, x, labels, mask=None):
        fn, out = self._scored(x)
        return fn(labels, out, mask=mask)


@register_layer
@dataclasses.dataclass
class RnnLossLayer(LossLayer):
    """The loss per timestep over [N,T,*] (DL4J RnnLossLayer)."""


@register_layer
@dataclasses.dataclass
class CnnLossLayer(LossLayer):
    """The loss per pixel over NHWC maps (DL4J CnnLossLayer): the feature
    axis is the channels, and the mask broadcasts over H and W."""

    def compute_loss(self, params, x, labels, mask=None):
        fn, out = self._scored(x)
        n = out.shape[0]
        out2 = out.reshape(n, -1, out.shape[-1])
        lab2 = labels.reshape(n, -1, labels.shape[-1])
        m2 = None if mask is None else mask.reshape(n, -1)
        return fn(lab2, out2, mask=m2)


@register_layer
@dataclasses.dataclass
class CenterLossOutputLayer(OutputLayer):
    """An output layer with the centre loss (DL4J CenterLossOutputLayer):
    ``cL`` holds a centre per class, ``[n_out, n_in]``, initialised to
    zeros."""

    alpha: float = 0.05
    lambda_: float = 2e-4

    def param_shapes(self):
        shapes = super().param_shapes()
        shapes["cL"] = (self.n_out, self.n_in)
        return shapes

    def init_params(self, gen, dtype=torch.float32, device=None):
        p = super().init_params(gen, dtype, device)
        p["cL"] = torch.zeros((self.n_out, self.n_in), dtype=dtype, device=device)
        return p

    def compute_loss(self, params, x, labels, mask=None):
        base = super().compute_loss(params, x, labels, mask)
        centers = matmul(labels, params["cL"])  # one-hot labels pick centres
        center_l = 0.5 * torch.mean(torch.sum((x - centers) ** 2, dim=-1))
        return base + self.lambda_ * center_l
