"""Output layers: the forward, and the loss the network trains on.

Counterpart of ``OutputLayer`` / ``RnnOutputLayer`` in
``deeplearning4j_tpu/nn/layers/output.py``: ``act(x @ W + b)``, softmax by
default, per timestep over a [N,T,C] sequence. ``compute_loss`` takes the
layer's INPUT and feeds the loss the pre-activation (logits) when the
loss's canonical activation is the layer's (softmax + MCXENT is one
fused, stable ``log_softmax``), as DL4J's ``BaseOutputLayer`` does.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn import losses as loss_mod
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import register_layer
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
