"""Layer wrappers: ``FrozenLayer`` and ``TimeDistributedWrapper``.

Counterpart of ``deeplearning4j_tpu/nn/layers/wrappers.py``.

``FrozenLayer`` (``nn/conf/layers/misc/FrozenLayer.java``) runs its inner
layer on detached parameters (the reference's ``stop_gradient``), so
their gradients are exactly 0. As in the reference the updater still
runs on those zeros: from a zero Adam state the tensors stay bit for bit
where they are, while an Adam state carried in (a zip) still moves them,
and every frozen tensor counts in the fused updater's launches. The
wrapper keeps its own hyperparameters unset (only the inner layer
inherits the network's defaults), so its tensors take no l1/l2 and the
network's updater.

``TimeDistributedWrapper`` applies its inner layer at every step of a
sequence by folding time into the batch: ``[N, T, ...]`` to ``[N·T,
...]``, the inner forward, and back. The inner forward sees no mask, as
in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


def _frozen(params):
    return {n: t.detach() for n, t in params.items()}


@register_layer
@dataclasses.dataclass
class FrozenLayer(Layer):
    layer: Optional[Layer] = None

    def set_n_in(self, input_type: InputType) -> None:
        self.layer.set_n_in(input_type)

    def output_type(self, input_type: InputType) -> InputType:
        return self.layer.output_type(input_type)

    def input_preprocessor(self, input_type: InputType):
        return self.layer.input_preprocessor(input_type)

    def apply_global_defaults(self, g):
        # the wrapper inherits nothing: only the inner layer takes defaults
        if self.layer is not None:
            self.layer.apply_global_defaults(g)

    def param_shapes(self):
        return self.layer.param_shapes()

    def init_params(self, gen, dtype=torch.float32, device=None):
        return self.layer.init_params(gen, dtype, device)

    def init_state(self, device=None):
        return self.layer.init_state(device)

    def has_loss(self):
        return self.layer.has_loss()

    def compute_loss(self, params, x, labels, mask=None):
        return self.layer.compute_loss(_frozen(params), x, labels, mask=mask)

    def forward_state(self, params, state, x, *, mask=None, train=False, gen=None):
        return self.layer.forward_state(_frozen(params), state, x, mask=mask,
                                        train=train, gen=gen)

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        return self.layer.forward(_frozen(params), x, mask=mask, train=train, gen=gen)


@register_layer
@dataclasses.dataclass
class TimeDistributedWrapper(Layer):
    """The inner layer at every step: ``[N, T, ...]`` folded to ``[N·T,
    ...]`` (Keras ``TimeDistributed``), for inner layers that are not
    position-wise (convolutions and pooling over image sequences)."""

    layer: Optional[Layer] = None

    @staticmethod
    def _inner_type(input_type: InputType) -> InputType:
        if input_type.kind == "cnn_seq":
            return InputType.convolutional(input_type.height, input_type.width,
                                           input_type.channels)
        if input_type.kind == "rnn":
            return InputType.feed_forward(input_type.size)
        raise ValueError(
            f"TimeDistributed expects sequence input, got {input_type.kind!r}")

    def set_n_in(self, input_type: InputType) -> None:
        self.layer.set_n_in(self._inner_type(input_type))

    def output_type(self, input_type: InputType) -> InputType:
        inner = self.layer.output_type(self._inner_type(input_type))
        t = input_type.timesteps
        if inner.kind == "cnn":
            return InputType.recurrent_convolutional(inner.height, inner.width,
                                                     inner.channels, t)
        return InputType.recurrent(inner.flat_size(), t)

    def apply_global_defaults(self, g):
        super().apply_global_defaults(g)
        if self.layer is not None:
            self.layer.apply_global_defaults(g)

    def param_shapes(self):
        return self.layer.param_shapes()

    def init_params(self, gen, dtype=torch.float32, device=None):
        return self.layer.init_params(gen, dtype, device)

    def init_state(self, device=None):
        return self.layer.init_state(device)

    def forward_state(self, params, state, x, *, mask=None, train=False, gen=None):
        n, t = x.shape[:2]
        y, new_state = self.layer.forward_state(
            params, state, x.reshape((n * t,) + tuple(x.shape[2:])), train=train,
            gen=gen)
        return y.reshape((n, t) + tuple(y.shape[1:])), new_state

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        n, t = x.shape[:2]
        y = self.layer.forward(params, x.reshape((n * t,) + tuple(x.shape[2:])),
                               train=train, gen=gen)
        return y.reshape((n, t) + tuple(y.shape[1:]))
