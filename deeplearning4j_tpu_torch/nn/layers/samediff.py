"""SameDiff-style custom layers: ``SameDiffLayer`` and
``SameDiffLambdaLayer``.

Counterpart of ``deeplearning4j_tpu/nn/layers/samediff.py`` (DL4J's
``AbstractSameDiffLayer`` / ``SameDiffLayer`` and ``SameDiffLambdaLayer``):
a user subclasses, declares ``define_parameters`` and writes
``define_layer(params, x)`` in torch; autograd supplies the backward pass
and the layer runs inside both networks like any other. A parameter named
``b``, or a 1-D one whose name ends in ``b``, starts at zero; the others
take the layer's weight init with fan-in ``shape[0]`` and fan-out
``shape[-1]``. The forward draws nothing (no input dropout), as in the
reference.

A subclass registered with ``register_layer`` under the same class name
in both packages reads back from either package's JSON and model zip.
``SameDiffLambdaLayer.to_dict`` drops ``fn``: re-attach it after reading.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


@register_layer
@dataclasses.dataclass
class SameDiffLayer(Layer):
    """Subclass and override ``define_parameters`` and ``define_layer``::

        @register_layer
        @dataclasses.dataclass
        class MyLayer(SameDiffLayer):
            def define_parameters(self):
                return {"W": (self.n_in, self.n_out), "b": (self.n_out,)}
            def define_layer(self, params, x):
                return torch.tanh(x @ params["W"] + params["b"])
    """

    n_in: int = 0
    n_out: int = 0

    def set_n_in(self, input_type: InputType) -> None:
        if not self.n_in:
            self.n_in = input_type.flat_size()

    def output_type(self, input_type: InputType) -> InputType:
        if self.n_out:
            return InputType.feed_forward(self.n_out)
        return input_type

    # -- SPI ----------------------------------------------------------------
    def define_parameters(self) -> Dict[str, Tuple[int, ...]]:
        return {}

    def define_layer(self, params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # -- plumbing -----------------------------------------------------------
    def param_shapes(self):
        return self.define_parameters()

    def init_params(self, gen, dtype=torch.float32, device=None):
        out = {}
        for name, shape in self.define_parameters().items():
            shape = tuple(shape)
            if name == "b" or (len(shape) == 1 and name.endswith("b")):
                out[name] = torch.zeros(shape, dtype=dtype, device=device)
            else:
                fan_in = shape[0] if len(shape) >= 1 else 1
                fan_out = shape[-1] if len(shape) >= 2 else shape[0]
                out[name] = self._init_w(gen, shape, fan_in, fan_out, dtype, device)
        return out

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        return self.define_layer(params, x)


@register_layer
@dataclasses.dataclass
class SameDiffLambdaLayer(SameDiffLayer):
    """A parameterless layer wrapping a function of the input (DL4J
    ``SameDiffLambdaLayer``)."""

    fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def define_parameters(self):
        return {}

    def define_layer(self, params, x):
        return self.fn(x)

    def to_dict(self):
        d = super().to_dict()
        d.pop("fn", None)
        return d
