"""Base layer class and registry.

Counterpart of ``deeplearning4j_tpu/nn/layers/base.py``. A layer is ONE
dataclass: hyperparameters (``None`` = inherit the network default), shape
inference (``set_n_in`` / ``output_type``), ``init_params`` returning a
dict of named tensors under the reference's names and layouts ("W", "b",
"gamma", ...), and ``forward(params, x, mask=None)``, a function of its
parameters and input, differentiable by autograd. Output layers
(``has_loss()``) also compute the network's loss.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn import activations as act_mod
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.weights import Distribution, init_weight

Params = Dict[str, torch.Tensor]

LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(cls):
    LAYER_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass
class Layer:
    """Common layer hyperparameters."""

    name: Optional[str] = None
    activation: Optional[Any] = None
    weight_init: Optional[str] = None
    distribution: Optional[Distribution] = None
    bias_init: Optional[float] = None
    updater: Optional[Any] = None
    bias_updater: Optional[Any] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    dtype: Optional[Any] = None

    def apply_global_defaults(self, g) -> None:
        """Inherit unset hyperparams from the global configuration."""
        for f in ("activation", "weight_init", "distribution", "bias_init",
                  "updater", "bias_updater", "l1", "l2", "l1_bias", "l2_bias",
                  "dtype"):
            if getattr(self, f) is None and getattr(g, f, None) is not None:
                setattr(self, f, getattr(g, f))

    # ---- shape inference --------------------------------------------------
    def set_n_in(self, input_type: InputType) -> None:
        """Infer input size from the previous layer's output type."""

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def input_preprocessor(self, input_type: InputType):
        """A ``(fn, new_input_type)`` reshape this layer needs in front of
        it, else None. The port's input kinds (ff, rnn) need none; the
        convolutional kinds come with the conv layers."""
        return None

    # ---- params ------------------------------------------------------------
    def init_params(self, gen: torch.Generator, dtype=torch.float32,
                    device=None) -> Params:
        return {}

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {}

    def num_params(self) -> int:
        return sum(int(math.prod(s)) for s in self.param_shapes().values())

    # ---- forward -----------------------------------------------------------
    def forward(self, params: Params, x: torch.Tensor, *,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    def act_fn(self):
        return act_mod.resolve(self.activation)

    def has_loss(self) -> bool:
        """Output-style layers compute the network loss."""
        return False

    def _init_w(self, gen, shape, fan_in, fan_out, dtype, device):
        scheme = self.weight_init or "xavier"
        return init_weight(gen, shape, scheme, fan_in, fan_out, dtype, device,
                           distribution=self.distribution)

    def _init_b(self, shape, dtype, device):
        return torch.full(shape, float(self.bias_init or 0.0), dtype=dtype,
                          device=device)
