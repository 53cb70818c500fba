"""Base layer class and registry.

Counterpart of ``deeplearning4j_tpu/nn/layers/base.py``. A layer is ONE
dataclass: hyperparameters (``None`` = inherit the network default), shape
inference (``set_n_in`` / ``output_type``), ``init_params`` returning a
dict of named tensors under the reference's names and layouts ("W", "b",
"gamma", ...), and ``forward(params, x, mask=None)``, a function of its
parameters and input, differentiable by autograd. Output layers
(``has_loss()``) also compute the network's loss.

Layer state: a layer may also keep non-trainable tensors
(``init_state``; BatchNorm's running mean and variance, empty for every
other layer). The networks run each layer through
``forward_state(params, state, x)``, which returns ``(y, new_state)``: a
stateless layer's is its ``forward`` and its state unchanged; a stateful
one's train forward returns the new state, which the network writes over
the old once per update. States take no gradient and no updater.

The regularizer fields are the reference's: ``dropout`` (a float keep
probability or an ``IDropout``, ``nn/dropout.py``) applied by
:meth:`Layer._dropout` to a layer's input when its forward runs with
``train=True`` and a generator; ``weight_noise`` (``nn/weightnoise.py``)
and ``constraints`` (``nn/constraints.py``), which the networks apply
around a layer's forward and after its update; ``gradient_normalization``
and its threshold (``nn/updaters.py`` ``normalize_gradients``). Each is
inherited from the network's defaults when unset.

``to_dict`` / ``layer_from_dict`` are the reference's serde: the same keys
and ``@layer``, ``@dropout``, ``@weight_noise``, ``@constraint`` and
``@recon`` (a VAE's reconstruction distribution, nested for a composite)
tags, so a configuration's JSON reads back in both packages.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn import activations as act_mod
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.constraints import (
    LayerConstraint,
    constraints_from_config,
)
from deeplearning4j_tpu_torch.nn.dropout import IDropout, resolve_dropout
from deeplearning4j_tpu_torch.nn.dtensor import column_input, reduce_partial
from deeplearning4j_tpu_torch.nn.updaters import Schedule, Updater
from deeplearning4j_tpu_torch.nn.weightnoise import IWeightNoise
from deeplearning4j_tpu_torch.nn.weights import Distribution, init_weight

Params = Dict[str, torch.Tensor]

LAYER_REGISTRY: Dict[str, type] = {}


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's type promotion: two float types meet in the
    wider one (an f32 recurrent carry against a bf16 weight under mixed
    precision, as ``jnp.matmul`` promotes), one type multiplies as is. A
    product of DTensors that comes out ``Partial`` (a row-parallel split)
    is reduced to ``Replicate``."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    # a row-parallel product (DTensors) is reduced here: one all-reduce,
    # and what follows sees it replicated over the model axis
    return reduce_partial(column_input(a, b) @ b)


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
    dropout: Optional[Any] = None  # float keep probability or IDropout
    weight_noise: Optional[Any] = None  # IWeightNoise
    constraints: Optional[list] = None  # LayerConstraint list
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    dtype: Optional[Any] = None

    def apply_global_defaults(self, g) -> None:
        """Inherit unset hyperparams from the global configuration; the
        builder's constraints become scoped copies on the layer."""
        for f in ("activation", "weight_init", "distribution", "bias_init",
                  "updater", "bias_updater", "l1", "l2", "l1_bias", "l2_bias",
                  "dropout", "weight_noise", "gradient_normalization", "dtype"):
            if getattr(self, f) is None and getattr(g, f, None) is not None:
                setattr(self, f, getattr(g, f))
        if self.gradient_normalization_threshold == 1.0 and \
                getattr(g, "gradient_normalization_threshold", 1.0) != 1.0:
            self.gradient_normalization_threshold = g.gradient_normalization_threshold
        if self.constraints is None:
            cs = ([c.scoped("all") for c in getattr(g, "all_constraints", None) or ()]
                  + [c.scoped("weights") for c in getattr(g, "weight_constraints", None) or ()]
                  + [c.scoped("bias") for c in getattr(g, "bias_constraints", None) or ()])
            if cs:
                self.constraints = cs

    # ---- shape inference --------------------------------------------------
    def set_n_in(self, input_type: InputType) -> None:
        """Infer input size from the previous layer's output type."""

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def input_preprocessor(self, input_type: InputType):
        """A ``(fn, new_input_type)`` reshape this layer needs in front of
        it (DL4J's automatic CnnToFeedForward etc.), else None."""
        return None

    # ---- params ------------------------------------------------------------
    def init_params(self, gen: torch.Generator, dtype=torch.float32,
                    device=None) -> Params:
        return {}

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {}

    def num_params(self) -> int:
        return sum(int(math.prod(s)) for s in self.param_shapes().values())

    def init_state(self, device=None) -> Params:
        """Non-trainable tensors of the layer, by name (float32, as the
        reference keeps them); empty for a stateless layer."""
        return {}

    # ---- forward -----------------------------------------------------------
    def forward_state(self, params: Params, state: Params, x: torch.Tensor, *,
                      mask: Optional[torch.Tensor] = None, train: bool = False,
                      gen: Optional[torch.Generator] = None):
        """``(y, new_state)``. A stateless layer returns :meth:`forward`'s
        output and ``state`` as it is."""
        return self.forward(params, x, mask=mask, train=train, gen=gen), state

    def forward(self, params: Params, x: torch.Tensor, *,
                mask: Optional[torch.Tensor] = None, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """``train`` with a generator ``gen`` turns on the layer's
        train-time noise; inference passes neither."""
        raise NotImplementedError

    def act_fn(self):
        return act_mod.resolve(self.activation)

    def _dropout(self, x: torch.Tensor, train: bool,
                 gen: Optional[torch.Generator]) -> torch.Tensor:
        """DL4J's input dropout: a float is the keep probability (inverted
        dropout); an IDropout applies itself."""
        if not train or self.dropout is None or gen is None:
            return x
        d = resolve_dropout(self.dropout)
        return x if d is None else d.apply(x, gen, train)

    def weight_param_names(self) -> Tuple[str, ...]:
        """The parameters that count as weights (weight noise, the
        "weights" constraint scope)."""
        return tuple(n for n in self.param_shapes()
                     if n not in ("b", "beta", "gamma", "mean", "var"))

    def bias_param_names(self) -> Tuple[str, ...]:
        return tuple(n for n in self.param_shapes() if n == "b")

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

    # ---- serde --------------------------------------------------------------
    def to_dict(self) -> dict:
        from deeplearning4j_tpu_torch.nn.layers.vae_distributions import (
            ReconstructionDistribution,
        )
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if isinstance(v, (Updater, Schedule, Distribution, IDropout,
                              IWeightNoise, Layer,  # a Layer: a wrapper's inner one
                              ReconstructionDistribution)):
                v = v.to_dict()
            elif (isinstance(v, list) and v
                  and all(isinstance(c, LayerConstraint) for c in v)):
                v = [c.to_dict() for c in v]
            d[f.name] = v
        d["@layer"] = type(self).__name__
        return d


def activation_from_config(v):
    """Parameterized activations (``("leakyrelu", {"alpha": ...})``) are
    tuples in memory but JSON lists on disk."""
    if (isinstance(v, list) and len(v) == 2 and isinstance(v[0], str)
            and isinstance(v[1], dict)):
        return (v[0], dict(v[1]))
    return v


def layer_from_dict(d: dict) -> Layer:
    """The layer a :meth:`Layer.to_dict` (or the reference's) describes."""
    d = dict(d)
    name = d.pop("@layer")
    if name not in LAYER_REGISTRY:
        raise NotImplementedError(f"layer {name!r} is not ported yet")
    kw = d
    for k, v in kw.items():
        if isinstance(v, dict) and "@updater" in v:
            kw[k] = Updater.from_dict(v)
        elif isinstance(v, dict) and "@schedule" in v:
            kw[k] = Schedule.from_dict(v)
        elif isinstance(v, dict) and "@dropout" in v:
            kw[k] = IDropout.from_dict(v)
        elif isinstance(v, dict) and "@weight_noise" in v:
            kw[k] = IWeightNoise.from_dict(v)
        elif isinstance(v, dict) and "@recon" in v:
            from deeplearning4j_tpu_torch.nn.layers.vae_distributions import (
                ReconstructionDistribution,
            )
            kw[k] = ReconstructionDistribution.from_dict(v)
        elif isinstance(v, dict) and "@layer" in v:
            kw[k] = layer_from_dict(v)
        elif (isinstance(v, list) and v
              and all(isinstance(c, dict) and "@constraint" in c for c in v)):
            kw[k] = constraints_from_config(v)
        elif k == "distribution" and isinstance(v, dict):
            kw[k] = Distribution.from_dict(v)
        elif k == "activation":
            kw[k] = activation_from_config(v)
        elif isinstance(v, list) and k in ("kernel_size", "stride", "padding",
                                           "dilation"):
            kw[k] = tuple(v)
    return LAYER_REGISTRY[name](**kw)
