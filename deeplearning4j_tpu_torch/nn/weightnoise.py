"""Weight noise: the ``IWeightNoise`` SPI, which transforms a layer's
WEIGHTS (not its activations) at train-time forward.

Counterpart of ``deeplearning4j_tpu/nn/weightnoise.py``, the same classes,
fields and ``@weight_noise`` serde: ``WeightNoise`` (additive or
multiplicative noise drawn from a ``Distribution``) and ``DropConnect``
(each weight zeroed with probability ``1 − p``, the survivors NOT scaled
by ``1/p``: DL4J's plain ``DropOut`` op). The noise is a function of the
parameter inside the differentiated forward, so the gradient reaches the
underlying weights; inference always sees the clean weights.

Draws go through ``nn/dropout.py``'s :func:`bernoulli` and :func:`normal`
(a normal ``WeightNoise`` distribution), one draw per noised tensor in
the order of the layer's parameter dict.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.nn import dropout as _dropout
from deeplearning4j_tpu_torch.nn.updaters import Schedule
from deeplearning4j_tpu_torch.nn.weights import Distribution, sample_distribution

WEIGHT_NOISE_REGISTRY: Dict[str, type] = {}


def register_weight_noise(cls):
    WEIGHT_NOISE_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass
class IWeightNoise:
    """SPI: ``apply`` noises the selected tensors of one layer's params."""

    apply_to_bias: bool = False

    def apply_param(self, param: torch.Tensor,
                    gen: torch.Generator) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, layer, params: Dict[str, torch.Tensor],
              gen: Optional[torch.Generator],
              train: bool) -> Dict[str, torch.Tensor]:
        """One layer's params with its weights (and its biases when
        ``apply_to_bias``) noised; train only."""
        if not train or gen is None:
            return params
        names = set(layer.weight_param_names())
        if self.apply_to_bias:
            names |= set(layer.bias_param_names())
        return {n: (self.apply_param(v, gen) if n in names else v)
                for n, v in params.items()}

    def to_dict(self) -> dict:
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Distribution):
                v = v.to_dict()
            d[f.name] = v
        d["@weight_noise"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d: dict) -> "IWeightNoise":
        d = dict(d)
        cls = WEIGHT_NOISE_REGISTRY[d.pop("@weight_noise")]
        if isinstance(d.get("distribution"), dict):
            d["distribution"] = Distribution.from_dict(d["distribution"])
        return cls(**d)


@register_weight_noise
@dataclasses.dataclass
class WeightNoise(IWeightNoise):
    """Additive (W + n) or multiplicative (W ∘ n) noise, drawn fresh each
    train forward from ``distribution`` (default N(0, 0.01))."""

    distribution: Optional[Distribution] = None
    additive: bool = True

    def __post_init__(self):
        if self.distribution is None:
            self.distribution = Distribution(kind="normal", mean=0.0, std=0.01)

    def apply_param(self, param, gen):
        d = self.distribution
        if d.kind == "normal":
            noise = d.mean + _dropout.normal(param.shape, gen, param.device,
                                             param.dtype) * d.std
        else:
            _dropout._check_generator(gen, param.device)
            noise = sample_distribution(gen, d, param.shape, param.dtype,
                                        param.device)
        return param + noise if self.additive else param * noise


@register_weight_noise
@dataclasses.dataclass
class DropConnect(IWeightNoise):
    """Zero each weight with probability ``1 − p`` at train-time forward;
    the kept weights are NOT rescaled by ``1/p`` (unlike
    :class:`~deeplearning4j_tpu_torch.nn.dropout.Dropout`). A schedule
    is refused, as in the reference."""

    p: float = 0.5

    def __post_init__(self):
        if isinstance(self.p, Schedule):
            raise ValueError(
                "DropConnect schedules are not supported (iteration is not "
                "threaded into layer forwards); use a fixed retain prob")
        if not (0.0 < self.p <= 1.0):
            raise ValueError(
                f"Weight retain probability must be in (0, 1]: got {self.p}")

    def apply_param(self, param, gen):
        if self.p >= 1.0:
            return param
        keep = _dropout.bernoulli(self.p, param.shape, gen, param.device,
                                  param.dtype)
        return torch.where(keep, param, param.new_zeros(()))
