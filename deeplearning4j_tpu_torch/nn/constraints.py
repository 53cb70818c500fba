"""Parameter constraints, applied after each update.

Counterpart of ``deeplearning4j_tpu/nn/constraints.py``, the same classes,
fields and ``@constraint`` serde: ``MaxNormConstraint``,
``MinMaxNormConstraint``, ``UnitNormConstraint`` and
``NonNegativeConstraint``. A layer carries them in ``constraints``; the
network builder's ``constrain_weights`` / ``constrain_bias`` /
``constrain_all_parameters`` attach scoped copies to every layer.

A constraint is a function of one tensor. The fit loops
(``nn/train_step.py``) write its result back into the parameter in place,
so the tensor objects the updater state and the fused updater kernel
point at stay the same.

Norm ``dimensions`` are the REDUCTION axes of the L2 norm. ``None`` (the
default) reduces over every axis but the last: for the stored layouts
(Dense ``[n_in, n_out]``, conv HWIO ``[kh, kw, in, out]``, LSTM ``RW``
``[H, 4H+3]``) that is the norm of each output unit's incoming weights,
and a bias is reduced over its one axis.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

CONSTRAINT_REGISTRY: Dict[str, type] = {}

DEFAULT_EPSILON = 1e-6  # BaseConstraint.DEFAULT_EPSILON


def register_constraint(cls):
    CONSTRAINT_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass
class LayerConstraint:
    """SPI. ``param_names``: the parameters to constrain; when None the
    ``scope`` picks them from the layer ("weights" | "bias" | "all")."""

    param_names: Optional[Tuple[str, ...]] = None
    scope: str = "weights"
    dimensions: Optional[Tuple[int, ...]] = None

    def apply(self, param: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply_to(self, layer, params: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """One layer's params with the selected entries constrained."""
        if self.param_names is not None:
            names = set(self.param_names)
        elif self.scope == "all":
            names = set(params)
        elif self.scope == "bias":
            names = set(layer.bias_param_names())
        else:
            names = set(layer.weight_param_names())
        return {n: (self.apply(v) if n in names else v)
                for n, v in params.items()}

    def scoped(self, scope: str) -> "LayerConstraint":
        return dataclasses.replace(self, scope=scope)

    def _axes(self, param: torch.Tensor) -> Tuple[int, ...]:
        if self.dimensions is not None:
            return tuple(int(d) for d in self.dimensions)
        return tuple(range(max(param.ndim - 1, 1)))  # all but the last

    def _norm2(self, param: torch.Tensor) -> torch.Tensor:
        axes = (0,) if param.ndim == 1 else self._axes(param)
        return torch.sqrt(torch.sum(param * param, dim=axes, keepdim=True))

    def to_dict(self) -> dict:
        d = {k: v for k, v in dataclasses.asdict(self).items() if v is not None}
        for k in ("param_names", "dimensions"):
            if k in d:
                d[k] = list(d[k])
        d["@constraint"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d: dict) -> "LayerConstraint":
        d = dict(d)
        cls = CONSTRAINT_REGISTRY[d.pop("@constraint")]
        for k in ("param_names", "dimensions"):
            if isinstance(d.get(k), list):
                d[k] = tuple(d[k])
        return cls(**d)


@register_constraint
@dataclasses.dataclass
class MaxNormConstraint(LayerConstraint):
    """Scale down every unit whose incoming-weight L2 norm exceeds
    ``max_norm``."""

    max_norm: float = 1.0

    def apply(self, param):
        norm = self._norm2(param)
        clipped = torch.clamp_max(norm, self.max_norm)
        return param * (clipped / (norm + DEFAULT_EPSILON))


@register_constraint
@dataclasses.dataclass
class MinMaxNormConstraint(LayerConstraint):
    """Keep incoming-weight norms in ``[min_norm, max_norm]``; ``rate``
    blends toward the projection: scale = rate·clip(n)/(n+ε) + (1−rate)."""

    min_norm: float = 0.0
    max_norm: float = 1.0
    rate: float = 1.0

    def __post_init__(self):
        if not (0.0 < self.rate <= 1.0):
            raise ValueError(f"Invalid rate: must be in (0, 1]: got {self.rate}")

    def apply(self, param):
        norm = self._norm2(param)
        clipped = torch.clamp(norm, self.min_norm, self.max_norm)
        scale = clipped / (norm + DEFAULT_EPSILON)
        if self.rate != 1.0:
            scale = self.rate * scale + (1.0 - self.rate)
        return param * scale


@register_constraint
@dataclasses.dataclass
class UnitNormConstraint(LayerConstraint):
    """Incoming-weight norms of exactly 1: divide by the L2 norm."""

    def apply(self, param):
        return param / (self._norm2(param) + DEFAULT_EPSILON)


@register_constraint
@dataclasses.dataclass
class NonNegativeConstraint(LayerConstraint):
    """Clamp negatives to zero."""

    def apply(self, param):
        return torch.clamp_min(param, 0.0)


def apply_constraints(layer, params: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """A layer's constraint chain over its updated params.

    A wrapper layer (one with an inner ``layer``) carries no constraints
    of its own: its inner layer's chain applies to the wrapper's params,
    to both halves of ``f_``/``b_``-prefixed ones."""
    cs = getattr(layer, "constraints", None)
    if not cs:
        inner = getattr(layer, "layer", None)
        if (inner is not None and getattr(inner, "constraints", None)
                and params):
            if all(k.startswith(("f_", "b_")) for k in params):
                halves = {}
                for pre in ("f_", "b_"):
                    sub = {k[len(pre):]: v for k, v in params.items()
                           if k.startswith(pre)}
                    sub = apply_constraints(inner, sub)
                    halves.update({pre + k: v for k, v in sub.items()})
                return halves
            return apply_constraints(inner, params)
        return params
    for c in cs:
        params = c.apply_to(layer, params)
    return params


def constraints_from_config(v):
    """A layer's ``constraints`` field from its configuration (a list of
    tagged dicts, or of constraints)."""
    if v is None:
        return None
    return [c if isinstance(c, LayerConstraint) else LayerConstraint.from_dict(c)
            for c in v]
