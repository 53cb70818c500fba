"""Dropout variants: the ``IDropout`` SPI and its implementations.

Counterpart of ``deeplearning4j_tpu/nn/dropout.py``, the same classes,
fields and ``@dropout`` serde: ``Dropout`` (inverted; ``p`` is the keep
probability), ``AlphaDropout`` (self-normalizing), ``GaussianDropout``
(multiplicative N(1, sqrt(rate/(1-rate)))), ``GaussianNoise`` (additive
N(0, stddev)) and ``SpatialDropout`` (whole channels, channels-last). A
layer's ``dropout`` field takes a float keep probability or an
``IDropout``; :func:`resolve_dropout` normalizes it. At inference every
variant is the identity.

Every random draw of the port's regularizers (this module, weight noise,
attention dropout) and of its pretraining layers (the autoencoder's
corruption, the VAE's ε and its distributions' samples) goes through
:func:`bernoulli`, :func:`normal` and :func:`uniform`,
from the network's dropout ``torch.Generator``, which must live on the
device it draws for: a CPU generator never draws for a CUDA tensor.

A scalar field may be a ``Schedule``, evaluated at the running step's
tick (``nn/tick.py``) and clamped into the field's valid range, as the
reference does for scheduled values that wander out of it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.tick import current_schedule_tick
from deeplearning4j_tpu_torch.nn.updaters import Schedule

DROPOUT_REGISTRY: Dict[str, type] = {}


def register_dropout(cls):
    DROPOUT_REGISTRY[cls.__name__] = cls
    return cls


def _check_generator(gen: torch.Generator, device) -> None:
    if gen.device.type != torch.device(device).type:
        raise ValueError(f"a generator on {gen.device} cannot draw for a "
                         f"tensor on {device}")


def bernoulli(p, shape, gen: torch.Generator, device, dtype=torch.float32):
    """A boolean keep mask of ``shape`` on ``device``: True with
    probability ``p`` (uniforms in ``dtype`` below ``p``)."""
    _check_generator(gen, device)
    return torch.rand(tuple(shape), generator=gen, device=device,
                      dtype=dtype) < p


def normal(shape, gen: torch.Generator, device, dtype=torch.float32):
    """Standard normal draws of ``shape`` in ``dtype`` on ``device``."""
    _check_generator(gen, device)
    return torch.randn(tuple(shape), generator=gen, device=device, dtype=dtype)


def uniform(shape, gen: torch.Generator, device, dtype=torch.float32,
            low: float = 0.0, high: float = 1.0):
    """Uniform draws in ``[low, high)`` of ``shape`` in ``dtype`` on
    ``device``."""
    _check_generator(gen, device)
    u = torch.rand(tuple(shape), generator=gen, device=device, dtype=dtype)
    return low + (high - low) * u


def _coerce_scalar(value):
    """Configuration-time normalization: Schedules (and their serde
    dicts) pass through; everything else becomes a float."""
    if isinstance(value, Schedule):
        return value
    if isinstance(value, dict) and "@schedule" in value:
        return Schedule.from_dict(value)
    return float(value)


def _now(value, lo=None, hi=None):
    """The value at the running step: a float as it is, a Schedule at the
    step's tick, in float32 and clamped into ``[lo, hi]``."""
    if isinstance(value, Schedule):
        it, ep = current_schedule_tick()
        v = np.float32(value.value(np.float32(it), np.float32(ep)))
        if lo is not None or hi is not None:
            v = np.clip(v, np.float32(-np.inf if lo is None else lo),
                        np.float32(np.inf if hi is None else hi))
        return float(v)
    return value


def _is_schedule(value) -> bool:
    return isinstance(value, Schedule)


def _f32(v) -> float:
    """``v`` rounded to float32, as the reference's ``jnp`` scalars are."""
    return float(np.float32(v))


@dataclasses.dataclass
class IDropout:
    """SPI: train-time activation noise."""

    def apply(self, x: torch.Tensor, gen: Optional[torch.Generator],
              train: bool) -> torch.Tensor:
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            d[f.name] = v.to_dict() if _is_schedule(v) else v
        d["@dropout"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d: dict) -> "IDropout":
        d = dict(d)
        cls = DROPOUT_REGISTRY[d.pop("@dropout")]
        return cls(**d)  # scalar fields re-inflate schedules via _coerce_scalar


def _check_keep(p) -> None:
    if not _is_schedule(p) and not (0.0 < p <= 1.0):
        raise ValueError(f"Activation retain probability must be in (0, 1]: "
                         f"got {p}")


def _inverted(x, keep, p):
    return torch.where(keep, x / p, x.new_zeros(()))


@register_dropout
@dataclasses.dataclass
class Dropout(IDropout):
    """Inverted dropout: keep with probability ``p``, scale what is kept
    by ``1/p``. ``p`` may be a Schedule."""

    p: float = 0.5

    def __post_init__(self):
        self.p = _coerce_scalar(self.p)
        _check_keep(self.p)

    def apply(self, x, gen, train):
        if not train or gen is None:
            return x
        if not _is_schedule(self.p) and self.p >= 1.0:
            return x
        p = _now(self.p, lo=1e-6, hi=1.0)
        return _inverted(x, bernoulli(p, x.shape, gen, x.device, x.dtype), p)


@register_dropout
@dataclasses.dataclass
class AlphaDropout(IDropout):
    """Self-normalizing-network dropout (Klambauer et al. 2017):
    ``a·(x·d + α'·(1−d)) + b`` with ``d ~ Bernoulli(p)``, ``α' = −λα``
    and ``a``, ``b`` chosen so that the mean and variance of the
    activations are kept. Pair with SELU."""

    p: float = 0.5
    alpha: float = 1.6732632423543772
    lambda_: float = 1.0507009873554804

    def __post_init__(self):
        self.p = _coerce_scalar(self.p)
        _check_keep(self.p)

    @property
    def alpha_prime(self) -> float:
        return -self.lambda_ * self.alpha

    def a(self, p: float) -> float:
        """1/sqrt(p + α'²·p·(1−p))."""
        ap = self.alpha_prime
        return 1.0 / float(np.sqrt(p + ap * ap * p * (1.0 - p)))

    def b(self, p: float) -> float:
        """−a(p)·(1−p)·α'."""
        return -self.a(p) * (1.0 - p) * self.alpha_prime

    def apply(self, x, gen, train):
        if not train or gen is None:
            return x
        if not _is_schedule(self.p) and self.p >= 1.0:
            return x
        p = _now(self.p, lo=1e-6, hi=1.0)
        ap = self.alpha_prime
        # a and b in float32, as the reference's jnp scalars
        f32 = np.float32
        a = f32(1.0) / np.sqrt(f32(p + ap * ap * p * (1.0 - p)))
        b = -a * f32(1.0 - p) * f32(ap)
        d = bernoulli(p, x.shape, gen, x.device, x.dtype)
        return (float(a) * torch.where(d, x, x.new_full((), _f32(ap)))
                + float(b))


@register_dropout
@dataclasses.dataclass
class GaussianDropout(IDropout):
    """Multiplicative Gaussian noise (Srivastava et al. 2014, §10):
    ``x · N(1, sqrt(rate/(1−rate)))``."""

    rate: float = 0.5

    def __post_init__(self):
        self.rate = _coerce_scalar(self.rate)
        if not _is_schedule(self.rate) and not (0.0 <= self.rate < 1.0):
            raise ValueError(f"rate must be in [0, 1): got {self.rate}")

    def apply(self, x, gen, train):
        if not train or gen is None:
            return x
        if not _is_schedule(self.rate) and self.rate == 0.0:
            return x
        rate = _now(self.rate, lo=0.0, hi=1.0 - 1e-6)
        stdev = _f32(np.sqrt(np.float32(rate / (1.0 - rate))))
        return x * (1.0 + stdev * normal(x.shape, gen, x.device, x.dtype))


@register_dropout
@dataclasses.dataclass
class GaussianNoise(IDropout):
    """Additive zero-mean Gaussian noise: ``x + N(0, stddev)``."""

    stddev: float = 0.1

    def __post_init__(self):
        self.stddev = _coerce_scalar(self.stddev)

    def apply(self, x, gen, train):
        if not train or gen is None:
            return x
        if not _is_schedule(self.stddev) and self.stddev == 0.0:
            return x
        return x + _f32(_now(self.stddev, lo=0.0)) * normal(
            x.shape, gen, x.device, x.dtype)


@register_dropout
@dataclasses.dataclass
class SpatialDropout(IDropout):
    """Channel dropout (Keras SpatialDropout1D/2D/3D; Tompson et al.
    2015): the keep mask covers (batch, channels) only, shape
    ``[N, 1, ..., 1, C]`` on the channels-last tensor, and broadcasts over
    the spatial or time axes. ``p`` is the keep probability, scaled as
    :class:`Dropout` scales it."""

    p: float = 0.5

    def __post_init__(self):
        self.p = _coerce_scalar(self.p)
        _check_keep(self.p)

    def apply(self, x, gen, train):
        if not train or gen is None:
            return x
        if not _is_schedule(self.p) and self.p >= 1.0:
            return x
        if x.ndim < 3:
            raise ValueError(
                f"SpatialDropout expects [N, ..., C] rank>=3 input, got shape "
                f"{tuple(x.shape)}; use Dropout for 2d activations")
        p = _now(self.p, lo=1e-6, hi=1.0)
        mask_shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        return _inverted(x, bernoulli(p, mask_shape, gen, x.device, x.dtype), p)


def resolve_dropout(v) -> Optional[IDropout]:
    """A layer's ``dropout`` value as an IDropout: a float keep
    probability is a :class:`Dropout`, a Schedule a :class:`Dropout` on
    it, an IDropout itself, None None. A float keep probability <= 0 or
    >= 1 means no dropout."""
    if v is None or isinstance(v, IDropout):
        return v
    if _is_schedule(v):
        return Dropout(v)
    p = float(v)
    if p <= 0.0 or p >= 1.0:
        return None
    return Dropout(p)
