"""Activation functions (the subset the served models use).

Counterpart of ``deeplearning4j_tpu/nn/activations.py``, same names and
math: ``gelu`` is the exact (erf) form, ``gelu_tanh`` the tanh
approximation, ``softmax`` runs over the last axis. ``resolve`` takes a
name, a ``(name, kwargs)`` tuple, a callable or ``None`` (identity).
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch
import torch.nn.functional as F

ActivationFn = Callable[[torch.Tensor], torch.Tensor]

_SELU_ALPHA = 1.6732632423543772
_SELU_LAMBDA = 1.0507009873554805


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def selu(x: torch.Tensor) -> torch.Tensor:
    # exp of the non-positive part only, so the unused branch stays finite
    safe = torch.where(x > 0, torch.zeros_like(x), x)
    return _SELU_LAMBDA * torch.where(x > 0, x,
                                      _SELU_ALPHA * (torch.exp(safe) - 1.0))


def gelu(x: torch.Tensor) -> torch.Tensor:
    # exact (erf-based) gelu, as the reference's "gelu"
    return F.gelu(x, approximate="none")


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # tanh approximation, written as the reference writes it
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


_REGISTRY: dict = {
    "identity": identity,
    "linear": identity,
    "relu": relu,
    "tanh": tanh,
    "sigmoid": sigmoid,
    "selu": selu,
    "gelu": gelu,
    "gelu_tanh": gelu_tanh,
    "softmax": softmax,
}


def names() -> list:
    return sorted(_REGISTRY)


def resolve(activation: Union[str, ActivationFn, tuple, None]) -> ActivationFn:
    if activation is None:
        return identity
    if callable(activation):
        return activation
    if isinstance(activation, tuple):
        name, kwargs = activation
        fn = _REGISTRY[name.lower()]
        return lambda x: fn(x, **kwargs)
    key = activation.lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown activation {activation!r}; known: {names()}")
    return _REGISTRY[key]
