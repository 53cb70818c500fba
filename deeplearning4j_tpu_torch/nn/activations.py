"""Activation functions with the reference's names and math.

Counterpart of ``deeplearning4j_tpu/nn/activations.py``: the same 23
names, each written from the reference's own formula. ``gelu`` is the
exact (erf) form, ``gelu_tanh`` the tanh approximation, ``softmax`` and
``logsoftmax`` run over the last axis, ``rationaltanh`` is the exact
``1.7159·tanh(2x/3)``, ``softplus`` is ``logaddexp(x, 0)`` (no threshold,
as ``jax.nn.softplus``). ``resolve`` takes a name, a ``(name, kwargs)``
tuple (``("leakyrelu", {"alpha": 0.2})``), a callable or ``None``
(identity).

The gradients at the ties are the reference's, as ``jax.grad`` gives
them: ``maximum`` and ``minimum`` split a tie in half (relu at 0, each
bound of relu6, hardsigmoid, hardtanh and rectifiedtanh), so each is a
``torch.maximum`` / ``torch.minimum`` against a 0-dim tensor, whose
backward splits a tie too (``clamp``, ``F.relu`` and ``F.hardtanh`` give
1 or 0 there); ``where(x >= 0 …)`` and ``where(x > 0 …)`` keep their
comparison, so leakyrelu's gradient at 0 is 1 and elu's is alpha.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import dtensor as _dt

ActivationFn = Callable[[torch.Tensor], torch.Tensor]

_SELU_ALPHA = 1.6732632423543772
_SELU_LAMBDA = 1.0507009873554805


def _max(x: torch.Tensor, v: float) -> torch.Tensor:
    """``jnp.maximum(x, v)``: a tie's gradient splits in half."""
    return torch.maximum(x, x.new_full((), v))


def _min(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.minimum(x, x.new_full((), v))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``."""
    return _min(_max(x, lo), hi)


def signed_abs(v: torch.Tensor) -> torch.Tensor:
    """``jnp.abs``: ``|v|`` as ``v·s``, ``s`` = +1 where v >= 0 (else -1)
    held constant, so the gradient at 0 is +1, as ``jax.grad`` gives
    (``torch.abs``'s is 0)."""
    return v * torch.where(v >= 0, 1.0, -1.0).to(v.dtype)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def relu(x: torch.Tensor) -> torch.Tensor:
    return _max(x, 0.0)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return _clip(x, 0.0, 6.0)


def leakyrelu(x: torch.Tensor, alpha: float = 0.01) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def _exp_of_non_positive(x: torch.Tensor) -> torch.Tensor:
    # exp of the non-positive part only, so the unused branch stays finite
    return torch.exp(torch.where(x > 0, torch.zeros_like(x), x))


def elu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    return torch.where(x > 0, x, alpha * (_exp_of_non_positive(x) - 1.0))


def selu(x: torch.Tensor) -> torch.Tensor:
    return _SELU_LAMBDA * torch.where(
        x > 0, x, _SELU_ALPHA * (_exp_of_non_positive(x) - 1.0))


def gelu(x: torch.Tensor) -> torch.Tensor:
    # exact (erf-based) gelu, as the reference's "gelu"
    return F.gelu(x, approximate="none")


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # tanh approximation, written as the reference writes it
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def hardsigmoid(x: torch.Tensor) -> torch.Tensor:
    return _clip(0.2 * x + 0.5, 0.0, 1.0)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def hardtanh(x: torch.Tensor) -> torch.Tensor:
    return _clip(x, -1.0, 1.0)


def rationaltanh(x: torch.Tensor) -> torch.Tensor:
    return 1.7159 * torch.tanh(2.0 * x / 3.0)


def rectifiedtanh(x: torch.Tensor) -> torch.Tensor:
    return _max(torch.tanh(x), 0.0)


def softmax(x: torch.Tensor) -> torch.Tensor:
    return _dt.softmax(x)  # torch.softmax over the last dim


def logsoftmax(x: torch.Tensor) -> torch.Tensor:
    return _dt.log_softmax(x)  # torch.log_softmax over the last dim


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, x.new_zeros(()))


def softsign(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + torch.abs(x))


def cube(x: torch.Tensor) -> torch.Tensor:
    return x ** 3


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(softplus(x))


def thresholdedrelu(x: torch.Tensor, theta: float = 1.0) -> torch.Tensor:
    return torch.where(x > theta, x, torch.zeros_like(x))


_REGISTRY: dict = {
    "identity": identity,
    "linear": identity,
    "relu": relu,
    "relu6": relu6,
    "leakyrelu": leakyrelu,
    "elu": elu,
    "selu": selu,
    "gelu": gelu,
    "gelu_tanh": gelu_tanh,
    "sigmoid": sigmoid,
    "hardsigmoid": hardsigmoid,
    "tanh": tanh,
    "hardtanh": hardtanh,
    "rationaltanh": rationaltanh,
    "rectifiedtanh": rectifiedtanh,
    "softmax": softmax,
    "logsoftmax": logsoftmax,
    "softplus": softplus,
    "softsign": softsign,
    "cube": cube,
    "swish": swish,
    "mish": mish,
    "thresholdedrelu": thresholdedrelu,
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
