"""Weight initialization — the DL4J ``WeightInit`` schemes.

Counterpart of ``deeplearning4j_tpu/nn/weights.py``, same scheme names and
variance formulas. Draws come from an explicit ``torch.Generator``; they
match the reference in distribution only (jax's PRNG and torch's never
agree), so parity tests carry weights across instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Union

import torch


@dataclasses.dataclass(frozen=True)
class Distribution:
    """User-specified distribution for WeightInit.DISTRIBUTION.

    kind: "normal" (mean, std) | "uniform" (lower, upper) |
          "truncated_normal" (mean, std) | "log_normal" (mean, std) |
          "orthogonal" (gain) | "constant" (value) | "binomial" (n, p)
    """

    kind: str = "normal"
    mean: float = 0.0
    std: float = 1.0
    lower: float = -1.0
    upper: float = 1.0
    gain: float = 1.0
    value: float = 0.0
    n: int = 1
    p: float = 0.5

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "Distribution":
        return Distribution(**d)


def _normal(gen, shape, std, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) * std


def _uniform(gen, shape, bound, dtype, device):
    u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    return (2.0 * u - 1.0) * bound


def _truncated_normal(gen, shape, std, dtype, device):
    # truncation at ±2 std, rescaled as jax.nn.initializers.variance_scaling
    out = torch.empty(shape, dtype=dtype, device=device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return out * (std / 0.87962566103423978)


def _orthogonal(gen, shape, gain, dtype, device):
    if len(shape) < 2:
        raise ValueError("orthogonal init needs >=2 dims")
    rows, cols = shape[0], int(math.prod(shape[1:]))
    n = max(rows, cols)
    a = torch.randn((n, n), generator=gen, dtype=dtype, device=device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return (gain * q[:rows, :cols]).reshape(shape)


def init_weight(gen: torch.Generator, shape: Sequence[int], scheme: str,
                fan_in: float, fan_out: float, dtype=torch.float32,
                device=None,
                distribution: Optional[Distribution] = None) -> torch.Tensor:
    """Initialize a weight tensor per the named DL4J scheme."""
    shape = tuple(int(s) for s in shape)
    s = scheme.lower()
    kw = dict(dtype=dtype, device=device)
    if s == "zero":
        return torch.zeros(shape, **kw)
    if s == "ones":
        return torch.ones(shape, **kw)
    if s == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError(
                f"IDENTITY weight init requires a square 2-D shape, got {shape}")
        return torch.eye(shape[0], **kw)
    if s == "distribution":
        if distribution is None:
            raise ValueError("WeightInit DISTRIBUTION requires a Distribution spec")
        return sample_distribution(gen, distribution, shape, dtype, device)
    normal = {
        "normal": lambda: 1.0 / math.sqrt(fan_in),
        "xavier": lambda: math.sqrt(2.0 / (fan_in + fan_out)),
        "xavier_fan_in": lambda: math.sqrt(1.0 / fan_in),
        "xavier_legacy": lambda: 1.0 / math.sqrt(shape[0] + shape[-1]),
        "relu": lambda: math.sqrt(2.0 / fan_in),
        "lecun_normal": lambda: math.sqrt(1.0 / fan_in),
    }
    uniform = {
        "uniform": lambda: 1.0 / math.sqrt(fan_in),
        "xavier_uniform": lambda: math.sqrt(6.0 / (fan_in + fan_out)),
        "sigmoid_uniform": lambda: 4.0 * math.sqrt(6.0 / (fan_in + fan_out)),
        "relu_uniform": lambda: math.sqrt(6.0 / fan_in),
        "lecun_uniform": lambda: math.sqrt(3.0 / fan_in),
        "var_scaling_uniform_fan_in": lambda: math.sqrt(3.0 / fan_in),
        "var_scaling_uniform_fan_out": lambda: math.sqrt(3.0 / fan_out),
        "var_scaling_uniform_fan_avg": lambda: math.sqrt(6.0 / (fan_in + fan_out)),
    }
    truncated = {
        "var_scaling_normal_fan_in": lambda: math.sqrt(1.0 / fan_in),
        "var_scaling_normal_fan_out": lambda: math.sqrt(1.0 / fan_out),
        "var_scaling_normal_fan_avg": lambda: math.sqrt(2.0 / (fan_in + fan_out)),
    }
    if s in normal:
        return _normal(gen, shape, normal[s](), dtype, device)
    if s in uniform:
        return _uniform(gen, shape, uniform[s](), dtype, device)
    if s in truncated:
        return _truncated_normal(gen, shape, truncated[s](), dtype, device)
    raise ValueError(f"Unknown weight init scheme {scheme!r}")


def sample_distribution(gen: torch.Generator,
                        distribution: Union[Distribution, dict],
                        shape: Sequence[int], dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """Draw a tensor from a :class:`Distribution` spec."""
    d = (Distribution(**distribution) if isinstance(distribution, dict)
         else distribution)
    shape = tuple(int(s) for s in shape)
    if d.kind == "normal":
        return d.mean + _normal(gen, shape, d.std, dtype, device)
    if d.kind == "truncated_normal":
        return d.mean + _truncated_normal(gen, shape, d.std, dtype, device)
    if d.kind == "log_normal":
        return torch.exp(d.mean + _normal(gen, shape, d.std, dtype, device))
    if d.kind == "uniform":
        u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
        return d.lower + u * (d.upper - d.lower)
    if d.kind == "orthogonal":
        return _orthogonal(gen, shape, d.gain, dtype, device)
    if d.kind == "constant":
        return torch.full(shape, d.value, dtype=dtype, device=device)
    if d.kind == "binomial":
        probs = torch.full(shape, d.p, dtype=torch.float32, device=device)
        counts = torch.full(shape, float(d.n), dtype=torch.float32,
                            device=device)
        return torch.binomial(counts, probs, generator=gen).to(dtype)
    raise ValueError(f"Unknown distribution kind {d.kind!r}")

