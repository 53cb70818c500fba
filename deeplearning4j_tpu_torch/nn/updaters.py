"""Updaters (optimizers) and learning-rate schedules with ND4J semantics.

Counterpart of ``deeplearning4j_tpu/nn/updaters.py`` (the schedules, the
ten updater classes, ``resolve_updater`` and ``normalize_gradients``). ``Updater.update(grad, state, lr, t)`` returns the
value to SUBTRACT from the parameter and the new state; ``t`` is the
1-based step (``iteration + 1``).

The reference runs these formulas inside ``jit`` with the iteration as a
traced float32, so every scalar (a schedule's value, ``beta ** t``, Adam's
``alpha``) is float32. The port computes those scalars on the host with
numpy float32 in the same order, then hands them to torch as Python
floats (exact: a float32 value is a double), so no step needs a
device-to-host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import numpy as np
import torch

_f32 = np.float32


def _pow1m(beta: float, t) -> np.float32:
    """``1 - beta ** t`` in float32, as the reference's traced math."""
    return _f32(1.0) - _f32(beta) ** _f32(t)


# ---------------------------------------------------------------------------
# Schedules (ND4J ISchedule: Fixed/Exponential/Inverse/Poly/Sigmoid/Step/Map)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Schedule:
    """Base class; subclasses implement value(iteration, epoch)."""

    schedule_type: str = "iteration"  # "iteration" | "epoch"

    def _t(self, iteration, epoch):
        return _f32(epoch if self.schedule_type == "epoch" else iteration)

    def value(self, iteration, epoch):  # pragma: no cover - abstract
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["@schedule"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d: dict) -> "Schedule":
        d = dict(d)
        cls = _SCHEDULES[d.pop("@schedule")]
        if cls is MapSchedule and "values" in d and isinstance(d["values"], dict):
            d["values"] = tuple(sorted((int(k), float(v)) for k, v in d["values"].items()))
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class FixedSchedule(Schedule):
    value_: float = 0.001

    def value(self, iteration, epoch):
        return self.value_


@dataclasses.dataclass(frozen=True)
class ExponentialSchedule(Schedule):
    initial_value: float = 0.001
    gamma: float = 0.99

    def value(self, iteration, epoch):
        return self.initial_value * self.gamma ** self._t(iteration, epoch)


@dataclasses.dataclass(frozen=True)
class InverseSchedule(Schedule):
    initial_value: float = 0.001
    gamma: float = 0.99
    power: float = 1.0

    def value(self, iteration, epoch):
        return self.initial_value / (1.0 + self.gamma * self._t(iteration, epoch)) ** self.power


@dataclasses.dataclass(frozen=True)
class PolySchedule(Schedule):
    initial_value: float = 0.001
    power: float = 1.0
    max_iter: int = 10000

    def value(self, iteration, epoch):
        frac = np.minimum(self._t(iteration, epoch) / self.max_iter, _f32(1.0))
        return self.initial_value * (1.0 - frac) ** self.power


@dataclasses.dataclass(frozen=True)
class SigmoidSchedule(Schedule):
    initial_value: float = 0.001
    gamma: float = 0.99
    step_size: int = 100

    def value(self, iteration, epoch):
        t = self._t(iteration, epoch)
        return self.initial_value / (1.0 + np.exp(-self.gamma * (t - self.step_size)))


@dataclasses.dataclass(frozen=True)
class StepSchedule(Schedule):
    initial_value: float = 0.001
    decay_rate: float = 0.1
    step: float = 100.0

    def value(self, iteration, epoch):
        t = self._t(iteration, epoch)
        return self.initial_value * self.decay_rate ** np.floor(t / self.step)


@dataclasses.dataclass(frozen=True)
class MapSchedule(Schedule):
    """Piecewise-constant schedule from {iteration_or_epoch: value}.

    ``values`` is a tuple of (threshold, value) pairs sorted by threshold;
    entry 0 must have threshold 0.
    """

    values: tuple = ((0, 0.001),)

    def value(self, iteration, epoch):
        t = self._t(iteration, epoch)
        out = _f32(self.values[0][1])
        for thresh, val in self.values[1:]:
            if t >= thresh:
                out = _f32(val)
        return out


@dataclasses.dataclass(frozen=True)
class WarmupCosineSchedule(Schedule):
    """Linear warmup then cosine decay (not in ND4J)."""

    peak_value: float = 0.001
    warmup_steps: int = 100
    total_steps: int = 10000
    final_value: float = 0.0

    def value(self, iteration, epoch):
        t = self._t(iteration, epoch)
        if t < self.warmup_steps:
            return self.peak_value * t / max(self.warmup_steps, 1)
        prog = np.clip((t - self.warmup_steps)
                       / max(self.total_steps - self.warmup_steps, 1),
                       _f32(0.0), _f32(1.0))
        return (self.final_value + 0.5 * (self.peak_value - self.final_value)
                * (1 + np.cos(_f32(np.pi) * prog)))


_SCHEDULES = {
    c.__name__: c
    for c in [FixedSchedule, ExponentialSchedule, InverseSchedule, PolySchedule,
              SigmoidSchedule, StepSchedule, MapSchedule, WarmupCosineSchedule]
}


def schedule_value(lr: Union[float, Schedule], iteration, epoch):
    if isinstance(lr, Schedule):
        return lr.value(iteration, epoch)
    return lr


# ---------------------------------------------------------------------------
# Updaters
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Updater:
    """Base updater config. ``learning_rate`` may be a float or a Schedule."""

    learning_rate: Union[float, Schedule] = 0.001

    def init_state(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def update(self, grad, state, lr, t):
        """Returns ``(value to subtract from the param, new state)``."""
        raise NotImplementedError

    def lr_at(self, iteration, epoch):
        return schedule_value(self.learning_rate, iteration, epoch)

    def to_dict(self) -> dict:
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            d[f.name] = v.to_dict() if isinstance(v, Schedule) else v
        d["@updater"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d: dict) -> "Updater":
        d = dict(d)
        cls = _UPDATERS[d.pop("@updater")]
        if isinstance(d.get("learning_rate"), dict):
            d["learning_rate"] = Schedule.from_dict(d["learning_rate"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class Sgd(Updater):
    learning_rate: Union[float, Schedule] = 0.1

    def update(self, grad, state, lr, t):
        return float(lr) * grad, state


@dataclasses.dataclass(frozen=True)
class NoOp(Updater):
    learning_rate: Union[float, Schedule] = 0.0

    def update(self, grad, state, lr, t):
        return torch.zeros_like(grad), state


@dataclasses.dataclass(frozen=True)
class Nesterovs(Updater):
    """Nesterov momentum, DL4J formulation (NesterovsUpdater):
    v' = mu*v - lr*g;  x += -mu*v + (1+mu)*v'  (we return the negation)."""

    learning_rate: Union[float, Schedule] = 0.1
    momentum: float = 0.9

    def init_state(self, param):
        return {"v": torch.zeros_like(param)}

    def update(self, grad, state, lr, t):
        v_prev = state["v"]
        v = self.momentum * v_prev - float(lr) * grad
        update = -(-self.momentum * v_prev + (1.0 + self.momentum) * v)
        return update, {"v": v}


def _adam_alpha(lr, beta1: float, beta2: float, t) -> float:
    """``lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` in float32."""
    return float(_f32(lr) * np.sqrt(_pow1m(beta2, t)) / _pow1m(beta1, t))


@dataclasses.dataclass(frozen=True)
class Adam(Updater):
    learning_rate: Union[float, Schedule] = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param)}

    def update(self, grad, state, lr, t):
        m = self.beta1 * state["m"] + (1 - self.beta1) * grad
        v = self.beta2 * state["v"] + (1 - self.beta2) * grad * grad
        alpha = _adam_alpha(lr, self.beta1, self.beta2, t)
        return alpha * m / (torch.sqrt(v) + self.epsilon), {"m": m, "v": v}


@dataclasses.dataclass(frozen=True)
class AdaMax(Updater):
    learning_rate: Union[float, Schedule] = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, param):
        return {"m": torch.zeros_like(param), "u": torch.zeros_like(param)}

    def update(self, grad, state, lr, t):
        m = self.beta1 * state["m"] + (1 - self.beta1) * grad
        u = torch.maximum(self.beta2 * state["u"], torch.abs(grad))
        alpha = float(_f32(lr) / _pow1m(self.beta1, t))
        return alpha * m / (u + self.epsilon), {"m": m, "u": u}


@dataclasses.dataclass(frozen=True)
class Nadam(Updater):
    learning_rate: Union[float, Schedule] = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param)}

    def update(self, grad, state, lr, t):
        om1 = float(_pow1m(self.beta1, t))
        om2 = float(_pow1m(self.beta2, t))
        m = self.beta1 * state["m"] + (1 - self.beta1) * grad
        v = self.beta2 * state["v"] + (1 - self.beta2) * grad * grad
        m_hat = m / om1
        v_hat = v / om2
        m_bar = self.beta1 * m_hat + (1 - self.beta1) * grad / om1
        return (float(lr) * m_bar / (torch.sqrt(v_hat) + self.epsilon),
                {"m": m, "v": v})


@dataclasses.dataclass(frozen=True)
class AMSGrad(Updater):
    learning_rate: Union[float, Schedule] = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param),
                "v_hat": torch.zeros_like(param)}

    def update(self, grad, state, lr, t):
        m = self.beta1 * state["m"] + (1 - self.beta1) * grad
        v = self.beta2 * state["v"] + (1 - self.beta2) * grad * grad
        v_hat = torch.maximum(state["v_hat"], v)
        alpha = _adam_alpha(lr, self.beta1, self.beta2, t)
        return (alpha * m / (torch.sqrt(v_hat) + self.epsilon),
                {"m": m, "v": v, "v_hat": v_hat})


@dataclasses.dataclass(frozen=True)
class AdaGrad(Updater):
    learning_rate: Union[float, Schedule] = 0.01
    epsilon: float = 1e-6

    def init_state(self, param):
        return {"h": torch.zeros_like(param)}

    def update(self, grad, state, lr, t):
        h = state["h"] + grad * grad
        return float(lr) * grad / (torch.sqrt(h) + self.epsilon), {"h": h}


@dataclasses.dataclass(frozen=True)
class AdaDelta(Updater):
    """No learning rate — DL4J AdaDeltaUpdater semantics."""

    learning_rate: Union[float, Schedule] = 0.0  # unused
    rho: float = 0.95
    epsilon: float = 1e-6

    def init_state(self, param):
        return {"eg2": torch.zeros_like(param), "edx2": torch.zeros_like(param)}

    def update(self, grad, state, lr, t):
        eg2 = self.rho * state["eg2"] + (1 - self.rho) * grad * grad
        dx = (grad * torch.sqrt(state["edx2"] + self.epsilon)
              / torch.sqrt(eg2 + self.epsilon))
        edx2 = self.rho * state["edx2"] + (1 - self.rho) * dx * dx
        return dx, {"eg2": eg2, "edx2": edx2}


@dataclasses.dataclass(frozen=True)
class RmsProp(Updater):
    learning_rate: Union[float, Schedule] = 0.001
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def init_state(self, param):
        return {"g2": torch.zeros_like(param)}

    def update(self, grad, state, lr, t):
        g2 = self.rms_decay * state["g2"] + (1 - self.rms_decay) * grad * grad
        return float(lr) * grad / torch.sqrt(g2 + self.epsilon), {"g2": g2}


_UPDATERS = {
    c.__name__: c
    for c in [Sgd, NoOp, Nesterovs, Adam, AdaMax, Nadam, AMSGrad, AdaGrad,
              AdaDelta, RmsProp]
}


def resolve_updater(spec: Union[str, Updater, dict, None]) -> Updater:
    if spec is None:
        return Sgd()
    if isinstance(spec, Updater):
        return spec
    if isinstance(spec, dict):
        return Updater.from_dict(spec)
    key = spec.lower()
    aliases = {"sgd": Sgd, "adam": Adam, "adamax": AdaMax, "nadam": Nadam,
               "amsgrad": AMSGrad, "adagrad": AdaGrad, "adadelta": AdaDelta,
               "rmsprop": RmsProp, "nesterovs": Nesterovs, "noop": NoOp,
               "none": NoOp}
    if key not in aliases:
        raise ValueError(f"Unknown updater {spec!r}")
    return aliases[key]()


# ---------------------------------------------------------------------------
# Gradient normalization (DL4J GradientNormalization enum)
# ---------------------------------------------------------------------------

def normalize_gradients(grads: Dict[str, torch.Tensor], mode,
                        threshold: float = 1.0) -> Dict[str, torch.Tensor]:
    """DL4J's GradientNormalization over one layer's gradient dict.

    Modes: None | "renormalize_l2_per_layer" | "renormalize_l2_per_param_type"
    | "clip_elementwise_absolute_value" | "clip_l2_per_layer"
    | "clip_l2_per_param_type". The norms stay on the device (no sync)."""
    if not mode or mode == "none":
        return grads
    mode = mode.lower()

    def norm(g):
        return torch.sqrt(torch.sum(g * g))

    if mode == "renormalize_l2_per_param_type":
        return {k: g / torch.clamp_min(norm(g), 1e-8) for k, g in grads.items()}
    if mode == "clip_elementwise_absolute_value":
        return {k: torch.clamp(g, -threshold, threshold) for k, g in grads.items()}
    if mode == "clip_l2_per_param_type":
        out = {}
        for k, g in grads.items():
            n = norm(g)
            out[k] = torch.where(n > threshold,
                                 g * (threshold / torch.clamp_min(n, 1e-8)), g)
        return out
    # the layer-wide modes need the joint norm
    total = sum(torch.sum(g * g) for g in grads.values())
    joint = torch.sqrt(torch.as_tensor(total))
    if mode == "renormalize_l2_per_layer":
        return {k: g / torch.clamp_min(joint, 1e-8) for k, g in grads.items()}
    if mode == "clip_l2_per_layer":
        scale = torch.where(joint > threshold,
                            threshold / torch.clamp_min(joint, 1e-8),
                            torch.ones_like(joint))
        return {k: g * scale for k, g in grads.items()}
    raise ValueError(f"Unknown gradient normalization mode {mode!r}")
