"""Hyperparameter search (the Arbiter role in the reference ecosystem:
ParameterSpace → CandidateGenerator → ScoreFunction → OptimizationRunner).

A search space is a dict of named
:class:`ParameterSpace` primitives; a ``model_fn(params)`` builds a fresh
model from one sampled assignment; a ``score_fn(model, params)`` returns the
value to MINIMIZE (e.g. validation loss, ``1 - accuracy``, or an
EarlyStoppingTrainer's best score). ``RandomSearch`` samples assignments;
``GridSearch`` enumerates the product of discrete spaces. Each trial is an
independent build-train-score. Draws come from
``np.random.default_rng(seed)``, so a seed gives the JAX package's trials
exactly (a copy of its jax-free ``optimize/hpo.py``).
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


class ParameterSpace:
    def sample(self, rng: np.random.Generator):
        raise NotImplementedError

    def grid_values(self) -> Sequence:
        raise NotImplementedError(
            f"{type(self).__name__} is continuous; grid search needs "
            "Choice/IntRange spaces (or pass explicit grid_points)")


class Choice(ParameterSpace):
    """Discrete set of values."""

    def __init__(self, *values):
        if len(values) == 1 and isinstance(values[0], (list, tuple)):
            values = tuple(values[0])
        self.values = list(values)

    def sample(self, rng):
        return self.values[int(rng.integers(0, len(self.values)))]

    def grid_values(self):
        return list(self.values)


class IntRange(ParameterSpace):
    """Integers in [low, high] inclusive."""

    def __init__(self, low: int, high: int):
        self.low, self.high = int(low), int(high)

    def sample(self, rng):
        return int(rng.integers(self.low, self.high + 1))

    def grid_values(self):
        return list(range(self.low, self.high + 1))


class Uniform(ParameterSpace):
    """Float uniform in [low, high)."""

    def __init__(self, low: float, high: float):
        self.low, self.high = float(low), float(high)

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))


class LogUniform(ParameterSpace):
    """Log-uniform in [low, high) — the learning-rate space."""

    def __init__(self, low: float, high: float):
        self.low, self.high = float(low), float(high)

    def sample(self, rng):
        return float(math.exp(rng.uniform(math.log(self.low),
                                          math.log(self.high))))


class Trial:
    def __init__(self, params: Dict[str, Any], score: float, model=None):
        self.params = params
        self.score = score
        self.model = model

    def __repr__(self):
        return f"Trial(score={self.score:.6f}, params={self.params})"


class _BaseSearch:
    def __init__(self, space: Dict[str, ParameterSpace],
                 model_fn: Callable[[Dict[str, Any]], Any],
                 score_fn: Callable[[Any, Dict[str, Any]], float],
                 keep_models: bool = False):
        self.space = space
        self.model_fn = model_fn
        self.score_fn = score_fn
        self.keep_models = keep_models
        self.trials: List[Trial] = []

    def _run_one(self, params: Dict[str, Any]) -> Trial:
        model = self.model_fn(params)
        score = float(self.score_fn(model, params))
        t = Trial(params, score, model if self.keep_models else None)
        self.trials.append(t)
        return t

    @property
    def best(self) -> Optional[Trial]:
        done = [t for t in self.trials if np.isfinite(t.score)]
        return min(done, key=lambda t: t.score) if done else None


class RandomSearch(_BaseSearch):
    """Sample ``n_trials`` independent assignments (Arbiter's
    RandomSearchGenerator)."""

    def optimize(self, n_trials: int, seed: int = 0) -> Trial:
        rng = np.random.default_rng(seed)
        for _ in range(int(n_trials)):
            params = {k: s.sample(rng) for k, s in self.space.items()}
            self._run_one(params)
        return self.best


class GridSearch(_BaseSearch):
    """Exhaustive product over discrete spaces (GridSearchCandidateGenerator)."""

    def optimize(self) -> Trial:
        names = list(self.space)
        for combo in itertools.product(
                *(self.space[n].grid_values() for n in names)):
            self._run_one(dict(zip(names, combo)))
        return self.best
