"""Network configuration DSL — ``NeuralNetConfiguration.builder()``.

Counterpart of ``deeplearning4j_tpu/nn/conf/network.py``: the global
defaults that layers inherit, and the fluent builder down to
``graph_builder()``. The training-only setters (regularization, dropout,
constraints, gradient normalization) and ``list()`` come with the next
training slice. ``updater(...)`` and ``bias_updater(...)`` resolve their argument
(a name, an ``Updater`` or its dict) through ``resolve_updater``, as the
reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from deeplearning4j_tpu_torch.nn.updaters import Updater, resolve_updater
from deeplearning4j_tpu_torch.nn.weights import Distribution

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


@dataclasses.dataclass
class GlobalConf:
    """Global (per-network) defaults, inherited by layers."""

    seed: int = 12345
    activation: Optional[Any] = None
    weight_init: Optional[str] = "xavier"
    distribution: Optional[Distribution] = None
    bias_init: Optional[float] = 0.0
    updater: Optional[Updater] = None
    bias_updater: Optional[Updater] = None
    dtype: str = "float32"
    # mixed precision (forward cast to this dtype); not supported by the
    # port's forward yet — ComputationGraph raises when it is set
    compute_dtype: Optional[str] = None

    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


class NeuralNetConfiguration:
    """Entry point: ``NeuralNetConfiguration.builder()``."""

    @staticmethod
    def builder() -> "Builder":
        return Builder()


class Builder:
    def __init__(self):
        self._g = GlobalConf()

    def seed(self, s: int) -> "Builder":
        self._g.seed = int(s)
        return self

    def activation(self, a) -> "Builder":
        self._g.activation = a
        return self

    def weight_init(self, w: str,
                    distribution: Optional[Distribution] = None) -> "Builder":
        self._g.weight_init = w
        if distribution is not None:
            self._g.distribution = distribution
        return self

    def dist(self, d: Distribution) -> "Builder":
        self._g.distribution = d
        self._g.weight_init = "distribution"
        return self

    def bias_init(self, b: float) -> "Builder":
        self._g.bias_init = b
        return self

    def updater(self, u) -> "Builder":
        self._g.updater = resolve_updater(u)
        return self

    def bias_updater(self, u) -> "Builder":
        self._g.bias_updater = resolve_updater(u)
        return self

    def dtype(self, dt: str) -> "Builder":
        self._g.dtype = dt
        return self

    def compute_dtype(self, dt: Optional[str]) -> "Builder":
        self._g.compute_dtype = dt
        return self

    def graph_builder(self):
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphBuilder
        return GraphBuilder(self._g)
