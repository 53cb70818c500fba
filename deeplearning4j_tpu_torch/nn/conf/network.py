"""Network configuration DSL — ``NeuralNetConfiguration.builder()``.

Counterpart of ``deeplearning4j_tpu/nn/conf/network.py``: the global
defaults that layers inherit (l1/l2 included), the fluent builder,
``graph_builder()`` and ``list()``, whose ``ListBuilder`` builds a
``MultiLayerConfiguration`` (global defaults, InputType propagation,
``set_n_in``, the preprocessors the layers ask for; standard or truncated
BPTT). ``updater(...)`` and ``bias_updater(...)`` resolve their argument
(a name, an ``Updater`` or its dict) through ``resolve_updater``, as the
reference does. Not ported yet: the dropout, constraint and
gradient-normalization setters, and explicit preprocessor specs
(``input_pre_processor``, with the LeNet slice), which raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer
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
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
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

    def l1(self, v: float) -> "Builder":
        self._g.l1 = v
        return self

    def l2(self, v: float) -> "Builder":
        self._g.l2 = v
        return self

    def l1_bias(self, v: float) -> "Builder":
        self._g.l1_bias = v
        return self

    def l2_bias(self, v: float) -> "Builder":
        self._g.l2_bias = v
        return self

    def dtype(self, dt: str) -> "Builder":
        self._g.dtype = dt
        return self

    def compute_dtype(self, dt: Optional[str]) -> "Builder":
        self._g.compute_dtype = dt
        return self

    def list(self) -> "ListBuilder":
        return ListBuilder(self._g)

    def graph_builder(self):
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphBuilder
        return GraphBuilder(self._g)


class ListBuilder:
    """DL4J ``NeuralNetConfiguration.ListBuilder``: layers in order."""

    def __init__(self, g: GlobalConf):
        self._g = g
        self._layers: List[Layer] = []
        self._input_type: Optional[InputType] = None
        self._backprop_type: str = "standard"
        self._tbptt_fwd: int = 20
        self._tbptt_bwd: int = 20
        self._input_pre_processors: dict = {}

    def input_pre_processor(self, index: int, spec: str) -> "ListBuilder":
        """Explicit preprocessor before layer ``index``; the spec strings
        are not ported yet, so a configuration with one refuses to build."""
        self._input_pre_processors[int(index)] = spec
        return self

    def layer(self, layer: Layer, index: Optional[int] = None) -> "ListBuilder":
        if index is not None and index != len(self._layers):
            raise ValueError("layers must be added in order")
        self._layers.append(layer)
        return self

    def set_input_type(self, input_type: InputType) -> "ListBuilder":
        self._input_type = input_type
        return self

    def backprop_type(self, t: str) -> "ListBuilder":
        self._backprop_type = normalize_backprop_type(t)
        return self

    def t_bptt_length(self, fwd: int, bwd: Optional[int] = None) -> "ListBuilder":
        self._tbptt_fwd = fwd
        self._tbptt_bwd = bwd if bwd is not None else fwd
        self._backprop_type = "truncated_bptt"
        return self

    def build(self) -> "MultiLayerConfiguration":
        conf = MultiLayerConfiguration(
            global_conf=self._g,
            layers=list(self._layers),
            input_type=self._input_type,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_bwd_length=self._tbptt_bwd,
            input_pre_processors=dict(self._input_pre_processors),
        )
        conf.finalize()
        return conf


def normalize_backprop_type(t: str) -> str:
    """One spelling for every entry point: DL4J's
    ``BackpropType.TruncatedBPTT`` and its shorthands all mean the
    truncated dispatch. Unknown spellings raise."""
    t = (t or "standard").lower()
    if t in ("tbptt", "truncatedbptt", "truncated_bptt"):
        return "truncated_bptt"
    if t != "standard":
        raise ValueError(
            f"unknown backprop_type {t!r}; expected 'standard' or "
            f"'truncated_bptt' (aliases: TBPTT, TruncatedBPTT)")
    return t


@dataclasses.dataclass
class MultiLayerConfiguration:
    global_conf: GlobalConf
    layers: List[Layer]
    input_type: Optional[InputType] = None
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_bwd_length: int = 20
    input_pre_processors: dict = dataclasses.field(default_factory=dict)
    # computed by finalize():
    preprocessors: dict = dataclasses.field(default_factory=dict)  # idx -> fn
    layer_input_types: List[Optional[InputType]] = dataclasses.field(
        default_factory=list)
    _finalized: bool = False

    def __post_init__(self):
        self.backprop_type = normalize_backprop_type(self.backprop_type)

    def finalize(self) -> None:
        """Propagate global defaults and infer shapes: each layer inherits
        the unset hyperparameters, gets its ``n_in`` from the InputType
        reaching it, and the preprocessor it asks for."""
        if self._finalized:
            return
        if not self.layers:
            raise ValueError("Configuration has no layers")
        if self.input_pre_processors:
            raise NotImplementedError(
                "explicit input_pre_processor specs are not ported yet "
                f"(layers {sorted(self.input_pre_processors)})")
        for layer in self.layers:
            layer.apply_global_defaults(self.global_conf)
        it = self.input_type
        self.layer_input_types = []
        for i, layer in enumerate(self.layers):
            if it is not None:
                pre = layer.input_preprocessor(it)
                if pre is not None:
                    self.preprocessors[i], it = pre
                layer.set_n_in(it)
            self.layer_input_types.append(it)
            if it is not None:
                it = layer.output_type(it)
        self._finalized = True

    def output_type(self) -> Optional[InputType]:
        if self.input_type is None:
            return None
        return self.layers[-1].output_type(self.layer_input_types[-1])

    def num_params(self) -> int:
        return sum(layer.num_params() for layer in self.layers)
