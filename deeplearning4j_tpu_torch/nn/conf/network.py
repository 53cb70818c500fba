"""Network configuration DSL — ``NeuralNetConfiguration.builder()``.

Counterpart of ``deeplearning4j_tpu/nn/conf/network.py``: the global
defaults that layers inherit (l1/l2 included), the fluent builder,
``graph_builder()`` and ``list()``, whose ``ListBuilder`` builds a
``MultiLayerConfiguration`` (global defaults, InputType propagation,
``set_n_in``, the preprocessors the layers ask for; standard or truncated
BPTT). ``updater(...)`` and ``bias_updater(...)`` resolve their argument
(a name, an ``Updater`` or its dict) through ``resolve_updater``, as the
reference does. ``ListBuilder.input_pre_processor(idx, spec)`` places a
``nn/conf/preprocessors.py`` spec in front of a layer.

Serde is the reference's (``global_conf_to_dict``/``global_conf_from_dict``,
``MultiLayerConfiguration.to_dict``/``to_json``/``from_dict``/``from_json``,
``to_yaml``/``from_yaml``):
the same keys, tags and ``format`` string, so a configuration written by
either package reads back in the other. The regularizer settings
(``dropout``, ``weight_noise``, ``constrain_*``,
``gradient_normalization``) are the reference's and flow into every
layer that leaves them unset. ``mini_batch`` is stored and carried, as
the reference only stores it. ``gradient_checkpointing`` recomputes each
layer's activations in the backward pass (both networks).
``optimization_algo`` and ``max_num_line_search_iterations`` choose what
``optimize/solvers.py``'s ``Solver`` runs (``fit`` ignores them, as in
the reference). ``MultiLayerConfiguration.memory_report`` is the reference's
analytic forecast (``nn/conf/memory.py`` holds the report classes).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, List, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf import preprocessors as pp
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.constraints import LayerConstraint
from deeplearning4j_tpu_torch.nn.dropout import IDropout
from deeplearning4j_tpu_torch.nn.layers.base import (
    Layer,
    activation_from_config,
    layer_from_dict,
)
from deeplearning4j_tpu_torch.nn.updaters import Updater, resolve_updater
from deeplearning4j_tpu_torch.nn.weightnoise import IWeightNoise
from deeplearning4j_tpu_torch.nn.weights import Distribution

MLN_FORMAT = "deeplearning4j_tpu.MultiLayerConfiguration"  # data, not an import

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
    dropout: Optional[Any] = None  # float keep probability or IDropout
    weight_noise: Optional[Any] = None  # IWeightNoise
    # the builder's constraints, attached to every layer at finalize()
    all_constraints: Optional[List[Any]] = None
    weight_constraints: Optional[List[Any]] = None
    bias_constraints: Optional[List[Any]] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    mini_batch: bool = True
    dtype: str = "float32"
    # mixed precision: the forward runs in this dtype on a cast of the
    # ``dtype`` master parameters; the loss head stays in f32
    compute_dtype: Optional[str] = None
    # rematerialization: recompute layer activations in the backward pass
    # instead of keeping them (FLOPs for device memory)
    gradient_checkpointing: bool = False
    # the full-batch Solver's algorithm and line-search budget
    optimization_algo: str = "stochastic_gradient_descent"
    max_num_line_search_iterations: int = 5

    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def torch_compute_dtype(self) -> Optional[torch.dtype]:
        """The forward's dtype under mixed precision (``jnp_compute_dtype``):
        None when unset, else f32, bf16 or f16; any other name raises."""
        if self.compute_dtype is None:
            return None
        return {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}[self.compute_dtype]


def global_conf_to_dict(gc: GlobalConf) -> dict:
    """A GlobalConf as the reference writes one: every field, updaters,
    the distribution, dropout, weight noise and constraints tagged."""
    g = dataclasses.asdict(gc)
    for key in ("updater", "bias_updater", "distribution", "weight_noise"):
        if getattr(gc, key) is not None:
            g[key] = getattr(gc, key).to_dict()
    if isinstance(gc.dropout, IDropout):
        g["dropout"] = gc.dropout.to_dict()
    for key in ("all_constraints", "weight_constraints", "bias_constraints"):
        if getattr(gc, key):
            g[key] = [c.to_dict() for c in getattr(gc, key)]
    return g


def global_conf_from_dict(d: dict) -> GlobalConf:
    g = dict(d)
    for key in ("updater", "bias_updater"):
        if isinstance(g.get(key), dict):
            g[key] = Updater.from_dict(g[key])
    if isinstance(g.get("distribution"), dict):
        g["distribution"] = Distribution.from_dict(g["distribution"])
    if isinstance(g.get("dropout"), dict):
        g["dropout"] = IDropout.from_dict(g["dropout"])
    if isinstance(g.get("weight_noise"), dict):
        g["weight_noise"] = IWeightNoise.from_dict(g["weight_noise"])
    g["activation"] = activation_from_config(g.get("activation"))
    for key in ("all_constraints", "weight_constraints", "bias_constraints"):
        if g.get(key):
            g[key] = [LayerConstraint.from_dict(c) if isinstance(c, dict)
                      else c for c in g[key]]
    return GlobalConf(**g)


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

    def dropout(self, keep_prob) -> "Builder":
        """A float keep probability (DL4J's shorthand) or an IDropout
        (AlphaDropout, GaussianDropout, GaussianNoise, SpatialDropout)."""
        self._g.dropout = keep_prob
        return self

    def weight_noise(self, wn) -> "Builder":
        """An IWeightNoise for every layer's weights at train-time forward
        (``DropConnect(0.5)``, ``WeightNoise(Distribution(...))``)."""
        self._g.weight_noise = wn
        return self

    def constrain_all_parameters(self, *constraints) -> "Builder":
        """Constraints on ALL parameters of every layer after each update."""
        self._g.all_constraints = (self._g.all_constraints or []) + list(constraints)
        return self

    def constrain_bias(self, *constraints) -> "Builder":
        """Constraints on every layer's biases after each update."""
        self._g.bias_constraints = (self._g.bias_constraints or []) + list(constraints)
        return self

    def constrain_weights(self, *constraints) -> "Builder":
        """Constraints on every layer's weights after each update."""
        self._g.weight_constraints = (self._g.weight_constraints or []) + list(constraints)
        return self

    def gradient_normalization(self, mode: str, threshold: float = 1.0) -> "Builder":
        self._g.gradient_normalization = mode
        self._g.gradient_normalization_threshold = threshold
        return self

    def gradient_checkpointing(self, enabled: bool = True) -> "Builder":
        """Recompute layer activations in the backward pass: less device
        memory, about one more forward of compute."""
        self._g.gradient_checkpointing = enabled
        return self

    def mini_batch(self, b: bool) -> "Builder":
        self._g.mini_batch = b
        return self

    def dtype(self, dt: str) -> "Builder":
        self._g.dtype = dt
        return self

    def compute_dtype(self, dt: Optional[str]) -> "Builder":
        self._g.compute_dtype = dt
        return self

    def optimization_algo(self, algo: str) -> "Builder":
        """The ``Solver``'s algorithm: stochastic_gradient_descent,
        line_gradient_descent, conjugate_gradient or lbfgs."""
        self._g.optimization_algo = algo
        return self

    def max_num_line_search_iterations(self, n: int) -> "Builder":
        """The ``Solver``'s line-search budget per iteration."""
        self._g.max_num_line_search_iterations = n
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
        """Explicit preprocessor before layer ``index`` (a
        ``nn/conf/preprocessors.py`` spec string), overriding the automatic
        InputType inference (``ListBuilder.inputPreProcessor``)."""
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
        reaching it, and the preprocessor it asks for (an explicit spec
        overrides the one it asks for)."""
        if self._finalized:
            return
        if not self.layers:
            raise ValueError("Configuration has no layers")
        for layer in self.layers:
            layer.apply_global_defaults(self.global_conf)
        it = self.input_type
        self.layer_input_types = []
        for i, layer in enumerate(self.layers):
            if i in self.input_pre_processors:
                spec = self.input_pre_processors[i]
                self.preprocessors[i] = lambda x, _s=spec: pp.apply(_s, x)
                if it is not None:
                    it = pp.output_type(spec, it)
            elif it is not None:
                pre = layer.input_preprocessor(it)
                if pre is not None:
                    self.preprocessors[i], it = pre
            if it is not None:
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

    def memory_report(self, batch: int = 1) -> dict:
        """Analytic per-layer memory forecast (the reference's dict): each
        layer's parameters and activation bytes at ``batch``. Every dtype
        but float32 counts 2 bytes an element, float64 included, as in the
        reference."""
        report = {"layers": [], "total_param_bytes": 0, "total_activation_bytes": 0}
        bytes_per = 4 if self.global_conf.dtype == "float32" else 2
        for i, layer in enumerate(self.layers):
            n_params = layer.num_params()
            act_elems = 0
            if self.input_type is not None:
                out = layer.output_type(self.layer_input_types[i])
                act_elems = int(math.prod(out.batch_shape(batch)))
            entry = {
                "name": layer.name or f"layer{i}",
                "type": type(layer).__name__,
                "params": n_params,
                "param_bytes": n_params * bytes_per,
                "activation_bytes": act_elems * bytes_per,
            }
            report["layers"].append(entry)
            report["total_param_bytes"] += entry["param_bytes"]
            report["total_activation_bytes"] += entry["activation_bytes"]
        return report

    # -- serde ---------------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "format": MLN_FORMAT,
            "version": 1,
            "global": global_conf_to_dict(self.global_conf),
            "layers": [layer.to_dict() for layer in self.layers],
            "input_type": (None if self.input_type is None
                           else self.input_type.to_dict()),
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_bwd_length": self.tbptt_bwd_length,
            "input_pre_processors": {str(k): v for k, v
                                     in self.input_pre_processors.items()},
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        if d.get("format", MLN_FORMAT) != MLN_FORMAT:
            raise ValueError(f"not a MultiLayerConfiguration: format "
                             f"{d.get('format')!r}")
        conf = MultiLayerConfiguration(
            global_conf=global_conf_from_dict(d["global"]),
            layers=[layer_from_dict(ld) for ld in d["layers"]],
            input_type=(None if d.get("input_type") is None
                        else InputType.from_dict(d["input_type"])),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_bwd_length=d.get("tbptt_bwd_length", 20),
            input_pre_processors={int(k): v for k, v in
                                  d.get("input_pre_processors", {}).items()},
        )
        conf.finalize()
        return conf

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))

    def to_yaml(self, **kw) -> str:
        """The serde dict as YAML (``toYaml``; needs PyYAML)."""
        import yaml
        return yaml.safe_dump(json.loads(self.to_json()), sort_keys=False, **kw)

    @staticmethod
    def from_yaml(s: str) -> "MultiLayerConfiguration":
        import yaml
        return MultiLayerConfiguration.from_dict(yaml.safe_load(s))
