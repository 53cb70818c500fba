"""ComputationGraphConfiguration + GraphBuilder.

Counterpart of ``deeplearning4j_tpu/nn/conf/graph_conf.py``: named inputs,
layer and vertex nodes with named input edges, named outputs, a
topological order computed once at build time, InputType propagation
through the DAG (which sets every layer's ``n_in`` and gives a layer the
reshape it asks for, as ``MultiLayerConfiguration`` does), explicit
per-vertex preprocessor specs (``input_pre_processors``, written to the
JSON only when there are any; the DL4J reader sets them), standard or
truncated BPTT (``backprop_type``, ``t_bptt_length``), and the reference's serde
(``to_dict``/``to_json``/``to_yaml`` and back, the same keys and
``format`` string), so a configuration written by either package reads
back in the other. A layer or vertex kind the port has not ported raises
``NotImplementedError`` naming it when read.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Union

from deeplearning4j_tpu_torch.nn.conf import preprocessors as pp
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import (
    GlobalConf,
    global_conf_from_dict,
    global_conf_to_dict,
    normalize_backprop_type,
)
from deeplearning4j_tpu_torch.nn.layers.base import Layer, layer_from_dict
from deeplearning4j_tpu_torch.nn.vertices import GraphVertex

GRAPH_FORMAT = "deeplearning4j_tpu.ComputationGraphConfiguration"  # data, not an import


@dataclasses.dataclass
class VertexDef:
    """One DAG node: a Layer (has params) or a GraphVertex (pure function)."""

    name: str
    obj: Union[Layer, GraphVertex]
    inputs: List[str]

    @property
    def is_layer(self) -> bool:
        return isinstance(self.obj, Layer)


class GraphBuilder:
    """Fluent DAG builder (ComputationGraphConfiguration.GraphBuilder)."""

    def __init__(self, g: GlobalConf):
        self._g = g
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._vertices: Dict[str, VertexDef] = {}
        self._input_types: List[Optional[InputType]] = []
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_bwd = 20
        self._input_pre_processors: Dict[str, str] = {}

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str) -> "GraphBuilder":
        if name in self._vertices or name in self._inputs:
            raise ValueError(f"duplicate vertex name {name!r}")
        layer.name = layer.name or name
        self._vertices[name] = VertexDef(name, layer, list(inputs))
        return self

    def add_vertex(self, name: str, vertex: GraphVertex,
                   *inputs: str) -> "GraphBuilder":
        if name in self._vertices or name in self._inputs:
            raise ValueError(f"duplicate vertex name {name!r}")
        self._vertices[name] = VertexDef(name, vertex, list(inputs))
        return self

    def input_pre_processor(self, name: str, spec: str) -> "GraphBuilder":
        """An explicit preprocessor (a ``nn/conf/preprocessors.py`` spec)
        in front of layer vertex ``name`` (``GraphBuilder.inputPreProcessor``),
        overriding the one its input type would give it."""
        self._input_pre_processors[name] = spec
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        self._input_types = list(types)
        return self

    def backprop_type(self, t: str) -> "GraphBuilder":
        self._backprop_type = normalize_backprop_type(t)
        return self

    def t_bptt_length(self, fwd: int, bwd: Optional[int] = None) -> "GraphBuilder":
        """Truncated BPTT in chunks of ``fwd`` steps (sets the backprop
        type too, as the reference does)."""
        self._tbptt_fwd = fwd
        self._tbptt_bwd = bwd if bwd is not None else fwd
        self._backprop_type = "truncated_bptt"
        return self

    def build(self) -> "ComputationGraphConfiguration":
        conf = ComputationGraphConfiguration(
            global_conf=self._g,
            inputs=list(self._inputs),
            outputs=list(self._outputs),
            vertices=dict(self._vertices),
            input_types=list(self._input_types),
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_bwd_length=self._tbptt_bwd,
            input_pre_processors=dict(self._input_pre_processors),
        )
        conf.finalize()
        return conf


@dataclasses.dataclass
class ComputationGraphConfiguration:
    global_conf: GlobalConf
    inputs: List[str]
    outputs: List[str]
    vertices: Dict[str, VertexDef]
    input_types: List[Optional[InputType]] = dataclasses.field(default_factory=list)
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_bwd_length: int = 20
    # explicit preprocessor specs (nn/conf/preprocessors.py) by layer vertex
    input_pre_processors: Dict[str, str] = dataclasses.field(default_factory=dict)
    # computed by finalize():
    topo_order: List[str] = dataclasses.field(default_factory=list)
    preprocessors: Dict[str, object] = dataclasses.field(default_factory=dict)
    vertex_input_types: Dict[str, List[InputType]] = dataclasses.field(
        default_factory=dict)
    _finalized: bool = False

    def __post_init__(self):
        self.backprop_type = normalize_backprop_type(self.backprop_type)

    def finalize(self) -> None:
        if self._finalized:
            return
        if not self.inputs:
            raise ValueError("graph has no inputs")
        if not self.outputs:
            raise ValueError("graph has no outputs")
        for name, vd in self.vertices.items():
            for src in vd.inputs:
                if src not in self.vertices and src not in self.inputs:
                    raise ValueError(
                        f"vertex {name!r} references unknown input {src!r}")
        for out in self.outputs:
            if out not in self.vertices:
                raise ValueError(f"output {out!r} is not a vertex")
        self._topo_sort()
        for vd in self.vertices.values():
            if vd.is_layer:
                vd.obj.apply_global_defaults(self.global_conf)
        for name, spec in self.input_pre_processors.items():
            if name not in self.vertices or not self.vertices[name].is_layer:
                raise ValueError(f"preprocessor for {name!r}, which is not a "
                                 f"layer vertex")
            self.preprocessors[name] = lambda x, _s=spec: pp.apply(_s, x)
        if self.input_types and all(t is not None for t in self.input_types):
            self._infer_types()
        self._finalized = True

    def _topo_sort(self) -> None:
        """Kahn's algorithm, ties broken by name (the reference's order)."""
        indeg = {n: 0 for n in self.vertices}
        dependents: Dict[str, List[str]] = {n: [] for n in self.vertices}
        for name, vd in self.vertices.items():
            for src in vd.inputs:
                if src in self.vertices:
                    indeg[name] += 1
                    dependents[src].append(name)
        ready = sorted(n for n, d in indeg.items() if d == 0)
        order: List[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for m in sorted(dependents[n]):
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        if len(order) != len(self.vertices):
            cyc = set(self.vertices) - set(order)
            raise ValueError(f"graph has a cycle involving {sorted(cyc)}")
        self.topo_order = order

    def _infer_types(self) -> None:
        if len(self.input_types) != len(self.inputs):
            raise ValueError("set_input_types needs one InputType per input")
        types: Dict[str, InputType] = dict(zip(self.inputs, self.input_types))
        for name in self.topo_order:
            vd = self.vertices[name]
            in_types = [types[src] for src in vd.inputs]
            self.vertex_input_types[name] = in_types
            if vd.is_layer and getattr(vd.obj, "consumes_multiple_inputs", False):
                # a multi-input layer (cross-attention) sees every input's
                # type apart: no concatenation, no preprocessor
                vd.obj.set_n_in_multi(in_types)
                types[name] = vd.obj.output_type_multi(in_types)
            elif vd.is_layer:
                it = in_types[0]
                if name in self.input_pre_processors:
                    it = pp.output_type(self.input_pre_processors[name], it)
                else:
                    pre = vd.obj.input_preprocessor(it)
                    if pre is not None:
                        self.preprocessors[name], it = pre
                vd.obj.set_n_in(it)
                types[name] = vd.obj.output_type(it)
            else:
                types[name] = vd.obj.output_type(in_types)

    def layer_vertices(self) -> List[VertexDef]:
        return [self.vertices[n] for n in self.topo_order
                if self.vertices[n].is_layer]

    def num_params(self) -> int:
        return sum(vd.obj.num_params() for vd in self.layer_vertices())

    # ---------------------------------------------------------------- serde
    def to_dict(self) -> dict:
        d = {
            "format": GRAPH_FORMAT,
            "version": 1,
            "global": global_conf_to_dict(self.global_conf),
            "inputs": list(self.inputs),
            "outputs": list(self.outputs),
            "vertices": [
                {"name": vd.name, "inputs": list(vd.inputs),
                 "def": vd.obj.to_dict()}
                for vd in (self.vertices[n] for n in self.topo_order)],
            "input_types": [None if t is None else t.to_dict()
                            for t in self.input_types],
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_bwd_length": self.tbptt_bwd_length,
        }
        if self.input_pre_processors:
            d["input_pre_processors"] = dict(self.input_pre_processors)
        return d

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @staticmethod
    def from_dict(d: dict) -> "ComputationGraphConfiguration":
        if d.get("format", GRAPH_FORMAT) != GRAPH_FORMAT:
            raise ValueError(f"not a ComputationGraphConfiguration: format "
                             f"{d.get('format')!r}")
        vertices: Dict[str, VertexDef] = {}
        for vd in d["vertices"]:
            obj_d = vd["def"]
            obj = (layer_from_dict(obj_d) if "@layer" in obj_d
                   else GraphVertex.from_dict(obj_d))
            vertices[vd["name"]] = VertexDef(vd["name"], obj, list(vd["inputs"]))
        conf = ComputationGraphConfiguration(
            global_conf=global_conf_from_dict(d["global"]),
            inputs=list(d["inputs"]),
            outputs=list(d["outputs"]),
            vertices=vertices,
            input_types=[None if t is None else InputType.from_dict(t)
                         for t in d.get("input_types", [])],
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_bwd_length=d.get("tbptt_bwd_length", 20),
            input_pre_processors=dict(d.get("input_pre_processors") or {}),
        )
        conf.finalize()
        return conf

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))

    def to_yaml(self, **kw) -> str:
        """The serde dict as YAML (``toYaml``; needs PyYAML)."""
        import yaml
        return yaml.safe_dump(json.loads(self.to_json()), sort_keys=False, **kw)

    @staticmethod
    def from_yaml(s: str) -> "ComputationGraphConfiguration":
        import yaml
        return ComputationGraphConfiguration.from_dict(yaml.safe_load(s))
