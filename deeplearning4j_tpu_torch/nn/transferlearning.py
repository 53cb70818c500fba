"""Transfer learning: fine-tune, freeze, and edit trained networks.

Counterpart of ``deeplearning4j_tpu/nn/transferlearning.py`` (DL4J's
``TransferLearning.Builder`` for ``MultiLayerNetwork``,
``TransferLearning.GraphBuilder`` for ``ComputationGraph``,
``FineTuneConfiguration`` and ``TransferLearningHelper``).

A frozen layer is the configuration-level ``FrozenLayer`` wrapper: its
forward runs on detached parameters, so their gradients are 0, and it
forwards ``train`` to its inner layer (its dropout is active in ``fit``,
as in the reference). Its tensors still take the updater, on a zero
gradient: from a zero Adam state they stay bit for bit where they are.

Surgery builds a new configuration and network on the source network's
device, then copies each retained tensor (parameters and layer state)
into the new network's own tensors: the fused updater writes parameters
in place, so shared storage would make fine-tuning write through into the
source network. Re-initialised layers (``n_out_replace``, added layers)
take the port's own init draws.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Union

import torch

from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
    VertexDef,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import GlobalConf, MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.layers.wrappers import FrozenLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Updater, resolve_updater
from deeplearning4j_tpu_torch.nn.weights import Distribution


def _copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]) -> None:
    """Copy each tensor of ``src`` into ``dst``'s tensor of that name (the
    new network's registered tensors keep their identity and storage)."""
    with torch.no_grad():
        for n, t in src.items():
            dst[n].copy_(t)


@dataclasses.dataclass
class FineTuneConfiguration:
    """Global hyperparameter overrides applied to the transferred net
    (``FineTuneConfiguration.java``). Only explicitly set fields override."""

    updater: Optional[Union[str, Updater]] = None
    bias_updater: Optional[Union[str, Updater]] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    distribution: Optional[Distribution] = None
    bias_init: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    dropout: Optional[float] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None
    seed: Optional[int] = None

    def apply_to(self, g: GlobalConf) -> GlobalConf:
        g = copy.deepcopy(g)
        for f in ("activation", "weight_init", "distribution", "bias_init",
                  "l1", "l2", "l1_bias", "l2_bias", "dropout",
                  "gradient_normalization", "gradient_normalization_threshold",
                  "seed"):
            v = getattr(self, f)
            if v is not None:
                setattr(g, f, v)
        if self.updater is not None:
            g.updater = resolve_updater(self.updater)
        if self.bias_updater is not None:
            g.bias_updater = resolve_updater(self.bias_updater)
        return g

    def apply_to_layer(self, layer: Layer) -> None:
        """Clear per-layer values that a fine-tune override should replace, so
        ``apply_global_defaults`` re-inherits them from the new global conf
        (per-layer overrides beat globals in DL4J; fine-tuning resets them on
        every non-frozen layer, ``FineTuneConfiguration.applyToLayer``)."""
        if isinstance(layer, FrozenLayer):
            return
        for f in ("updater", "bias_updater", "activation", "weight_init",
                  "distribution", "bias_init", "dropout", "l1", "l2",
                  "l1_bias", "l2_bias", "gradient_normalization"):
            if getattr(self, f) is not None:
                setattr(layer, f, None)
        if self.gradient_normalization_threshold is not None:
            layer.gradient_normalization_threshold = self.gradient_normalization_threshold


class TransferLearning:
    """Namespace matching the reference API: ``TransferLearning.Builder`` for
    sequential nets, ``TransferLearning.GraphBuilder`` for DAGs."""

    class Builder:
        """Surgery on a trained MultiLayerNetwork (``TransferLearning.Builder``)."""

        def __init__(self, net: MultiLayerNetwork):
            if net.params is None:
                raise ValueError("network must be initialized (call .init())")
            self._net = net
            self._ftc: Optional[FineTuneConfiguration] = None
            self._freeze_until: Optional[int] = None
            # surgery recorded as (op, args) applied in order at build()
            self._removed_from_output = 0
            self._appended: List[Layer] = []
            self._nout_replaced: Dict[int, tuple] = {}
            self._input_type: Optional[InputType] = None

        def fine_tune_configuration(self, ftc: FineTuneConfiguration) -> "TransferLearning.Builder":
            self._ftc = ftc
            return self

        def set_feature_extractor(self, layer_index: int) -> "TransferLearning.Builder":
            """Freeze layers [0, layer_index] (inclusive)."""
            self._freeze_until = layer_index
            return self

        def remove_output_layer(self) -> "TransferLearning.Builder":
            return self.remove_layers_from_output(1)

        def remove_layers_from_output(self, n: int) -> "TransferLearning.Builder":
            self._removed_from_output += n
            return self

        def add_layer(self, layer: Layer) -> "TransferLearning.Builder":
            self._appended.append(layer)
            return self

        def n_out_replace(self, layer_index: int, n_out: int,
                          weight_init: Optional[str] = None,
                          distribution: Optional[Distribution] = None) -> "TransferLearning.Builder":
            """Change layer ``layer_index``'s n_out; that layer and its
            consumer are re-initialized (``TransferLearning.nOutReplace``)."""
            self._nout_replaced[layer_index] = (n_out, weight_init, distribution)
            return self

        def set_input_type(self, it: InputType) -> "TransferLearning.Builder":
            self._input_type = it
            return self

        def build(self) -> MultiLayerNetwork:
            old_conf = self._net.conf
            n_old = len(old_conf.layers)
            keep = n_old - self._removed_from_output
            if keep < 0:
                raise ValueError("removed more layers than the network has")

            new_layers: List[Layer] = [copy.deepcopy(old_conf.layers[i])
                                       for i in range(keep)]
            reinit: Set[int] = set()

            def inner_of(l: Layer) -> Layer:
                return l.layer if isinstance(l, FrozenLayer) else l

            for i, (n_out, w, dist) in self._nout_replaced.items():
                inner = inner_of(new_layers[i])
                inner.n_out = n_out
                if w is not None:
                    inner.weight_init = w
                if dist is not None:
                    inner.distribution = dist
                reinit.add(i)
                if i + 1 < keep:
                    nxt = inner_of(new_layers[i + 1])
                    if hasattr(nxt, "n_in"):
                        nxt.n_in = 0  # re-infer from the new upstream width
                    reinit.add(i + 1)
            if self._freeze_until is not None:
                for i in range(min(self._freeze_until + 1, keep)):
                    if not isinstance(new_layers[i], FrozenLayer):
                        new_layers[i] = FrozenLayer(layer=new_layers[i])
            for j, l in enumerate(self._appended):
                reinit.add(keep + j)
                new_layers.append(copy.deepcopy(l))

            g = old_conf.global_conf
            if self._ftc is not None:
                g = self._ftc.apply_to(g)
                for i, l in enumerate(new_layers):
                    if self._freeze_until is None or i > self._freeze_until:
                        self._ftc.apply_to_layer(l)

            new_conf = MultiLayerConfiguration(
                global_conf=g,
                layers=new_layers,
                input_type=self._input_type or old_conf.input_type,
                backprop_type=old_conf.backprop_type,
                tbptt_fwd_length=old_conf.tbptt_fwd_length,
                tbptt_bwd_length=old_conf.tbptt_bwd_length,
            )
            new_conf.finalize()
            new_net = MultiLayerNetwork(new_conf, device=self._net.device).init(seed=g.seed)
            for i in range(keep):
                if i not in reinit:
                    _copy_into(new_net.params[i], self._net.params[i])
                    _copy_into(new_net.states[i], self._net.states[i])
            return new_net

    class GraphBuilder:
        """Surgery on a trained ComputationGraph (``TransferLearning.GraphBuilder:447``)."""

        def __init__(self, graph: ComputationGraph):
            if graph.params is None:
                raise ValueError("graph must be initialized (call .init())")
            self._graph = graph
            self._ftc: Optional[FineTuneConfiguration] = None
            self._freeze_boundary: List[str] = []
            self._removed: Set[str] = set()
            self._added: List[VertexDef] = []
            self._nout_replaced: Dict[str, tuple] = {}
            self._outputs: Optional[List[str]] = None

        def fine_tune_configuration(self, ftc: FineTuneConfiguration) -> "TransferLearning.GraphBuilder":
            self._ftc = ftc
            return self

        def set_feature_extractor(self, *vertex_names: str) -> "TransferLearning.GraphBuilder":
            """Freeze the named vertices and every ancestor of them."""
            self._freeze_boundary = list(vertex_names)
            return self

        def remove_vertex(self, name: str, remove_connections: bool = True) -> "TransferLearning.GraphBuilder":
            self._removed.add(name)
            if remove_connections:
                # downstream-only removal: also drop vertices that depend on it
                conf = self._graph.conf
                changed = True
                while changed:
                    changed = False
                    for vn, vd in conf.vertices.items():
                        if vn in self._removed:
                            continue
                        if any(s in self._removed for s in vd.inputs):
                            self._removed.add(vn)
                            changed = True
            return self

        def add_layer(self, name: str, layer: Layer, *inputs: str) -> "TransferLearning.GraphBuilder":
            layer.name = layer.name or name
            self._added.append(VertexDef(name, layer, list(inputs)))
            return self

        def add_vertex(self, name: str, vertex, *inputs: str) -> "TransferLearning.GraphBuilder":
            self._added.append(VertexDef(name, vertex, list(inputs)))
            return self

        def set_outputs(self, *names: str) -> "TransferLearning.GraphBuilder":
            self._outputs = list(names)
            return self

        def n_out_replace(self, name: str, n_out: int,
                          weight_init: Optional[str] = None,
                          distribution: Optional[Distribution] = None) -> "TransferLearning.GraphBuilder":
            self._nout_replaced[name] = (n_out, weight_init, distribution)
            return self

        def _ancestors(self, names: Sequence[str]) -> Set[str]:
            conf = self._graph.conf
            out: Set[str] = set()
            stack = [n for n in names if n in conf.vertices]
            while stack:
                n = stack.pop()
                if n in out:
                    continue
                out.add(n)
                for src in conf.vertices[n].inputs:
                    if src in conf.vertices:
                        stack.append(src)
            return out

        def build(self) -> ComputationGraph:
            old = self._graph.conf
            frozen = self._ancestors(self._freeze_boundary)
            reinit: Set[str] = set()

            # consumers of an n_out-replaced vertex must re-infer their n_in
            consumers: Dict[str, List[str]] = {}
            for vn, vd in old.vertices.items():
                for s in vd.inputs:
                    consumers.setdefault(s, []).append(vn)

            g = old.global_conf
            if self._ftc is not None:
                g = self._ftc.apply_to(g)

            vertices: Dict[str, VertexDef] = {}
            for vn in old.topo_order:
                if vn in self._removed:
                    continue
                vd = old.vertices[vn]
                obj = copy.deepcopy(vd.obj)
                if vn in self._nout_replaced and vd.is_layer:
                    n_out, w, dist = self._nout_replaced[vn]
                    inner = obj.layer if isinstance(obj, FrozenLayer) else obj
                    inner.n_out = n_out
                    if w is not None:
                        inner.weight_init = w
                    if dist is not None:
                        inner.distribution = dist
                    reinit.add(vn)
                    for cn in consumers.get(vn, []):
                        cvd = old.vertices[cn]
                        if cvd.is_layer:
                            reinit.add(cn)
                if vn in frozen and vd.is_layer and not isinstance(obj, FrozenLayer):
                    obj = FrozenLayer(layer=obj)
                if vd.is_layer and self._ftc is not None and vn not in frozen:
                    self._ftc.apply_to_layer(obj)
                vertices[vn] = VertexDef(vn, obj, list(vd.inputs))
            for vd in self._added:
                reinit.add(vd.name)
                vertices[vd.name] = vd

            # consumers of reinit'd layers need n_in re-inferred
            for vn in list(reinit):
                for cn in consumers.get(vn, []):
                    if cn in vertices and vertices[cn].is_layer:
                        obj = vertices[cn].obj
                        inner = obj.layer if isinstance(obj, FrozenLayer) else obj
                        if hasattr(inner, "n_in"):
                            inner.n_in = 0
                            reinit.add(cn)

            outputs = self._outputs or [o for o in old.outputs if o in vertices]
            new_conf = ComputationGraphConfiguration(
                global_conf=g,
                inputs=list(old.inputs),
                outputs=outputs,
                vertices=vertices,
                input_types=list(old.input_types),
                backprop_type=old.backprop_type,
                tbptt_fwd_length=old.tbptt_fwd_length,
                tbptt_bwd_length=old.tbptt_bwd_length,
            )
            new_conf.finalize()
            new_graph = ComputationGraph(new_conf, device=self._graph.device).init(seed=g.seed)
            for vn, p in self._graph.params.items():
                if vn in vertices and vn not in reinit:
                    _copy_into(new_graph.params[vn], p)
                    _copy_into(new_graph.states[vn], self._graph.states[vn])
            return new_graph


class TransferLearningHelper:
    """Featurization helper (``TransferLearningHelper.java``): runs the frozen
    trunk once per example and trains only the unfrozen head on the cached
    features — the reference's featurize/fitFeaturized workflow."""

    def __init__(self, net: MultiLayerNetwork, frozen_till: int):
        self._net = net
        self._split = frozen_till + 1
        if self._split >= len(net.layers):
            raise ValueError("frozen_till must leave at least one trainable layer")
        head_layers = [copy.deepcopy(l) for l in net.conf.layers[self._split:]]
        head_conf = MultiLayerConfiguration(
            global_conf=net.conf.global_conf,
            layers=head_layers,
            input_type=net.conf.layer_input_types[self._split],
            backprop_type=net.conf.backprop_type,
            tbptt_fwd_length=net.conf.tbptt_fwd_length,
            tbptt_bwd_length=net.conf.tbptt_bwd_length,
        )
        head_conf.finalize()
        self._head = MultiLayerNetwork(head_conf, device=net.device).init(
            seed=net.conf.global_conf.seed)
        for j in range(len(head_layers)):
            _copy_into(self._head.params[j], net.params[self._split + j])
            _copy_into(self._head.states[j], net.states[self._split + j])

    @property
    def unfrozen_mln(self) -> MultiLayerNetwork:
        return self._head

    def featurize(self, ds):
        """Run the frozen trunk forward (inference mode); returns a DataSet
        of the features, on the network's device, and the labels."""
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet
        acts = self._net.feed_forward_to_layer(self._split - 1, ds.features)[self._split]
        # the head conf's input_type is post-preprocessor, so apply the
        # original net's preprocessor for the first head layer here
        pre = self._net.conf.preprocessors.get(self._split)
        if pre is not None:
            acts = pre(acts)
        # a copy outside inference mode, so that a fit can save it
        return DataSet(acts.clone(), ds.labels)

    def fit_featurized(self, ds, epochs: int = 1) -> None:
        self._head.fit(ds.features, ds.labels, epochs=epochs)

    def output_from_featurized(self, features):
        return self._head.output(features)
