"""Keras model-level import into the port: Sequential -> MultiLayerNetwork,
functional Model -> ComputationGraph.

Counterpart of ``deeplearning4j_tpu/modelimport/keras/model.py`` (DL4J's
``KerasModel.java``, ``KerasSequentialModel.java``,
``utils/KerasModelBuilder.java``): the same configuration parsing,
channels-first detection, input types and topology. A configuration comes
from a standalone JSON or from the ``model_config`` attribute of a
full-model HDF5; weights live under ``model_weights`` (full save) or at the
file root (save_weights). ``init(device=None)`` builds the network on
``cuda`` (``"cpu"`` for the CPU). ``copy_weights`` writes each imported
array into the network's own tensors in place, under ``no_grad``, in their
dtype and on their device, so the updater state and a fused updater
kernel keep pointing at the tensors they were made for.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.modelimport.keras.hdf5 import Hdf5Archive, read_weights_for_layer
from deeplearning4j_tpu_torch.modelimport.keras.layers import (
    LOSSES,
    InvalidKerasConfigurationException,
    UnsupportedKerasConfigurationException,
    map_keras_layer,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, LossLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.vertices import ElementWiseVertex, MergeVertex, PreprocessorVertex


def _reshape_spec(conf: dict) -> str:
    """Keras Reshape target_shape → ``reshape:`` preprocessor spec. A -1
    wildcard dim needs the upstream element count to resolve, which the
    import-time spec cannot carry — rejected loudly rather than emitting a
    corrupt negative-size InputType."""
    target = conf.get("target_shape") or ()
    dims = [int(d) for d in target]
    if any(d < 0 for d in dims):
        raise UnsupportedKerasConfigurationException(
            f"Reshape target_shape {tuple(target)} contains a -1 wildcard; "
            "re-save the model with explicit dimensions")
    return "reshape:" + ",".join(str(d) for d in dims)


def _channels_first(layer_configs) -> bool:
    """True when the model declares theano dim ordering / channels_first —
    then rank-3 input shapes are [C,H,W] and must be re-interpreted for
    this framework's NHWC layout (KerasLayer.getDimOrder role).

    A model whose LAYOUT-BEARING layers (conv/pooling — the ones whose
    data_format decides how spatial inputs are interpreted) mix both
    orderings is rejected loudly: one whole-model flag cannot honestly
    re-interpret per-branch input shapes, and silently picking either
    ordering would mis-map the other branch's [H,W,C]/[C,H,W] inputs.
    Pass-through layers that merely serialize a data_format field
    (Flatten, a lone default-format pooling after channels_first convs…)
    follow the conv layers' ordering and do not create a conflict."""
    bearing, other = set(), set()
    for lc in layer_configs:
        cls = lc.get("class_name") or ""
        c = lc.get("config", {})
        fmt = c.get("dim_ordering") or c.get("data_format")
        if fmt in ("th", "channels_first"):
            fmt = "channels_first"
        elif fmt in ("tf", "channels_last"):
            fmt = "channels_last"
        else:
            continue
        if "Conv" in cls or "Pooling" in cls:
            bearing.add(fmt)
        else:
            other.add(fmt)
    if len(bearing) > 1:
        raise UnsupportedKerasConfigurationException(
            "model mixes channels_first and channels_last conv/pooling "
            "layers; re-save with a single data_format")
    decisive = bearing or other
    return "channels_first" in decisive and len(decisive) == 1


def _input_type_from_shape(shape, channels_first: bool = False) -> InputType:
    """Keras input_shape/batch_input_shape (batch dim stripped) → InputType.
    Layout is channels_last (NHWC), the framework's layout; a channels-first
    model's [C,H,W] input shape maps to the equivalent NHWC type."""
    shape = tuple(shape)
    if channels_first and len(shape) == 3:
        c, h, w = shape
        return InputType.convolutional(h, w, c)
    if len(shape) == 1:
        return InputType.feed_forward(shape[0])
    if len(shape) == 2:
        t, features = shape  # (timesteps-or-None, features)
        return InputType.recurrent(features, t)
    if len(shape) == 3:
        h, w, c = shape
        return InputType.convolutional(h, w, c)
    if len(shape) == 4:
        t, h, w, c = shape  # image sequence (ConvLSTM2D / TimeDistributed conv)
        return InputType.recurrent_convolutional(h, w, c, t)
    raise UnsupportedKerasConfigurationException(f"Unsupported input shape {shape}")


def _to_loss(loss_name: Optional[str]) -> Optional[str]:
    if not loss_name:
        return None
    return LOSSES.get(str(loss_name).lower())


class KerasModelConfig:
    """Parsed top-level Keras config."""

    def __init__(self, config_json: dict, training_json: Optional[dict] = None):
        self.class_name = config_json.get("class_name")
        self.config = config_json.get("config")
        self.training = training_json or {}

    @property
    def loss(self) -> Optional[str]:
        return _to_loss(self.training.get("loss"))

    @property
    def layer_configs(self) -> List[dict]:
        if isinstance(self.config, list):  # Keras 1 Sequential
            return self.config
        return self.config.get("layers", [])


class KerasSequentialModel:
    """Sequential import (``KerasSequentialModel.java``)."""

    def __init__(self, model_config: KerasModelConfig):
        self.cfg = model_config
        self.layer_names: List[str] = []
        self.weight_fns: Dict[str, object] = {}
        self._build()

    def _build(self):
        input_type: Optional[InputType] = None
        layers = []
        explicit_pre: Dict[int, str] = {}
        ch_first = _channels_first(self.cfg.layer_configs)
        for lc in self.cfg.layer_configs:
            cls = lc["class_name"]
            conf = dict(lc.get("config", {}))
            if input_type is None:
                shape = conf.get("batch_input_shape") or conf.get("batch_shape")
                if shape is not None and cls == "Embedding":
                    # token-index sequence [N, T] (T may be None — the imdb
                    # fixtures declare [None, None]); never a raw ff size
                    input_type = InputType.recurrent(
                        1, shape[1] if len(shape) > 1 else None)
                elif shape is not None:
                    input_type = _input_type_from_shape(shape[1:], ch_first)
                elif "input_shape" in conf:
                    input_type = _input_type_from_shape(conf["input_shape"],
                                                        ch_first)
                elif "input_dim" in conf and cls in ("Dense", "Embedding"):
                    if cls == "Embedding":
                        input_type = InputType.recurrent(
                            1, conf.get("input_length"))
                    else:
                        input_type = InputType.feed_forward(int(conf["input_dim"]))
            if cls == "Reshape":
                # KerasReshape.java: a Reshape layer IS an input preprocessor
                # on the next layer (raw row-major reshape after batch)
                explicit_pre[len(layers)] = _reshape_spec(conf)
                continue
            if cls == "Flatten" and len(layers) in explicit_pre:
                # Reshape→Flatten→Dense: the flatten normally rides the
                # dense layer's AUTO preprocessor, but an explicit spec
                # replaces auto inference — compose the flatten matching
                # the reshape target's RANK. Keras Flatten is a row-major
                # collapse of the per-example dims: rank-3 [H,W,C] →
                # cnn_to_ff ([N,H*W*C], same memory order); rank-2 [T,C] →
                # a raw reshape to [N, T*C] (NOT rnn_to_ff, which is the
                # per-timestep [N*T,C] view and changes the batch size);
                # rank-1 is already flat.
                spec = explicit_pre[len(layers)]
                tail = spec.rsplit("|", 1)[-1]
                if not tail.startswith("reshape:"):
                    # only tails KNOWN to produce flat per-example output
                    # make the Flatten a no-op (cnn_to_ff/rnn_to_ff collapse
                    # to [*, C]); a rank-raising or unknown tail silently
                    # dropping the Flatten would corrupt the topology
                    if tail in ("cnn_to_ff", "rnn_to_ff"):
                        continue
                    raise UnsupportedKerasConfigurationException(
                        f"Flatten after explicit preprocessor {spec!r}: "
                        f"tail {tail!r} is not known to produce flat "
                        "output, so the Flatten cannot be composed or "
                        "skipped safely")
                dims = [int(d) for d in
                        tail[len("reshape:"):].split(",")]
                if len(dims) > 1:
                    # Keras Flatten = row-major collapse of the per-example
                    # dims, i.e. a raw reshape to prod(dims) for ANY rank
                    # (identical to cnn_to_ff at rank 3)
                    total = 1
                    for d in dims:
                        total *= d
                    explicit_pre[len(layers)] += f"|reshape:{total}"
                continue
            layer, wf = map_keras_layer(cls, conf)
            if layer is None:
                continue
            lname = conf.get("name") or f"layer_{len(layers)}"
            layer.name = lname
            self.layer_names.append(lname)
            self.weight_fns[lname] = wf
            layers.append(layer)
        if input_type is None:
            raise InvalidKerasConfigurationException(
                "Sequential model config declares no input shape")
        if not layers:
            raise InvalidKerasConfigurationException("model has no layers")

        # attach the training loss: final Dense becomes an OutputLayer,
        # otherwise a LossLayer caps the stack (KerasLoss.java behavior)
        loss = self.cfg.loss
        if loss is not None:
            last = layers[-1]
            if type(last) is DenseLayer:
                out = OutputLayer(name=last.name, n_in=last.n_in, n_out=last.n_out,
                                  activation=last.activation, has_bias=last.has_bias,
                                  loss=loss)
                layers[-1] = out
            elif not last.has_loss():
                layers.append(LossLayer(name="keras_loss", loss=loss,
                                        activation="identity"))

        b = NeuralNetConfiguration.builder().list()
        for l in layers:
            b.layer(l)
        for idx, spec in explicit_pre.items():
            if idx >= len(layers):
                raise UnsupportedKerasConfigurationException(
                    "Reshape as the final layer has no consumer to attach to")
            b.input_pre_processor(idx, spec)
        self.conf = b.set_input_type(input_type).build()

    def init(self, device=None) -> MultiLayerNetwork:
        return MultiLayerNetwork(self.conf, device=device).init()

    def copy_weights(self, net: MultiLayerNetwork, archive: Hdf5Archive,
                     *root: str) -> None:
        _copy_weights(self, net, dict(enumerate(l.name for l in net.layers)),
                      archive, root)


def _copy_weights(km, net, keys: dict, archive, root) -> None:
    """Every imported layer's Keras weights into ``net`` (``keys``: the
    network's container key of each layer name), checked first, then
    copied in place."""
    by_name = {name: key for key, name in keys.items()}
    writes = []
    for lname in km.layer_names:
        if lname not in by_name:
            continue
        raw = read_weights_for_layer(archive, lname, *root)
        if not raw:
            continue
        params, states = km.weight_fns[lname](raw)
        key = by_name[lname]
        writes += _checked(net.params[key], params, lname)
        writes += _checked(net.states[key], states, lname, what="state")
    with torch.no_grad():
        for dest, arr in writes:
            dest.copy_(torch.from_numpy(np.array(arr)).to(dest.dtype))


def _checked(target: dict, src: dict, lname: str, what: str = "param") -> list:
    """``[(tensor, array), ...]`` of ``src`` into ``target``, every name and
    shape checked."""
    out = []
    for k, v in src.items():
        if k not in target:
            raise InvalidKerasConfigurationException(
                f"layer {lname!r}: imported {what} {k!r} not in model {what}s "
                f"{sorted(target)}")
        if tuple(target[k].shape) != tuple(np.shape(v)):
            raise InvalidKerasConfigurationException(
                f"layer {lname!r} {what} {k!r}: shape {np.shape(v)} does not "
                f"match model {tuple(target[k].shape)}")
        out.append((target[k], v))
    return out


class KerasModel:
    """Functional-API import (``KerasModel.java``) → ComputationGraph."""

    MERGE_LAYERS = {"Concatenate", "Merge"}
    ELEMENTWISE = {"Add": "add", "Average": "average", "Subtract": "subtract",
                   "Multiply": "product", "Maximum": "max"}

    def __init__(self, model_config: KerasModelConfig):
        self.cfg = model_config
        self.layer_names: List[str] = []
        self.weight_fns: Dict[str, object] = {}
        self._build()

    @staticmethod
    def _inbound(lc: dict) -> List[str]:
        nodes = lc.get("inbound_nodes") or []
        if not nodes:
            return []
        node = nodes[0]
        names = []
        if isinstance(node, dict):  # Keras 3 style {"args": [...]}
            def walk(o):
                if isinstance(o, dict):
                    if o.get("class_name") == "__keras_tensor__":
                        names.append(o["config"]["keras_history"][0])
                    else:
                        for v in o.values():
                            walk(v)
                elif isinstance(o, (list, tuple)):
                    for v in o:
                        walk(v)
            walk(node)
        else:
            for entry in node:
                names.append(entry[0])
        return names

    def _build(self):
        conf = self.cfg.config
        layer_confs = conf["layers"]

        def names_of(specs) -> List[str]:
            # Keras 2: [["name", 0, 0], ...]; Keras 3 single output: ["name", 0, 0]
            if (isinstance(specs, (list, tuple)) and len(specs) == 3
                    and isinstance(specs[0], str) and isinstance(specs[1], int)):
                return [specs[0]]
            return [s[0] if isinstance(s, (list, tuple)) else s for s in specs]

        input_names = names_of(conf.get("input_layers", []))
        output_names = names_of(conf.get("output_layers", []))

        g = NeuralNetConfiguration.builder().graph_builder()
        input_types: List[InputType] = []
        ch_first = _channels_first(layer_confs)
        for lc in layer_confs:
            cls = lc["class_name"]
            c = dict(lc.get("config", {}))
            lname = lc.get("name") or c.get("name")
            inputs = self._inbound(lc)
            if cls == "InputLayer":
                shape = c.get("batch_input_shape") or c.get("batch_shape")
                input_types.append(_input_type_from_shape(shape[1:], ch_first))
                g.add_inputs(lname)
                continue
            if cls in self.MERGE_LAYERS:
                g.add_vertex(lname, MergeVertex(), *inputs)
                continue
            if cls in self.ELEMENTWISE:
                g.add_vertex(lname, ElementWiseVertex(op=self.ELEMENTWISE[cls]),
                             *inputs)
                continue
            if cls == "Flatten":
                g.add_vertex(lname, PreprocessorVertex(preprocessor="cnn_to_ff"),
                             *inputs)
                continue
            if cls == "Reshape":
                g.add_vertex(lname,
                             PreprocessorVertex(preprocessor=_reshape_spec(c)),
                             *inputs)
                continue
            if cls == "MultiHeadAttention":
                # self-attention calls mha(x, x[, x]): collapse identical
                # inbound tensors to one input. Distinct query/value sources =
                # true cross-attention → CrossAttentionLayer, keeping the
                # inbound tensors separate (Keras call order [query, value(,
                # key)]) via the graph's multi-input layer protocol.
                uniq = list(dict.fromkeys(inputs))
                if len(uniq) > 1:
                    from deeplearning4j_tpu_torch.modelimport.keras.layers import (
                        map_keras_mha_cross)

                    layer, wf = map_keras_mha_cross(c)
                    layer.name = lname
                    self.layer_names.append(lname)
                    self.weight_fns[lname] = wf
                    g.add_layer(lname, layer, *inputs)
                    continue
                inputs = uniq
            layer, wf = map_keras_layer(cls, c)
            if layer is None:
                # structural no-op (Masking): pass-through vertex
                g.add_vertex(lname, PreprocessorVertex(preprocessor="identity"),
                             *inputs)
                continue
            layer.name = lname
            self.layer_names.append(lname)
            self.weight_fns[lname] = wf
            g.add_layer(lname, layer, *inputs)

        loss = self.cfg.loss
        if loss is not None:
            final_outputs = []
            for on in output_names:
                loss_name = f"{on}_loss"
                g.add_layer(loss_name, LossLayer(loss=loss, activation="identity"), on)
                final_outputs.append(loss_name)
            output_names = final_outputs
        g.set_outputs(*output_names)
        g.set_input_types(*input_types)
        self.conf = g.build()

    def init(self, device=None) -> ComputationGraph:
        return ComputationGraph(self.conf, device=device).init()

    def copy_weights(self, net: ComputationGraph, archive: Hdf5Archive,
                     *root: str) -> None:
        _copy_weights(self, net, {n: n for n in net.params}, archive, root)
