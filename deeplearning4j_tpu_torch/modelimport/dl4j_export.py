"""The port's networks written as DL4J-format checkpoints.

Counterpart of ``deeplearning4j_tpu/modelimport/dl4j_export.py``:
``modelimport/dl4j.py`` reads DL4J's ``ModelSerializer`` zips, this module
writes them (``ModelSerializer.java``'s ``writeModel`` file set), so a
network trained with the port goes back to a DL4J deployment and keeps
fine-tuning there: ``configuration.json`` in the DL4J
``MultiLayerConfiguration`` / ``ComputationGraphConfiguration`` dialect,
``coefficients.bin`` and ``updaterState.bin`` in the ND4J binary layout,
and ``normalizer.bin`` when a normalizer is given. The bytes are the
reference's for the same configuration and values.

Layers: Dense, Output/RnnOutput, Loss, Convolution, Subsampling,
BatchNormalization, Embedding, Activation, Dropout, LSTM/GravesLSTM,
SimpleRnn, GlobalPooling. Vertices: Merge, ElementWise, Subset,
Stack/Unstack, Scale/Shift, L2/L2Normalize, LastTimeStep,
ReverseTimeSeries, DuplicateToTimeSeries. Anything the dialect cannot
express raises :class:`UnsupportedDl4jConfigurationException` (IDropout
objects, learning-rate schedules, other layers, vertices and boundaries).

The flattened vector follows the reader's ``_dl4j_param_specs`` (DL4J's
ParamInitializer order, weights in 'f' order, HWIO kernels as DL4J's
``[out, in, kH, kW]``, BatchNorm's running statistics in line), a graph's
layers in DL4J's topological order (``_layer_seq``: the Java
``HashSet`` successor order the reader emulates), and
``updaterState.bin`` the reader's ``_updater_blocks`` (each block's slots
in turn). Layout boundaries become ``inputPreProcessors``: a convolution
into a dense layer is ``cnnToFeedForward``, with the dense weight's rows
moved from the port's NHWC flatten order to DL4J's NCHW one; dense layers
between recurrent ones take ``rnnToFeedForward`` / ``feedForwardToRnn``.
An explicit preprocessor spec, like any other boundary the dialect cannot
carry, raises. The values written are the network's, read from wherever
its tensors lie (``cuda`` or the CPU).
"""

from __future__ import annotations

import json
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.modelimport.dl4j import (
    _UPDATER_STATE_SLOTS,
    UnsupportedDl4jConfigurationException,
    _dl4j_param_specs,
    _layer_seq,
    _updater_blocks,
)
from deeplearning4j_tpu_torch.modelimport.nd4j_binary import nd4j_array_to_bytes
from deeplearning4j_tpu_torch.modelimport.normalizer_serde import normalizer_to_bytes
from deeplearning4j_tpu_torch.nn import vertices as V
from deeplearning4j_tpu_torch.nn.conf.network import normalize_backprop_type
from deeplearning4j_tpu_torch.nn.dropout import Dropout as _PlainDropout
from deeplearning4j_tpu_torch.nn.weights import Distribution

__all__ = ["export_multi_layer_network", "export_computation_graph"]

_ACT_CLASS = {
    "relu": "ActivationReLU", "relu6": "ActivationReLU6",
    "sigmoid": "ActivationSigmoid", "tanh": "ActivationTanH",
    "softmax": "ActivationSoftmax", "identity": "ActivationIdentity",
    "linear": "ActivationIdentity", "softplus": "ActivationSoftPlus",
    "softsign": "ActivationSoftSign", "elu": "ActivationELU",
    "selu": "ActivationSELU", "cube": "ActivationCube",
    "hardsigmoid": "ActivationHardSigmoid",
    "hardtanh": "ActivationHardTanH", "leakyrelu": "ActivationLReLU",
    "rationaltanh": "ActivationRationalTanh", "swish": "ActivationSwish",
    "gelu": "ActivationGELU", "thresholdedrelu": "ActivationThresholdedReLU",
}

_LOSS_CLASS = {
    "mcxent": "LossMCXENT", "negativeloglikelihood": "LossMCXENT",
    "mse": "LossMSE", "xent": "LossBinaryXENT", "l1": "LossL1",
    "mae": "LossL1", "kld": "LossKLD", "poisson": "LossPoisson",
    "cosine_proximity": "LossCosineProximity", "hinge": "LossHinge",
    "squared_hinge": "LossSquaredHinge",
    "msle": "LossMeanSquaredLogarithmicError",
}

_CONV_MODE = {"truncate": "Truncate", "same": "Same", "strict": "Strict"}

# layers whose DL4J implementation consumes/produces time-major 3-D input
_RNN_NATURED = {"LSTMLayer", "GravesLSTMLayer", "GravesBidirectionalLSTMLayer",
                "SimpleRnnLayer", "GRULayer", "RnnOutputLayer"}
_FF_NATURED = {"DenseLayer", "OutputLayer", "ElementWiseMultiplicationLayer",
               "EmbeddingLayer"}


def _activation_entry(act) -> Optional[dict]:
    if act is None:
        return None
    params: Dict[str, float] = {}
    if isinstance(act, tuple):
        act, params = act[0], dict(act[1])
    key = str(act).lower()
    cls = _ACT_CLASS.get(key)
    if cls is None:
        raise UnsupportedDl4jConfigurationException(
            f"cannot express activation {act!r} in the DL4J dialect")
    out = {"@class": f"org.nd4j.linalg.activations.impl.{cls}"}
    out.update(params)
    return out


def _loss_entry(loss) -> dict:
    cls = _LOSS_CLASS.get(str(loss).lower())
    if cls is None:
        raise UnsupportedDl4jConfigurationException(
            f"cannot express loss {loss!r} in the DL4J dialect")
    return {"@class": f"org.nd4j.linalg.lossfunctions.impl.{cls}"}


def _updater_entry(u) -> Optional[dict]:
    if u is None:
        return None
    name = type(u).__name__
    table = {"Sgd": "Sgd", "Adam": "Adam", "AdaMax": "AdaMax",
             "AdaDelta": "AdaDelta", "AdaGrad": "AdaGrad", "Nadam": "Nadam",
             "Nesterovs": "Nesterovs", "RmsProp": "RmsProp", "NoOp": "NoOp"}
    if name not in table:
        raise UnsupportedDl4jConfigurationException(
            f"cannot express updater {name} in the DL4J dialect")
    out: Dict[str, object] = {
        "@class": f"org.nd4j.linalg.learning.config.{table[name]}"}
    lr = getattr(u, "learning_rate", None)
    if isinstance(lr, (int, float)):
        out["learningRate"] = float(lr)
    elif lr is not None:
        raise UnsupportedDl4jConfigurationException(
            "cannot export a learning-rate SCHEDULE to the DL4J dialect")
    for ours, theirs in (("beta1", "beta1"), ("beta2", "beta2"),
                         ("momentum", "momentum"),
                         ("rms_decay", "rmsDecay")):
        v = getattr(u, ours, None)
        if isinstance(v, (int, float)):
            out[theirs] = float(v)
    return out


def _distribution_entry(dist) -> dict:
    """Serialize a ``Distribution`` spec into DL4J's ``@class``-tagged
    ``dist`` field (``org.deeplearning4j.nn.conf.distribution.*`` —
    the inverse of ``dl4j._distribution``), so ``DISTRIBUTION`` weight
    init exports with the payload DL4J needs to re-init from it."""
    if dist is None:
        raise UnsupportedDl4jConfigurationException(
            "weightInit DISTRIBUTION without a Distribution spec cannot "
            "be expressed in the DL4J dialect")
    if isinstance(dist, dict):
        dist = Distribution.from_dict(dist)
    pkg = "org.deeplearning4j.nn.conf.distribution"
    k = dist.kind
    if k == "normal":
        return {"@class": f"{pkg}.NormalDistribution",
                "mean": float(dist.mean), "std": float(dist.std)}
    if k == "uniform":
        return {"@class": f"{pkg}.UniformDistribution",
                "lower": float(dist.lower), "upper": float(dist.upper)}
    if k == "truncated_normal":
        return {"@class": f"{pkg}.TruncatedNormalDistribution",
                "mean": float(dist.mean), "std": float(dist.std)}
    if k == "log_normal":
        return {"@class": f"{pkg}.LogNormalDistribution",
                "mean": float(dist.mean), "std": float(dist.std)}
    if k == "orthogonal":
        return {"@class": f"{pkg}.OrthogonalDistribution",
                "gain": float(dist.gain)}
    if k == "constant":
        return {"@class": f"{pkg}.ConstantDistribution",
                "value": float(dist.value)}
    if k == "binomial":
        return {"@class": f"{pkg}.BinomialDistribution",
                "numberOfTrials": int(dist.n),
                "probabilityOfSuccess": float(dist.p)}
    raise UnsupportedDl4jConfigurationException(
        f"cannot express distribution kind {k!r} in the DL4J dialect")


def _layer_entry(layer, updater_entry) -> Tuple[str, dict]:
    """(WRAPPER_OBJECT type name, cfg dict) for one layer."""
    cls = type(layer).__name__
    cfg: Dict[str, object] = {}
    if getattr(layer, "name", None):
        cfg["layerName"] = layer.name
    act = _activation_entry(getattr(layer, "activation", None))
    if act is not None:
        cfg["activationFn"] = act
    if updater_entry is not None:
        cfg["iUpdater"] = updater_entry
    drop = getattr(layer, "dropout", None)
    if drop is not None:
        if type(drop) is _PlainDropout:
            if not isinstance(drop.p, (int, float)):
                raise UnsupportedDl4jConfigurationException(
                    "cannot express a SCHEDULED dropout probability "
                    f"({type(drop.p).__name__}) in the DL4J dialect — "
                    "plain Dropout objects export as scalar dropOut")
            # a plain inverted-dropout object IS DL4J's scalar dropOut
            drop = float(drop.p)
        if not isinstance(drop, (int, float)):
            raise UnsupportedDl4jConfigurationException(
                f"cannot express dropout object {type(drop).__name__} in "
                "the DL4J dialect (scalar keep probabilities only)")
        cfg["dropOut"] = float(drop)
    # per-layer regularization / init travel with the layer so handback
    # fine-tuning keeps training the same objective
    for ours, theirs in (("l1", "l1"), ("l2", "l2"),
                         ("l1_bias", "l1Bias"), ("l2_bias", "l2Bias")):
        v = getattr(layer, ours, None)
        if v:
            cfg[theirs] = float(v)
    wi = getattr(layer, "weight_init", None)
    if wi:
        cfg["weightInit"] = str(wi).upper()
        if str(wi) == "distribution":
            cfg["dist"] = _distribution_entry(
                getattr(layer, "distribution", None))

    def ff():
        cfg["nin"] = int(layer.n_in)
        cfg["nout"] = int(layer.n_out)

    if cls == "DenseLayer":
        ff()
        cfg["hasBias"] = bool(getattr(layer, "has_bias", True))
        return "dense", cfg
    if cls in ("OutputLayer", "RnnOutputLayer"):
        ff()
        cfg["lossFn"] = _loss_entry(layer.loss)
        return ("output" if cls == "OutputLayer" else "rnnoutput"), cfg
    if cls == "LossLayer":
        cfg["lossFn"] = _loss_entry(layer.loss)
        return "loss", cfg
    if cls == "ConvolutionLayer":
        ff()
        cfg["kernelSize"] = list(layer.kernel_size)
        cfg["stride"] = list(layer.stride)
        cfg["padding"] = list(layer.padding)
        cfg["dilation"] = list(layer.dilation)
        cfg["convolutionMode"] = _CONV_MODE[layer.convolution_mode]
        return "convolution", cfg
    if cls == "SubsamplingLayer":
        cfg["poolingType"] = layer.pooling_type.upper()
        cfg["kernelSize"] = list(layer.kernel_size)
        cfg["stride"] = list(layer.stride)
        cfg["padding"] = list(layer.padding)
        cfg["convolutionMode"] = _CONV_MODE[layer.convolution_mode]
        return "subsampling", cfg
    if cls == "BatchNormalizationLayer":
        cfg["eps"] = float(layer.eps)
        cfg["decay"] = float(layer.decay)
        cfg["nin"] = cfg["nout"] = int(layer.n_in)
        if getattr(layer, "lock_gamma_beta", False):
            cfg["lockGammaBeta"] = True
        return "batchNormalization", cfg
    if cls == "EmbeddingLayer":
        ff()
        cfg["hasBias"] = bool(getattr(layer, "has_bias", False))
        return "embedding", cfg
    if cls == "ActivationLayer":
        return "activation", cfg
    if cls == "DropoutLayer":
        return "dropout", cfg
    if cls in ("LSTMLayer", "GravesLSTMLayer"):
        ff()
        cfg["forgetGateBiasInit"] = float(
            getattr(layer, "forget_gate_bias_init", 1.0))
        return ("LSTM" if cls == "LSTMLayer" else "gravesLSTM"), cfg
    if cls == "SimpleRnnLayer":
        ff()
        return "SimpleRnn", cfg
    if cls == "GlobalPoolingLayer":
        cfg["poolingType"] = layer.pooling_type.upper()
        return "GlobalPooling", cfg
    raise UnsupportedDl4jConfigurationException(
        f"export does not support layer type {cls}")


def _walk_boundaries(conf):
    """(preprocessor entries, cnn→ff weight-permutation map).

    Tracks the DL4J-side data nature (ff / rnn / cnn) through the stack
    and emits the preprocessor DL4J needs at every transition:
    ``cnnToFeedForward`` (with the NHWC→NCHW weight permutation recorded
    for the receiving dense layer), ``rnnToFeedForward`` /
    ``feedForwardToRnn`` around time-distributed dense layers. Boundary
    kinds with no DL4J spelling here (cnn3d / cnn_seq / cnn_flat inputs)
    raise instead of silently exporting a wrong checkpoint.
    """
    pre: Dict[str, dict] = {}
    permute: Dict[int, Tuple[int, int, int]] = {}
    it = conf.input_type
    if it is not None and it.kind not in ("ff", "rnn", "cnn"):
        raise UnsupportedDl4jConfigurationException(
            f"cannot export input type kind {it.kind!r} to the DL4J "
            "dialect (ff / rnn / cnn only)")
    nature = it.kind if it is not None else None
    for i, layer in enumerate(conf.layers):
        cls = type(layer).__name__
        fed = conf.layer_input_types[i]
        if cls in _RNN_NATURED:
            if nature == "ff":
                pre[str(i)] = {"feedForwardToRnn": {}}
            elif nature == "cnn":
                raise UnsupportedDl4jConfigurationException(
                    "cnn→rnn boundary export is not supported")
            nature = "rnn"
        elif cls in _FF_NATURED:
            if nature == "cnn":
                if fed is None or fed.kind != "ff" or it is None:
                    raise UnsupportedDl4jConfigurationException(
                        f"unsupported cnn boundary into layer {i} ({cls})")
                pre[str(i)], permute[i] = _cnn_to_ff_entry(it)
            elif nature == "rnn":
                # time-distributed dense: DL4J flattens time around it
                pre[str(i)] = {"rnnToFeedForward": {}}
            nature = "ff"
        elif cls in ("ConvolutionLayer", "SubsamplingLayer"):
            if nature not in ("cnn", None):
                raise UnsupportedDl4jConfigurationException(
                    f"{nature}→cnn boundary export is not supported")
            nature = "cnn"
        elif cls == "GlobalPoolingLayer":
            nature = "ff"  # DL4J GlobalPooling consumes rnn/cnn natively
        # shape-preserving layers (BN, Activation, Dropout) keep nature
        if it is not None and fed is not None:
            it = layer.output_type(fed)
    return pre, permute


def _flatten_segment(layer, name, order, arr) -> np.ndarray:
    """Inverse of _iter_param_slices' reshape/convert for one value."""
    a = np.asarray(arr, np.float32)
    cls = type(layer).__name__
    if cls == "ConvolutionLayer" and name == "W":
        # ours HWIO → DL4J OIHW, then C-order flatten
        return np.transpose(a, (3, 2, 0, 1)).reshape(-1)
    if order == "f":
        return a.reshape(-1, order="F")
    return a.reshape(-1)


def _permute_nhwc_rows_to_nchw(w: np.ndarray, h: int, wdt: int,
                               c: int) -> np.ndarray:
    """Reorder dense-weight ROWS from the port's NHWC flatten index
    (h·W·C + w·C + c) to DL4J's NCHW (c·H·W + h·W + w)."""
    idx = np.arange(h * wdt * c).reshape(h, wdt, c)      # ours: [h][w][c]
    nchw_order = idx.transpose(2, 0, 1).reshape(-1)      # walk c, h, w
    return np.asarray(w)[nchw_order]


def _host(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _export_value(layer, i, name, order, container, permute) -> np.ndarray:
    arr = _host(container[name])
    if i in permute and name == "W":
        arr = _permute_nhwc_rows_to_nchw(arr, *permute[i])
    return _flatten_segment(layer, name, order, arr)


def _updater_state_vector(net, permute) -> Optional[np.ndarray]:
    """updaterState.bin contents in DL4J's block/slot layout, or None
    when some updater class has no known slot layout. Works for both
    network kinds — ``_layer_seq`` yields MLN layer indices or graph
    vertex names as the container keys."""
    blocks = _updater_blocks(net.conf, net._updaters)
    segs: List[np.ndarray] = []
    layers = dict(_layer_seq(net.conf))
    for u, block in blocks:
        slots = _UPDATER_STATE_SLOTS.get(type(u).__name__)
        if slots is None:
            return None
        for slot in slots:
            for i, name, _shape, order, _convert in block:
                state = net.updater_states[i][name]
                if slot not in state:
                    return None
                segs.append(_export_value(layers[i], i, name, order,
                                          {name: state[slot]}, permute))
    if not segs:
        return np.zeros(0, np.float32)
    return np.concatenate(segs)


def export_multi_layer_network(net, path: str,
                               save_updater: bool = True,
                               normalizer=None) -> None:
    """Write ``net`` as a DL4J-format zip (configuration.json +
    coefficients.bin + updaterState.bin + normalizer.bin when
    ``normalizer`` is given, matching ``ModelSerializer.writeModel``'s
    optional dataNormalization argument, ``ModelSerializer.java:106,
    165-168``); re-importable via ``restore_multi_layer_network`` and
    structured for DL4J's own ``ModelSerializer``."""
    conf = net.conf
    if conf.input_pre_processors:
        raise UnsupportedDl4jConfigurationException(
            "explicit input_pre_processor specs have no DL4J serialized "
            "form; export supports automatically inferred boundaries only")

    g = conf.global_conf
    default_updater = _updater_entry(g.updater) or {
        "@class": "org.nd4j.linalg.learning.config.Sgd",
        "learningRate": 0.1}

    confs: List[dict] = []
    for i, layer in enumerate(conf.layers):
        upd = _updater_entry(layer.updater) or default_updater
        t, cfg = _layer_entry(layer, upd)
        # effective bias updater (layer override, else global bias updater;
        # multilayer.py:85 resolution) — emitted when it differs from the
        # weight updater, since it moves UpdaterBlock boundaries and with
        # them the updaterState.bin layout (BaseLayer.java biasUpdater)
        bias_u = getattr(layer, "bias_updater", None) or g.bias_updater
        if bias_u is not None:
            bias_entry = _updater_entry(bias_u)
            if bias_entry != upd:
                cfg["biasUpdater"] = bias_entry
        entry: Dict[str, object] = {"layer": {t: cfg}}
        if i == 0:
            entry["seed"] = int(g.seed)
        confs.append(entry)

    pre, permute = _walk_boundaries(conf)

    doc: Dict[str, object] = {"backprop": True, "confs": confs,
                              # 1.0-era MultiLayerConfiguration counters:
                              # Adam/Nadam bias correction needs the step
                              # count to resume identically
                              "iterationCount": int(net.iteration),
                              "epochCount": int(net.epoch)}
    if conf.backprop_type == "truncated_bptt":
        doc["backpropType"] = "TruncatedBPTT"
        doc["tbpttFwdLength"] = int(conf.tbptt_fwd_length)
        doc["tbpttBackLength"] = int(conf.tbptt_bwd_length)
    else:
        doc["backpropType"] = "Standard"
    if pre:
        doc["inputPreProcessors"] = pre

    _write_model_zip(net, path, doc, permute, save_updater, normalizer)


def _flatten_params(net, permute) -> np.ndarray:
    """Flattened parameter vector in DL4J layout order — ``_layer_seq``
    yields MLN layer indices or graph vertex names as container keys."""
    segments: List[np.ndarray] = []
    for key, layer in _layer_seq(net.conf):
        for name, _shape, order, _convert, target in _dl4j_param_specs(layer):
            container = (net.params[key] if target == "param"
                         else net.states[key])
            if name not in container:
                raise UnsupportedDl4jConfigurationException(
                    f"layer {key!r} has no value for expected param {name!r}")
            segments.append(_export_value(layer, key, name, order,
                                          container, permute))
    return (np.concatenate(segments) if segments
            else np.zeros(0, np.float32)).reshape(1, -1)


def _write_model_zip(net, path, doc, permute, save_updater,
                     normalizer=None) -> None:
    """Shared ModelSerializer-zip epilogue for both network kinds."""
    flat = _flatten_params(net, permute)
    upd_flat = _updater_state_vector(net, permute) if save_updater else None
    norm_bytes = None if normalizer is None else normalizer_to_bytes(normalizer)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("configuration.json", json.dumps(doc, indent=1))
        z.writestr("coefficients.bin", nd4j_array_to_bytes(flat, order="c"))
        if upd_flat is not None and upd_flat.size:
            z.writestr("updaterState.bin",
                       nd4j_array_to_bytes(upd_flat.reshape(1, -1),
                                           order="c"))
        if norm_bytes is not None:
            # ModelSerializer.java:165-168 — normalizer as additional entry
            z.writestr("normalizer.bin", norm_bytes)


# ---------------------------------------------------------------------------
# ComputationGraph export (ModelSerializer.writeModel's graph half)

def _vertex_entry(v) -> Tuple[str, dict]:
    """Inverse of ``dl4j._convert_dl4j_vertex``: the port's vertex object → the
    DL4J WRAPPER_OBJECT (type name, cfg). Vertex kinds with no DL4J
    spelling (non-identity PreprocessorVertex, MoE routing, …) raise."""
    if isinstance(v, V.MergeVertex):
        return "MergeVertex", {}
    if isinstance(v, V.ElementWiseVertex):
        # canonical DL4J Op enum names — the runtime also accepts aliases
        # ('sum'/'mul'/…) that must not leak into the wire format
        canon = {"add": "Add", "sum": "Add", "subtract": "Subtract",
                 "sub": "Subtract", "product": "Product", "prod": "Product",
                 "mul": "Product", "average": "Average", "avg": "Average",
                 "max": "Max"}
        op = canon.get(str(v.op).lower())
        if op is None:
            raise UnsupportedDl4jConfigurationException(
                f"cannot express ElementWiseVertex op {v.op!r} in the DL4J "
                "dialect")
        return "ElementWiseVertex", {"op": op}
    if isinstance(v, V.SubsetVertex):
        return "SubsetVertex", {"from": int(v.from_index),
                                "to": int(v.to_index)}
    if isinstance(v, V.StackVertex):
        return "StackVertex", {}
    if isinstance(v, V.UnstackVertex):
        return "UnstackVertex", {"from": int(v.from_index),
                                 "stackSize": int(v.stack_size)}
    if isinstance(v, V.ScaleVertex):
        return "ScaleVertex", {"scaleFactor": float(v.scale_factor)}
    if isinstance(v, V.ShiftVertex):
        return "ShiftVertex", {"shiftFactor": float(v.shift_factor)}
    if isinstance(v, V.L2NormalizeVertex):
        return "L2NormalizeVertex", {}
    if isinstance(v, V.L2Vertex):
        return "L2Vertex", {}
    if isinstance(v, V.LastTimeStepVertex):
        return "LastTimeStepVertex", {"maskArrayInputName": v.mask_input}
    if isinstance(v, V.ReverseTimeSeriesVertex):
        return "ReverseTimeSeriesVertex", {"maskArrayInputName": v.mask_input}
    if isinstance(v, V.DuplicateToTimeSeriesVertex):
        return "DuplicateToTimeSeriesVertex", {"inputName": v.ts_input}
    raise UnsupportedDl4jConfigurationException(
        f"cannot express graph vertex {type(v).__name__} in the DL4J "
        "dialect")


def _cnn_to_ff_entry(it) -> Tuple[dict, tuple]:
    """The ONE wire spelling of the conv→dense flatten boundary, shared by
    the MLN (`_walk_boundaries`) and graph (`_graph_boundaries`) walkers:
    (cnnToFeedForward entry, NHWC→NCHW dense-W permutation key)."""
    return ({"cnnToFeedForward": {
        "inputHeight": it.height, "inputWidth": it.width,
        "numChannels": it.channels}},
        (it.height, it.width, it.channels))


def _graph_boundaries(conf) -> Tuple[Dict[str, dict], Dict[str, tuple]]:
    """(LayerVertex ``preProcessor`` entries, dense-W permutation map) for
    every layout preprocessor of the graph, carried INSIDE the LayerVertex
    as DL4J does (``LayerVertex.java:45``): the graph twin of
    ``_walk_boundaries``. A conv -> dense flatten is ``cnnToFeedForward``,
    the port's NHWC rows moved to NCHW order; any other boundary
    (``cnn_flat`` inputs, ``cnn_seq`` reshapes into recurrent layers,
    ``cnn3d``, an explicit spec) has no round-trippable spelling and
    raises. A graph read from a DL4J zip carries the entries it was read
    with (``_dl4j_layer_preprocessors``): they are written back as they
    were, with no permutation (its dense rows already index DL4J's
    features)."""
    pre: Dict[str, dict] = {}
    permute: Dict[str, tuple] = {}
    imported = getattr(conf, "_dl4j_layer_preprocessors", {})
    for name in conf.preprocessors:
        if name in imported:
            pre[name] = imported[name]
            continue
        vd = conf.vertices.get(name)
        its = conf.vertex_input_types.get(name, [])
        it = its[0] if its else None
        cls = type(vd.obj).__name__ if vd is not None and vd.is_layer else None
        if (cls in _FF_NATURED and it is not None and it.kind == "cnn"
                and name not in conf.input_pre_processors):
            pre[name], permute[name] = _cnn_to_ff_entry(it)
            continue
        raise UnsupportedDl4jConfigurationException(
            f"graph vertex {name!r} carries an input preprocessor with no "
            "DL4J round-trip spelling (only the conv→dense "
            "CnnToFeedForward boundary is supported) — restructure with a "
            "GlobalPoolingLayer, or export as MultiLayerNetwork")
    return pre, permute


def export_computation_graph(net, path: str,
                             save_updater: bool = True,
                             normalizer=None) -> None:
    """Write a ComputationGraph as a DL4J-format zip (configuration.json
    in the ComputationGraphConfiguration dialect + coefficients.bin in
    DL4J's OWN topological parameter order + updaterState.bin);
    re-importable via ``restore_computation_graph``
    (``ModelSerializer.java:51`` writeModel, graph case —
    ``ComputationGraphConfiguration.java:62-90`` vertices/vertexInputs/
    networkInputs/networkOutputs).

    The flattened parameter vector follows the same
    ``topologicalSortOrder()`` emulation the reader uses
    (``dl4j._dl4j_topological_order``), so branchy DAGs lay out
    deterministically on both sides."""
    conf = net.conf
    g = conf.global_conf
    pre_entries, permute = _graph_boundaries(conf)

    default_updater = _updater_entry(g.updater) or {
        "@class": "org.nd4j.linalg.learning.config.Sgd",
        "learningRate": 0.1}

    vertices: Dict[str, dict] = {}
    vertex_inputs: Dict[str, list] = {}
    for name, vd in conf.vertices.items():
        if vd.is_layer:
            upd = _updater_entry(vd.obj.updater) or default_updater
            t, cfg = _layer_entry(vd.obj, upd)
            bias_u = getattr(vd.obj, "bias_updater", None) or g.bias_updater
            if bias_u is not None:
                bias_entry = _updater_entry(bias_u)
                if bias_entry != upd:
                    cfg["biasUpdater"] = bias_entry
            lv = {"layerConf": {"layer": {t: cfg}}}
            if name in pre_entries:
                lv["preProcessor"] = pre_entries[name]
            vertices[name] = {"LayerVertex": lv}
        else:
            vt, vc = _vertex_entry(vd.obj)
            vertices[name] = {vt: vc}
        vertex_inputs[name] = list(vd.inputs)

    doc: Dict[str, object] = {
        "vertices": vertices,
        "vertexInputs": vertex_inputs,
        "networkInputs": list(conf.inputs),
        "networkOutputs": list(conf.outputs),
        "iterationCount": int(net.iteration),
        "epochCount": int(net.epoch),
    }
    if normalize_backprop_type(conf.backprop_type) == "truncated_bptt":
        doc["backpropType"] = "TruncatedBPTT"
        doc["tbpttFwdLength"] = int(conf.tbptt_fwd_length)
        doc["tbpttBackLength"] = int(conf.tbptt_bwd_length)
    else:
        doc["backpropType"] = "Standard"

    # flattened params in DL4J's topological layer order (same walk the
    # reader's _iter_param_slices does), with conv→dense boundary weights
    # re-indexed to the NCHW feature order the emitted preprocessor implies
    _write_model_zip(net, path, doc, permute, save_updater, normalizer)
