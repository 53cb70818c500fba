"""DL4J checkpoints into the port: configuration JSON, ``coefficients.bin``,
``updaterState.bin`` and ``normalizer.bin``.

Counterpart of ``deeplearning4j_tpu/modelimport/dl4j.py``. It reads DL4J's
``MultiLayerConfiguration`` and ``ComputationGraphConfiguration`` JSON
(Jackson's WRAPPER_OBJECT layer entries, ``@class`` activation, loss and
updater wrappers, the pre-0.9 flat updater fields) into the port's
configurations, and a ``ModelSerializer`` zip into a network on
``device``: ``cuda`` unless the caller passes ``"cpu"``, as every entry
point of the port. The spellings accepted are the reference's (``nin`` /
``nIn``, an activation as an enum string or an ``@class`` wrapper).

Layers: dense, output, rnnoutput, CenterLossOutputLayer, loss,
RnnLossLayer (read as a ``LossLayer``, as the reference reads it),
CnnLossLayer, convolution, convolution1d, subsampling, subsampling1d,
batchNormalization, localResponseNormalization, embedding, activation,
dropout, LSTM, gravesLSTM, gravesBidirectionalLSTM, SimpleRnn,
Bidirectional, MaskZeroLayer, GlobalPooling, zeroPadding, Upsampling2D,
ElementWiseMult, autoEncoder (its ``corruptionLevel``) and FrozenLayer
(its wrapped ``layer``). Every other DL4J layer type and an unknown
activation or loss raise :class:`UnsupportedDl4jConfigurationException`
naming it; as in the reference, ``coefficients.bin`` is read for a
FrozenLayer over a dense-family layer and refused for an autoEncoder. A parameterized
activation keeps its coefficient: ``ActivationLReLU`` / ``RReLU`` / ``ELU``
with an ``alpha`` and ``ActivationThresholdedReLU`` with a ``theta`` read
as ``(name, {...})``, and the pre-0.8 ``leakyreluAlpha`` layer field as
leakyrelu's alpha. Vertices: every one the reference reads.

Preprocessors become the port's serializable specs
(``nn/conf/preprocessors.py``), where the reference builds closures:
``cnnToFeedForward`` keeps DL4J's C, H, W flatten order
(``cnn_to_ff_nchw``), or every dense weight after a convolution would be
read permuted; ``rnnToFeedForward`` and ``feedForwardToRnn`` are the
identity (a dense layer applies per step over ``[N, T, C]``);
``cnnToRnn`` and ``rnnToCnn`` keep DL4J's C, H, W order over each step of
an image sequence (``cnn_seq_to_rnn_nchw``, ``rnn_to_cnn_seq_nchw``).

Coefficients: the flattened vector is walked layer by layer in DL4J's
ParamInitializer order (weights in 'f' order, conv kernels ``[out, in,
kH, kW]`` in 'c' order, to HWIO); BatchNorm's ``mean`` and ``var`` go to
the layer's state; a Bidirectional layer's forward direction comes before
its backward one (``f_``, ``b_``), and MaskZeroLayer holds its wrapped
layer's parameters. A graph's layers are walked in DL4J's own topological
order (``_dl4j_topological_order``: Kahn's algorithm over vertex indices
with Java ``HashSet<Integer>`` successor order), with a warning where
the bucket-order emulation is all that fixes it. The updater state is
mapped per ``UpdaterBlock`` (blocks split where the updater configuration
changes and where BatchNorm's statistics interrupt the trainable
parameters).
"""

from __future__ import annotations

import json
import warnings
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import activations as act_mod
from deeplearning4j_tpu_torch.nn import constraints as C
from deeplearning4j_tpu_torch.nn import dropout as D
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import losses as loss_mod
from deeplearning4j_tpu_torch.nn import updaters as U
from deeplearning4j_tpu_torch.nn import vertices as V
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.weights import Distribution


class InvalidDl4jConfigurationException(ValueError):
    pass


class UnsupportedDl4jConfigurationException(ValueError):
    pass


def _get(d: dict, *names, default=None):
    for n in names:
        if n in d:
            return d[n]
    return default


# -- activation / loss / updater / weight-init vocabulary -------------------

_ACTIVATIONS = {
    "relu": "relu", "relu6": "relu6", "sigmoid": "sigmoid", "tanh": "tanh",
    "tanh.": "tanh", "softmax": "softmax", "identity": "identity",
    "softplus": "softplus", "softsign": "softsign", "elu": "elu",
    "selu": "selu", "cube": "cube", "hardsigmoid": "hardsigmoid",
    "hardtanh": "hardtanh", "leakyrelu": "leakyrelu", "lrelu": "leakyrelu",
    "rationaltanh": "rationaltanh", "swish": "swish", "gelu": "gelu",
    "rrelu": "leakyrelu", "thresholdedrelu": "thresholdedrelu",
}


def _activation(v):
    """activationFn: an enum string ("RELU"), ``{"@class": ".ActivationReLU"}``
    or a WRAPPER_OBJECT ``{"ReLU": {...}}``. A leakyrelu or elu with an
    ``alpha``, or a thresholdedrelu with a ``theta``, comes back as
    ``(name, {...})``. An unknown one raises."""
    if v is None:
        return None
    params: dict = {}
    if isinstance(v, str):
        key = v.lower()
    elif isinstance(v, dict):
        cls = v.get("@class")
        if cls is not None:
            params = v
        elif len(v) == 1:
            cls = next(iter(v))
            if isinstance(v[cls], dict):
                params = v[cls]
        if cls is None:
            return None
        key = cls.rsplit(".", 1)[-1]
        if key.lower().startswith("activation"):
            key = key[len("Activation"):]
        key = key.lower()
    else:
        return None
    key = key.replace("_", "")
    if key not in _ACTIVATIONS:
        raise UnsupportedDl4jConfigurationException(
            f"unknown DL4J activation {v!r}")
    mapped = _ACTIVATIONS[key]
    if mapped not in act_mod.names():
        raise UnsupportedDl4jConfigurationException(
            f"DL4J activation {v!r} ({mapped}) is not ported yet")
    if mapped in ("leakyrelu", "elu") and "alpha" in params:
        return (mapped, {"alpha": float(params["alpha"])})
    if mapped == "thresholdedrelu" and "theta" in params:
        return (mapped, {"theta": float(params["theta"])})
    return mapped


_LOSSES = {
    "mcxent": "mcxent", "negativeloglikelihood": "mcxent", "mse": "mse",
    "l2": "mse", "binaryxent": "xent", "xent": "xent", "mae": "l1",
    "l1": "l1", "kld": "kl_divergence", "kldivergence": "kl_divergence",
    "poisson": "poisson", "cosineproximity": "cosine_proximity",
    "hinge": "hinge", "squaredhinge": "squared_hinge",
    "meansquaredlogarithmicerror": "msle",
}


def _loss(v) -> Optional[str]:
    if v is None:
        return None
    if isinstance(v, str):
        key = v.lower()
    elif isinstance(v, dict):
        cls = v.get("@class")
        if cls is None and len(v) == 1:
            cls = next(iter(v))
        if cls is None:
            return None
        key = cls.rsplit(".", 1)[-1]
        if key.lower().startswith("loss"):
            key = key[len("Loss"):]
        key = key.lower()
    else:
        return None
    key = key.replace("_", "")
    if key not in _LOSSES or _LOSSES[key] not in loss_mod.names():
        raise UnsupportedDl4jConfigurationException(f"unknown DL4J loss {v!r}")
    return _LOSSES[key]


_UPDATERS = {
    "sgd": U.Sgd, "adam": U.Adam, "adamax": U.AdaMax, "adadelta": U.AdaDelta,
    "adagrad": U.AdaGrad, "nadam": U.Nadam, "nesterovs": U.Nesterovs,
    "rmsprop": U.RmsProp, "noop": U.NoOp,
}


def _updater(v):
    """iUpdater: ``{"@class": "org.nd4j.linalg.learning.config.Adam", ...}``."""
    if v is None or not isinstance(v, dict):
        return None
    cls = v.get("@class")
    if cls is None and len(v) == 1:
        cls, v = next(iter(v.items()))
    if cls is None:
        return None
    name = cls.rsplit(".", 1)[-1].lower()
    if name not in _UPDATERS:
        raise UnsupportedDl4jConfigurationException(
            f"unknown DL4J updater {cls!r}")
    kw: Dict[str, Any] = {}
    lr = _get(v, "learningRate", "lr")
    if lr is not None:
        kw["learning_rate"] = float(lr)
    if name == "nesterovs" and "momentum" in v:
        kw["momentum"] = float(v["momentum"])
    if name in ("adam", "adamax", "nadam"):
        for f in ("beta1", "beta2"):
            if f in v:
                kw[f] = float(v[f])
    if name == "rmsprop" and "rmsDecay" in v:
        kw["rms_decay"] = float(v["rmsDecay"])
    try:
        return _UPDATERS[name](**kw)
    except TypeError:  # no learning rate (AdaDelta, NoOp)
        kw.pop("learning_rate", None)
        return _UPDATERS[name](**kw)


def _legacy_updater(cfg: dict, name: str):
    """The pre-0.9 dialect: an ``updater`` enum string and flat fields
    (``learningRate``, ``momentum``, ``rmsDecay``, ``rho``,
    ``adamMeanDecay``/``adamVarDecay``)."""
    name = name.lower()
    lr = _get(cfg, "learningRate", "lr")
    kw: Dict[str, Any] = {}
    if lr is not None:
        kw["learning_rate"] = float(lr)
    if name == "nesterovs":
        if "momentum" in cfg:
            kw["momentum"] = float(cfg["momentum"])
        return U.Nesterovs(**kw)
    if name == "rmsprop":
        if "rmsDecay" in cfg:
            kw["rms_decay"] = float(cfg["rmsDecay"])
        return U.RmsProp(**kw)
    if name in ("adam", "adamax"):
        if "adamMeanDecay" in cfg:
            kw["beta1"] = float(cfg["adamMeanDecay"])
        if "adamVarDecay" in cfg:
            kw["beta2"] = float(cfg["adamVarDecay"])
        return (U.Adam if name == "adam" else U.AdaMax)(**kw)
    if name == "adadelta":
        return U.AdaDelta(rho=float(cfg.get("rho", 0.95)))
    if name == "adagrad":
        return U.AdaGrad(**kw)
    if name == "nadam":
        return U.Nadam(**kw)
    if name == "sgd":
        return U.Sgd(**kw)
    if name == "none":
        return U.NoOp()  # Updater.NONE freezes the parameters
    if name == "custom":
        return None
    raise UnsupportedDl4jConfigurationException(
        f"unknown legacy DL4J updater enum {cfg.get('updater')!r}")


def _distribution(v):
    """``dist``: the legacy WRAPPER_OBJECT (``{"normal": {"mean": ...}}``) or
    an ``@class``-tagged one."""
    if not isinstance(v, dict):
        return None
    if "@class" in v:
        kind = v["@class"].rsplit(".", 1)[-1]
        kind = kind[:-len("Distribution")] if kind.endswith("Distribution") else kind
        cfg = v
    elif len(v) == 1:
        kind, cfg = next(iter(v.items()))
        cfg = cfg or {}
    else:
        return None
    kind = kind.lower()
    std = lambda: float(_get(cfg, "std", "standardDeviation", default=1.0))  # noqa: E731
    if kind in ("normal", "gaussian"):
        return Distribution(kind="normal", mean=float(cfg.get("mean", 0.0)), std=std())
    if kind == "uniform":
        return Distribution(kind="uniform", lower=float(cfg.get("lower", -1.0)),
                            upper=float(cfg.get("upper", 1.0)))
    if kind == "binomial":
        return Distribution(
            kind="binomial", n=int(_get(cfg, "numberOfTrials", "n", default=1)),
            p=float(_get(cfg, "probabilityOfSuccess", "p", default=0.5)))
    if kind in ("truncatednormal", "truncated_normal"):
        return Distribution(kind="truncated_normal",
                            mean=float(cfg.get("mean", 0.0)), std=std())
    if kind in ("lognormal", "log_normal"):
        return Distribution(kind="log_normal", mean=float(cfg.get("mean", 0.0)),
                            std=std())
    if kind == "orthogonal":
        return Distribution(kind="orthogonal", gain=float(cfg.get("gain", 1.0)))
    if kind == "constant":
        return Distribution(kind="constant", value=float(cfg.get("value", 0.0)))
    raise UnsupportedDl4jConfigurationException(
        f"unknown DL4J distribution {v!r}")


def _constraints(v, conv: bool = False):
    """A layer's ``constraints`` list (``@class`` entries with ``params``,
    ``dimensions`` and the subclass fields) as the port's constraint
    chain. DL4J's canonical per-unit ``dimensions`` ([1] for a 2-D weight,
    [1, 2, 3] for a conv kernel) are the port's default axes; other sets
    import with a warning and the default axes."""
    if not isinstance(v, list) or not v:
        return None
    out = []
    for entry in v:
        if not isinstance(entry, dict):
            continue
        short = entry.get("@class", "").rsplit(".", 1)[-1]
        dims = entry.get("dimensions")
        canonical = [1, 2, 3] if conv else [1]
        if dims is not None and list(dims) != canonical:
            warnings.warn(
                f"DL4J constraint {short} has non-canonical dimensions "
                f"{list(dims)}; importing with the default (per-output-unit) "
                "reduction axes", stacklevel=3)
        common = dict(param_names=tuple(entry.get("params") or ()) or None,
                      dimensions=None)
        if short == "MaxNormConstraint":
            out.append(C.MaxNormConstraint(
                max_norm=float(entry.get("maxNorm", 1.0)), **common))
        elif short == "MinMaxNormConstraint":
            out.append(C.MinMaxNormConstraint(
                min_norm=float(entry.get("min", 0.0)),
                max_norm=float(entry.get("max", 1.0)),
                rate=float(entry.get("rate", 1.0)), **common))
        elif short == "UnitNormConstraint":
            out.append(C.UnitNormConstraint(**common))
        elif short == "NonNegativeConstraint":
            out.append(C.NonNegativeConstraint(**common))
        else:
            warnings.warn(
                f"ignoring unsupported DL4J constraint {short!r}: the "
                "imported model loses this train-time projection", stacklevel=3)
    return out or None


_IDROPOUT = {"Dropout": ("p", float), "AlphaDropout": ("p", D.AlphaDropout),
             "GaussianDropout": ("rate", D.GaussianDropout),
             "GaussianNoise": ("stddev", D.GaussianNoise),
             "SpatialDropout": ("p", D.SpatialDropout)}


def _idropout(idrop: dict):
    cls = idrop.get("@class", "")
    short = cls.rsplit(".", 1)[-1]
    if short in _IDROPOUT and _IDROPOUT[short][0] in idrop:
        field, make = _IDROPOUT[short]
        value = float(idrop[field])
        return value if make is float else make(**{field: value})
    warnings.warn(f"ignoring unsupported DL4J iDropout {cls!r}: the imported "
                  "model's training loses this regularization", stacklevel=3)
    return None


# -- per-layer conversion ----------------------------------------------------

def _base_kwargs(cfg: dict, conv: bool = False) -> dict:
    """The BaseLayer fields. ``conv`` marks a 4-D DL4J weight, whose
    canonical constraint ``dimensions`` are [1, 2, 3]."""
    kw: Dict[str, Any] = {}
    name = _get(cfg, "layerName", "layername")
    if name:
        kw["name"] = name
    act = _activation(_get(cfg, "activationFn", "activationFunction", "activation"))
    if act == "leakyrelu" and "leakyreluAlpha" in cfg:
        # the pre-0.8 dialect: the alpha rides the layer, not the activation
        act = ("leakyrelu", {"alpha": float(cfg["leakyreluAlpha"])})
    if act is not None:
        kw["activation"] = act
    wi = _get(cfg, "weightInit", "weightinit")
    wi = None if wi is None else str(wi).lower()
    if wi == "distribution":
        dist = _distribution(cfg.get("dist"))
        if dist is not None:
            kw["weight_init"], kw["distribution"] = "distribution", dist
    elif wi:
        kw["weight_init"] = wi
    for f in ("l1", "l2"):
        val = cfg.get(f)
        if isinstance(val, (int, float)) and val == val and val != 0.0:
            kw[f] = float(val)
    drop = _get(cfg, "dropOut", "dropout")
    if isinstance(drop, (int, float)) and 0.0 < float(drop) < 1.0:
        kw["dropout"] = float(drop)  # the pre-1.0 retain probability, ours too
    idrop = _get(cfg, "iDropout", "idropout")
    if isinstance(idrop, dict):
        d = _idropout(idrop)
        if d is not None:
            kw["dropout"] = d
    cons = _constraints(cfg.get("constraints"), conv=conv)
    if cons:
        kw["constraints"] = cons
    upd_v = _get(cfg, "iUpdater", "iupdater", "updater")
    upd = _legacy_updater(cfg, upd_v) if isinstance(upd_v, str) else _updater(upd_v)
    if upd is not None:
        kw["updater"] = upd
    # a per-layer bias updater moves the UpdaterBlock boundaries, so it
    # must be kept for updaterState.bin to map
    bias_upd = _updater(_get(cfg, "biasUpdater", "biasupdater"))
    if bias_upd is not None:
        kw["bias_updater"] = bias_upd
    gn = _get(cfg, "gradientNormalization")
    if gn and gn != "None":
        kw["gradient_normalization"] = "".join(
            ("_" + c.lower() if c.isupper() else c) for c in gn).lstrip("_")
        thr = _get(cfg, "gradientNormalizationThreshold")
        if thr is not None:
            kw["gradient_normalization_threshold"] = float(thr)
    return kw


def _nin_nout(cfg: dict) -> dict:
    out = {}
    nin, nout = _get(cfg, "nin", "nIn", "nIn_"), _get(cfg, "nout", "nOut")
    if nin:
        out["n_in"] = int(nin)
    if nout:
        out["n_out"] = int(nout)
    return out


def _pair(v, default=(1, 1)):
    if v is None:
        return default
    if isinstance(v, int):
        return (v, v)
    return tuple(int(x) for x in v[:2]) if len(v) >= 2 else (int(v[0]),) * 2


def _conv_mode(v) -> str:
    return {"Same": "same", "Truncate": "truncate", "Strict": "strict"}.get(v, "truncate")


def _pooling_type(cfg) -> str:
    pt = str(_get(cfg, "poolingType", default="MAX")).lower()
    return "avg" if pt in ("avg", "average") else pt


def convert_dl4j_layer(type_name: str, cfg: dict):
    """One WRAPPER_OBJECT layer entry ``{type_name: cfg}`` as a port layer."""
    t = type_name
    # a 4-D DL4J weight: its canonical constraint dimensions are [1, 2, 3]
    base = _base_kwargs(cfg, conv=t in ("convolution", "deconvolution2d",
                                        "separableConvolution2d",
                                        "depthwiseConvolution2d"))
    ff = _nin_nout(cfg)
    if t == "dense":
        return L.DenseLayer(**base, **ff,
                            has_bias=bool(_get(cfg, "hasBias", default=True)))
    if t in ("output", "rnnoutput", "CenterLossOutputLayer"):
        kw = dict(base, **ff)
        loss = _loss(_get(cfg, "lossFn", "lossFunction"))
        if loss:
            kw["loss"] = loss
        if t == "CenterLossOutputLayer":
            if "alpha" in cfg:
                kw["alpha"] = float(cfg["alpha"])
            if "lambda" in cfg:
                kw["lambda_"] = float(cfg["lambda"])
        return {"output": L.OutputLayer, "rnnoutput": L.RnnOutputLayer,
                "CenterLossOutputLayer": L.CenterLossOutputLayer}[t](**kw)
    if t in ("loss", "RnnLossLayer", "CnnLossLayer"):
        loss = _loss(_get(cfg, "lossFn", "lossFunction")) or "mse"
        return (L.CnnLossLayer if t == "CnnLossLayer" else L.LossLayer)(
            **base, loss=loss)
    if t in ("convolution", "convolution1d"):
        kw = dict(base, **ff, kernel_size=_pair(_get(cfg, "kernelSize"), (3, 3)),
                  stride=_pair(_get(cfg, "stride"), (1, 1)),
                  padding=_pair(_get(cfg, "padding"), (0, 0)),
                  dilation=_pair(_get(cfg, "dilation"), (1, 1)),
                  convolution_mode=_conv_mode(_get(cfg, "convolutionMode")))
        if t == "convolution":
            return L.ConvolutionLayer(**kw)
        kw["kernel_size"], kw["stride"] = kw["kernel_size"][0], kw["stride"][0]
        return L.Convolution1DLayer(**kw)
    if t in ("subsampling", "subsampling1d"):
        return (L.Subsampling1DLayer if t == "subsampling1d" else L.SubsamplingLayer)(
            **base, pooling_type=_pooling_type(cfg),
            kernel_size=_pair(_get(cfg, "kernelSize"), (2, 2)),
            stride=_pair(_get(cfg, "stride"), (2, 2)),
            padding=_pair(_get(cfg, "padding"), (0, 0)),
            convolution_mode=_conv_mode(_get(cfg, "convolutionMode")))
    if t == "batchNormalization":
        kw = dict(base)
        for f in ("eps", "decay"):
            if f in cfg:
                kw[f] = float(cfg[f])
        if cfg.get("lockGammaBeta"):
            # locked gamma/beta hold NO values in the DL4J vector; every
            # later slice would shift if this were dropped
            kw["lock_gamma_beta"] = True
        n = _get(cfg, "nin", "nIn", "nout", "nOut")
        if n:
            kw["n_in"] = int(n)
        return L.BatchNormalizationLayer(**kw)
    if t == "localResponseNormalization":
        return L.LocalResponseNormalizationLayer(
            **base, **{f: cfg[f] for f in ("k", "n", "alpha", "beta") if f in cfg})
    if t == "embedding":
        return L.EmbeddingLayer(**base, **ff,
                                has_bias=bool(_get(cfg, "hasBias", default=False)))
    if t == "activation":
        return L.ActivationLayer(**base)
    if t == "dropout":
        return L.DropoutLayer(**base)
    if t in ("LSTM", "gravesLSTM", "gravesBidirectionalLSTM"):
        cls = {"LSTM": L.LSTMLayer, "gravesLSTM": L.GravesLSTMLayer,
               "gravesBidirectionalLSTM": L.GravesBidirectionalLSTMLayer}[t]
        return cls(**base, **ff, forget_gate_bias_init=float(
            _get(cfg, "forgetGateBiasInit", default=1.0)))
    if t == "SimpleRnn":
        return L.SimpleRnnLayer(**base, **ff)
    if t == "MaskZeroLayer":
        inner_t, inner_cfg = next(iter(_get(cfg, "underlying", default={}).items()))
        return L.MaskZeroLayer(layer=convert_dl4j_layer(inner_t, inner_cfg),
                               mask_value=float(_get(cfg, "maskingValue", default=0.0)))
    if t == "Bidirectional":
        inner = _get(cfg, "fwd", "rnnLayer")
        if not isinstance(inner, dict) or len(inner) != 1:
            raise InvalidDl4jConfigurationException(
                "Bidirectional layer without inner rnn config")
        mode = str(_get(cfg, "mode", default="CONCAT")).lower()
        return L.BidirectionalWrapper(
            layer=convert_dl4j_layer(*next(iter(inner.items()))),
            mode=mode if mode in ("add", "mul", "average") else "concat")
    if t == "GlobalPooling":
        return L.GlobalPoolingLayer(**base, pooling_type=_pooling_type(cfg))
    if t == "zeroPadding":
        return L.ZeroPaddingLayer(
            **base, padding=tuple(_get(cfg, "padding", default=(1, 1, 1, 1))))
    if t == "Upsampling2D":
        return L.UpsamplingLayer(**base, size=_pair(_get(cfg, "size", default=2), (2, 2)))
    if t == "ElementWiseMult":
        return L.ElementWiseMultiplicationLayer(**base, **ff)
    if t == "autoEncoder":
        kw = dict(base, **ff)
        if "corruptionLevel" in cfg:
            kw["corruption_level"] = float(cfg["corruptionLevel"])
        return L.AutoEncoderLayer(**kw)
    if t == "FrozenLayer":
        inner = _get(cfg, "layer", default=None)
        if isinstance(inner, dict) and len(inner) == 1:
            return L.FrozenLayer(layer=convert_dl4j_layer(*next(iter(inner.items()))))
        raise InvalidDl4jConfigurationException("FrozenLayer without inner layer")
    raise UnsupportedDl4jConfigurationException(
        f"unsupported DL4J layer type {t!r} (not ported yet)")


# -- preprocessors and vertices ----------------------------------------------

def _convert_dl4j_preprocessor(entry) -> Optional[str]:
    """One ``inputPreProcessors`` entry as a preprocessor spec, or None (the
    identity). Both dialects: WRAPPER_OBJECT ``{"cnnToFeedForward":
    {...}}`` and ``{"@class": "...CnnToFeedForwardPreProcessor", ...}``. An
    unknown type warns and reads as the identity, so that a configuration
    still imports."""
    if isinstance(entry, dict) and "@class" in entry:
        t, cfg = entry["@class"], entry
    elif isinstance(entry, dict) and len(entry) == 1:
        t, cfg = next(iter(entry.items()))
    else:
        raise InvalidDl4jConfigurationException(
            f"bad inputPreProcessors entry {entry!r}")
    cfg = cfg or {}
    name = t.lstrip(".").rsplit(".", 1)[-1]
    key = name[0].lower() + name[1:]
    if key.endswith("PreProcessor"):
        key = key[:-len("PreProcessor")]
    if key == "cnnToFeedForward":
        return "cnn_to_ff_nchw"
    if key == "cnnToRnn":
        return "cnn_seq_to_rnn_nchw"
    if key == "rnnToCnn":
        h = int(_get(cfg, "inputHeight", "numRows"))
        w = int(_get(cfg, "inputWidth", "numColumns"))
        c = int(_get(cfg, "numChannels", "depth", default=1))
        return f"rnn_to_cnn_seq_nchw:{h},{w},{c}"
    if key == "feedForwardToCnn":
        h = int(_get(cfg, "inputHeight", "numRows"))
        w = int(_get(cfg, "inputWidth", "numColumns"))
        c = int(_get(cfg, "numChannels", "depth", default=1))
        return f"ff_to_cnn_nchw:{h},{w},{c}"
    if key in ("rnnToFeedForward", "feedForwardToRnn"):
        return None  # a dense layer applies per step
    warnings.warn(
        f"ignoring unsupported DL4J input preprocessor {t!r} (identity); "
        "check the imported network's activations", stacklevel=2)
    return None


def _convert_dl4j_vertex(type_name: str, cfg: dict):
    """One WRAPPER_OBJECT vertex entry as a port vertex or, for a
    LayerVertex, the converted layer."""
    t = type_name
    if t == "LayerVertex":
        layer_entry = (_get(cfg, "layerConf", default={}) or {}).get("layer")
        if not isinstance(layer_entry, dict) or len(layer_entry) != 1:
            raise InvalidDl4jConfigurationException(
                f"LayerVertex without layer config: {cfg!r}")
        return convert_dl4j_layer(*next(iter(layer_entry.items())))
    if t == "MergeVertex":
        return V.MergeVertex()
    if t == "ElementWiseVertex":
        return V.ElementWiseVertex(op=str(_get(cfg, "op", default="Add")).lower())
    if t == "SubsetVertex":
        return V.SubsetVertex(from_index=int(_get(cfg, "from", "from_", default=0)),
                              to_index=int(_get(cfg, "to", default=0)))
    if t == "StackVertex":
        return V.StackVertex()
    if t == "UnstackVertex":
        return V.UnstackVertex(from_index=int(_get(cfg, "from", "from_", default=0)),
                               stack_size=int(_get(cfg, "stackSize", default=1)))
    if t == "ScaleVertex":
        return V.ScaleVertex(scale_factor=float(_get(cfg, "scaleFactor", default=1.0)))
    if t == "ShiftVertex":
        return V.ShiftVertex(shift_factor=float(_get(cfg, "shiftFactor", default=0.0)))
    if t == "L2Vertex":
        return V.L2Vertex()
    if t == "L2NormalizeVertex":
        return V.L2NormalizeVertex()
    if t == "LastTimeStepVertex":
        return V.LastTimeStepVertex(mask_input=_get(cfg, "maskArrayInputName"))
    if t == "ReverseTimeSeriesVertex":
        return V.ReverseTimeSeriesVertex(mask_input=_get(cfg, "maskArrayInputName"))
    if t == "DuplicateToTimeSeriesVertex":
        return V.DuplicateToTimeSeriesVertex(
            ts_input=_get(cfg, "inputName", "inputVertexName"))
    if t == "PreprocessorVertex":
        return V.PreprocessorVertex(preprocessor="identity")
    raise UnsupportedDl4jConfigurationException(
        f"unsupported DL4J graph vertex type {t!r}")


# -- top-level configurations --------------------------------------------------

def _counters(d: dict):
    """The 1.0-era training counters (absent in 0.9.x zips): a resumed
    Adam needs its bias-correction step count."""
    return int(d.get("iterationCount", 0)), int(d.get("epochCount", 0))


def import_dl4j_configuration(source):
    """DL4J ``MultiLayerConfiguration`` JSON (a string or a dict) as the
    port's configuration."""
    d = json.loads(source) if isinstance(source, str) else source
    confs = d.get("confs")
    if confs is None:
        raise InvalidDl4jConfigurationException(
            "not a MultiLayerConfiguration JSON (no 'confs')")
    b = NeuralNetConfiguration.builder()
    first = confs[0] if confs else {}
    if "seed" in first:
        b.seed(int(first["seed"]))
    lb = b.list()
    for conf in confs:
        layer_entry = conf.get("layer")
        if not isinstance(layer_entry, dict) or len(layer_entry) != 1:
            raise InvalidDl4jConfigurationException(f"bad layer entry {layer_entry!r}")
        lb.layer(convert_dl4j_layer(*next(iter(layer_entry.items()))))
    for k, v in (d.get("inputPreProcessors") or {}).items():
        spec = _convert_dl4j_preprocessor(v)
        if spec is not None:
            lb.input_pre_processor(int(k), spec)
    if d.get("backpropType") == "TruncatedBPTT":
        fwd = int(d.get("tbpttFwdLength", 20))
        lb.t_bptt_length(fwd, int(d.get("tbpttBackLength", fwd)))
    built = lb.build()
    built._dl4j_counters = _counters(d)
    return built


def import_dl4j_graph_configuration(source):
    """DL4J ``ComputationGraphConfiguration`` JSON (``vertices``,
    ``vertexInputs``, ``networkInputs``, ``networkOutputs``) as the port's
    graph configuration; a LayerVertex's ``preProcessor`` becomes its
    vertex's preprocessor spec."""
    d = json.loads(source) if isinstance(source, str) else source
    vertices = d.get("vertices")
    if vertices is None:
        raise InvalidDl4jConfigurationException(
            "not a ComputationGraphConfiguration JSON (no 'vertices')")
    vertex_inputs = d.get("vertexInputs") or {}
    g = NeuralNetConfiguration.builder().graph_builder()
    g.add_inputs(*(d.get("networkInputs") or []))
    raw_pre = {}
    for name, entry in vertices.items():
        if not isinstance(entry, dict) or len(entry) != 1:
            raise InvalidDl4jConfigurationException(f"bad vertex {name!r}")
        vt, vc = next(iter(entry.items()))
        vc = vc or {}
        obj = _convert_dl4j_vertex(vt, vc)
        srcs = vertex_inputs.get(name, [])
        if isinstance(obj, L.Layer):
            g.add_layer(name, obj, *srcs)
            pp = vc.get("preProcessor")
            spec = None if pp is None else _convert_dl4j_preprocessor(pp)
            if spec is not None:
                g.input_pre_processor(name, spec)
                raw_pre[name] = pp
        else:
            g.add_vertex(name, obj, *srcs)
    g.set_outputs(*(d.get("networkOutputs") or []))
    if d.get("backpropType") == "TruncatedBPTT":
        fwd = int(d.get("tbpttFwdLength", 20))
        g.t_bptt_length(fwd, int(d.get("tbpttBackLength", fwd)))
    built = g.build()
    built._dl4j_counters = _counters(d)
    # the LayerVertex entries as read, which the exporter writes back
    built._dl4j_layer_preprocessors = raw_pre
    return built


def _read_zip_configuration(z: zipfile.ZipFile, path) -> dict:
    names = set(z.namelist())
    if "configuration.json" not in names:
        raise InvalidDl4jConfigurationException(
            f"{path}: no configuration.json in zip (entries: {sorted(names)})")
    return json.loads(z.read("configuration.json").decode("utf-8"))


def import_dl4j_zip(path):
    """A ModelSerializer zip's ``(configuration, metadata)``; a
    ``normalizer.bin`` rides along parsed as ``meta["normalizer"]`` (or
    its error as ``meta["normalizer_error"]``: a normalizer the reader
    cannot parse does not fail the model's import)."""
    from deeplearning4j_tpu_torch.modelimport.normalizer_serde import (
        normalizer_from_bytes,
    )

    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        raw = _read_zip_configuration(z, path)
        conf = (import_dl4j_graph_configuration(raw) if "vertices" in raw
                else import_dl4j_configuration(raw))
        meta = {"has_coefficients": "coefficients.bin" in names,
                "has_updater_state": "updaterState.bin" in names,
                "has_normalizer": "normalizer.bin" in names,
                "normalizer": None}
        if meta["has_normalizer"]:
            try:
                meta["normalizer"] = normalizer_from_bytes(z.read("normalizer.bin"))
            except Exception as e:  # a CUSTOM strategy, a bit-rotted entry
                meta["normalizer_error"] = f"{type(e).__name__}: {e}"
    return conf, meta


def restore_normalizer(path):
    """The zip's ``normalizer.bin`` as a fitted normalizer
    (``ModelSerializer.restoreNormalizerFromFile``), or None without one."""
    from deeplearning4j_tpu_torch.modelimport.normalizer_serde import (
        normalizer_from_bytes,
    )

    with zipfile.ZipFile(path) as z:
        if "normalizer.bin" not in set(z.namelist()):
            return None
        return normalizer_from_bytes(z.read("normalizer.bin"))


def add_normalizer_to_model(path, normalizer) -> None:
    """``ModelSerializer.addNormalizerToModel``: the zip rewritten with
    every entry but an existing ``normalizer.bin`` (matched without case),
    then the serialized normalizer."""
    from deeplearning4j_tpu_torch.modelimport.normalizer_serde import (
        normalizer_to_bytes,
    )
    from deeplearning4j_tpu_torch.util.model_serializer import replace_zip_entry

    replace_zip_entry(path, "normalizer.bin", normalizer_to_bytes(normalizer))


def restore_multi_layer_network_configuration(path, device=None):
    """An uninitialized ``MultiLayerNetwork`` of the zip's configuration,
    on ``device`` (``cuda`` unless ``"cpu"``)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf, _ = import_dl4j_zip(path)
    return MultiLayerNetwork(conf, device=device)


# -- coefficients.bin -----------------------------------------------------------

def _dl4j_param_specs(layer):
    """One layer's slices of the flattened vector, in order: ``(name,
    dl4j_shape, memory_order, convert, target)``, target "param" or
    "state". Empty for a layer without parameters."""
    cls = type(layer).__name__
    shapes = layer.param_shapes()

    def ravel(a):
        return np.ascontiguousarray(a).reshape(-1)

    def ident(a):
        return np.ascontiguousarray(a)

    if cls == "BatchNormalizationLayer":
        # BatchNormalizationParamInitializer: gamma, beta, mean, var
        n = layer.n_in
        specs = []
        if "gamma" in shapes:
            specs += [("gamma", (1, n), "c", ravel, "param"),
                      ("beta", (1, n), "c", ravel, "param")]
        return specs + [("mean", (1, n), "c", ravel, "state"),
                        ("var", (1, n), "c", ravel, "state")]
    if not shapes:
        return []
    if cls == "ConvolutionLayer":
        # ConvolutionParamInitializer: W [nOut, nIn, kH, kW] 'c' -> HWIO
        kh, kw = layer.kernel_size
        specs = [("W", (layer.n_out, layer.n_in, kh, kw), "c",
                  lambda a: np.transpose(a, (2, 3, 1, 0)), "param")]
        if "b" in shapes:
            specs.append(("b", (1, layer.n_out), "c", ravel, "param"))
        return specs
    if cls in ("LSTMLayer", "GravesLSTMLayer", "SimpleRnnLayer"):
        # LSTMParamInitializer: W [nIn, 4H], RW [H, 4H (+3 peepholes)], b;
        # the gate order (IFOG) is shared with nn/layers/recurrent.py;
        # SimpleRnnParamInitializer: W, RW, b in the same order
        specs = [("W", shapes["W"], "f", ident, "param"),
                 ("RW", shapes["RW"], "f", ident, "param")]
        if "b" in shapes:
            specs.append(("b", (1, shapes["b"][0]), "c", ravel, "param"))
        return specs
    if cls in ("BidirectionalWrapper", "GravesBidirectionalLSTMLayer"):
        # the forward direction's parameters, then the backward's, each in
        # its layer's order (GravesBidirectionalLSTMParamInitializer: WF,
        # RWF, bF, WB, RWB, bB; BidirectionalParamInitializer likewise)
        inner = _dl4j_param_specs(layer.layer)
        return ([("f_" + n, *rest) for n, *rest in inner]
                + [("b_" + n, *rest) for n, *rest in inner])
    if cls == "MaskZeroLayer":  # the wrapped layer's parameters, unprefixed
        return _dl4j_param_specs(layer.layer)
    if set(shapes) <= {"W", "b"} and len(shapes.get("W", (0, 0))) == 2:
        # DefaultParamInitializer (dense, output): W reshaped 'f'
        specs = [("W", shapes["W"], "f", ident, "param")]
        if "b" in shapes:
            specs.append(("b", (1, shapes["b"][0]), "c", ravel, "param"))
        return specs
    raise UnsupportedDl4jConfigurationException(
        f"coefficients.bin ingestion does not support layer type {cls} "
        f"(params {sorted(shapes)})")


def _java_int_set_iter(elems):
    """The iteration order of a ``java.util.HashSet<Integer>`` filled by
    ``add()`` in ``elems`` order: buckets ascend (an Integer hashes to its
    value; the spread ``h ^ h >>> 16`` is the identity below 2^16), and
    entries in one bucket keep insertion order. The capacity starts at 16
    and doubles whenever the size exceeds 0.75 of it."""
    cap = 16
    while len(elems) > 0.75 * cap:
        cap *= 2
    buckets = {}
    for e in elems:
        buckets.setdefault((e ^ (e >> 16)) & (cap - 1), []).append(e)
    return [e for b in sorted(buckets) for e in buckets[b]]


def _dl4j_topological_order(conf, java_set_order: bool = True):
    """``ComputationGraph.topologicalSortOrder()``: Kahn's algorithm over
    vertex indices (the network inputs in order, then the vertices in
    serialization order), a FIFO queue, successors in Java HashSet order
    (``java_set_order=False``: ascending, to find where the emulation is
    all that decides)."""
    names = list(conf.inputs) + list(conf.vertices)
    idx = {n: i for i, n in enumerate(names)}
    input_edges = {idx[n]: set() for n in conf.inputs}
    output_elems: Dict[int, list] = {}
    for name, vd in conf.vertices.items():
        i = idx[name]
        input_edges[i] = set()
        for src in vd.inputs:
            j = idx[src]
            input_edges[i].add(j)
            lst = output_elems.setdefault(j, [])
            if i not in lst:
                lst.append(i)
    queue = [i for i in sorted(input_edges) if not input_edges[i]]
    out = []
    while queue:
        nxt = queue.pop(0)
        out.append(nxt)
        succs = output_elems.get(nxt, [])
        for v in (_java_int_set_iter(succs) if java_set_order else sorted(succs)):
            input_edges[v].discard(nxt)
            if not input_edges[v]:
                queue.append(v)
    if len(out) != len(names):
        raise InvalidDl4jConfigurationException("graph contains a cycle")
    return [names[i] for i in out]


def _graph_layer_order(conf, java_set_order: bool = True):
    """The layer vertices in the order ``ComputationGraph.init`` gives them
    their views of the flattened vector."""
    return [n for n in _dl4j_topological_order(conf, java_set_order)
            if n in conf.vertices and conf.vertices[n].is_layer]


def _layer_seq(conf):
    """``(key, layer)`` in DL4J's flattened order: by index for a
    MultiLayerNetwork, in DL4J's topological order for a graph."""
    if hasattr(conf, "layers"):
        return list(enumerate(conf.layers))
    return [(n, conf.vertices[n].obj) for n in _graph_layer_order(conf)]


def _iter_param_slices(conf, flat):
    """``(layer key, name, target, array)`` along the flattened vector."""
    pos = 0
    flat = np.asarray(flat).reshape(-1)
    for key, layer in _layer_seq(conf):
        for name, shape, order, convert, target in _dl4j_param_specs(layer):
            n = int(np.prod(shape))
            seg = flat[pos:pos + n]
            if seg.size != n:
                raise InvalidDl4jConfigurationException(
                    f"coefficients.bin too short: layer {key} param {name!r} "
                    f"wants {n} values at offset {pos}, only {seg.size} left")
            pos += n
            yield key, name, target, convert(seg.reshape(
                shape, order="F" if order == "f" else "C"))
    if pos != flat.size:
        raise InvalidDl4jConfigurationException(
            f"coefficients.bin length mismatch: consumed {pos} of {flat.size} "
            "values; the layers disagree with the checkpoint")


def _copy_into(dest: torch.Tensor, arr: np.ndarray, where: str) -> None:
    if tuple(dest.shape) != tuple(arr.shape):
        raise InvalidDl4jConfigurationException(
            f"{where}: checkpoint shape {tuple(arr.shape)} vs model shape "
            f"{tuple(dest.shape)}")
    with torch.no_grad():
        # each tensor keeps its dtype (BatchNorm's statistics stay float32)
        dest.copy_(torch.from_numpy(np.array(arr)).to(dest.dtype))


def apply_coefficients(net, flat) -> None:
    """A DL4J flattened parameter vector into an initialized network of
    either kind, in place: parameters and BatchNorm's statistics."""
    slices = list(_iter_param_slices(net.conf, flat))  # checks the length first
    for key, name, target, arr in slices:
        dest = (net.params if target == "param" else net.states)[key]
        _copy_into(dest[name], arr, f"layer {key} param {name!r}")


# GradientUpdater state views in DL4J's order, by the port's slot names
_UPDATER_STATE_SLOTS = {
    "Adam": ("m", "v"), "AdaMax": ("m", "u"), "Nadam": ("m", "v"),
    "AMSGrad": ("m", "v", "v_hat"), "Nesterovs": ("v",), "RmsProp": ("g2",),
    "AdaGrad": ("h",), "AdaDelta": ("eg2", "edx2"), "Sgd": (), "NoOp": (),
}


def _updater_blocks(conf, updaters):
    """DL4J's ``UpdaterBlock``s over the flattened layout: the trainable
    parameters in runs, split where a non-trainable run (BatchNorm's
    statistics) interrupts them and where neighbouring updater
    configurations differ (a dataclass's ``==`` is DL4J's
    ``updaterConfigurationsEquals``). ``(updater, [(key, name, shape,
    order, convert), ...])`` a block."""
    blocks, current, cur_u = [], [], None
    for key, layer in _layer_seq(conf):
        for name, shape, order, convert, target in _dl4j_param_specs(layer):
            if target != "param":
                if current:
                    blocks.append((cur_u, current))
                    current, cur_u = [], None
                continue
            u = updaters[key][name]
            if current and u != cur_u:
                blocks.append((cur_u, current))
                current = []
            cur_u = u
            current.append((key, name, shape, order, convert))
    if current:
        blocks.append((cur_u, current))
    return blocks


def apply_updater_state(net, flat) -> bool:
    """A DL4J ``updaterState.bin`` vector into the network's updater state,
    in place: block by block, each block's ``[slot 0 (block), slot 1
    (block), ...]`` in flattened order. False (the state left as it was)
    when an updater's slot layout is unknown."""
    flat = np.asarray(flat).reshape(-1)
    blocks = _updater_blocks(net.conf, net._updaters)
    if any(type(u).__name__ not in _UPDATER_STATE_SLOTS for u, _ in blocks):
        return False
    want = sum(len(_UPDATER_STATE_SLOTS[type(u).__name__]) * int(np.prod(shape))
               for u, b in blocks for (_, _, shape, _, _) in b)
    if want == 0:
        return flat.size == 0
    if flat.size != want:
        raise InvalidDl4jConfigurationException(
            f"updaterState.bin length {flat.size} != expected {want} "
            "(per-block updater slots over the trainable params)")
    pos, writes = 0, []
    for u, block in blocks:
        for slot in _UPDATER_STATE_SLOTS[type(u).__name__]:
            for key, name, shape, order, convert in block:
                n = int(np.prod(shape))
                arr = flat[pos:pos + n].reshape(shape, order="F" if order == "f" else "C")
                writes.append((net.updater_states[key][name][slot], convert(arr),
                               f"updater state {key}/{name}/{slot}"))
                pos += n
    for dest, arr, where in writes:
        _copy_into(dest, arr, where)
    return True


def _restore(path, conf_kind: str, load_params: bool, load_updater: bool,
             device):
    from deeplearning4j_tpu_torch.modelimport.nd4j_binary import (
        read_nd4j_array_from_bytes,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        raw = _read_zip_configuration(z, path)
        is_graph = "vertices" in raw
        if conf_kind == "graph" and not is_graph:
            raise UnsupportedDl4jConfigurationException(
                "restore_computation_graph is for ComputationGraph zips; this "
                "is a MultiLayerNetwork configuration: use "
                "restore_multi_layer_network")
        if conf_kind == "multilayer" and is_graph:
            raise UnsupportedDl4jConfigurationException(
                "restore_multi_layer_network is for MultiLayerNetwork zips; "
                "this is a ComputationGraph configuration")
        if is_graph:
            net = ComputationGraph(import_dl4j_graph_configuration(raw),
                                   device=device).init()
        else:
            net = MultiLayerNetwork(import_dl4j_configuration(raw),
                                    device=device).init()
        if load_params and "coefficients.bin" in names:
            if is_graph and (_graph_layer_order(net.conf)
                             != _graph_layer_order(net.conf, False)):
                warnings.warn(
                    "graph layer order depends on the Java HashSet bucket-order "
                    "emulation for vertex indices >= 16; check the restored "
                    "outputs against known activations", stacklevel=3)
            apply_coefficients(net, read_nd4j_array_from_bytes(
                z.read("coefficients.bin")))
        net.iteration, net.epoch = net.conf._dl4j_counters
        if load_params and load_updater and "updaterState.bin" in names:
            apply_updater_state(net, read_nd4j_array_from_bytes(
                z.read("updaterState.bin")))
    return net


def restore_multi_layer_network(path, load_params: bool = True,
                                load_updater: bool = True, device=None):
    """``ModelSerializer.restoreMultiLayerNetwork``: the configuration, the
    flattened ``coefficients.bin`` and ``updaterState.bin`` when present,
    as an initialized ``MultiLayerNetwork`` on ``device`` (``cuda`` unless
    ``"cpu"``)."""
    return _restore(path, "multilayer", load_params, load_updater, device)


def restore_computation_graph(path, load_params: bool = True,
                              load_updater: bool = True, device=None):
    """``ModelSerializer.restoreComputationGraph``: as
    :func:`restore_multi_layer_network`, for a graph, its layers walked in
    DL4J's topological order."""
    return _restore(path, "graph", load_params, load_updater, device)
