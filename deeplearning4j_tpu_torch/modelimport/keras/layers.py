"""Keras layer configurations -> the port's layers (the Keras 1 and Keras 2
dialects).

Counterpart of ``deeplearning4j_tpu/modelimport/keras/layers.py`` (DL4J's
per-family mappers under ``modelimport/keras/layers/`` and the two field
dialects of ``Keras1LayerConfiguration.java`` /
``Keras2LayerConfiguration.java``: ``output_dim``/``nb_filter``/
``border_mode``/``subsample`` against ``units``/``filters``/``padding``/
``strides``). Every class name, activation, loss and constraint it maps,
and every one it refuses, is the reference's.

Each mapper returns ``(layer, weight_fn)``; ``weight_fn(raw)`` turns the
layer's Keras weights into ``(params, states)`` of the layer. The port's
layouts are the reference's (kernels HWIO, NHWC activations), so arrays
keep Keras' order, but for the LSTM's gates: Keras' ``[i|f|c|o]`` becomes
IFOG, the order of the port's LSTM and its kernel. A MultiHeadAttention's
query, key and value kernels pack into the head-major fused ``Wqkv`` the
port's ``SelfAttentionLayer`` holds. A ``Lambda`` layer takes the torch
callable (or layer) registered under its name, wrapped in a
``SameDiffLambdaLayer``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer,
    BatchNormalizationLayer,
    Convolution1DLayer,
    ConvolutionLayer,
    DenseLayer,
    DepthwiseConvolution2DLayer,
    DropoutLayer,
    EmbeddingSequenceLayer,
    GlobalPoolingLayer,
    LSTMLayer,
    SeparableConvolution2DLayer,
    SimpleRnnLayer,
    Subsampling1DLayer,
    SubsamplingLayer,
    Upsampling1DLayer,
    UpsamplingLayer,
    ZeroPadding1DLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.layers.recurrent import BidirectionalWrapper, LastTimeStepWrapper

WeightFn = Callable[[Dict[str, np.ndarray]], Tuple[dict, dict]]

# Keras activation name → ours
ACTIVATIONS = {
    "linear": "identity", "relu": "relu", "relu6": "relu6",
    "sigmoid": "sigmoid", "hard_sigmoid": "hardsigmoid", "tanh": "tanh",
    "softmax": "softmax", "softplus": "softplus", "softsign": "softsign",
    "elu": "elu", "selu": "selu", "swish": "swish", "silu": "swish",
    "gelu": "gelu", "exponential": "exp", "leaky_relu": "leakyrelu",
}

# Keras loss name → ours
LOSSES = {
    "categorical_crossentropy": "mcxent",
    "sparse_categorical_crossentropy": "mcxent",
    "binary_crossentropy": "xent",
    "mean_squared_error": "mse", "mse": "mse",
    "mean_absolute_error": "l1", "mae": "l1",
    "kullback_leibler_divergence": "kld", "kld": "kld",
    "poisson": "poisson",
    "cosine_proximity": "cosine_proximity",
    "hinge": "hinge", "squared_hinge": "squared_hinge",
}


def map_activation(name: Optional[str]) -> str:
    if not name:
        return "identity"
    key = str(name).lower()
    if key not in ACTIVATIONS:
        raise UnsupportedKerasConfigurationException(
            f"Unsupported Keras activation {name!r}")
    return ACTIVATIONS[key]


class InvalidKerasConfigurationException(ValueError):
    """Reference: ``exceptions/InvalidKerasConfigurationException.java``."""


# user-registered Lambda layer implementations, keyed by Keras layer name
# (reference: ``KerasLayer.registerLambdaLayer(name, SameDiffLambdaLayer)``)
_LAMBDA_REGISTRY: Dict[str, object] = {}


def register_lambda_layer(name: str, impl) -> None:
    """Register the implementation for a Keras ``Lambda`` layer by its layer
    name, to be picked up at import time. ``impl`` is either a layer of the
    port or a torch function ``fn(x) -> y`` of the layer's input tensor
    (wrapped in a ``SameDiffLambdaLayer``, as the reference wraps it)."""
    _LAMBDA_REGISTRY[name] = impl


def clear_lambda_layers() -> None:
    _LAMBDA_REGISTRY.clear()


class UnsupportedKerasConfigurationException(ValueError):
    """Reference: ``exceptions/UnsupportedKerasConfigurationException.java``."""


def _pair(v, default=(1, 1)):
    if v is None:
        return default
    if isinstance(v, int):
        return (v, v)
    return tuple(int(x) for x in v)


def _no_weights(raw):
    return {}, {}


def _dense_weights(raw):
    p = {}
    if "kernel" in raw:
        p["W"] = raw["kernel"]
    elif "W" in raw:
        p["W"] = raw["W"]
    else:  # Keras1 flat names like "dense_1_W"
        for k, v in raw.items():
            if k.endswith("_W") or v.ndim >= 2:
                p["W"] = v
            elif k.endswith("_b") or v.ndim == 1:
                p["b"] = v
    if "bias" in raw:
        p["b"] = raw["bias"]
    elif "b" in raw:
        p["b"] = raw["b"]
    return p, {}


def _bn_weights(raw):
    get = lambda *names: next((raw[n] for n in names if n in raw), None)
    p, s = {}, {}
    gamma = get("gamma")
    beta = get("beta")
    mean = get("moving_mean", "running_mean")
    var = get("moving_variance", "running_std", "running_var")
    if gamma is None or beta is None or mean is None or var is None:
        # Keras1 flat names: <layer>_gamma etc.
        for k, v in raw.items():
            if k.endswith("_gamma"):
                gamma = v
            elif k.endswith("_beta"):
                beta = v
            elif k.endswith("_running_mean"):
                mean = v
            elif k.endswith(("_running_std", "_running_var")):
                var = v
    if gamma is not None:
        p["gamma"] = gamma
    if beta is not None:
        p["beta"] = beta
    if mean is not None:
        s["mean"] = mean
    if var is not None:
        s["var"] = var
    return p, s


def _lstm_reorder(k: np.ndarray, units: int) -> np.ndarray:
    """Keras gate blocks [i|f|c|o] → the layer's [i|f|o|g] along the last axis
    (IFOG: the order of the port's LSTM and its kernel, not torch's IFGO)."""
    i, f, c, o = (k[..., j * units:(j + 1) * units] for j in range(4))
    return np.concatenate([i, f, o, c], axis=-1)


def _lstm_weights_fn(units: int) -> WeightFn:
    def fn(raw):
        get = lambda *names: next((raw[n] for n in names if n in raw), None)
        k = get("kernel", "W")
        rk = get("recurrent_kernel", "U")
        b = get("bias", "b")
        if k is None:
            # Keras1 per-gate names: W_i, W_f, W_c, W_o / U_* / b_*
            def cat(prefix):
                gates = [raw.get(f"{prefix}_{g}") for g in ("i", "f", "o", "c")]
                if any(g is None for g in gates):
                    # also try flat <layer>_W_i style
                    gates = [next((v for n, v in raw.items()
                                   if n.endswith(f"{prefix}_{g}")), None)
                             for g in ("i", "f", "o", "c")]
                if any(g is None for g in gates):
                    return None
                return np.concatenate(gates, axis=-1)
            k_ifog, rk_ifog, b_ifog = cat("W"), cat("U"), cat("b")
            if k_ifog is None:
                raise InvalidKerasConfigurationException(
                    f"cannot locate LSTM weights among {sorted(raw)}")
            return {"W": k_ifog, "RW": rk_ifog, "b": b_ifog}, {}
        p = {"W": _lstm_reorder(k, units), "RW": _lstm_reorder(rk, units)}
        if b is not None:
            if b.ndim == 2:  # CuDNN-style split bias rows
                b = b.sum(axis=0)
            p["b"] = _lstm_reorder(b, units)
        return p, {}
    return fn


def _rnn_weights(raw):
    get = lambda *names: next((raw[n] for n in names if n in raw), None)
    p = {}
    k = get("kernel", "W")
    rk = get("recurrent_kernel", "U")
    b = get("bias", "b")
    if k is None:
        for n, v in raw.items():
            if n.endswith("_W"):
                k = v
            elif n.endswith("_U"):
                rk = v
            elif n.endswith("_b"):
                b = v
    if k is not None:
        p["W"] = k
    if rk is not None:
        p["RW"] = rk
    if b is not None:
        p["b"] = b
    return p, {}


def _embedding_weights(raw):
    get = lambda *names: next((raw[n] for n in names if n in raw), None)
    w = get("embeddings", "W")
    if w is None:
        w = next((v for n, v in raw.items() if v.ndim == 2), None)
    return ({"W": w} if w is not None else {}), {}


def _conv1d_weights(raw):
    p, s = _dense_weights(raw)
    if "W" in p and p["W"].ndim == 3:  # Keras [k,in,out] -> ours [k,1,in,out]
        p["W"] = p["W"][:, None, :, :]
    return p, s


def _grouped_kernel(dk: np.ndarray) -> np.ndarray:
    """Keras' depthwise kernel ``[kh, kw, C, M]`` as the layer's grouped
    one ``[kh, kw, 1, C*M]``: output channel ``c*M + m`` in both, so a
    reshape. The reference keeps Keras' shape, which its separable layer
    refuses (ROADMAP C10)."""
    dk = np.asarray(dk)
    return dk.reshape(dk.shape[0], dk.shape[1], 1, -1)


def _sepconv_weights(raw):
    get = lambda *names: next((raw[n] for n in names if n in raw), None)
    p = {}
    dk = get("depthwise_kernel")
    pk = get("pointwise_kernel")
    b = get("bias", "b")
    if dk is not None:
        p["W"] = _grouped_kernel(dk)
    if pk is not None:
        p["pW"] = pk
    if b is not None:
        p["b"] = b
    return p, {}


def _depthwise_weights(raw):
    get = lambda *names: next((raw[n] for n in names if n in raw), None)
    p = {}
    # Keras 3 stores a DepthwiseConv2D's kernel as "kernel" (ROADMAP C10)
    dk = get("depthwise_kernel", "kernel")
    b = get("bias", "b")
    if dk is not None:
        p["W"] = _grouped_kernel(dk)
    if b is not None:
        p["b"] = b
    return p, {}


def _bidirectional_weights(inner_fn: WeightFn) -> WeightFn:
    def fn(raw):
        fwd = {k[len("forward_"):] if k.startswith("forward_") else k: v
               for k, v in raw.items() if not k.startswith("backward_")}
        bwd = {k[len("backward_"):]: v for k, v in raw.items()
               if k.startswith("backward_")}
        fp, _ = inner_fn(fwd)
        bp, _ = inner_fn(bwd)
        return ({f"f_{k}": v for k, v in fp.items()} |
                {f"b_{k}": v for k, v in bp.items()}), {}
    return fn


def _one_constraint(spec, scope: str):
    """One serialized Keras constraint → LayerConstraint (keras.constraints:
    MaxNorm/NonNeg/UnitNorm/MinMaxNorm). Keras ``axis`` is the norm's
    reduction axis — the same meaning as the constraints' ``dimensions``, and both
    frameworks share the kernel layouts (Dense [in,out], conv HWIO), so it
    maps through unchanged."""
    from deeplearning4j_tpu_torch.nn.constraints import (
        MaxNormConstraint, MinMaxNormConstraint, NonNegativeConstraint,
        UnitNormConstraint)
    if spec is None:
        return None
    # Keras 2 nests {"class_name": ..., "config": {...}}; Keras 1 is FLAT —
    # {"name": "MaxNorm", "m": 2.0, "axis": 0} (constraints.py get_config)
    cls = spec.get("class_name") or spec.get("name", "")
    c = spec.get("config", spec if "class_name" not in spec else {})
    # keras.constraints' own default is axis=0, NOT this framework's
    # all-but-last: for conv kernels (HWIO) those differ ((0,) vs (0,1,2)),
    # so a config that omits the field must get Keras's default.
    ax = c.get("axis", 0)
    dims = None if ax is None else tuple(ax) if isinstance(ax, (list, tuple)) \
        else (int(ax),)
    if cls in ("MaxNorm", "max_norm", "maxnorm"):
        # Keras 1 spells the bound "m", Keras 2 "max_value"
        return MaxNormConstraint(
            max_norm=float(c.get("max_value", c.get("m", 2.0))),
            dimensions=dims, scope=scope)
    if cls in ("MinMaxNorm", "min_max_norm"):
        return MinMaxNormConstraint(min_norm=float(c.get("min_value", 0.0)),
                                    max_norm=float(c.get("max_value", 1.0)),
                                    rate=float(c.get("rate", 1.0)),
                                    dimensions=dims, scope=scope)
    if cls in ("NonNeg", "non_neg", "nonneg"):
        return NonNegativeConstraint(scope=scope)
    if cls in ("UnitNorm", "unit_norm", "unitnorm"):
        return UnitNormConstraint(dimensions=dims, scope=scope)
    raise UnsupportedKerasConfigurationException(
        f"Unsupported Keras constraint: {cls!r} (supported: MaxNorm, "
        "MinMaxNorm, NonNeg, UnitNorm)")


def recurrent_constraints_from_keras_cfg(cfg: dict):
    """Recurrent layers name their targets: kernel→W, recurrent_kernel→RW,
    bias→b (explicit param names rather than scopes)."""
    out = []
    for key, pnames in (("kernel_constraint", ("W",)),
                        ("W_constraint", ("W",)),
                        ("recurrent_constraint", ("RW",)),
                        ("U_constraint", ("RW",)),
                        ("bias_constraint", ("b",)),
                        ("b_constraint", ("b",))):
        c = _one_constraint(cfg.get(key), "weights")
        if c is not None:
            import dataclasses as _dc
            out.append(_dc.replace(c, param_names=pnames))
    return out or None


def constraints_from_keras_cfg(cfg: dict):
    """Map ``kernel_constraint`` / ``bias_constraint`` (and the Keras-1
    ``W_constraint`` / ``b_constraint`` spellings) to the layer's constraint list."""
    out = []
    for key, scope in (("kernel_constraint", "weights"),
                       ("W_constraint", "weights"),
                       ("bias_constraint", "bias"),
                       ("b_constraint", "bias")):
        c = _one_constraint(cfg.get(key), scope)
        if c is not None:
            out.append(c)
    return out or None


def map_keras_layer(class_name: str, cfg: dict) -> Tuple[Optional[Layer], WeightFn]:
    """One Keras layer config → (the port's layer or None if structural, weight_fn).

    Returns ``(None, _no_weights)`` for layers that vanish in the imported model
    (Flatten — handled by dense auto-preprocessors; InputLayer).
    """
    name = cfg.get("name")
    act = map_activation(cfg.get("activation")) if "activation" in cfg else None

    if class_name in ("InputLayer", "Flatten", "Masking"):
        return None, _no_weights

    if class_name in ("Dense", "TimeDistributedDense"):
        # Keras-1 TimeDistributedDense == a position-wise Dense; the
        # DenseLayer applies position-wise over [N,T,C] already (the DL4J
        # mapping is Dense + rnn↔ff preprocessors — KerasDense.java:49)
        units = cfg.get("units", cfg.get("output_dim"))
        return DenseLayer(name=name, n_out=int(units), activation=act or "identity",
                          has_bias=cfg.get("use_bias", cfg.get("bias", True)),
                          constraints=constraints_from_keras_cfg(cfg)), _dense_weights

    if class_name in ("Conv2D", "Convolution2D"):
        filters = cfg.get("filters", cfg.get("nb_filter"))
        if "kernel_size" in cfg:
            ks = _pair(cfg["kernel_size"])
        else:
            ks = (int(cfg["nb_row"]), int(cfg["nb_col"]))
        strides = _pair(cfg.get("strides", cfg.get("subsample")), (1, 1))
        pad = cfg.get("padding", cfg.get("border_mode", "valid"))
        mode = "same" if pad == "same" else "truncate"
        return (ConvolutionLayer(name=name, n_out=int(filters), kernel_size=ks,
                                 stride=strides, convolution_mode=mode,
                                 dilation=_pair(cfg.get("dilation_rate"), (1, 1)),
                                 activation=act or "identity",
                                 has_bias=cfg.get("use_bias", cfg.get("bias", True)),
                                 constraints=constraints_from_keras_cfg(cfg)),
                _dense_weights)

    if class_name in ("Conv1D", "Convolution1D"):
        filters = cfg.get("filters", cfg.get("nb_filter"))
        k = cfg.get("kernel_size", cfg.get("filter_length"))
        k = int(k[0]) if isinstance(k, (list, tuple)) else int(k)
        s = cfg.get("strides", cfg.get("subsample_length", 1))
        s = int(s[0]) if isinstance(s, (list, tuple)) else int(s)
        pad = cfg.get("padding", cfg.get("border_mode", "valid"))
        mode = "same" if pad in ("same", "causal") else "truncate"
        return (Convolution1DLayer(name=name, n_out=int(filters),
                                   kernel_size=k, stride=s,
                                   convolution_mode=mode,
                                   activation=act or "identity",
                                   constraints=constraints_from_keras_cfg(cfg)),
                _conv1d_weights)

    if class_name == "SeparableConv2D":
        return (SeparableConvolution2DLayer(
            name=name, n_out=int(cfg.get("filters")),
            kernel_size=_pair(cfg.get("kernel_size")),
            stride=_pair(cfg.get("strides"), (1, 1)),
            depth_multiplier=int(cfg.get("depth_multiplier", 1)),
            convolution_mode="same" if cfg.get("padding") == "same" else "truncate",
            activation=act or "identity",
            constraints=constraints_from_keras_cfg(cfg)), _sepconv_weights)

    if class_name == "DepthwiseConv2D":
        return (DepthwiseConvolution2DLayer(
            name=name,
            kernel_size=_pair(cfg.get("kernel_size")),
            stride=_pair(cfg.get("strides"), (1, 1)),
            depth_multiplier=int(cfg.get("depth_multiplier", 1)),
            convolution_mode="same" if cfg.get("padding") == "same" else "truncate",
            activation=act or "identity",
            constraints=constraints_from_keras_cfg(cfg)), _depthwise_weights)

    if class_name in ("MaxPooling2D", "AveragePooling2D"):
        pt = "max" if class_name.startswith("Max") else "avg"
        ks = _pair(cfg.get("pool_size"), (2, 2))
        strides = _pair(cfg.get("strides"), ks)
        pad = cfg.get("padding", cfg.get("border_mode", "valid"))
        return (SubsamplingLayer(name=name, pooling_type=pt, kernel_size=ks,
                                 stride=strides,
                                 convolution_mode="same" if pad == "same" else "truncate"),
                _no_weights)

    if class_name in ("MaxPooling1D", "AveragePooling1D"):
        pt = "max" if class_name.startswith("Max") else "avg"
        k = cfg.get("pool_size", cfg.get("pool_length", 2))
        k = int(k[0]) if isinstance(k, (list, tuple)) else int(k)
        s = cfg.get("strides", cfg.get("stride")) or k
        s = int(s[0]) if isinstance(s, (list, tuple)) else int(s)
        return (Subsampling1DLayer(name=name, pooling_type=pt,
                                   kernel_size=(k, 1), stride=(s, 1)),
                _no_weights)

    if class_name in ("GlobalMaxPooling1D", "GlobalAveragePooling1D",
                      "GlobalMaxPooling2D", "GlobalAveragePooling2D"):
        pt = "max" if "Max" in class_name else "avg"
        return GlobalPoolingLayer(name=name, pooling_type=pt), _no_weights

    if class_name == "Dropout":
        rate = cfg.get("rate", cfg.get("p", 0.5))
        return DropoutLayer(name=name, dropout=1.0 - float(rate)), _no_weights

    if class_name in ("SpatialDropout1D", "SpatialDropout2D",
                      "SpatialDropout3D"):
        # real channel dropout (keras SpatialDropoutND → nn/dropout.py)
        from deeplearning4j_tpu_torch.nn.dropout import SpatialDropout
        rate = float(cfg.get("rate", cfg.get("p", 0.5)))
        return (DropoutLayer(name=name, dropout=SpatialDropout(p=1.0 - rate)),
                _no_weights)

    if class_name == "GaussianDropout":
        # keras rate IS the reference's rate: noise std = sqrt(rate/(1-rate))
        from deeplearning4j_tpu_torch.nn.dropout import GaussianDropout
        rate = float(cfg.get("rate", cfg.get("p", 0.5)))
        return (DropoutLayer(name=name, dropout=GaussianDropout(rate=rate)),
                _no_weights)

    if class_name == "GaussianNoise":
        from deeplearning4j_tpu_torch.nn.dropout import GaussianNoise
        stddev = float(cfg.get("stddev", cfg.get("sigma", 0.1)))
        return (DropoutLayer(name=name, dropout=GaussianNoise(stddev=stddev)),
                _no_weights)

    if class_name == "AlphaDropout":
        # real SNN dropout (AlphaDropout.java:38), not a plain-dropout stand-in
        from deeplearning4j_tpu_torch.nn.dropout import AlphaDropout
        rate = float(cfg.get("rate", cfg.get("p", 0.5)))
        return (DropoutLayer(name=name, dropout=AlphaDropout(p=1.0 - rate)),
                _no_weights)

    if class_name == "Activation":
        return ActivationLayer(name=name, activation=act or "identity"), _no_weights

    if class_name == "LeakyReLU":
        alpha = float(cfg.get("alpha", cfg.get("negative_slope", 0.3)))
        return ActivationLayer(name=name, activation=("leakyrelu", {"alpha": alpha})), _no_weights

    if class_name == "ELU":
        return ActivationLayer(name=name, activation="elu"), _no_weights

    if class_name == "ThresholdedReLU":
        theta = float(cfg.get("theta", 1.0))
        return (ActivationLayer(name=name,
                                activation=("thresholdedrelu",
                                            {"theta": theta})),
                _no_weights)

    if class_name == "BatchNormalization":
        eps = float(cfg.get("epsilon", 1e-3))
        momentum = float(cfg.get("momentum", 0.99))
        return (BatchNormalizationLayer(name=name, eps=eps, decay=momentum,
                                        activation="identity"), _bn_weights)

    if class_name == "Embedding":
        emb_cs = None
        if cfg.get("embeddings_constraint") is not None:
            import dataclasses as _dc
            c = _one_constraint(cfg["embeddings_constraint"], "weights")
            emb_cs = [_dc.replace(c, param_names=("W",))]
        return (EmbeddingSequenceLayer(name=name,
                                       n_in=int(cfg.get("input_dim")),
                                       n_out=int(cfg.get("output_dim")),
                                       activation="identity", has_bias=False,
                                       constraints=emb_cs),
                _embedding_weights)

    if class_name == "LSTM":
        units = int(cfg.get("units", cfg.get("output_dim")))
        layer = LSTMLayer(
            name=name, n_out=units,
            activation=map_activation(cfg.get("activation", "tanh")),
            gate_activation=map_activation(
                cfg.get("recurrent_activation", cfg.get("inner_activation", "sigmoid"))),
            forget_gate_bias_init=1.0 if cfg.get("unit_forget_bias", True) else 0.0,
            constraints=recurrent_constraints_from_keras_cfg(cfg))
        wf = _lstm_weights_fn(units)
        if not cfg.get("return_sequences", False):
            # LastTimeStepWrapper stores the inner layer's params unprefixed,
            # so the same weight fn applies
            return LastTimeStepWrapper(name=name, layer=layer), wf
        return layer, wf

    if class_name == "GRU":
        from deeplearning4j_tpu_torch.nn.layers import GRULayer

        units = int(cfg.get("units", cfg.get("output_dim")))
        # Keras versions that omit the key (Keras 1 / 2.0-2.1) implement the
        # classic reset-before GRU; reset_after=True appears with Keras 2.2+
        # configs that always serialize the key
        reset_after = bool(cfg.get("reset_after", False))
        layer = GRULayer(
            name=name, n_out=units, reset_after=reset_after,
            activation=map_activation(cfg.get("activation", "tanh")),
            gate_activation=map_activation(
                cfg.get("recurrent_activation",
                        cfg.get("inner_activation", "sigmoid"))),
            constraints=recurrent_constraints_from_keras_cfg(cfg))

        def gru_weights(raw):
            # keras GRU: kernel [C, 3H] (z|r|h), recurrent_kernel [H, 3H],
            # bias [2, 3H] when reset_after else [3H]
            if "kernel" not in raw or "recurrent_kernel" not in raw:
                raise InvalidKerasConfigurationException(
                    f"cannot locate GRU weights among {sorted(raw)} "
                    "(per-gate Keras-1 GRU weight names are not supported)")
            out = {"W": raw["kernel"], "RW": raw["recurrent_kernel"]}
            if "bias" in raw:
                b = np.asarray(raw["bias"])
                if reset_after and b.ndim == 1:
                    b = b.reshape(2, -1)
                out["b"] = b
            # use_bias=False: the layer's zero-initialized bias stands
            return out, {}

        if not cfg.get("return_sequences", False):
            return (LastTimeStepWrapper(name=name, layer=layer), gru_weights)
        return layer, gru_weights

    if class_name == "TimeDistributed":
        # Position-wise inner layers (Dense/Activation/Dropout) broadcast over
        # leading dims natively, so the wrapper is transparent for them.
        # Anything spatial (Conv2D, pooling, …) gets the real rank-5 path:
        # TimeDistributedWrapper folds time into batch around the inner layer.
        # TimeDistributed(Flatten) vanishes — the cnn_seq→rnn auto-preprocessor
        # of the following layer performs the per-step flatten.
        inner_cfg = cfg.get("layer", {})
        inner_cls = inner_cfg.get("class_name")
        inner, wf = map_keras_layer(inner_cls, dict(inner_cfg.get("config", {})))
        if inner is None:
            return None, _no_weights
        inner.name = name
        if inner_cls in ("Dense", "Activation", "Dropout"):
            return inner, wf
        from deeplearning4j_tpu_torch.nn.layers import TimeDistributedWrapper

        # the wrapper stores the inner layer's params unprefixed, so the
        # inner weight fn applies directly
        return TimeDistributedWrapper(name=name, layer=inner), wf

    if class_name == "Lambda":
        impl = _LAMBDA_REGISTRY.get(name)
        if impl is None:
            raise UnsupportedKerasConfigurationException(
                f"Lambda layer {name!r}: arbitrary serialized Python is not "
                "executed; register an implementation first with "
                "modelimport.keras.register_lambda_layer(name, impl)")
        if not isinstance(impl, Layer):
            from deeplearning4j_tpu_torch.nn.layers import SameDiffLambdaLayer

            impl = SameDiffLambdaLayer(name=name, fn=impl)
        impl.name = name
        return impl, _no_weights

    if class_name == "ConvLSTM2D":
        filters = int(cfg.get("filters", cfg.get("nb_filter")))
        if "kernel_size" in cfg:
            ks = _pair(cfg["kernel_size"])
        else:  # Keras 1 dialect
            ks = (int(cfg["nb_row"]), int(cfg["nb_col"]))
        strides = _pair(cfg.get("strides", cfg.get("subsample")), (1, 1))
        pad = cfg.get("padding", cfg.get("border_mode", "valid"))
        if cfg.get("data_format") == "channels_first":
            raise UnsupportedKerasConfigurationException(
                "ConvLSTM2D with channels_first data_format is not supported "
                "(convert the model to channels_last)")
        from deeplearning4j_tpu_torch.nn.layers import ConvLSTM2DLayer

        layer = ConvLSTM2DLayer(
            name=name, n_out=filters, kernel_size=ks, stride=strides,
            dilation=_pair(cfg.get("dilation_rate"), (1, 1)),
            convolution_mode="same" if pad == "same" else "truncate",
            has_bias=cfg.get("use_bias", True),
            forget_gate_bias_init=1.0 if cfg.get("unit_forget_bias", True) else 0.0,
            activation=map_activation(cfg.get("activation", "tanh")),
            gate_activation=map_activation(
                cfg.get("recurrent_activation", "hard_sigmoid")))

        def convlstm_weights(raw):
            # kernel [kh,kw,C,4F], recurrent_kernel [kh,kw,F,4F], bias [4F];
            # Keras gate blocks i|f|c|o → the layer's i|f|o|g along the last axis
            if "kernel" not in raw or "recurrent_kernel" not in raw:
                raise InvalidKerasConfigurationException(
                    f"cannot locate ConvLSTM2D weights among {sorted(raw)}")
            p = {"W": _lstm_reorder(np.asarray(raw["kernel"]), filters),
                 "RW": _lstm_reorder(np.asarray(raw["recurrent_kernel"]), filters)}
            if "bias" in raw:
                p["b"] = _lstm_reorder(np.asarray(raw["bias"]), filters)
            return p, {}

        if not cfg.get("return_sequences", False):
            return LastTimeStepWrapper(name=name, layer=layer), convlstm_weights
        return layer, convlstm_weights

    if class_name == "SimpleRNN":
        units = int(cfg.get("units", cfg.get("output_dim")))
        layer = SimpleRnnLayer(name=name, n_out=units,
                               activation=map_activation(cfg.get("activation", "tanh")),
                               constraints=recurrent_constraints_from_keras_cfg(cfg))
        if not cfg.get("return_sequences", False):
            return LastTimeStepWrapper(name=name, layer=layer), _rnn_weights
        return layer, _rnn_weights

    if class_name == "Bidirectional":
        inner_cfg = cfg["layer"]
        inner, inner_fn = map_keras_layer(inner_cfg["class_name"],
                                          dict(inner_cfg["config"]))
        merge = cfg.get("merge_mode", "concat")
        if merge is None:
            raise UnsupportedKerasConfigurationException(
                "Bidirectional merge_mode=None (two output tensors) is not supported")
        merge = {"sum": "add", "ave": "average"}.get(merge, merge)
        if merge not in ("concat", "add", "mul", "average"):
            raise UnsupportedKerasConfigurationException(
                f"Unsupported Bidirectional merge_mode {merge!r}")
        if isinstance(inner, LastTimeStepWrapper):
            wrapped = BidirectionalWrapper(name=name, layer=inner.layer, mode=merge)
            return (LastTimeStepWrapper(name=name, layer=wrapped),
                    _bidirectional_weights(inner_fn))
        return (BidirectionalWrapper(name=name, layer=inner, mode=merge),
                _bidirectional_weights(inner_fn))

    if class_name == "ZeroPadding2D":
        pad = cfg.get("padding", (1, 1))
        if isinstance(pad, (list, tuple)) and pad and isinstance(pad[0], (list, tuple)):
            (t, b), (l, r) = pad
            return ZeroPaddingLayer(name=name, padding=(t, b, l, r)), _no_weights
        return ZeroPaddingLayer(name=name, padding=_pair(pad)), _no_weights

    if class_name == "ZeroPadding1D":
        pad = cfg.get("padding", 1)
        pad = _pair(pad, (1, 1)) if not isinstance(pad, int) else (pad, pad)
        return ZeroPadding1DLayer(name=name, padding=pad), _no_weights

    if class_name == "UpSampling2D":
        return (UpsamplingLayer(name=name, size=_pair(cfg.get("size"), (2, 2))),
                _no_weights)

    if class_name == "UpSampling1D":
        s = cfg.get("size", cfg.get("length", 2))
        s = int(s[0]) if isinstance(s, (list, tuple)) else int(s)
        return Upsampling1DLayer(name=name, size=s), _no_weights

    if class_name == "LayerNormalization":
        from deeplearning4j_tpu_torch.nn.layers import LayerNormalizationLayer

        axis = cfg.get("axis", -1)
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        if list(axes) != [-1]:
            raise UnsupportedKerasConfigurationException(
                f"LayerNormalization over axis {axis!r} is not supported "
                "(only the last/feature axis)")

        def ln_weights(raw):
            out = {}
            if "gamma" in raw:
                out["gamma"] = raw["gamma"]
            elif "beta" in raw:  # scale=False: identity gamma
                out["gamma"] = np.ones_like(np.asarray(raw["beta"]))
            if "beta" in raw:
                out["beta"] = raw["beta"]
            elif "gamma" in raw:  # center=False: zero beta
                out["beta"] = np.zeros_like(np.asarray(raw["gamma"]))
            return out, {}

        return (LayerNormalizationLayer(name=name,
                                        eps=float(cfg.get("epsilon", 1e-3))),
                ln_weights)

    if class_name == "MultiHeadAttention":
        from deeplearning4j_tpu_torch.nn.layers import SelfAttentionLayer

        heads = int(cfg.get("num_heads", 1))
        key_dim = int(cfg.get("key_dim", 0)) or None
        value_dim = cfg.get("value_dim")
        if value_dim is not None and int(value_dim) != (key_dim or 0):
            raise UnsupportedKerasConfigurationException(
                f"MultiHeadAttention with value_dim ({value_dim}) != key_dim "
                f"({key_dim}) is not supported")
        if cfg.get("output_shape") is not None:
            raise UnsupportedKerasConfigurationException(
                "MultiHeadAttention with an explicit output_shape is not "
                "supported (output dim must equal the model dim)")

        def mha_weights(raw):
            # keras MHA: query/key/value kernels [d_model, H, Dh] + biases
            # [H, Dh]; attention_output kernel [H, Dh, d_model] + bias
            # [d_model]. Pack into SelfAttentionLayer's HEAD-MAJOR fused
            # layout: Wqkv [d_model, H*3*Dh] with each head's q|k|v block
            # contiguous (attention.py param_shapes — the layout that lets
            # tensor-parallel column sharding propagate), Wo [H*Dh, d_model].
            wq = np.asarray(raw["query_kernel"])
            d_model = wq.shape[0]
            inner = wq.shape[1] * wq.shape[2]
            h, dh = wq.shape[1], wq.shape[2]
            kernels = [np.asarray(raw[f"{p}_kernel"])
                       for p in ("query", "key", "value")]     # [D,H,Dh] x3
            # use_bias=False stores no bias datasets: zero bias == no bias
            biases = [np.asarray(raw[f"{p}_bias"])
                      if f"{p}_bias" in raw else np.zeros((h, dh), np.float32)
                      for p in ("query", "key", "value")]      # [H,Dh] x3
            wqkv = np.stack(kernels, axis=2)                   # [D,H,3,Dh]
            bqkv = np.stack([b.reshape(h, dh) for b in biases],
                            axis=1)                            # [H,3,Dh]
            wo = np.asarray(raw["attention_output_kernel"]).reshape(inner, -1)
            bo = (np.asarray(raw["attention_output_bias"])
                  if "attention_output_bias" in raw
                  else np.zeros(wo.shape[1], np.float32))
            return ({"Wqkv": wqkv.reshape(d_model, 3 * inner),
                     "bqkv": bqkv.reshape(3 * inner),
                     "Wo": wo,
                     "bo": bo}, {})

        return (SelfAttentionLayer(name=name, n_heads=heads,
                                   head_size=key_dim, project_input=True,
                                   attn_dropout=float(cfg.get("dropout", 0.0))),
                mha_weights)

    raise UnsupportedKerasConfigurationException(
        f"Unsupported Keras layer type {class_name!r}")


def map_keras_mha_cross(cfg: dict) -> Tuple[Layer, WeightFn]:
    """True cross-attention ``MultiHeadAttention`` (distinct query/value
    inbound tensors) → CrossAttentionLayer. Called by the functional-model
    importer, which knows the inbound arity."""
    from deeplearning4j_tpu_torch.nn.layers import CrossAttentionLayer

    name = cfg.get("name")
    heads = int(cfg.get("num_heads", 1))
    key_dim = int(cfg.get("key_dim", 0)) or None
    value_dim = cfg.get("value_dim")
    if cfg.get("output_shape") is not None:
        raise UnsupportedKerasConfigurationException(
            "MultiHeadAttention with an explicit output_shape is not "
            "supported (output dim must equal the query dim)")

    def weights(raw):
        def proj(prefix):
            kk = np.asarray(raw[f"{prefix}_kernel"])
            d, h, dh = kk.shape
            w = kk.reshape(d, h * dh)
            b = (np.asarray(raw[f"{prefix}_bias"]).reshape(h * dh)
                 if f"{prefix}_bias" in raw else np.zeros(h * dh, np.float32))
            return w, b
        wq, bq = proj("query")
        wk, bk = proj("key")
        wv, bv = proj("value")
        wo_raw = np.asarray(raw["attention_output_kernel"])
        wo = wo_raw.reshape(-1, wo_raw.shape[-1])
        bo = (np.asarray(raw["attention_output_bias"])
              if "attention_output_bias" in raw
              else np.zeros(wo.shape[1], np.float32))
        return ({"Wq": wq, "bq": bq, "Wk": wk, "bk": bk, "Wv": wv, "bv": bv,
                 "Wo": wo, "bo": bo}, {})

    layer = CrossAttentionLayer(
        name=name, n_heads=heads, head_size=key_dim,
        value_size=None if value_dim is None else int(value_dim),
        attn_dropout=float(cfg.get("dropout", 0.0)))
    return layer, weights
