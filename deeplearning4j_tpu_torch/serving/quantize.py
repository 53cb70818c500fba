"""Quantized inference — per-version dtype policies for the serving tier.

Counterpart of the JAX package's ``serving/quantize.py``. A registered
model version can be served under a ``dtype_policy`` without touching any
layer code:

- ``"float32"`` — the model as trained (no wrapper);
- ``"bf16"``    — weights stored bfloat16;
- ``"int8"``    — weight-only symmetric int8: every float weight matrix /
  kernel of at least ``min_size`` entries is stored as an ``int8`` tensor
  plus a float32 per-output-channel scale, and dequantized to float32
  INSIDE each forward. Between requests only the int8 tensors, their
  scales and the float parameters too small or too flat to quantize (1-d
  biases and norm scales, which the wrapper shares with the base model)
  live on the device: never a float32 copy of the quantized weights.

Quantization runs on the host in numpy, as the reference's does (round
half to even, scales ``max|w| / 127`` over every axis but the last), so the
int8 tensors and the scales equal the reference's byte for byte.

Which way each layer goes under ``"bf16"``. JAX promotes a mixed-dtype
product to the wider type; torch refuses one. The wrapper computes what the
reference computes:

- a network whose every input feeds an embedding lookup
  (``EmbeddingLayer`` / ``EmbeddingSequenceLayer``: token ids, as
  ``TransformerLM``) takes bfloat16 rows from the lookup, so in the
  reference every later layer — the positional embedding, LayerNorm, the
  attention projections and the attention itself, the feed-forward layers,
  the residual adds and the output layer's softmax — runs in bfloat16 on
  bfloat16 weights, and the answer is bfloat16. The wrapper runs the
  same forward on the bfloat16 weights; causal attention therefore goes
  through the attention seam to the bf16 flash-attention kernel (K3a-bf16)
  where the kernel admits the shape;
- any other network meets its bfloat16 weights with float32 activations,
  which the reference promotes to float32 (the weights converted exactly),
  so the wrapper runs the float32 forward on the weights cast up, and
  the answer is float32.

``"int8"`` dequantizes to float32 and runs the float32 forward, as the
reference does; its attention takes the f32 flash-attention kernel (K3a).

The wrapper holds a reference to the base model (its ``states``, conf and
forward are reused). It duck-types the one method the serving stack calls
— ``output(x)`` — and ``device``, so it drops into ``ParallelInference`` /
``ModelRegistry`` hot swap and rollback like any other model.
Calibration happens at registration: the registry runs a sample batch
through the float and the quantized forward and records the deviation on
the version (``ModelVersion.quant_error``), optionally failing the
registration past a tolerance.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.layers.core import (
    EmbeddingLayer,
    EmbeddingSequenceLayer,
)
from deeplearning4j_tpu_torch.nn.train_step import as_tensor, to_host

DTYPE_POLICIES = ("float32", "bf16", "int8")

# params small enough that quantizing them saves nothing but risks accuracy
_MIN_QUANT_SIZE = 64


class QTensor:
    """One int8-quantized weight: ``q`` (int8) × ``scale`` (f32) ≈ original,
    both tensors on the weight's device."""

    __slots__ = ("q", "scale")

    def __init__(self, q, scale):
        self.q = q
        self.scale = scale

    def dequantize(self, dtype=torch.float32):
        return self.q.to(dtype) * self.scale.to(dtype)

    @property
    def nbytes(self) -> int:
        return _nbytes(self.q) + _nbytes(self.scale)


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return int(np.asarray(t).nbytes)


def quantize_array(w, *, min_size: int = _MIN_QUANT_SIZE):
    """Symmetric int8 quantization of one tensor; returns a ``QTensor`` on
    the tensor's device, or the tensor unchanged when quantization is not
    worthwhile (non-float, tiny, or 0/1-d). Scales are per output channel
    (last axis) for >=2-d weights — the axis that is per-unit in every
    Dense [in, out] and conv HWIO kernel. Computed on the host in numpy,
    exactly as the reference's."""
    is_tensor = isinstance(w, torch.Tensor)
    if is_tensor:
        floating = w.is_floating_point()
        ndim, size = w.dim(), w.numel()
    else:
        wa = np.asarray(w)
        floating = np.issubdtype(wa.dtype, np.floating)
        ndim, size = wa.ndim, wa.size
    if not floating or ndim < 2 or size < min_size:
        return w
    wn = w.detach().cpu().float().numpy() if is_tensor else np.asarray(w)
    scale = np.max(np.abs(wn), axis=tuple(range(wn.ndim - 1)),
                   keepdims=True) / 127.0
    scale = np.where(scale == 0.0, 1.0, scale).astype(np.float32)
    q = np.clip(np.round(wn / scale), -127, 127).astype(np.int8)
    device = w.device if is_tensor else "cpu"
    return QTensor(torch.from_numpy(q).to(device),
                   torch.from_numpy(scale).to(device))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def quantize_pytree(params, *, min_size: int = _MIN_QUANT_SIZE):
    """Quantize every eligible tensor of a ``{key: {name: tensor}}`` tree."""
    return _tree_map(lambda w: quantize_array(w, min_size=min_size), params)


def dequantize_pytree(params, dtype=torch.float32):
    """Inverse of ``quantize_pytree``; each forward runs it."""
    return _tree_map(
        lambda t: t.dequantize(dtype) if isinstance(t, QTensor) else t, params)


def param_nbytes(params) -> int:
    """Total bytes across a params tree (QTensors count their int8+scale)."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, (QTensor, torch.Tensor, np.ndarray)):
            total += leaf.nbytes if isinstance(leaf, QTensor) else _nbytes(leaf)
    return total


def _input_layers(base, is_graph: bool):
    """The layers that read a network input directly."""
    conf = base.conf
    if not is_graph:
        return [base.layers[0]]
    return [vd.obj for vd in conf.vertices.values()
            if vd.is_layer and any(s in conf.inputs for s in vd.inputs)]


class QuantizedModel:
    """Serve-side wrapper holding a quantized copy of a model's params.

    Duck-types ``output`` for both ``MultiLayerNetwork`` (``output(x,
    mask=None)``) and single/multi-input ``ComputationGraph``
    (``output(*xs, masks=None)``), and ``device``. The base model object is
    untouched — training, checkpointing and the float version's own serving
    keep working; the wrapper shares its ``states``, conf and the float
    parameters it does not quantize.
    """

    def __init__(self, base, policy: str = "int8", *,
                 min_size: int = _MIN_QUANT_SIZE):
        if policy not in ("int8", "bf16"):
            raise ValueError(
                f"dtype_policy {policy!r} needs no wrapper"
                if policy == "float32" else
                f"unknown dtype_policy {policy!r} (one of {DTYPE_POLICIES})")
        if getattr(base, "params", None) is None:
            raise ValueError("model has no params to quantize "
                             "(not init()ed, or not a framework model)")
        self.base = base
        self.policy = policy
        self.conf = base.conf
        self.device = base.device
        self._is_graph = hasattr(base.conf, "inputs")
        if policy == "int8":
            self.qparams = quantize_pytree(base.params, min_size=min_size)
            self.compute_dtype = torch.float32
        else:  # bf16: a straight storage cast
            self.qparams = _tree_map(
                lambda w: (w.detach().to(torch.bfloat16)
                           if isinstance(w, torch.Tensor) and w.is_floating_point()
                           else w), base.params)
            ids_in = all(isinstance(layer, (EmbeddingLayer, EmbeddingSequenceLayer))
                         for layer in _input_layers(base, self._is_graph))
            self.compute_dtype = torch.bfloat16 if ids_in else torch.float32

    # ------------------------------------------------------------- plumbing
    @property
    def param_nbytes(self) -> int:
        return param_nbytes(self.qparams)

    def release_base_params(self) -> None:
        """Drop the base model's float params (the quantized copy is what
        serves). Only for a base the CALLER no longer needs — the registry
        does this for checkpoint loads it owns; after it, the base can no
        longer train, checkpoint, or run its own float forward."""
        try:
            self.base.params = None
        except AttributeError:  # duck-typed base without settable params
            pass

    def _params(self):
        """The forward's parameters: int8 weights dequantized to float32;
        bf16 weights as stored, or cast up where the reference promotes."""
        if self.policy == "int8":
            return dequantize_pytree(self.qparams)
        if self.compute_dtype == torch.bfloat16:
            return self.qparams
        return _tree_map(lambda w: (w.float() if isinstance(w, torch.Tensor)
                                    and w.dtype == torch.bfloat16 else w),
                         self.qparams)

    # ------------------------------------------------------------ data path
    def output(self, *xs, mask=None, masks=None):
        base = self.base
        dtype = base.dtype
        with torch.inference_mode():
            params = self._params()
            if self._is_graph:
                if len(xs) == 1 and isinstance(xs[0], (list, tuple)):
                    xs = tuple(xs[0])
                inputs = {n: as_tensor(x, dtype, base.device)
                          for n, x in zip(self.conf.inputs, xs)}
                mask_d = None
                if masks is not None:
                    mask_d = {n: (None if m is None
                                  else as_tensor(m, dtype, base.device, False))
                              for n, m in zip(self.conf.inputs, masks)}
                acts, _, _ = base._forward_all(params, inputs, mask_d)
                outs = [acts[n] for n in self.conf.outputs]
                return outs[0] if len(outs) == 1 else outs
            if len(xs) != 1:
                raise TypeError(f"output() takes one input, got {len(xs)}")
            x = as_tensor(xs[0], dtype, base.device)
            m = None if mask is None else as_tensor(mask, dtype, base.device, False)
            h, _, _ = base._forward_all(params, x, m)
            return h


def quantize_model(model, policy: str,
                   *, min_size: int = _MIN_QUANT_SIZE):
    """Apply a dtype policy; ``"float32"``/None return the model as-is."""
    if policy in (None, "float32"):
        return model
    return QuantizedModel(model, policy, min_size=min_size)


def calibrate(base, quantized, sample_batch) -> dict:
    """Run one sample batch through both forwards; return deviation stats
    (max absolute error and error relative to the float output range)."""
    ref = np.asarray(to_host(base.output(np.asarray(sample_batch))),
                     dtype=np.float32)
    got = np.asarray(to_host(quantized.output(np.asarray(sample_batch))),
                     dtype=np.float32)
    max_abs = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    span = float(np.max(np.abs(ref))) if ref.size else 0.0
    return {"max_abs_err": max_abs,
            "rel_err": max_abs / (span + 1e-12),
            "sample_rows": int(np.asarray(sample_batch).shape[0])}


def check_tolerance(stats: dict, tolerance: Optional[float]) -> None:
    if tolerance is not None and stats["rel_err"] > tolerance:
        raise ValueError(
            f"quantization error {stats['rel_err']:.4g} exceeds "
            f"tolerance {tolerance:.4g} — version rejected at registration")
