"""Core layers: Dense, Activation, Dropout, Mask, Embedding,
EmbeddingSequence, ElementWiseMultiplication, PReLU, PositionalEmbedding.

Counterpart of ``deeplearning4j_tpu/nn/layers/core.py``. Parameters keep
the reference's names and layouts: Dense ``W`` is ``[n_in, n_out]`` and is
used as ``x @ W + b``. Dense (and so the output layers) applies its input
dropout in a train forward; ``DropoutLayer`` is dropout alone.
``EmbeddingLayer`` reads its ids as ``jnp.take`` does, with no read of
them on the host: an id in ``[-n_in, 0)`` counts from the end, and one
outside ``[-n_in, n_in)`` gives a row of NaN.
``PositionalEmbeddingLayer`` carries its absolute offset (a Python int,
so reading it never waits for the device) through ``forward_seq`` for
stateful decoding and TBPTT.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.dtensor import full, reduce_partial, spread
from deeplearning4j_tpu_torch.nn.layers.base import Layer, matmul, register_layer
from deeplearning4j_tpu_torch.nn.layers.recurrent import BaseRecurrentLayer

_ID_CHECK = threading.local()


@contextlib.contextmanager
def unchecked_token_ids():
    """Inside (on this thread), :class:`EmbeddingSequenceLayer` skips its
    range check of the token ids, which reads them on the host and so
    waits for the device. For ids the caller has made in range, such as
    the tokens an on-device decode loop samples."""
    prev = getattr(_ID_CHECK, "off", False)
    _ID_CHECK.off = True
    try:
        yield
    finally:
        _ID_CHECK.off = prev


@register_layer
@dataclasses.dataclass
class DenseLayer(Layer):
    """Fully connected layer: y = act(x @ W + b); W is [n_in, n_out].
    Applies position-wise over a [N,T,C] sequence."""

    n_in: int = 0
    n_out: int = 0
    has_bias: bool = True

    def set_n_in(self, input_type: InputType) -> None:
        if not self.n_in:
            self.n_in = input_type.flat_size()

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def input_preprocessor(self, input_type: InputType):
        """DL4J's automatic CnnToFeedForward: NHWC images (flat ones, and
        NDHWC volumes) become ``[N, H*W*C]`` rows in H, W, C order, the
        order of ``W``'s rows in the reference."""
        if input_type.kind in ("cnn", "cnn_flat", "cnn3d"):
            return (lambda x: x.reshape(x.shape[0], -1),
                    InputType.feed_forward(input_type.flat_size()))
        if input_type.kind == "cnn_seq":  # per step; then position-wise
            return input_type.cnn_seq_to_rnn()
        return None

    def param_shapes(self):
        shapes = {"W": (self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def init_params(self, gen, dtype=torch.float32, device=None):
        p = {"W": self._init_w(gen, (self.n_in, self.n_out), self.n_in,
                               self.n_out, dtype, device)}
        if self.has_bias:
            p["b"] = self._init_b((self.n_out,), dtype, device)
        return p

    def _preact(self, params, x):
        y = matmul(x, params["W"])
        if self.has_bias:
            y = y + params["b"]
        return y

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        x = self._dropout(x, train, gen)
        return self.act_fn()(self._preact(params, x))


@register_layer
@dataclasses.dataclass
class ActivationLayer(Layer):
    """The activation alone (DL4J ActivationLayer)."""

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        return self.act_fn()(x)


@register_layer
@dataclasses.dataclass
class DropoutLayer(Layer):
    """Dropout alone; ``dropout`` is the KEEP probability, DL4J-style. Unset
    here and on the network, it is 0.5 (the network's default still flows
    in first, through ``apply_global_defaults``)."""

    def apply_global_defaults(self, g):
        super().apply_global_defaults(g)
        if self.dropout is None:
            self.dropout = 0.5

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        return self._dropout(x, train, gen)


@register_layer
@dataclasses.dataclass
class MaskLayer(Layer):
    """The current mask applied to the activations, else a pass-through
    (DL4J MaskLayer): a mask of the input's shape multiplies it; a
    ``[N,T]`` step mask multiplies a ``[N,T,F]`` sequence; a per-example
    ``[N]`` / ``[N,1]`` mask broadcasts over every other axis."""

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        if mask is None:
            return x
        m = mask.to(x.dtype)
        if m.shape == x.shape:
            return x * m
        if x.ndim == 3 and m.ndim == 2 and m.shape == x.shape[:2]:
            m = m[:, :, None]
        else:
            if m.shape[0] != x.shape[0] or m.numel() != x.shape[0]:
                raise ValueError(
                    f"MaskLayer: mask shape {tuple(m.shape)} does not broadcast "
                    f"over input shape {tuple(x.shape)} (want [N]/[N,1] "
                    "per-example, or [N,T] for 3d time series)")
            m = m.reshape((m.shape[0],) + (1,) * (x.ndim - 1))
        return x * m


@register_layer
@dataclasses.dataclass
class EmbeddingLayer(Layer):
    """Index → embedding row (DL4J EmbeddingLayer): ``[N]`` or ``[N,1]``
    ids (integers, or floats truncated) → ``[N, n_out]``. An id in
    ``[-n_in, 0)`` stands for ``id + n_in``; one outside ``[-n_in, n_in)``
    gives a row of NaN, as ``jnp.take`` fills it. Nothing reads the ids
    on the host."""

    n_in: int = 0
    n_out: int = 0
    has_bias: bool = False

    def set_n_in(self, input_type: InputType) -> None:
        if not self.n_in:
            self.n_in = input_type.flat_size()

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def param_shapes(self):
        shapes = {"W": (self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def init_params(self, gen, dtype=torch.float32, device=None):
        p = {"W": self._init_w(gen, (self.n_in, self.n_out), self.n_in,
                               self.n_out, dtype, device)}
        if self.has_bias:
            p["b"] = self._init_b((self.n_out,), dtype, device)
        return p

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        idx = x.to(torch.int64)
        if idx.ndim == 2 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        n = self.n_in
        valid = (idx >= -n) & (idx < n)
        idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
        w = params["W"]
        y = torch.where(valid[..., None], w[idx], w.new_full((), float("nan")))
        if self.has_bias:
            y = y + params["b"]
        return self.act_fn()(y)


@register_layer
@dataclasses.dataclass
class EmbeddingSequenceLayer(Layer):
    """Sequence of indices → sequence of embeddings: [N,T] (or [N,T,1])
    token ids → [N,T,n_out]. Ids may arrive as floats (a network's inputs
    are cast to its dtype) and are truncated to integers. An id in
    ``[-n_in, 0)`` stands for ``id + n_in`` (the reference's ``jnp.take``);
    ids outside ``[-n_in, n_in)`` are refused."""

    n_in: int = 0
    n_out: int = 0
    input_length: Optional[int] = None
    has_bias: bool = False

    def set_n_in(self, input_type: InputType) -> None:
        if not self.n_in:
            self.n_in = input_type.flat_size()

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out,
                                   self.input_length or input_type.timesteps)

    def param_shapes(self):
        shapes = {"W": (self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def init_params(self, gen, dtype=torch.float32, device=None):
        p = {"W": self._init_w(gen, (self.n_in, self.n_out), self.n_in,
                               self.n_out, dtype, device)}
        if self.has_bias:
            p["b"] = self._init_b((self.n_out,), dtype, device)
        return p

    def check_ids(self, x) -> None:
        """Refuse ids outside ``[-n_in, n_in)``: an out-of-range id would
        fault the device (a CUDA gather asserts and poisons the context).
        Reads the ids' range on the host, so it waits for the device."""
        idx = x.to(torch.int64)
        if idx.numel():
            lo, hi = (full(t) for t in torch.aminmax(idx))  # over every shard
            if int(lo) < -self.n_in or int(hi) >= self.n_in:
                raise ValueError(f"token ids must lie in [-{self.n_in}, "
                                 f"{self.n_in}); got [{int(lo)}, {int(hi)}]")

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        idx = x.to(torch.int64)
        if idx.ndim == 3 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        if not getattr(_ID_CHECK, "off", False):
            self.check_ids(idx)
        # ids in [-n_in, 0) count from the end, as jnp.take wraps them
        idx = torch.where(idx < 0, idx + self.n_in, idx)
        w = params["W"]
        if spread(w):
            # a vocab-row-sharded table: masked local lookups, one
            # all-reduce, never a gather of the table
            y = reduce_partial(F.embedding(idx, w))
        else:
            y = w[idx]  # [N,T,n_out]
        if self.has_bias:
            y = y + params["b"]
        return self.act_fn()(y)


@register_layer
@dataclasses.dataclass
class ElementWiseMultiplicationLayer(Layer):
    """``act(x * W + b)`` elementwise, ``W`` initialised to ones (DL4J
    ElementWiseMultiplicationLayer); n_in == n_out."""

    n_in: int = 0
    n_out: int = 0

    def set_n_in(self, input_type: InputType) -> None:
        if not self.n_in:
            self.n_in = input_type.flat_size()
        if not self.n_out:
            self.n_out = self.n_in

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out or self.n_in)

    def param_shapes(self):
        return {"W": (self.n_in,), "b": (self.n_in,)}

    def init_params(self, gen, dtype=torch.float32, device=None):
        return {"W": torch.ones((self.n_in,), dtype=dtype, device=device),
                "b": self._init_b((self.n_in,), dtype, device)}

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        return self.act_fn()(x * params["W"] + params["b"])


@register_layer
@dataclasses.dataclass
class PReLULayer(Layer):
    """Parametric ReLU, ``where(x >= 0, x, W * x)``, with a learned alpha
    ``W`` of the input's feature shape (initialised to zeros); each axis in
    ``shared_axes`` (counted with the batch axis as 0) shares one alpha
    (DL4J PReLULayer)."""

    input_shape: Optional[Tuple[int, ...]] = None  # the feature shape
    shared_axes: Optional[Tuple[int, ...]] = None

    def set_n_in(self, input_type: InputType) -> None:
        if self.input_shape is None:
            self.input_shape = tuple(input_type.batch_shape(1)[1:])

    def param_shapes(self):
        shape = list(self.input_shape or ())
        if self.shared_axes:
            for ax in self.shared_axes:
                shape[ax - 1] = 1
        return {"W": tuple(shape)}

    def init_params(self, gen, dtype=torch.float32, device=None):
        return {"W": torch.zeros(self.param_shapes()["W"], dtype=dtype,
                                 device=device)}

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        return torch.where(x >= 0, x, params["W"] * x)


@register_layer
@dataclasses.dataclass
class PositionalEmbeddingLayer(BaseRecurrentLayer):
    """Adds a learned position embedding to a sequence: [N,T,C] →
    x + P[:T] with P [max_len, C]. Its carry is the absolute offset of the
    next step: ``forward_seq`` adds ``P[offset:offset+T]``."""

    n_in: int = 0
    max_len: int = 512

    def set_n_in(self, input_type: InputType) -> None:
        if not self.n_in:
            self.n_in = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def param_shapes(self):
        return {"P": (self.max_len, self.n_in)}

    def init_params(self, gen, dtype=torch.float32, device=None):
        return {"P": 0.02 * torch.randn((self.max_len, self.n_in),
                                        generator=gen, dtype=dtype,
                                        device=device)}

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        t = x.shape[1]
        if t > self.max_len:
            raise ValueError(f"sequence length {t} exceeds max_len "
                             f"{self.max_len}")
        return x + params["P"][:t]

    def carry_capacity(self):
        return self.max_len

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        return 0  # the absolute position offset

    def forward_seq(self, params, x, carry=None, mask=None, train=False,
                    gen=None):
        if carry is None:
            return self.forward(params, x, mask=mask, train=train, gen=gen), None
        t, offset = x.shape[1], int(carry)
        if offset + t > self.max_len:
            raise ValueError(
                f"position overflow: step at offset {offset}+{t} exceeds "
                f"max_len={self.max_len}; raise max_len or "
                f"rnn_clear_previous_state() first")
        return x + params["P"][offset:offset + t], offset + t
