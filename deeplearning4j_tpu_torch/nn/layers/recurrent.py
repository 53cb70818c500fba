"""Recurrent layers: the protocol, LSTM, GravesLSTM, SimpleRnn, GRU,
ConvLSTM2D and the wrappers (Bidirectional, GravesBidirectionalLSTM,
LastTimeStep, MaskZeroLayer).

Counterpart of ``deeplearning4j_tpu/nn/layers/recurrent.py``. Layout
[batch, time, features] ([batch, time, H, W, C] for ConvLSTM2D's image
sequences, the ``cnn_seq`` input kind); the recurrence runs time-major
inside. Gate order is DL4J's IFOG (input, forget, output, cell gate);
GRU's is Keras's z|r|h. Parameters keep the reference's names and
layouts: LSTM ``W`` [n_in, 4H], ``RW`` [H, 4H] (Graves: 3 more columns,
the peephole vectors), ``b`` [4H] with the forget-gate bias; SimpleRnn
``W`` [n_in, H], ``RW`` [H, H], ``b`` [H]; GRU ``W`` [n_in, 3H], ``RW``
[H, 3H], ``b`` [2, 3H] with ``reset_after`` (input and recurrent biases)
or [3H]; ConvLSTM2D ``W`` [kh, kw, C, 4F], ``RW`` [kh, kw, F, 4F], ``b``
[4F]; Bidirectional prefixes its two copies' names with ``f_`` and
``b_``; LastTimeStep and MaskZeroLayer keep their inner layer's names.

A [N,T] mask freezes the carried state and zeroes the output at masked
steps. TBPTT and stateful inference use ``forward_seq(params, x, carry)``,
which returns the final carry (Bidirectional's is the pair of its
directions' carries).

Where the reference scans with ``lax.scan``, the plain path here is a
Python loop over the steps of ``_cell_pre``, after the input projection
(``x @ W + b``, or ConvLSTM2D's input convolution) is hoisted into one
op. The standard LSTM's sequence pass goes through the "lstm" helper seam
first: a registered helper that supports the layer takes it; with none
registered and auto-fused-LSTM on (``helpers.set_auto_fused_lstm``),
``FusedLSTMHelper`` does, at any T and H (the reference's TPU win region
is not carried over), when ``x`` and ``RW`` are float32 (K1) or bfloat16
(K1-bf16) and the carry is None or of that dtype: the hand-written kernel
on CUDA tensors, its plain version on CPU tensors. A mixed carry (an f32
TBPTT or ``rnn_time_step`` carry under a bf16 compute dtype) takes the
loop, which promotes to f32 as the reference does off the TPU (its TPU
kernel raises on one). GravesLSTM (peepholes), masked sequences,
MaskZeroLayer (it always passes a mask), SimpleRnn, GRU and ConvLSTM2D
take loops, as in the reference; Bidirectional and LastTimeStep over an
unmasked standard LSTM reach the seam through the inner layer's
``forward_seq`` (one launch a direction).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import activations as act_mod
from deeplearning4j_tpu_torch.nn import helpers as _helpers
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.cuda_kernels import (
    FusedLSTMHelper,
    kernel_dtypes_match,
)
from deeplearning4j_tpu_torch.nn.layers.base import Layer, matmul, register_layer
from deeplearning4j_tpu_torch.nn.layers.conv import _pair, conv2d_nhwc, conv_out_size

_AUTO_LSTM = FusedLSTMHelper()


def check_carry_capacity(named_layers, t_total: int, context: str) -> None:
    """Reject sequences longer than any finite carry before a host loop
    (TBPTT fit, stateful ``rnn_time_step``) runs into it."""
    for label, layer in named_layers:
        if isinstance(layer, BaseRecurrentLayer):
            cap = layer.carry_capacity()
            if cap is not None and t_total > cap:
                raise ValueError(
                    f"{context}: sequence length {t_total} exceeds {label} "
                    f"carry capacity {cap}; raise max_cache/max_len, "
                    f"shorten the sequence, or rnn_clear_previous_state()")


def map_carry(fn, carry):
    """``carry`` with ``fn`` applied to every tensor leaf (a carry is a
    tensor, a tuple of tensors and ints, or None; ints pass through)."""
    if isinstance(carry, torch.Tensor):
        return fn(carry)
    if isinstance(carry, (tuple, list)):
        return type(carry)(map_carry(fn, c) for c in carry)
    return carry


def own_carry(carry, device):
    """A copy of ``carry`` on ``device``: arrays and tensors become tensors
    there, and a 0-d integer (a position or offset, e.g. the reference's
    int32 scalar) becomes a Python int, so reading it never waits for the
    device."""
    if isinstance(carry, (tuple, list)):
        return type(carry)(own_carry(c, device) for c in carry)
    if isinstance(carry, (np.ndarray, np.generic)):
        carry = torch.from_numpy(np.array(carry))
    if isinstance(carry, torch.Tensor):
        if carry.ndim == 0 and not carry.is_floating_point():
            return int(carry)
        return carry.to(device, copy=True)
    return carry


def _time_major_mask(mask, x):
    """A [N,T] mask as [T,N] in ``x``'s dtype (None stays None)."""
    return None if mask is None else mask.to(x.dtype).transpose(0, 1)


class BaseRecurrentLayer(Layer):
    """Mixin API for layers that carry recurrent state."""

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        raise NotImplementedError

    def carry_capacity(self):
        """Max total timesteps the carry can absorb, or None if unbounded."""
        return None

    def forward_seq(self, params, x, carry=None, mask=None, train=False,
                    gen=None):
        """[N,T,C] → ([N,T,H], final_carry); ``train`` with ``gen`` draws
        the layer's train-time noise."""
        raise NotImplementedError

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        y, _ = self.forward_seq(params, x, carry=None, mask=mask, train=train,
                                gen=gen)
        return y

    def input_preprocessor(self, input_type: InputType):
        # image sequences flatten per step for flat-input recurrent layers
        # (ConvLSTM2D overrides this: it consumes [N,T,H,W,C] directly)
        if input_type.kind == "cnn_seq":
            return input_type.cnn_seq_to_rnn()
        return None

    def _scan_seq(self, params, xws, carry, ms):
        """Masked loop over time-major precomputed inputs ``xws`` [T,N,*];
        cells implement ``_cell_pre(params, xw_t, carry) -> (h,
        new_carry)``. Masked steps freeze every carry component and zero
        the output. Returns ``(final_carry, ys [T,N,H])``."""
        ys = []
        for t, xw_t in enumerate(xws):
            h, new_c = self._cell_pre(params, xw_t, carry)
            if ms is not None:
                m = ms[t].reshape(ms[t].shape + (1,) * (h.ndim - 1))
                new_c = tuple(m * n + (1 - m) * o for n, o in zip(new_c, carry))
                h = h * m
            carry = new_c
            ys.append(h)
        if not ys:
            return carry, xws.new_zeros((0,) + tuple(carry[0].shape))
        return carry, torch.stack(ys)


@register_layer
@dataclasses.dataclass
class LSTMLayer(BaseRecurrentLayer):
    """Standard LSTM (DL4J ``LSTM``: no peepholes)."""

    n_in: int = 0
    n_out: int = 0
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"

    def __post_init__(self):
        if self.activation is None:
            self.activation = "tanh"

    peephole = False

    def set_n_in(self, input_type: InputType) -> None:
        if not self.n_in:
            self.n_in = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def _rw_cols(self) -> int:
        # Graves peepholes live in 3 extra RW columns, DL4J's [nOut, 4*nOut+3]
        return 4 * self.n_out + (3 if self.peephole else 0)

    def param_shapes(self):
        h = self.n_out
        return {"W": (self.n_in, 4 * h), "RW": (h, self._rw_cols()),
                "b": (4 * h,)}

    def init_params(self, gen, dtype=torch.float32, device=None):
        h, rw_cols = self.n_out, self._rw_cols()
        w = self._init_w(gen, (self.n_in, 4 * h), self.n_in, 4 * h, dtype, device)
        rw = self._init_w(gen, (h, rw_cols), h, rw_cols, dtype, device)
        b = torch.zeros((4 * h,), dtype=dtype, device=device)
        b[h:2 * h] = self.forget_gate_bias_init  # the forget block in IFOG
        return {"W": w, "RW": rw, "b": b}

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        shape = (batch, self.n_out)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    def _cell_pre(self, params, xw_t, carry):
        """One step given the precomputed input projection ``x_t @ W + b``:
        only the recurrent product ``h @ RW`` stays in the loop."""
        h_prev, c_prev = carry
        hidden = self.n_out
        gate_act = act_mod.resolve(self.gate_activation)
        cell_act = self.act_fn()
        z = xw_t + matmul(h_prev, params["RW"][:, :4 * hidden])
        zi, zf, zo, zg = torch.split(z, hidden, dim=-1)
        if self.peephole:
            # per-unit (diagonal) peepholes: RW columns 4H, 4H+1, 4H+2
            pi, pf, po = (params["RW"][:, 4 * hidden + k] for k in range(3))
            zi = zi + c_prev * pi
            zf = zf + c_prev * pf
        i = gate_act(zi)
        f = gate_act(zf)
        g = cell_act(zg)
        c = f * c_prev + i * g
        if self.peephole:
            zo = zo + c * po
        o = gate_act(zo)
        h = o * cell_act(c)
        return h, (h, c)

    def forward_seq(self, params, x, carry=None, mask=None, train=False,
                    gen=None):
        helper = _helpers.get_helper("lstm")
        if helper is not None and helper.supports(self, mask):
            return helper.forward_seq(self, params, x, carry)
        # K1 takes float32 and K1-bf16 bfloat16, with the carry of x's
        # dtype or none: f16, f64 and a mixed carry take the plain loop
        if (helper is None and _helpers.auto_fused_lstm_enabled()
                and kernel_dtypes_match(x, params["RW"], carry)
                and _AUTO_LSTM.supports(self, mask)):
            return _AUTO_LSTM.forward_seq(self, params, x, carry)
        if carry is None:
            carry = self.init_carry(x.shape[0], x.dtype, x.device)
        xws = (matmul(x, params["W"]) + params["b"]).transpose(0, 1)  # [T,N,4H]
        final_carry, ys = self._scan_seq(params, xws, carry,
                                         _time_major_mask(mask, x))
        return ys.transpose(0, 1), final_carry


@register_layer
@dataclasses.dataclass
class GravesLSTMLayer(LSTMLayer):
    """LSTM with peephole connections (DL4J ``GravesLSTM``); the fused
    kernel declines it, so it always takes the plain loop."""

    peephole = True


@register_layer
@dataclasses.dataclass
class SimpleRnnLayer(BaseRecurrentLayer):
    """Vanilla RNN: h_t = act(x W + h_{t-1} RW + b) (DL4J SimpleRnn)."""

    n_in: int = 0
    n_out: int = 0

    def __post_init__(self):
        if self.activation is None:
            self.activation = "tanh"

    def set_n_in(self, input_type: InputType) -> None:
        if not self.n_in:
            self.n_in = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out), "RW": (self.n_out, self.n_out),
                "b": (self.n_out,)}

    def init_params(self, gen, dtype=torch.float32, device=None):
        h = self.n_out
        return {"W": self._init_w(gen, (self.n_in, h), self.n_in, h, dtype, device),
                "RW": self._init_w(gen, (h, h), h, h, dtype, device),
                "b": self._init_b((h,), dtype, device)}

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        return (torch.zeros((batch, self.n_out), dtype=dtype, device=device),)

    def _cell_pre(self, params, xw_t, carry):
        (h_prev,) = carry
        h = self.act_fn()(xw_t + matmul(h_prev, params["RW"]))
        return h, (h,)

    def forward_seq(self, params, x, carry=None, mask=None, train=False,
                    gen=None):
        if carry is None:
            carry = self.init_carry(x.shape[0], x.dtype, x.device)
        xws = (matmul(x, params["W"]) + params["b"]).transpose(0, 1)  # [T,N,H]
        final_carry, ys = self._scan_seq(params, xws, carry,
                                         _time_major_mask(mask, x))
        return ys.transpose(0, 1), final_carry


class _Wrapper:
    """What the wrappers share: the inner ``layer`` takes the shape
    inference, the global defaults and the input preprocessor."""

    def set_n_in(self, input_type: InputType) -> None:
        self.layer.set_n_in(input_type)

    def apply_global_defaults(self, g):
        Layer.apply_global_defaults(self, g)
        if self.layer is not None:
            self.layer.apply_global_defaults(g)

    def input_preprocessor(self, input_type: InputType):
        return self.layer.input_preprocessor(input_type)


@register_layer
@dataclasses.dataclass
class BidirectionalWrapper(_Wrapper, BaseRecurrentLayer):
    """Bidirectional RNN wrapper (DL4J ``Bidirectional``): runs the wrapped
    recurrent layer forward and on the time-reversed sequence (only the
    valid prefix of each example under a mask), then combines the two
    (``mode``: concat, add, mul, average). Parameters ``f_<name>`` and
    ``b_<name>``; the carry is ``(forward's, backward's)``."""

    layer: Optional[Layer] = None
    mode: str = "concat"  # "concat" | "add" | "mul" | "average"

    def output_type(self, input_type: InputType) -> InputType:
        inner = self.layer.output_type(input_type)
        if inner.kind == "cnn_seq":  # ConvLSTM2D: combine over channels
            c = inner.channels * 2 if self.mode == "concat" else inner.channels
            return InputType.recurrent_convolutional(inner.height, inner.width,
                                                     c, inner.timesteps)
        size = inner.size * 2 if self.mode == "concat" else inner.size
        return InputType.recurrent(size, inner.timesteps)

    def param_shapes(self):
        inner = self.layer.param_shapes()
        return ({f"f_{k}": v for k, v in inner.items()}
                | {f"b_{k}": v for k, v in inner.items()})

    def init_params(self, gen, dtype=torch.float32, device=None):
        fwd = self.layer.init_params(gen, dtype, device)
        bwd = self.layer.init_params(gen, dtype, device)
        return ({f"f_{k}": v for k, v in fwd.items()}
                | {f"b_{k}": v for k, v in bwd.items()})

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        return (self.layer.init_carry(batch, dtype, device),
                self.layer.init_carry(batch, dtype, device))

    @staticmethod
    def _reverse_masked(x, mask):
        """``x`` reversed in time; under a [N,T] mask only each example's
        first ``sum(mask)`` steps are reversed (DL4J's ReverseOp with a
        mask), the rest stay in place."""
        if mask is None:
            return torch.flip(x, [1])
        lengths = mask.to(torch.int64).sum(1)[:, None]  # [N,1]
        idx = torch.arange(x.shape[1], device=x.device)[None, :]
        rev = torch.where(idx < lengths, lengths - 1 - idx, idx)  # [N,T]
        rev = rev.reshape(rev.shape + (1,) * (x.ndim - 2)).expand(x.shape)
        return torch.gather(x, 1, rev)

    def forward_seq(self, params, x, carry=None, mask=None, train=False,
                    gen=None):
        fwd_p = {k[2:]: v for k, v in params.items() if k.startswith("f_")}
        bwd_p = {k[2:]: v for k, v in params.items() if k.startswith("b_")}
        c_f, c_b = carry if carry is not None else (None, None)
        y_f, cf = self.layer.forward_seq(fwd_p, x, carry=c_f, mask=mask,
                                         train=train, gen=gen)
        x_rev = self._reverse_masked(x, mask)
        y_b, cb = self.layer.forward_seq(bwd_p, x_rev, carry=c_b, mask=mask,
                                         train=train, gen=gen)
        y_b = self._reverse_masked(y_b, mask)
        m = self.mode.lower()
        if m == "concat":
            y = torch.cat([y_f, y_b], -1)
        elif m == "add":
            y = y_f + y_b
        elif m == "mul":
            y = y_f * y_b
        elif m == "average":
            y = 0.5 * (y_f + y_b)
        else:
            raise ValueError(self.mode)
        return y, (cf, cb)


@register_layer
@dataclasses.dataclass
class GravesBidirectionalLSTMLayer(BidirectionalWrapper):
    """DL4J GravesBidirectionalLSTM: a Bidirectional GravesLSTM whose two
    directions are summed (``mode`` "concat" becomes "add", as in the
    reference); ``n_in``/``n_out`` as on the layer it wraps."""

    n_in: int = 0
    n_out: int = 0
    forget_gate_bias_init: float = 1.0

    def __post_init__(self):
        if self.layer is None:
            self.layer = GravesLSTMLayer(n_in=self.n_in, n_out=self.n_out,
                                         forget_gate_bias_init=self.forget_gate_bias_init,
                                         activation=self.activation)
        if self.mode == "concat":
            self.mode = "add"  # DL4J GravesBidirectionalLSTM sums directions

    def set_n_in(self, input_type: InputType) -> None:
        if not self.n_in:
            self.n_in = input_type.size
        self.layer.n_in = self.n_in
        self.layer.n_out = self.n_out


@register_layer
@dataclasses.dataclass
class LastTimeStepWrapper(_Wrapper, Layer):
    """Wraps a recurrent layer and emits only its last step, under a mask
    each example's last unmasked one (DL4J ``LastTimeStep``). Not itself a
    recurrent layer: its output is [N, size] (an image for a wrapped
    ConvLSTM2D), so it cannot sit inside a TBPTT chain of carries. Its
    parameters are the inner layer's, unprefixed."""

    layer: Optional[Layer] = None

    def output_type(self, input_type: InputType) -> InputType:
        inner = self.layer.output_type(input_type)
        if inner.kind == "cnn_seq":  # e.g. a wrapped ConvLSTM2D -> one image
            return InputType.convolutional(inner.height, inner.width, inner.channels)
        return InputType.feed_forward(inner.size)

    def param_shapes(self):
        return self.layer.param_shapes()

    def init_params(self, gen, dtype=torch.float32, device=None):
        return self.layer.init_params(gen, dtype, device)

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        y, _ = self.layer.forward_seq(params, x, mask=mask, train=train, gen=gen)
        if mask is None:
            return y[:, -1]
        lengths = mask.to(torch.int64).sum(1).clamp_min(1)
        return y[torch.arange(y.shape[0], device=y.device), lengths - 1]


@register_layer
@dataclasses.dataclass
class MaskZeroLayer(_Wrapper, BaseRecurrentLayer):
    """Masks the steps whose features all equal ``mask_value`` (DL4J
    MaskZeroLayer): the derived [N,T] mask, times a given one, goes to the
    wrapped recurrent layer, whose parameters and carry it keeps."""

    layer: Optional[Layer] = None
    mask_value: float = 0.0

    def output_type(self, input_type: InputType) -> InputType:
        return self.layer.output_type(input_type)

    def param_shapes(self):
        return self.layer.param_shapes()

    def init_params(self, gen, dtype=torch.float32, device=None):
        return self.layer.init_params(gen, dtype, device)

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        return self.layer.init_carry(batch, dtype, device)

    def forward_seq(self, params, x, carry=None, mask=None, train=False,
                    gen=None):
        derived = (x != self.mask_value).any(-1).to(x.dtype)  # [N,T]
        if mask is not None:
            derived = derived * mask.to(x.dtype)
        return self.layer.forward_seq(params, x, carry=carry, mask=derived,
                                      train=train, gen=gen)


@register_layer
@dataclasses.dataclass
class GRULayer(BaseRecurrentLayer):
    """GRU with Keras semantics, gate order z|r|h in the fused matrices.
    ``reset_after`` (Keras 2's default) applies the reset gate after the
    recurrent product and keeps separate input and recurrent biases (``b``
    [2, 3H]); else the classic form with one bias [3H]."""

    n_in: int = 0
    n_out: int = 0
    reset_after: bool = True
    gate_activation: str = "sigmoid"

    def __post_init__(self):
        if self.activation is None:
            self.activation = "tanh"

    def set_n_in(self, input_type: InputType) -> None:
        if not self.n_in:
            self.n_in = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def _b_shape(self):
        return (2, 3 * self.n_out) if self.reset_after else (3 * self.n_out,)

    def param_shapes(self):
        h = self.n_out
        return {"W": (self.n_in, 3 * h), "RW": (h, 3 * h), "b": self._b_shape()}

    def init_params(self, gen, dtype=torch.float32, device=None):
        h = self.n_out
        return {"W": self._init_w(gen, (self.n_in, 3 * h), self.n_in, 3 * h, dtype, device),
                "RW": self._init_w(gen, (h, 3 * h), h, 3 * h, dtype, device),
                "b": torch.zeros(self._b_shape(), dtype=dtype, device=device)}

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        return (torch.zeros((batch, self.n_out), dtype=dtype, device=device),)

    def _cell_pre(self, params, xw_t, carry):
        (h_prev,) = carry
        hidden = self.n_out
        gate = act_mod.resolve(self.gate_activation)
        act = self.act_fn()
        xz, xr, xh = torch.split(xw_t, hidden, dim=-1)
        if self.reset_after:
            rec = matmul(h_prev, params["RW"]) + params["b"][1]
            rz, rr, rh = torch.split(rec, hidden, dim=-1)
            z = gate(xz + rz)
            r = gate(xr + rr)
            hh = act(xh + r * rh)
        else:
            rw = params["RW"]
            zr = matmul(h_prev, rw[:, :2 * hidden])  # the z|r products at once
            z = gate(xz + zr[:, :hidden])
            r = gate(xr + zr[:, hidden:])
            hh = act(xh + matmul(r * h_prev, rw[:, 2 * hidden:]))
        h = z * h_prev + (1.0 - z) * hh
        return h, (h,)

    def forward_seq(self, params, x, carry=None, mask=None, train=False,
                    gen=None):
        if carry is None:
            carry = self.init_carry(x.shape[0], x.dtype, x.device)
        b_in = params["b"][0] if self.reset_after else params["b"]
        xws = (matmul(x, params["W"]) + b_in).transpose(0, 1)  # [T,N,3H]
        final_carry, ys = self._scan_seq(params, xws, carry,
                                         _time_major_mask(mask, x))
        return ys.transpose(0, 1), final_carry


@register_layer
@dataclasses.dataclass
class ConvLSTM2DLayer(BaseRecurrentLayer):
    """Convolutional LSTM over image sequences [N, T, H, W, C] (Keras
    ``ConvLSTM2D``): the gates are convolutions. The input convolution of
    every step is hoisted into one [N*T, H, W, C] convolution (stride,
    padding, dilation and mode as configured); the recurrent convolution
    of h (stride 1, "same") stays in the loop. Gate order IFOG along the
    channels. ``W`` [kh, kw, C, 4F], ``RW`` [kh, kw, F, 4F], ``b`` [4F]."""

    n_in: int = 0   # input channels
    n_out: int = 0  # filters
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: str = "truncate"  # "truncate" (valid) | "same"
    has_bias: bool = True
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"

    def __post_init__(self):
        if self.activation is None:
            self.activation = "tanh"
        self.kernel_size = _pair(self.kernel_size)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)
        self.dilation = _pair(self.dilation)
        self._out_hw = None  # set by output_type while the configuration builds

    def set_n_in(self, input_type: InputType) -> None:
        if not self.n_in:
            self.n_in = input_type.channels

    def input_preprocessor(self, input_type: InputType):
        return None  # consumes [N,T,H,W,C] directly

    def output_type(self, input_type: InputType) -> InputType:
        kh, kw = self.kernel_size
        sh, sw = self.stride
        ph, pw = self.padding
        dh, dw = self.dilation
        h = conv_out_size(input_type.height, kh, sh, ph, dh, self.convolution_mode)
        w = conv_out_size(input_type.width, kw, sw, pw, dw, self.convolution_mode)
        self._out_hw = (h, w)
        return InputType.recurrent_convolutional(h, w, self.n_out, input_type.timesteps)

    def param_shapes(self):
        kh, kw = self.kernel_size
        shapes = {"W": (kh, kw, self.n_in, 4 * self.n_out),
                  "RW": (kh, kw, self.n_out, 4 * self.n_out)}
        if self.has_bias:
            shapes["b"] = (4 * self.n_out,)
        return shapes

    def init_params(self, gen, dtype=torch.float32, device=None):
        kh, kw = self.kernel_size
        f = self.n_out
        p = {"W": self._init_w(gen, (kh, kw, self.n_in, 4 * f), self.n_in * kh * kw,
                               4 * f * kh * kw, dtype, device),
             "RW": self._init_w(gen, (kh, kw, f, 4 * f), f * kh * kw,
                                4 * f * kh * kw, dtype, device)}
        if self.has_bias:
            b = torch.zeros((4 * f,), dtype=dtype, device=device)
            b[f:2 * f] = self.forget_gate_bias_init
            p["b"] = b
        return p

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        if self._out_hw is None:
            raise ValueError(
                "ConvLSTM2DLayer carry shape is unknown until output_type() "
                "has run (build the layer inside a network config)")
        h, w = self._out_hw
        z = torch.zeros((batch, h, w, self.n_out), dtype=dtype, device=device)
        return (z, z.clone())

    def _cell_pre(self, params, xw_t, carry):
        h_prev, c_prev = carry
        gate = act_mod.resolve(self.gate_activation)
        act = self.act_fn()
        z = xw_t + conv2d_nhwc(h_prev, params["RW"], (1, 1), (1, 1), (0, 0), "same")
        zi, zf, zo, zg = torch.split(z, self.n_out, dim=-1)
        i = gate(zi)
        f = gate(zf)
        g = act(zg)
        c = f * c_prev + i * g
        o = gate(zo)
        h = o * act(c)
        return h, (h, c)

    def forward_seq(self, params, x, carry=None, mask=None, train=False,
                    gen=None):
        n, t = x.shape[:2]
        xf = x.reshape((n * t,) + tuple(x.shape[2:]))
        z = conv2d_nhwc(xf, params["W"], self.stride, self.dilation, self.padding,
                        self.convolution_mode)
        if self.has_bias:
            z = z + params["b"]
        ho, wo = z.shape[1], z.shape[2]
        xws = z.reshape(n, t, ho, wo, 4 * self.n_out).transpose(0, 1)
        if carry is None:
            zero = torch.zeros((n, ho, wo, self.n_out), dtype=x.dtype, device=x.device)
            carry = (zero, zero)
        final_carry, ys = self._scan_seq(params, xws, carry,
                                         _time_major_mask(mask, x))
        return ys.transpose(0, 1), final_carry
