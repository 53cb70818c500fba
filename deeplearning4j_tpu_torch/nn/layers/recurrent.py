"""Recurrent layers: the protocol, LSTM and GravesLSTM.

Counterpart of ``deeplearning4j_tpu/nn/layers/recurrent.py``. Layout
[batch, time, features]; the recurrence runs time-major inside. Gate order
is DL4J's IFOG (input, forget, output, cell gate). Parameters keep
``LSTMParamInitializer``'s names and layouts: ``W`` [n_in, 4H], ``RW``
[H, 4H] (Graves: 3 more columns, the peephole vectors), ``b`` [4H] with
the forget-gate bias.

A [N,T] mask freezes the carried state and zeroes the output at masked
steps. TBPTT and stateful inference use ``forward_seq(params, x, carry)``,
which returns the final carry.

Where the reference scans with ``lax.scan``, the plain path here is a
Python loop over the steps of ``_cell_pre``, after the input projection
``x @ W + b`` is hoisted into one product. The standard LSTM's sequence
pass goes through the "lstm" helper seam first: a registered helper that
supports the layer takes it; with none registered and auto-fused-LSTM on
(``helpers.set_auto_fused_lstm``), ``FusedLSTMHelper`` does, at any T and
H (the reference's TPU win region is not carried over): the hand-written
kernel on CUDA tensors, its plain version on CPU tensors. GravesLSTM
(peepholes) and masked sequences take the loop, as in the reference.
SimpleRnn, GRU, the wrappers and ConvLSTM2D are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import activations as act_mod
from deeplearning4j_tpu_torch.nn import helpers as _helpers
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.cuda_kernels import FusedLSTMHelper
from deeplearning4j_tpu_torch.nn.layers.base import Layer, matmul, register_layer

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
        # the kernel takes float32 only: any other dtype takes the plain
        # loop, as the reference's auto helper declines off the TPU
        if (helper is None and x.dtype == torch.float32
                and _helpers.auto_fused_lstm_enabled()
                and _AUTO_LSTM.supports(self, mask)):
            return _AUTO_LSTM.forward_seq(self, params, x, carry)
        if carry is None:
            carry = self.init_carry(x.shape[0], x.dtype, x.device)
        xws = (matmul(x, params["W"]) + params["b"]).transpose(0, 1)  # [T,N,4H]
        ms = None if mask is None else mask.to(x.dtype).transpose(0, 1)  # [T,N]
        final_carry, ys = self._scan_seq(params, xws, carry, ms)
        return ys.transpose(0, 1), final_carry


@register_layer
@dataclasses.dataclass
class GravesLSTMLayer(LSTMLayer):
    """LSTM with peephole connections (DL4J ``GravesLSTM``); the fused
    kernel declines it, so it always takes the plain loop."""

    peephole = True
