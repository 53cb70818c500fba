"""Pooling over NHWC images and ``[N, T, C]`` sequences.

Counterpart of ``SubsamplingLayer``, ``Subsampling1DLayer`` and
``GlobalPoolingLayer`` in ``deeplearning4j_tpu/nn/layers/pooling.py``
(max, avg, sum, pnorm). The
reference pools with ``lax.reduce_window``: ``max`` pads with -inf,
``avg`` and ``sum`` with 0, and ``avg`` divides by kh·kw, padding
included. Here every pad (the XLA "same" one, or ``padding`` on both
sides, which ``F.max_pool2d`` refuses above half the kernel) is an
explicit ``F.pad``, and the pool then runs with no padding: ``avg`` and
``sum`` are ``F.avg_pool2d`` with the divisor kh·kw and 1; ``pnorm`` is
(Σ|x|^p)^(1/p) over the window. ``Subsampling1DLayer`` pools a sequence
over T as a 2-D pool over ``[N, T, 1, C]`` with ``(k, 1)`` geometry.

``GlobalPoolingLayer`` pools NHWC images over H and W and ``[N, T, C]``
sequences over T (max, avg, sum, pnorm). A sequence's ``[N, T]`` mask
leaves the masked steps out as ``MaskedReductionUtil`` does: max over
the unmasked steps, sum and pnorm of the masked values, avg divided by
the count of unmasked steps (at least 1). An image's mask is ignored, as
in the reference, and so are ``pooling_dimensions`` and
``collapse_dimensions`` (carried for the configuration's serde).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.dtensor import batch_local
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer
from deeplearning4j_tpu_torch.nn.layers.conv import (_first, _pair, conv_out_size,
                                                    nchw_pad)


@register_layer
@dataclasses.dataclass
class SubsamplingLayer(Layer):
    """2-D pooling over NHWC (DL4J SubsamplingLayer)."""

    pooling_type: str = "max"  # "max" | "avg" | "sum" | "pnorm"
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"
    pnorm: int = 2

    def __post_init__(self):
        self.kernel_size = _pair(self.kernel_size)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)

    def output_type(self, input_type: InputType) -> InputType:
        kh, kw = self.kernel_size
        sh, sw = self.stride
        ph, pw = self.padding
        h = conv_out_size(input_type.height, kh, sh, ph, 1, self.convolution_mode)
        w = conv_out_size(input_type.width, kw, sw, pw, 1, self.convolution_mode)
        return InputType.convolutional(h, w, input_type.channels)

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        pt = self.pooling_type.lower()
        if pt not in ("max", "avg", "sum", "pnorm"):
            raise ValueError(f"Unknown pooling type {self.pooling_type!r}")
        k, s = self.kernel_size, self.stride

        def pool(x):
            xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC input
            if pt == "pnorm":
                xc = xc.abs() ** float(self.pnorm)
            xc = nchw_pad(xc, k, s, (1, 1), self.padding, self.convolution_mode,
                          value=float("-inf") if pt == "max" else 0.0)
            if pt == "max":
                y = F.max_pool2d(xc, k, s)
            else:
                y = F.avg_pool2d(xc, k, s, divisor_override=(
                    k[0] * k[1] if pt == "avg" else 1))
            if pt == "pnorm":
                y = y ** (1.0 / float(self.pnorm))
            return y.permute(0, 2, 3, 1)  # back to NHWC

        # on a DTensor batch: each rank's examples (nn/dtensor.py)
        return batch_local(pool, x)


@register_layer
@dataclasses.dataclass
class Subsampling1DLayer(SubsamplingLayer):
    """1-D pooling over ``[N, T, C]`` (DL4J Subsampling1DLayer); the
    geometry is stored as ``(k, 1)`` pairs."""

    def __post_init__(self):
        self.kernel_size = (_first(self.kernel_size), 1)
        self.stride = (_first(self.stride), 1)
        self.padding = (_first(self.padding), 0)

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps
        if t is not None:
            t = conv_out_size(t, self.kernel_size[0], self.stride[0],
                              self.padding[0], 1, self.convolution_mode)
        return InputType.recurrent(input_type.size, t)

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        return super().forward(params, x[:, :, None, :], train=train,
                               gen=gen)[:, :, 0, :]


@register_layer
@dataclasses.dataclass
class GlobalPoolingLayer(Layer):
    """Global pooling over time (rnn) or space (cnn) (DL4J
    GlobalPoolingLayer)."""

    pooling_type: str = "max"
    pooling_dimensions: Optional[Tuple[int, ...]] = None
    collapse_dimensions: bool = True
    pnorm: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "rnn":
            return InputType.feed_forward(input_type.size)
        if input_type.kind == "cnn":
            return InputType.feed_forward(input_type.channels)
        return input_type

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        pt = self.pooling_type.lower()
        if pt not in ("max", "avg", "sum", "pnorm"):
            raise ValueError(f"Unknown pooling type {self.pooling_type!r}")
        if x.ndim == 3:
            axes = (1,)
        elif x.ndim == 4:
            axes = (1, 2)
        else:
            raise ValueError(f"GlobalPooling expects 3-D or 4-D input, got "
                             f"{tuple(x.shape)}")
        p = float(self.pnorm)
        if mask is not None and x.ndim == 3:
            m = mask.to(x.dtype)[:, :, None]
            if pt == "max":
                return torch.where(m > 0, x, float("-inf")).amax(dim=1)
            if pt == "sum":
                return (x * m).sum(dim=1)
            if pt == "avg":
                return (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
            return ((x.abs() * m) ** p).sum(dim=1) ** (1.0 / p)
        if pt == "max":
            return x.amax(dim=axes)
        if pt == "sum":
            return x.sum(dim=axes)
        if pt == "avg":
            return x.mean(dim=axes)
        return (x.abs() ** p).sum(dim=axes) ** (1.0 / p)
