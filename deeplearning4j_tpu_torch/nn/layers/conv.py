"""2-D convolution over NHWC activations.

Counterpart of ``ConvolutionLayer`` in ``deeplearning4j_tpu/nn/layers/conv.py``
(with ``_pair`` and ``conv_out_size``). The API stays NHWC and ``W`` is
stored HWIO (``[kh, kw, in, out]``), as in the reference, its model zip
and ``util/convert.py``. ``forward`` views the input as NCHW in
channels-last memory (``x.permute(0, 3, 1, 2)``), convolves with
``W.permute(3, 2, 0, 1)`` (OIHW) and permutes the result back to NHWC, so
a Dense layer after it flattens in H, W, C order: the order of the
reference's Dense ``W`` rows.

``convolution_mode="same"`` pads the XLA way (:func:`same_pads`): the
total ``max((ceil(in/s) - 1)·s + eff_k - in, 0)`` split low ``total // 2``,
the rest on the bottom and right. ``F.conv2d(padding="same")`` refuses a
stride above 1, so the pad is an explicit ``F.pad``. ``"truncate"`` and
``"strict"`` pad ``padding`` on both sides and size the output by floor.

Input dropout runs on the NHWC input, before the NCHW view, so a
``SpatialDropout`` mask is ``[N, 1, 1, C]`` over the channels as in the
reference. ``ZeroPaddingLayer`` pads H and W with zeros. Not ported yet:
the other conv layers (1-D, separable, depthwise, deconvolution,
space-to-depth, upsampling, cropping).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, register_layer


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1] if len(v) > 1 else v[0]))
    return (int(v), int(v))


def conv_out_size(size: int, k: int, s: int, p: int, dilation: int,
                  mode: str) -> int:
    if mode == "same":
        return -(-size // s)  # ceil
    eff_k = k + (k - 1) * (dilation - 1)
    return (size + 2 * p - eff_k) // s + 1


def same_pads(size: int, k: int, s: int, dilation: int = 1) -> Tuple[int, int]:
    """(low, high) padding of one spatial axis in "same" mode, as XLA's
    ``SAME`` computes it (the larger half on the high side)."""
    eff_k = k + (k - 1) * (dilation - 1)
    total = max((-(-size // s) - 1) * s + eff_k - size, 0)
    return total // 2, total - total // 2


def nchw_pad(x, kernel, stride, dilation, padding, mode, value=0.0):
    """``x`` (NCHW) padded for a window op in ``mode``: the XLA "same" pads,
    else ``padding`` on both sides of each axis; through ``F.pad``."""
    if mode == "same":
        top, bottom = same_pads(x.shape[2], kernel[0], stride[0], dilation[0])
        left, right = same_pads(x.shape[3], kernel[1], stride[1], dilation[1])
    else:
        (top, left), (bottom, right) = padding, padding
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def conv2d_nhwc(x, w, stride, dilation, padding, mode):
    """NHWC ``x`` convolved with HWIO ``w``, NHWC out (no bias): an NCHW
    view of ``x``, ``w`` as OIHW; "same" pads the XLA way
    (:func:`same_pads`), else ``padding`` on both sides."""
    xc = x.permute(0, 3, 1, 2)
    pad = 0
    if mode == "same":
        xc = nchw_pad(xc, (w.shape[0], w.shape[1]), stride, dilation, padding, "same")
    else:
        pad = padding
    return F.conv2d(xc, w.permute(3, 2, 0, 1), None, stride, pad,
                    dilation).permute(0, 2, 3, 1)


@register_layer
@dataclasses.dataclass
class ConvolutionLayer(Layer):
    """2-D convolution (DL4J ConvolutionLayer), NHWC in and out."""

    n_in: int = 0   # input channels
    n_out: int = 0  # output channels
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: str = "truncate"  # "strict" | "truncate" | "same"
    has_bias: bool = True
    # The reference's space-to-depth rewrite of a stride-2 stem feeds the
    # TPU's systolic array a deeper contraction and computes the same
    # convolution. The field is kept (configurations carry it) and the
    # plain convolution runs: the rewrite is a TPU device trick.
    space_to_depth_stem: bool = False

    def __post_init__(self):
        self.kernel_size = _pair(self.kernel_size)
        self.stride = _pair(self.stride)
        self.padding = _pair(self.padding)
        self.dilation = _pair(self.dilation)

    def set_n_in(self, input_type: InputType) -> None:
        if not self.n_in:
            self.n_in = input_type.channels

    def output_type(self, input_type: InputType) -> InputType:
        kh, kw = self.kernel_size
        sh, sw = self.stride
        ph, pw = self.padding
        dh, dw = self.dilation
        mode = self.convolution_mode
        h = conv_out_size(input_type.height, kh, sh, ph, dh, mode)
        w = conv_out_size(input_type.width, kw, sw, pw, dw, mode)
        return InputType.convolutional(h, w, self.n_out)

    def param_shapes(self):
        kh, kw = self.kernel_size
        shapes = {"W": (kh, kw, self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def init_params(self, gen, dtype=torch.float32, device=None):
        kh, kw = self.kernel_size
        p = {"W": self._init_w(gen, (kh, kw, self.n_in, self.n_out),
                               self.n_in * kh * kw, self.n_out * kh * kw,
                               dtype, device)}
        if self.has_bias:
            p["b"] = self._init_b((self.n_out,), dtype, device)
        return p

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        x = self._dropout(x, train, gen)  # on NHWC, before the view
        y = conv2d_nhwc(x, params["W"], self.stride, self.dilation, self.padding,
                        self.convolution_mode)
        if self.has_bias:
            y = y + params["b"]
        return self.act_fn()(y)


@register_layer
@dataclasses.dataclass
class ZeroPaddingLayer(Layer):
    """Zero padding of NHWC images (DL4J ZeroPaddingLayer): ``padding`` is
    (top, bottom, left, right), or (h, w) for both sides."""

    padding: Tuple[int, ...] = (0, 0)

    def _pads(self):
        p = tuple(int(v) for v in self.padding)
        return (p[0], p[0], p[1], p[1]) if len(p) == 2 else p

    def output_type(self, input_type: InputType) -> InputType:
        t, b, l, r = self._pads()
        return InputType.convolutional(input_type.height + t + b,
                                       input_type.width + l + r,
                                       input_type.channels)

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        t, b, l, r = self._pads()
        return F.pad(x, (0, 0, l, r, t, b))
