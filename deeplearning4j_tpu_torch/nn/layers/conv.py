"""The convolution family over NHWC activations.

Counterpart of ``deeplearning4j_tpu/nn/layers/conv.py``: the 2-D, 1-D,
transposed, depthwise and separable convolutions, zero padding (2-D and
1-D), cropping, space-to-depth, space-to-batch and nearest-neighbour
upsampling (2-D and 1-D). The API stays NHWC and ``W`` is
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
reference. ``ZeroPaddingLayer`` pads H and W with zeros.

``Convolution1DLayer`` runs on the rnn kind, ``[N, T, C]``, as a 2-D
convolution over ``[N, T, 1, C]`` with ``(k, 1)`` geometry.
``Deconvolution2DLayer`` is the reference's fractionally strided
convolution: the input dilated by the stride and correlated with the
flipped kernel over padding ``k-1-p`` on each side, or in "same" mode
``tot // 2`` low and ``tot - tot // 2`` high, ``tot = s + k - 2``. It runs
as ``F.conv_transpose2d`` with no padding (the full output, which is that
correlation over padding ``k-1``), then ``F.pad`` by the difference on
each side, a crop where it is negative: so the odd ``tot`` of "same"
mode, which ``conv_transpose2d``'s symmetric padding cannot express,
comes out as the reference's. The depthwise and separable convolutions
are ``groups = n_in``, whose output channel ``g·dm + m`` reads input
channel ``g``, the order of XLA's ``feature_group_count``.
``SpaceToDepthLayer`` puts block offset ``(bi, bj)`` and channel ``c`` at
channel ``(bi·b + bj)·C + c`` (``F.pixel_unshuffle`` orders them
``c·b² + bi·b + bj``, so it is not used); ``SpaceToBatchLayer`` puts
example ``n`` at offset ``(bi, bj)`` at batch ``(bi·bw + bj)·N + n``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.dtensor import batch_local
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


def conv2d_nhwc(x, w, stride, dilation, padding, mode, groups=1):
    """NHWC ``x`` convolved with HWIO ``w``, NHWC out (no bias): an NCHW
    view of ``x``, ``w`` as OIHW; "same" pads the XLA way
    (:func:`same_pads`), else ``padding`` on both sides. With ``groups``
    (a depthwise ``w`` of ``[kh, kw, 1, groups·dm]``) output channel
    ``g·dm + m`` reads input channel ``g``, as XLA's
    ``feature_group_count`` orders them."""
    def conv(x, w):
        xc = x.permute(0, 3, 1, 2)
        pad = 0
        if mode == "same":
            xc = nchw_pad(xc, (w.shape[0], w.shape[1]), stride, dilation, padding, "same")
        else:
            pad = padding
        return F.conv2d(xc, w.permute(3, 2, 0, 1), None, stride, pad,
                        dilation, groups).permute(0, 2, 3, 1)

    # on a DTensor batch: each rank's examples (nn/dtensor.py)
    return batch_local(conv, x, w)


def _first(v) -> int:
    """The first of a pair (or the value): a 1-D layer's geometry."""
    return int(v[0] if isinstance(v, (tuple, list)) else v)


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


@register_layer
@dataclasses.dataclass
class Convolution1DLayer(ConvolutionLayer):
    """1-D convolution over ``[N, T, C]`` (DL4J Convolution1DLayer on
    rnn-format data); the geometry is stored as ``(k, 1)`` pairs."""

    def __post_init__(self):
        self.kernel_size = (_first(self.kernel_size), 1)
        self.stride = (_first(self.stride), 1)
        self.padding = (_first(self.padding), 0)
        self.dilation = (_first(self.dilation), 1)

    def set_n_in(self, input_type: InputType) -> None:
        if not self.n_in:
            self.n_in = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps
        if t is not None:
            t = conv_out_size(t, self.kernel_size[0], self.stride[0],
                              self.padding[0], self.dilation[0],
                              self.convolution_mode)
        return InputType.recurrent(self.n_out, t)

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        return super().forward(params, x[:, :, None, :], train=train,
                               gen=gen)[:, :, 0, :]


@register_layer
@dataclasses.dataclass
class Deconvolution2DLayer(ConvolutionLayer):
    """Transposed 2-D convolution (DL4J Deconvolution2D); ``W`` is HWIO,
    ``[kh, kw, n_in, n_out]``. The output is ``s·(in-1) + k - 2p``, or
    ``in·s`` in "same" mode."""

    def output_type(self, input_type: InputType) -> InputType:
        kh, kw = self.kernel_size
        sh, sw = self.stride
        ph, pw = self.padding
        if self.convolution_mode == "same":
            h, w = input_type.height * sh, input_type.width * sw
        else:
            h = sh * (input_type.height - 1) + kh - 2 * ph
            w = sw * (input_type.width - 1) + kw - 2 * pw
        return InputType.convolutional(h, w, self.n_out)

    def _pads(self, size, k, s, p):
        """(low, high) padding of the dilated input on one axis, as the
        reference gives it to ``lax.conv_general_dilated``."""
        if self.convolution_mode == "same":
            tot = max(size * s + k - 1 - ((size - 1) * s + 1), 0)
            return tot // 2, tot - tot // 2
        return k - 1 - p, k - 1 - p

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        x = self._dropout(x, train, gen)
        kh, kw = self.kernel_size
        top, bottom = self._pads(x.shape[1], kh, self.stride[0], self.padding[0])
        left, right = self._pads(x.shape[2], kw, self.stride[1], self.padding[1])
        # [in, out, kh, kw]: conv_transpose2d's weight from HWIO
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                               params["W"].permute(2, 3, 0, 1), None, self.stride)
        # the full output is the correlation over k-1 on each side
        y = F.pad(y, (left - (kw - 1), right - (kw - 1),
                      top - (kh - 1), bottom - (kh - 1))).permute(0, 2, 3, 1)
        if self.has_bias:
            y = y + params["b"]
        return self.act_fn()(y)


@register_layer
@dataclasses.dataclass
class DepthwiseConvolution2DLayer(ConvolutionLayer):
    """Depthwise convolution (DL4J DepthwiseConvolution2D):
    ``depth_multiplier`` filters per input channel, ``groups = n_in``."""

    depth_multiplier: int = 1

    def output_type(self, input_type: InputType) -> InputType:
        base = super().output_type(input_type)
        return InputType.convolutional(base.height, base.width,
                                       self.n_in * self.depth_multiplier)

    def param_shapes(self):
        kh, kw = self.kernel_size
        c_out = self.n_in * self.depth_multiplier
        shapes = {"W": (kh, kw, 1, c_out)}
        if self.has_bias:
            shapes["b"] = (c_out,)
        return shapes

    def init_params(self, gen, dtype=torch.float32, device=None):
        kh, kw = self.kernel_size
        c_out = self.n_in * self.depth_multiplier
        p = {"W": self._init_w(gen, (kh, kw, 1, c_out), kh * kw,
                               self.depth_multiplier * kh * kw, dtype, device)}
        if self.has_bias:
            p["b"] = self._init_b((c_out,), dtype, device)
        return p

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        x = self._dropout(x, train, gen)
        y = conv2d_nhwc(x, params["W"], self.stride, self.dilation, self.padding,
                        self.convolution_mode, groups=self.n_in)
        if self.has_bias:
            y = y + params["b"]
        return self.act_fn()(y)


@register_layer
@dataclasses.dataclass
class SeparableConvolution2DLayer(ConvolutionLayer):
    """Depthwise then pointwise convolution (DL4J SeparableConvolution2D):
    ``W`` is the depthwise kernel ``[kh, kw, 1, n_in·dm]``, ``pW`` the
    pointwise one ``[1, 1, n_in·dm, n_out]``."""

    depth_multiplier: int = 1

    def param_shapes(self):
        kh, kw = self.kernel_size
        cm = self.n_in * self.depth_multiplier
        shapes = {"W": (kh, kw, 1, cm), "pW": (1, 1, cm, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def init_params(self, gen, dtype=torch.float32, device=None):
        kh, kw = self.kernel_size
        cm = self.n_in * self.depth_multiplier
        p = {"W": self._init_w(gen, (kh, kw, 1, cm), kh * kw,
                               self.depth_multiplier * kh * kw, dtype, device),
             "pW": self._init_w(gen, (1, 1, cm, self.n_out), cm, self.n_out,
                                dtype, device)}
        if self.has_bias:
            p["b"] = self._init_b((self.n_out,), dtype, device)
        return p

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        x = self._dropout(x, train, gen)
        y = conv2d_nhwc(x, params["W"], self.stride, self.dilation, self.padding,
                        self.convolution_mode, groups=self.n_in)
        y = conv2d_nhwc(y, params["pW"], (1, 1), (1, 1), (0, 0), "truncate")
        if self.has_bias:
            y = y + params["b"]
        return self.act_fn()(y)


@register_layer
@dataclasses.dataclass
class ZeroPadding1DLayer(Layer):
    """Zero padding of ``[N, T, C]`` over T (DL4J ZeroPadding1DLayer):
    ``padding`` is (left, right)."""

    padding: Tuple[int, int] = (0, 0)

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps
        if t is not None:
            t = t + self.padding[0] + self.padding[1]
        return InputType.recurrent(input_type.size, t)

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        left, right = (int(v) for v in self.padding)
        return F.pad(x, (0, 0, left, right))


@register_layer
@dataclasses.dataclass
class CropLayer(Layer):
    """Cropping of NHWC images (DL4J Cropping2D): ``crop`` is (top,
    bottom, left, right), or (h, w) for both sides."""

    crop: Tuple[int, ...] = (0, 0, 0, 0)

    def _crops(self):
        c = tuple(int(v) for v in self.crop)
        return (c[0], c[0], c[1], c[1]) if len(c) == 2 else c

    def output_type(self, input_type: InputType) -> InputType:
        t, b, l, r = self._crops()
        return InputType.convolutional(input_type.height - t - b,
                                       input_type.width - l - r,
                                       input_type.channels)

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        t, b, l, r = self._crops()
        h, w = x.shape[1], x.shape[2]
        return x[:, t:h - b or None, l:w - r or None, :]


@register_layer
@dataclasses.dataclass
class SpaceToDepthLayer(Layer):
    """NHWC space-to-depth (DL4J SpaceToDepthLayer): each ``b × b`` block
    becomes one pixel of ``b²·C`` channels, ``(bi·b + bj)·C + c``."""

    block_size: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        b = self.block_size
        return InputType.convolutional(input_type.height // b,
                                       input_type.width // b,
                                       input_type.channels * b * b)

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        n, h, w, c = x.shape
        b = self.block_size
        y = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(n, h // b, w // b, c * b * b)


@register_layer
@dataclasses.dataclass
class SpaceToBatchLayer(Layer):
    """NHWC space-to-batch (DL4J SpaceToBatchLayer): zero padding
    ``padding`` (top, bottom, left, right, or (h, w) for both sides), then
    each ``bh × bw`` block offset becomes a batch slice,
    ``(bi·bw + bj)·N + n``."""

    blocks: Tuple[int, int] = (2, 2)
    padding: Tuple[int, ...] = (0, 0, 0, 0)

    def _pads(self):
        p = tuple(int(v) for v in self.padding)
        return p if len(p) == 4 else (*p, *p)

    def output_type(self, input_type: InputType) -> InputType:
        bh, bw = self.blocks
        p = self._pads()
        return InputType.convolutional((input_type.height + p[0] + p[1]) // bh,
                                       (input_type.width + p[2] + p[3]) // bw,
                                       input_type.channels)

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        bh, bw = (int(v) for v in self.blocks)
        p = self._pads()
        x = F.pad(x, (0, 0, p[2], p[3], p[0], p[1]))
        n, h, w, c = x.shape
        y = x.reshape(n, h // bh, bh, w // bw, bw, c).permute(2, 4, 0, 1, 3, 5)
        return y.reshape(n * bh * bw, h // bh, w // bw, c)


@register_layer
@dataclasses.dataclass
class UpsamplingLayer(Layer):
    """2-D nearest-neighbour upsampling of NHWC images (DL4J
    Upsampling2D) by ``size`` (h, w)."""

    size: Tuple[int, int] = (2, 2)

    def __post_init__(self):
        self.size = _pair(self.size)

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(input_type.height * self.size[0],
                                       input_type.width * self.size[1],
                                       input_type.channels)

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        return x.repeat_interleave(self.size[0], dim=1).repeat_interleave(
            self.size[1], dim=2)


@register_layer
@dataclasses.dataclass
class Upsampling1DLayer(Layer):
    """1-D nearest-neighbour upsampling of ``[N, T, C]`` over T (DL4J
    Upsampling1D)."""

    size: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps
        return InputType.recurrent(input_type.size,
                                   None if t is None else t * self.size)

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        return x.repeat_interleave(self.size, dim=1)
