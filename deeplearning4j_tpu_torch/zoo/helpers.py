"""Block builders for the zoo's CNNs.

Counterpart of ``conv_bn_act``, ``darknet_block``,
``resnet_identity_block``, ``resnet_conv_block``, ``inception_module``
and ``inception_resnet_block_a`` / ``_b`` / ``_c`` in
``deeplearning4j_tpu/zoo/helpers.py`` (DL4J's ``DarknetHelper``,
``ResNet50.java`` ``identityBlock``/``convBlock``, ``GoogLeNet.java``'s
``inception``, ``InceptionResNetHelper``).
Each appends named vertices to a :class:`GraphBuilder` and returns the
name of the block's output vertex; the names are the reference's, so
parameters carry across by name. Every convolution of the ResNet blocks
feeds a BatchNorm and has no bias: the norm's mean subtraction cancels
one and its beta replaces it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphBuilder
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer,
    BatchNormalizationLayer,
    ConvolutionLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.vertices import ElementWiseVertex, MergeVertex, ScaleVertex


def conv_bn_act(g: GraphBuilder, name: str, inp: str, n_out: int,
                kernel: Tuple[int, int] = (3, 3), stride: Tuple[int, int] = (1, 1),
                mode: str = "same", activation: str = "relu",
                eps: float = 1e-5, decay: float = 0.9) -> str:
    """conv → batchnorm → activation."""
    g.add_layer(name + "_conv",
                ConvolutionLayer(n_out=n_out, kernel_size=kernel, stride=stride,
                                 convolution_mode=mode, activation="identity",
                                 has_bias=False),
                inp)
    g.add_layer(name + "_bn", BatchNormalizationLayer(eps=eps, decay=decay,
                                                      activation="identity"),
                name + "_conv")
    g.add_layer(name + "_act", ActivationLayer(activation=activation), name + "_bn")
    return name + "_act"


def darknet_block(g: GraphBuilder, num: int, inp: str, n_out: int,
                  filter_size: int = 3, pool: int = 0, pool_stride: int = 0) -> str:
    """Darknet's unit (DL4J ``DarknetHelper.addLayers``): a "same"
    convolution without bias, BatchNorm, leakyrelu, and a max pool when
    ``pool`` is set ("same" at stride 1). The activation is the
    reference's ``"leakyrelu"``, whose alpha is 0.01 (DL4J's
    ``DarknetHelper`` uses 0.1): the port keeps the reference's."""
    name = f"convolution2d_{num}"
    g.add_layer(name,
                ConvolutionLayer(n_out=n_out, kernel_size=(filter_size, filter_size),
                                 stride=(1, 1), convolution_mode="same",
                                 activation="identity", has_bias=False),
                inp)
    g.add_layer(f"batchnormalization_{num}",
                BatchNormalizationLayer(activation="identity"), name)
    g.add_layer(f"activation_{num}", ActivationLayer(activation="leakyrelu"),
                f"batchnormalization_{num}")
    out = f"activation_{num}"
    if pool:
        ps = pool_stride or pool
        g.add_layer(f"maxpooling2d_{num}",
                    SubsamplingLayer(pooling_type="max", kernel_size=(pool, pool),
                                     stride=(ps, ps),
                                     convolution_mode="same" if ps == 1 else "truncate"),
                    out)
        out = f"maxpooling2d_{num}"
    return out


def _bottleneck(g: GraphBuilder, kernel, filters, stage: str, block: str,
                inp: str, stride) -> Tuple[str, str]:
    """The 1x1 → kxk → 1x1 main branch of a bottleneck block; returns the
    name prefix of its convolutions and its last BatchNorm."""
    f1, f2, f3 = filters
    cn, bn, an = (f"res{stage}{block}_branch", f"bn{stage}{block}_branch",
                  f"act{stage}{block}_branch")
    g.add_layer(cn + "2a", ConvolutionLayer(n_out=f1, kernel_size=(1, 1),
                                            stride=stride, activation="identity",
                                            has_bias=False), inp)
    g.add_layer(bn + "2a", BatchNormalizationLayer(activation="identity"), cn + "2a")
    g.add_layer(an + "2a", ActivationLayer(activation="relu"), bn + "2a")
    g.add_layer(cn + "2b", ConvolutionLayer(n_out=f2, kernel_size=kernel,
                                            convolution_mode="same",
                                            activation="identity",
                                            has_bias=False), an + "2a")
    g.add_layer(bn + "2b", BatchNormalizationLayer(activation="identity"), cn + "2b")
    g.add_layer(an + "2b", ActivationLayer(activation="relu"), bn + "2b")
    g.add_layer(cn + "2c", ConvolutionLayer(n_out=f3, kernel_size=(1, 1),
                                            activation="identity",
                                            has_bias=False), an + "2b")
    g.add_layer(bn + "2c", BatchNormalizationLayer(activation="identity"), cn + "2c")
    return cn, bn + "2c"


def resnet_identity_block(g: GraphBuilder, kernel: Tuple[int, int],
                          filters: Sequence[int], stage: str, block: str,
                          inp: str) -> str:
    """Bottleneck residual block whose shortcut is the input itself."""
    cn, main = _bottleneck(g, kernel, filters, stage, block, inp, (1, 1))
    g.add_vertex(f"short{stage}{block}_branch", ElementWiseVertex(op="add"),
                 main, inp)
    g.add_layer(cn, ActivationLayer(activation="relu"), f"short{stage}{block}_branch")
    return cn


def resnet_conv_block(g: GraphBuilder, kernel: Tuple[int, int],
                      filters: Sequence[int], stage: str, block: str, inp: str,
                      stride: Tuple[int, int] = (2, 2)) -> str:
    """Bottleneck residual block with a strided 1x1 projection shortcut."""
    cn, main = _bottleneck(g, kernel, filters, stage, block, inp, stride)
    bn = f"bn{stage}{block}_branch"
    g.add_layer(cn + "1", ConvolutionLayer(n_out=filters[2], kernel_size=(1, 1),
                                           stride=stride, activation="identity",
                                           has_bias=False), inp)
    g.add_layer(bn + "1", BatchNormalizationLayer(activation="identity"), cn + "1")
    g.add_vertex(f"short{stage}{block}_branch", ElementWiseVertex(op="add"),
                 main, bn + "1")
    g.add_layer(cn, ActivationLayer(activation="relu"), f"short{stage}{block}_branch")
    return cn


def inception_module(g: GraphBuilder, name: str, inp: str,
                     b1: int, b3r: int, b3: int, b5r: int, b5: int, pp: int) -> str:
    """GoogLeNet's inception module (Szegedy 2014): four branches merged
    along the channels: 1x1; 1x1 → 3x3; 1x1 → 5x5; 3x3 max pool → 1x1."""
    g.add_layer(f"{name}-1x1", ConvolutionLayer(n_out=b1, kernel_size=(1, 1),
                                                activation="relu"), inp)
    g.add_layer(f"{name}-3x3reduce", ConvolutionLayer(n_out=b3r, kernel_size=(1, 1),
                                                      activation="relu"), inp)
    g.add_layer(f"{name}-3x3", ConvolutionLayer(n_out=b3, kernel_size=(3, 3),
                                                convolution_mode="same",
                                                activation="relu"), f"{name}-3x3reduce")
    g.add_layer(f"{name}-5x5reduce", ConvolutionLayer(n_out=b5r, kernel_size=(1, 1),
                                                      activation="relu"), inp)
    g.add_layer(f"{name}-5x5", ConvolutionLayer(n_out=b5, kernel_size=(5, 5),
                                                convolution_mode="same",
                                                activation="relu"), f"{name}-5x5reduce")
    g.add_layer(f"{name}-maxpool", SubsamplingLayer(pooling_type="max",
                                                    kernel_size=(3, 3), stride=(1, 1),
                                                    convolution_mode="same"), inp)
    g.add_layer(f"{name}-poolproj", ConvolutionLayer(n_out=pp, kernel_size=(1, 1),
                                                     activation="relu"), f"{name}-maxpool")
    g.add_vertex(name, MergeVertex(), f"{name}-1x1", f"{name}-3x3",
                 f"{name}-5x5", f"{name}-poolproj")
    return name


def _residual_tail(g: GraphBuilder, name: str, inp: str, branches, n_out: int,
                   scale: float) -> str:
    """The end of an Inception-ResNet block: the branches merged, a 1x1
    linear projection back to ``n_out`` channels, scaled by ``scale``,
    added to the block's input, relu."""
    g.add_vertex(f"{name}-merge", MergeVertex(), *branches)
    g.add_layer(f"{name}-proj", ConvolutionLayer(n_out=n_out, kernel_size=(1, 1),
                                                 activation="identity"),
                f"{name}-merge")
    g.add_vertex(f"{name}-scale", ScaleVertex(scale_factor=scale), f"{name}-proj")
    g.add_vertex(f"{name}-residual", ElementWiseVertex(op="add"), inp, f"{name}-scale")
    g.add_layer(name, ActivationLayer(activation="relu"), f"{name}-residual")
    return name


def inception_resnet_block_a(g: GraphBuilder, name: str, inp: str, scale: float) -> str:
    """Inception-ResNet-v1 block35 (``InceptionResNetHelper.inceptionV1ResA``):
    1x1; 1x1 -> 3x3; 1x1 -> 3x3 -> 3x3, 32 channels each, merged and
    projected to 256."""
    b1 = conv_bn_act(g, f"{name}-b1", inp, 32, (1, 1))
    b2a = conv_bn_act(g, f"{name}-b2a", inp, 32, (1, 1))
    b2 = conv_bn_act(g, f"{name}-b2b", b2a, 32, (3, 3))
    b3a = conv_bn_act(g, f"{name}-b3a", inp, 32, (1, 1))
    b3b = conv_bn_act(g, f"{name}-b3b", b3a, 32, (3, 3))
    b3 = conv_bn_act(g, f"{name}-b3c", b3b, 32, (3, 3))
    return _residual_tail(g, name, inp, (b1, b2, b3), 256, scale)


def inception_resnet_block_b(g: GraphBuilder, name: str, inp: str, scale: float) -> str:
    """Inception-ResNet-v1 block17: 1x1; 1x1 -> 1x7 -> 7x1, 128 channels
    each, merged and projected to 896."""
    b1 = conv_bn_act(g, f"{name}-b1", inp, 128, (1, 1))
    b2a = conv_bn_act(g, f"{name}-b2a", inp, 128, (1, 1))
    b2b = conv_bn_act(g, f"{name}-b2b", b2a, 128, (1, 7))
    b2 = conv_bn_act(g, f"{name}-b2c", b2b, 128, (7, 1))
    return _residual_tail(g, name, inp, (b1, b2), 896, scale)


def inception_resnet_block_c(g: GraphBuilder, name: str, inp: str, scale: float) -> str:
    """Inception-ResNet-v1 block8: 1x1; 1x1 -> 1x3 -> 3x1, 192 channels
    each, merged and projected to 1792."""
    b1 = conv_bn_act(g, f"{name}-b1", inp, 192, (1, 1))
    b2a = conv_bn_act(g, f"{name}-b2a", inp, 192, (1, 1))
    b2b = conv_bn_act(g, f"{name}-b2b", b2a, 192, (1, 3))
    b2 = conv_bn_act(g, f"{name}-b2c", b2b, 192, (3, 1))
    return _residual_tail(g, name, inp, (b1, b2), 1792, scale)
