"""Model zoo: the CNNs, the character LSTM, the transformers, and text
generation.

Counterpart of ``LeNet``, ``SimpleCNN``, ``AlexNet``, ``VGG16``,
``VGG19``, ``Darknet19``, ``TinyYOLO``, ``YOLO2`` (with
``TINY_YOLO_ANCHORS`` and ``YOLO2_ANCHORS``), ``ResNet50``,
``GoogLeNet``, ``InceptionResNetV1``, ``FaceNetNN4Small2``,
``TextGenerationLSTM``, ``transformer_decoder_block``,
``TransformerLM``, ``transformer_encoder_block``, ``TransformerEncoder``,
``VisionTransformer``, ``lm_labels``, ``generate``, ``generate_on_device``
and ``beam_search`` in ``deeplearning4j_tpu/zoo/models.py``. The same
layers, layer and vertex names, parameter shapes and defaults;
every model is a ``ZooModel`` (``zoo/zoo_model.py``), registered with
``ModelSelector``, with the reference's ``meta_data`` and its registry of
pretrained artifacts (URLs, Adler32 checksums); ``init(device=None)``
builds the network on ``cuda`` (``device="cpu"`` for the CPU) and
``init_pretrained`` restores a cached or ``file://`` artifact. The
reference's zips themselves are not in the repository.

Generation runs the network's stateful path: every causal attention layer
carries a fixed-capacity KV cache, so each new token is one single-token
step. Token ids travel as float features ``[N,T,1]`` (exact up to 2**24),
as in the reference. ``generate`` is the reference's host loop over
``rnn_time_step`` (the probabilities read to numpy each token, numpy
sampling). ``generate_on_device`` and ``beam_search`` drive
``ComputationGraph._forward_all`` with carries directly and keep every
token on the device until one read at the end; where the reference
compiles the whole decode into one executable, the port launches each
step's kernels eagerly, with no host synchronisation between the prefill
and that read.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    BaseRecurrentLayer,
    ActivationLayer,
    BatchNormalizationLayer,
    CausalSelfAttentionLayer,
    CenterLossOutputLayer,
    ConvolutionLayer,
    DenseLayer,
    DropoutLayer,
    EmbeddingSequenceLayer,
    GlobalPoolingLayer,
    GravesLSTMLayer,
    LayerNormalizationLayer,
    LocalResponseNormalizationLayer,
    LossLayer,
    OutputLayer,
    PositionalEmbeddingLayer,
    RnnOutputLayer,
    SelfAttentionLayer,
    SpaceToDepthLayer,
    SubsamplingLayer,
    Yolo2OutputLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.core import unchecked_token_ids
from deeplearning4j_tpu_torch.nn.layers.recurrent import map_carry
from deeplearning4j_tpu_torch.nn.train_step import to_host
from deeplearning4j_tpu_torch.nn.updaters import AdaDelta, Adam, Nesterovs
from deeplearning4j_tpu_torch.nn.vertices import (
    ElementWiseVertex,
    L2NormalizeVertex,
    MergeVertex,
    ReshapeVertex,
)
from deeplearning4j_tpu_torch.nn.weights import Distribution
from deeplearning4j_tpu_torch.zoo.helpers import (
    conv_bn_act,
    darknet_block,
    inception_module,
    inception_resnet_block_a,
    inception_resnet_block_b,
    inception_resnet_block_c,
    resnet_conv_block,
    resnet_identity_block,
)
from deeplearning4j_tpu_torch.zoo.zoo_model import (
    ModelMetaData,
    PretrainedType,
    ZooModel,
    register_zoo_model,
)


@register_zoo_model
class LeNet(ZooModel):
    """LeNet-5-style CNN (``zoo/model/LeNet.java``): two 5x5 "same"
    convolutions of 20 and 50 channels, each followed by a 2x2 max pool,
    a dense 500 and a softmax output, trained with AdaDelta.
    ``input_shape`` is (channels, height, width), as in the reference."""

    # the reference's published artifact (LeNet.java:58-70): a DL4J
    # ModelSerializer zip, which init_pretrained restores
    PRETRAINED_URLS = {PretrainedType.MNIST:
                       "http://blob.deeplearning4j.org/models/lenet_dl4j_mnist_inference.zip"}
    PRETRAINED_CHECKSUMS = {PretrainedType.MNIST: 1906861161}

    def __init__(self, num_labels: int = 10, seed: int = 123,
                 input_shape=(1, 28, 28)):
        super().__init__(num_labels, seed)
        self.input_shape = tuple(input_shape)

    def meta_data(self):
        return ModelMetaData((self.input_shape,), 1, "cnn")

    def conf(self):
        c, h, w = self.input_shape
        return (NeuralNetConfiguration.builder().seed(self.seed)
                .activation("identity").weight_init("xavier")
                .updater(AdaDelta()).list()
                .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5), stride=(1, 1),
                                        convolution_mode="same", activation="identity"))
                .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5), stride=(1, 1),
                                        convolution_mode="same", activation="identity"))
                .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_out=self.num_labels, loss="mcxent",
                                   activation="softmax"))
                .set_input_type(InputType.convolutional(h, w, c)).build())


@register_zoo_model
class SimpleCNN(ZooModel):
    """A conv, BatchNorm and average-pool stack ending in a fully
    convolutional softmax head (``zoo/model/SimpleCNN.java``): two 7x7
    "same" convolutions of 16 channels, then two 5x5 of 32 and two 3x3 of
    64 and of 128, each pair with BatchNorms, a relu, a 2x2 average pool
    and dropout 0.5; then a 3x3 convolution of 256, BatchNorm, a 3x3
    convolution of ``num_labels``, global average pooling and a softmax
    ``LossLayer``. relu weights and activations, AdaDelta.
    ``input_shape`` is (channels, height, width)."""

    def __init__(self, num_labels: int = 10, seed: int = 123,
                 input_shape=(3, 48, 48)):
        super().__init__(num_labels, seed)
        self.input_shape = tuple(input_shape)

    def meta_data(self):
        return ModelMetaData((self.input_shape,), 1, "cnn")

    def conf(self):
        c, h, w = self.input_shape
        b = (NeuralNetConfiguration.builder().seed(self.seed)
             .activation("relu").weight_init("relu").updater(AdaDelta()).list())
        b.layer(ConvolutionLayer(n_out=16, kernel_size=(7, 7), convolution_mode="same"))
        b.layer(BatchNormalizationLayer())
        b.layer(ConvolutionLayer(n_out=16, kernel_size=(7, 7), convolution_mode="same"))
        b.layer(BatchNormalizationLayer())
        b.layer(ActivationLayer(activation="relu"))
        b.layer(SubsamplingLayer(pooling_type="avg", kernel_size=(2, 2), stride=(2, 2)))
        b.layer(DropoutLayer(dropout=0.5))
        for n in (32, 64, 128):
            k = 5 if n == 32 else 3
            b.layer(ConvolutionLayer(n_out=n, kernel_size=(k, k), convolution_mode="same"))
            b.layer(BatchNormalizationLayer())
            b.layer(ConvolutionLayer(n_out=n, kernel_size=(k, k), convolution_mode="same"))
            b.layer(BatchNormalizationLayer())
            b.layer(ActivationLayer(activation="relu"))
            b.layer(SubsamplingLayer(pooling_type="avg", kernel_size=(2, 2), stride=(2, 2)))
            b.layer(DropoutLayer(dropout=0.5))
        b.layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3), convolution_mode="same"))
        b.layer(BatchNormalizationLayer())
        b.layer(ConvolutionLayer(n_out=self.num_labels, kernel_size=(3, 3),
                                 convolution_mode="same", activation="identity"))
        b.layer(GlobalPoolingLayer(pooling_type="avg"))
        b.layer(LossLayer(loss="mcxent", activation="softmax"))
        return b.set_input_type(InputType.convolutional(h, w, c)).build()


@register_zoo_model
class AlexNet(ZooModel):
    """AlexNet, the one-tower variant (``zoo/model/AlexNet.java``): an
    11x11/4 convolution of 64 channels (padding 3), LRN and a 3x3/2 max
    pool; a 5x5 "same" convolution of 192, LRN and a max pool; three 3x3
    "same" convolutions of 384, 256, 256 and a max pool; two dense layers
    of 4096 with dropout 0.5 and a softmax output. Weights from N(0,
    0.005), relu, Nesterovs(1e-2, 0.9), l2 5e-4. ``input_shape`` is
    (channels, height, width)."""

    def __init__(self, num_labels: int = 1000, seed: int = 123,
                 input_shape=(3, 224, 224)):
        super().__init__(num_labels, seed)
        self.input_shape = tuple(input_shape)

    def meta_data(self):
        return ModelMetaData((self.input_shape,), 1, "cnn")

    def conf(self):
        c, h, w = self.input_shape
        return (NeuralNetConfiguration.builder().seed(self.seed)
                .activation("relu")
                .weight_init("distribution", Distribution("normal", 0.0, 0.005))
                .updater(Nesterovs(1e-2, 0.9)).l2(5e-4).list()
                .layer(ConvolutionLayer(n_out=64, kernel_size=(11, 11), stride=(4, 4),
                                        padding=(3, 3)))
                .layer(LocalResponseNormalizationLayer())
                .layer(SubsamplingLayer(pooling_type="max", kernel_size=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=192, kernel_size=(5, 5), convolution_mode="same"))
                .layer(LocalResponseNormalizationLayer())
                .layer(SubsamplingLayer(pooling_type="max", kernel_size=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3), convolution_mode="same"))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3), convolution_mode="same"))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3), convolution_mode="same"))
                .layer(SubsamplingLayer(pooling_type="max", kernel_size=(3, 3), stride=(2, 2)))
                .layer(DenseLayer(n_out=4096, dropout=0.5))
                .layer(DenseLayer(n_out=4096, dropout=0.5))
                .layer(OutputLayer(n_out=self.num_labels, loss="mcxent", activation="softmax"))
                .set_input_type(InputType.convolutional(h, w, c)).build())


def _vgg_conf(blocks, num_labels, seed, input_shape):
    """VGG: for each ``(convolutions, channels)`` block that many 3x3
    "same" convolutions and a 2x2/2 max pool, then two dense layers of
    4096 with dropout 0.5 and a softmax output; xavier, relu,
    Nesterovs(1e-2, 0.9)."""
    c, h, w = input_shape
    b = (NeuralNetConfiguration.builder().seed(seed)
         .activation("relu").weight_init("xavier").updater(Nesterovs(1e-2, 0.9)).list())
    for n_convs, n_out in blocks:
        for _ in range(n_convs):
            b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3), convolution_mode="same"))
        b.layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
    b.layer(DenseLayer(n_out=4096, dropout=0.5))
    b.layer(DenseLayer(n_out=4096, dropout=0.5))
    b.layer(OutputLayer(n_out=num_labels, loss="mcxent", activation="softmax"))
    return b.set_input_type(InputType.convolutional(h, w, c)).build()


@register_zoo_model
class VGG16(ZooModel):
    """VGG-16 (``zoo/model/VGG16.java``; Simonyan & Zisserman 2014):
    blocks of 2, 2, 3, 3, 3 convolutions of 64 to 512 channels."""

    PRETRAINED_URLS = {
        PretrainedType.IMAGENET: "http://blob.deeplearning4j.org/models/vgg16_dl4j_inference.zip",
        PretrainedType.CIFAR10: "http://blob.deeplearning4j.org/models/vgg16_dl4j_cifar10_inference.v1.zip",
        PretrainedType.VGGFACE: "http://blob.deeplearning4j.org/models/vgg16_dl4j_vggface_inference.v1.zip",
    }
    PRETRAINED_CHECKSUMS = {PretrainedType.IMAGENET: 3501732770,
                            PretrainedType.CIFAR10: 2192260131,
                            PretrainedType.VGGFACE: 2706403553}

    def __init__(self, num_labels: int = 1000, seed: int = 123,
                 input_shape=(3, 224, 224)):
        super().__init__(num_labels, seed)
        self.input_shape = tuple(input_shape)

    def meta_data(self):
        return ModelMetaData((self.input_shape,), 1, "cnn")

    def conf(self):
        return _vgg_conf([(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)],
                         self.num_labels, self.seed, self.input_shape)


@register_zoo_model
class VGG19(VGG16):
    """VGG-19 (``zoo/model/VGG19.java``): blocks of 2, 2, 4, 4, 4."""

    PRETRAINED_URLS = {PretrainedType.IMAGENET:
                       "http://blob.deeplearning4j.org/models/vgg19_dl4j_inference.zip"}
    PRETRAINED_CHECKSUMS = {PretrainedType.IMAGENET: 2782932419}

    def conf(self):
        return _vgg_conf([(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)],
                         self.num_labels, self.seed, self.input_shape)


@register_zoo_model
class Darknet19(ZooModel):
    """Darknet-19 (``zoo/model/Darknet19.java``, through DarknetHelper):
    18 :func:`darknet_block` units of 32 to 1024 channels, five with a 2x2
    max pool, then a 1x1 convolution of ``num_labels``, global average
    pooling and a softmax ``LossLayer`` (a ``ComputationGraph``); xavier,
    Nesterovs(1e-3, 0.9). ``input_shape`` is (channels, height, width).
    The published weights depend on the input side (224 or 448):
    :meth:`pretrained_url` and :meth:`pretrained_checksum` name the
    reference's artifacts, each in a cache slot of its own."""

    def __init__(self, num_labels: int = 1000, seed: int = 123,
                 input_shape=(3, 224, 224)):
        super().__init__(num_labels, seed)
        self.input_shape = tuple(input_shape)

    def _is_448(self) -> bool:
        return self.input_shape[1] == 448 and self.input_shape[2] == 448

    def _artifact_name(self, pretrained_type: str) -> str:
        # the 224 and 448 weights are different artifacts: two cache slots
        if self._is_448():
            return f"darknet19_448_{pretrained_type}.zip"
        return f"darknet19_{pretrained_type}.zip"

    def pretrained_url(self, pretrained_type: str):
        if pretrained_type != "imagenet":
            return None
        if self._is_448():
            return "http://blob.deeplearning4j.org/models/darknet19_448_dl4j_inference.v1.zip"
        return "http://blob.deeplearning4j.org/models/darknet19_dl4j_inference.v1.zip"

    def pretrained_checksum(self, pretrained_type: str) -> int:
        if pretrained_type != "imagenet":
            return 0
        return 870575230 if self._is_448() else 3952910425

    def meta_data(self):
        return ModelMetaData((self.input_shape,), 1, "cnn")

    def conf(self):
        c, h, w = self.input_shape
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .weight_init("xavier").updater(Nesterovs(1e-3, 0.9)).graph_builder()
             .add_inputs("input").set_input_types(InputType.convolutional(h, w, c)))
        x = "input"
        for num, (n_out, filter_size, pool) in enumerate(
                ((32, 3, 2), (64, 3, 2), (128, 3, 0), (64, 1, 0), (128, 3, 2),
                 (256, 3, 0), (128, 1, 0), (256, 3, 2), (512, 3, 0), (256, 1, 0),
                 (512, 3, 0), (256, 1, 0), (512, 3, 2), (1024, 3, 0), (512, 1, 0),
                 (1024, 3, 0), (512, 1, 0), (1024, 3, 0)), start=1):
            x = darknet_block(g, num, x, n_out, filter_size=filter_size, pool=pool)
        g.add_layer("convolution2d_19",
                    ConvolutionLayer(n_out=self.num_labels, kernel_size=(1, 1),
                                     convolution_mode="same", activation="identity"), x)
        g.add_layer("globalpooling", GlobalPoolingLayer(pooling_type="avg"),
                    "convolution2d_19")
        g.add_layer("loss", LossLayer(loss="mcxent", activation="softmax"),
                    "globalpooling")
        return g.set_outputs("loss").build()


# the reference's anchor priors (TinyYOLO.java, YOLO2.java), (w, h) in grid units
TINY_YOLO_ANCHORS = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38), (9.42, 5.11),
                     (16.62, 10.52))
YOLO2_ANCHORS = ((0.57273, 0.677385), (1.87446, 2.06253), (3.33843, 5.47434),
                 (7.88282, 3.52778), (9.77052, 9.16828))


@register_zoo_model
class TinyYOLO(ZooModel):
    """Tiny YOLOv2 (``zoo/model/TinyYOLO.java``): eight
    :func:`darknet_block` units of 16 to 1024 channels, the first five with
    a 2x2 max pool at stride 2, the sixth at stride 1 ("same": 13x13 stays
    13x13 at 416x416), a 1x1 convolution of 5·(5 + ``num_labels``) and a
    ``Yolo2OutputLayer`` over ``TINY_YOLO_ANCHORS`` (a
    ``ComputationGraph``); xavier, Adam(1e-3). ``input_shape`` is
    (channels, height, width)."""

    PRETRAINED_URL = "http://blob.deeplearning4j.org/models/tiny-yolo-voc_dl4j_inference.v1.zip"
    PRETRAINED_CHECKSUM = 2004171617
    PRETRAINED_URLS = {PretrainedType.IMAGENET: PRETRAINED_URL}
    PRETRAINED_CHECKSUMS = {PretrainedType.IMAGENET: PRETRAINED_CHECKSUM}

    def __init__(self, num_labels: int = 20, seed: int = 123,
                 input_shape=(3, 416, 416)):
        super().__init__(num_labels, seed)
        self.input_shape = tuple(input_shape)

    def meta_data(self):
        return ModelMetaData((self.input_shape,), 1, "cnn")

    def conf(self):
        c, h, w = self.input_shape
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .weight_init("xavier").updater(Adam(1e-3)).graph_builder()
             .add_inputs("input").set_input_types(InputType.convolutional(h, w, c)))
        x = "input"
        for num, n_out in enumerate((16, 32, 64, 128, 256), start=1):
            x = darknet_block(g, num, x, n_out, pool=2)
        x = darknet_block(g, 6, x, 512, pool=2, pool_stride=1)
        x = darknet_block(g, 7, x, 1024)
        x = darknet_block(g, 8, x, 1024)
        return _yolo_head(g, "convolution2d_9", x, TINY_YOLO_ANCHORS, self.num_labels)


def _yolo_head(g, conv_name: str, src: str, anchors, num_labels: int):
    """The 1x1 convolution of B·(5 + C) channels and the
    ``Yolo2OutputLayer`` ("outputs") of both YOLO models."""
    g.add_layer(conv_name,
                ConvolutionLayer(n_out=len(anchors) * (5 + num_labels),
                                 kernel_size=(1, 1), convolution_mode="same",
                                 activation="identity"), src)
    g.add_layer("outputs", Yolo2OutputLayer(boxes=anchors, n_classes=num_labels),
                conv_name)
    return g.set_outputs("outputs").build()


@register_zoo_model
class YOLO2(ZooModel):
    """YOLOv2 on a Darknet-19 backbone with the passthrough reorg
    (``zoo/model/YOLO2.java``): 20 :func:`darknet_block` units; the 1/16
    map of block 13 goes through ``SpaceToDepthLayer(2)`` and a
    ``MergeVertex`` onto the 1/32 map of block 20, then block 21, the 1x1
    convolution of 5·(5 + ``num_labels``) and a ``Yolo2OutputLayer`` over
    ``YOLO2_ANCHORS``; xavier, Adam(1e-3). At 608x608 the output is
    19x19."""

    PRETRAINED_URL = "http://blob.deeplearning4j.org/models/yolo2_dl4j_inference.v1.zip"
    PRETRAINED_CHECKSUM = 1357637732
    PRETRAINED_URLS = {PretrainedType.IMAGENET: PRETRAINED_URL}
    PRETRAINED_CHECKSUMS = {PretrainedType.IMAGENET: PRETRAINED_CHECKSUM}

    def __init__(self, num_labels: int = 80, seed: int = 123,
                 input_shape=(3, 608, 608)):
        super().__init__(num_labels, seed)
        self.input_shape = tuple(input_shape)

    def meta_data(self):
        return ModelMetaData((self.input_shape,), 1, "cnn")

    def conf(self):
        c, h, w = self.input_shape
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .weight_init("xavier").updater(Adam(1e-3)).graph_builder()
             .add_inputs("input").set_input_types(InputType.convolutional(h, w, c)))
        x = "input"
        for num, (n_out, filter_size, pool) in enumerate(
                ((32, 3, 2), (64, 3, 2), (128, 3, 0), (64, 1, 0), (128, 3, 2),
                 (256, 3, 0), (128, 1, 0), (256, 3, 2), (512, 3, 0), (256, 1, 0),
                 (512, 3, 0), (256, 1, 0), (512, 3, 0)), start=1):
            x = darknet_block(g, num, x, n_out, filter_size=filter_size, pool=pool)
        passthrough = x  # the 1/16 map
        g.add_layer("maxpooling2d_13",
                    SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)),
                    passthrough)
        x = "maxpooling2d_13"
        for num, (n_out, filter_size) in enumerate(
                ((1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3), (1024, 3),
                 (1024, 3)), start=14):
            x = darknet_block(g, num, x, n_out, filter_size=filter_size)
        # the passthrough: the 1/16 map reorganized to 1/32, joined to the deep map
        g.add_layer("reorg", SpaceToDepthLayer(block_size=2), passthrough)
        g.add_vertex("concat", MergeVertex(), "reorg", x)
        x = darknet_block(g, 21, "concat", 1024)
        return _yolo_head(g, "convolution2d_22", x, YOLO2_ANCHORS, self.num_labels)


@register_zoo_model
class ResNet50(ZooModel):
    """ResNet-50 (``zoo/model/ResNet50.java``): a 7x7/2 stem (zero padding
    3, convolution, BatchNorm, relu, 3x3/2 max pool), then [3, 4, 6, 3]
    bottleneck blocks of 256, 512, 1024 and 2048 channels, a 3x3 "same"
    average pool, global average pooling and a softmax output; Nesterovs
    (1e-2, 0.9), l1 1e-7, l2 5e-5. Stage 2's projection has stride 1, as
    in the reference (canonical ResNet-50; DL4J's passes 2). The stem
    convolution carries ``space_to_depth_stem`` and runs the plain
    convolution. ``input_shape`` is (channels, height, width)."""

    PRETRAINED_URLS = {PretrainedType.IMAGENET:
                       "http://blob.deeplearning4j.org/models/resnet50_dl4j_inference.zip"}
    PRETRAINED_CHECKSUMS = {PretrainedType.IMAGENET: 1982516793}

    def __init__(self, num_labels: int = 1000, seed: int = 123,
                 input_shape=(3, 224, 224)):
        super().__init__(num_labels, seed)
        self.input_shape = tuple(input_shape)

    def meta_data(self):
        return ModelMetaData((self.input_shape,), 1, "cnn")

    def conf(self):
        c, h, w = self.input_shape
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .activation("identity").weight_init("xavier")
             .updater(Nesterovs(1e-2, 0.9)).l1(1e-7).l2(5e-5).graph_builder()
             .add_inputs("input").set_input_types(InputType.convolutional(h, w, c)))
        g.add_layer("stem-zero", ZeroPaddingLayer(padding=(3, 3)), "input")
        g.add_layer("stem-cnn1",
                    ConvolutionLayer(n_out=64, kernel_size=(7, 7), stride=(2, 2),
                                     activation="identity", has_bias=False,
                                     space_to_depth_stem=True), "stem-zero")
        g.add_layer("stem-batch1", BatchNormalizationLayer(activation="identity"),
                    "stem-cnn1")
        g.add_layer("stem-act1", ActivationLayer(activation="relu"), "stem-batch1")
        g.add_layer("stem-maxpool1",
                    SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                                     stride=(2, 2)), "stem-act1")
        x = resnet_conv_block(g, (3, 3), (64, 64, 256), "2", "a", "stem-maxpool1",
                              stride=(1, 1))
        for blk in "bc":
            x = resnet_identity_block(g, (3, 3), (64, 64, 256), "2", blk, x)
        for stage, width, blocks in (("3", 128, "bcd"), ("4", 256, "bcdef"),
                                     ("5", 512, "bc")):
            filters = (width, width, 4 * width)
            x = resnet_conv_block(g, (3, 3), filters, stage, "a", x)
            for blk in blocks:
                x = resnet_identity_block(g, (3, 3), filters, stage, blk, x)
        g.add_layer("avgpool",
                    SubsamplingLayer(pooling_type="avg", kernel_size=(3, 3),
                                     stride=(1, 1), convolution_mode="same"), x)
        g.add_layer("globalpool", GlobalPoolingLayer(pooling_type="avg"), "avgpool")
        g.add_layer("fc1000", OutputLayer(n_out=self.num_labels, loss="mcxent",
                                          activation="softmax"), "globalpool")
        return g.set_outputs("fc1000").build()


@register_zoo_model
class GoogLeNet(ZooModel):
    """GoogLeNet / Inception-v1 (``zoo/model/GoogLeNet.java``): a 7x7/2
    stem with "same" max pools and LRN, nine inception modules (3a-3b,
    4a-4e, 5a-5b) with "same" 3x3/2 max pools between the stages, global
    average pooling, dropout 0.4 and a softmax output; xavier, relu,
    Nesterovs(1e-2, 0.9). ``input_shape`` is (channels, height, width)."""

    PRETRAINED_URLS = {PretrainedType.IMAGENET:
                       "http://blob.deeplearning4j.org/models/googlenet_dl4j_inference.zip"}
    PRETRAINED_CHECKSUMS = {PretrainedType.IMAGENET: 3337733202}

    def __init__(self, num_labels: int = 1000, seed: int = 123,
                 input_shape=(3, 224, 224)):
        super().__init__(num_labels, seed)
        self.input_shape = tuple(input_shape)

    def meta_data(self):
        return ModelMetaData((self.input_shape,), 1, "cnn")

    def conf(self):
        c, h, w = self.input_shape
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .activation("relu").weight_init("xavier")
             .updater(Nesterovs(1e-2, 0.9)).graph_builder()
             .add_inputs("input").set_input_types(InputType.convolutional(h, w, c)))

        def max_pool(name, src):
            g.add_layer(name, SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                                               stride=(2, 2), convolution_mode="same"),
                        src)

        g.add_layer("cnn1", ConvolutionLayer(n_out=64, kernel_size=(7, 7), stride=(2, 2),
                                             convolution_mode="same"), "input")
        max_pool("max1", "cnn1")
        g.add_layer("lrn1", LocalResponseNormalizationLayer(), "max1")
        g.add_layer("cnn2", ConvolutionLayer(n_out=64, kernel_size=(1, 1)), "lrn1")
        g.add_layer("cnn3", ConvolutionLayer(n_out=192, kernel_size=(3, 3),
                                             convolution_mode="same"), "cnn2")
        g.add_layer("lrn2", LocalResponseNormalizationLayer(), "cnn3")
        max_pool("max2", "lrn2")
        x = inception_module(g, "3a", "max2", 64, 96, 128, 16, 32, 32)
        x = inception_module(g, "3b", x, 128, 128, 192, 32, 96, 64)
        max_pool("max3", x)
        x = inception_module(g, "4a", "max3", 192, 96, 208, 16, 48, 64)
        x = inception_module(g, "4b", x, 160, 112, 224, 24, 64, 64)
        x = inception_module(g, "4c", x, 128, 128, 256, 24, 64, 64)
        x = inception_module(g, "4d", x, 112, 144, 288, 32, 64, 64)
        x = inception_module(g, "4e", x, 256, 160, 320, 32, 128, 128)
        max_pool("max4", x)
        x = inception_module(g, "5a", "max4", 256, 160, 320, 32, 128, 128)
        x = inception_module(g, "5b", x, 384, 192, 384, 48, 128, 128)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("dropout", DropoutLayer(dropout=0.4), "avgpool")
        g.add_layer("output", OutputLayer(n_out=self.num_labels, loss="mcxent",
                                          activation="softmax"), "dropout")
        return g.set_outputs("output").build()


def _max_pool_3x3_2(g, name, src):
    g.add_layer(name, SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                                       stride=(2, 2), convolution_mode="same"), src)


def _center_loss_head(g, src, embedding_size, num_labels):
    """A linear bottleneck to the embedding, L2-normalized, into a softmax
    center-loss output (alpha 0.9, lambda 1e-4)."""
    g.add_layer("bottleneck", DenseLayer(n_out=embedding_size, activation="identity"), src)
    g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
    g.add_layer("lossLayer",
                CenterLossOutputLayer(n_out=num_labels, loss="mcxent", activation="softmax",
                                      alpha=0.9, lambda_=1e-4),
                "embeddings")
    return g.set_outputs("lossLayer").build()


@register_zoo_model
class InceptionResNetV1(ZooModel):
    """Inception-ResNet-v1 with a center-loss embedding head
    (``zoo/model/InceptionResNetV1.java``): a stem of conv-BN-relu units
    and a "same" max pool, 5 x block35 (scale 0.17), reduction A (256 ->
    896 channels), 10 x block17 (0.10), reduction B (896 -> 1792), 5 x
    block8 (0.20), global average pooling, dropout 0.8, a 128-wide linear
    bottleneck, L2 normalization and a softmax center-loss output; relu
    weights, Adam(1e-3). ``input_shape`` is (channels, height, width)."""

    def __init__(self, num_labels: int = 1000, seed: int = 123,
                 input_shape=(3, 160, 160), embedding_size: int = 128):
        super().__init__(num_labels, seed)
        self.input_shape = tuple(input_shape)
        self.embedding_size = embedding_size

    def meta_data(self):
        return ModelMetaData((self.input_shape,), 1, "cnn")

    def _stem(self, g, inp):
        x = conv_bn_act(g, "stem-1", inp, 32, (3, 3), (2, 2))
        x = conv_bn_act(g, "stem-2", x, 32, (3, 3))
        x = conv_bn_act(g, "stem-3", x, 64, (3, 3))
        _max_pool_3x3_2(g, "stem-pool", x)
        x = conv_bn_act(g, "stem-4", "stem-pool", 80, (1, 1))
        x = conv_bn_act(g, "stem-5", x, 192, (3, 3))
        return conv_bn_act(g, "stem-6", x, 256, (3, 3), (2, 2))

    def conf(self):
        c, h, w = self.input_shape
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .activation("relu").weight_init("relu")
             .updater(Adam(1e-3)).graph_builder()
             .add_inputs("input").set_input_types(InputType.convolutional(h, w, c)))
        x = self._stem(g, "input")
        for i in range(5):
            x = inception_resnet_block_a(g, f"block35-{i}", x, 0.17)
        ra_b1 = conv_bn_act(g, "redA-b1", x, 384, (3, 3), (2, 2))
        ra_b2a = conv_bn_act(g, "redA-b2a", x, 192, (1, 1))
        ra_b2b = conv_bn_act(g, "redA-b2b", ra_b2a, 192, (3, 3))
        ra_b2 = conv_bn_act(g, "redA-b2c", ra_b2b, 256, (3, 3), (2, 2))
        _max_pool_3x3_2(g, "redA-pool", x)
        g.add_vertex("redA", MergeVertex(), ra_b1, ra_b2, "redA-pool")
        x = "redA"
        for i in range(10):
            x = inception_resnet_block_b(g, f"block17-{i}", x, 0.10)
        rb_b1a = conv_bn_act(g, "redB-b1a", x, 256, (1, 1))
        rb_b1 = conv_bn_act(g, "redB-b1b", rb_b1a, 384, (3, 3), (2, 2))
        rb_b2a = conv_bn_act(g, "redB-b2a", x, 256, (1, 1))
        rb_b2 = conv_bn_act(g, "redB-b2b", rb_b2a, 256, (3, 3), (2, 2))
        rb_b3a = conv_bn_act(g, "redB-b3a", x, 256, (1, 1))
        rb_b3b = conv_bn_act(g, "redB-b3b", rb_b3a, 256, (3, 3))
        rb_b3 = conv_bn_act(g, "redB-b3c", rb_b3b, 256, (3, 3), (2, 2))
        _max_pool_3x3_2(g, "redB-pool", x)
        g.add_vertex("redB", MergeVertex(), rb_b1, rb_b2, rb_b3, "redB-pool")
        x = "redB"
        for i in range(5):
            x = inception_resnet_block_c(g, f"block8-{i}", x, 0.20)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("dropout", DropoutLayer(dropout=0.8), "avgpool")
        return _center_loss_head(g, "dropout", self.embedding_size, self.num_labels)


@register_zoo_model
class FaceNetNN4Small2(ZooModel):
    """FaceNet's NN4.small2 (``zoo/model/FaceNetNN4Small2.java``): a 7x7/2
    conv-BN-relu stem with "same" 3x3/2 max pools, inception modules 3a,
    3b, 4a, 4e, 5a, 5b, global average pooling, a 128-wide linear
    bottleneck, L2 normalization and a softmax center-loss output; relu
    weights, Adam(0.1). ``input_shape`` is (channels, height, width)."""

    def __init__(self, num_labels: int = 1000, seed: int = 123,
                 input_shape=(3, 96, 96), embedding_size: int = 128):
        super().__init__(num_labels, seed)
        self.input_shape = tuple(input_shape)
        self.embedding_size = embedding_size

    def meta_data(self):
        return ModelMetaData((self.input_shape,), 1, "cnn")

    def conf(self):
        c, h, w = self.input_shape
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .activation("relu").weight_init("relu")
             .updater(Adam(0.1)).graph_builder()
             .add_inputs("input").set_input_types(InputType.convolutional(h, w, c)))
        x = conv_bn_act(g, "stem-cnn1", "input", 64, (7, 7), (2, 2))
        _max_pool_3x3_2(g, "stem-pool1", x)
        x = conv_bn_act(g, "inception-2", "stem-pool1", 64, (1, 1))
        x = conv_bn_act(g, "inception-3", x, 192, (3, 3))
        _max_pool_3x3_2(g, "stem-pool2", x)
        x = inception_module(g, "3a", "stem-pool2", 64, 96, 128, 16, 32, 32)
        x = inception_module(g, "3b", x, 64, 96, 128, 32, 64, 64)
        _max_pool_3x3_2(g, "pool3", x)
        x = inception_module(g, "4a", "pool3", 256, 96, 192, 32, 64, 128)
        x = inception_module(g, "4e", x, 160, 128, 256, 32, 64, 128)
        _max_pool_3x3_2(g, "pool4", x)
        x = inception_module(g, "5a", "pool4", 256, 96, 384, 24, 64, 96)
        x = inception_module(g, "5b", x, 256, 96, 384, 24, 64, 96)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        return _center_loss_head(g, "avgpool", self.embedding_size, self.num_labels)


@register_zoo_model
class TextGenerationLSTM(ZooModel):
    """The character-level text generator
    (``zoo/model/TextGenerationLSTM.java:81-86``): 2 x GravesLSTM(256, tanh)
    and a softmax ``RnnOutputLayer`` over ``num_labels`` characters;
    xavier, RmsProp, l2 1e-3, gradients clipped elementwise at 10."""

    def __init__(self, num_labels: int = 26, seed: int = 123, max_length: int = 40):
        super().__init__(num_labels, seed)
        self.max_length = max_length

    def meta_data(self):
        return ModelMetaData(((self.max_length, self.num_labels),), 1, "rnn")

    def conf(self):
        return (NeuralNetConfiguration.builder().seed(self.seed)
                .weight_init("xavier").updater("rmsprop")
                .l2(0.001)
                .gradient_normalization("clip_elementwise_absolute_value", 10.0).list()
                .layer(GravesLSTMLayer(n_in=self.num_labels, n_out=256, activation="tanh"))
                .layer(GravesLSTMLayer(n_out=256, activation="tanh"))
                .layer(RnnOutputLayer(n_out=self.num_labels, loss="mcxent",
                                      activation="softmax"))
                .set_input_type(InputType.recurrent(self.num_labels, self.max_length))
                .build())


def transformer_decoder_block(g, name: str, src: str, d_model: int,
                              n_heads: int, d_ff: int, max_len: int,
                              attn_dropout: float = 0.0) -> str:
    """One pre-LN causal decoder block (GPT-style): LN → causal
    self-attention → residual, LN → position-wise FFN → residual. Returns
    the output vertex name."""
    g.add_layer(f"{name}-ln1", LayerNormalizationLayer(), src)
    g.add_layer(f"{name}-att",
                CausalSelfAttentionLayer(n_heads=n_heads,
                                         head_size=d_model // n_heads,
                                         project_input=True,
                                         max_cache=max_len,
                                         attn_dropout=attn_dropout),
                f"{name}-ln1")
    g.add_vertex(f"{name}-res1", ElementWiseVertex(op="add"),
                 src, f"{name}-att")
    g.add_layer(f"{name}-ln2", LayerNormalizationLayer(), f"{name}-res1")
    g.add_layer(f"{name}-ff1", DenseLayer(n_in=d_model, n_out=d_ff,
                                          activation="gelu"), f"{name}-ln2")
    g.add_layer(f"{name}-ff2", DenseLayer(n_in=d_ff, n_out=d_model,
                                          activation="identity"),
                f"{name}-ff1")
    g.add_vertex(f"{name}-res2", ElementWiseVertex(op="add"),
                 f"{name}-res1", f"{name}-ff2")
    return f"{name}-res2"


@register_zoo_model
class TransformerLM(ZooModel):
    """GPT-style causal-decoder language model: token ids [N,T] →
    embedding + learned positions → n pre-LN causal decoder blocks → final
    LayerNorm → per-timestep softmax over the vocabulary. Defaults are
    GPT-2-small (vocab 50257, 1024 positions, 12L / 768 / 12H / 3072)."""

    def __init__(self, num_labels: int = 0, seed: int = 123,
                 vocab_size: int = 50257, max_length: int = 1024,
                 n_layers: int = 12, d_model: int = 768, n_heads: int = 12,
                 d_ff: int = 3072, attn_dropout: float = 0.0):
        # for an LM the label space IS the vocabulary (the reference's rule)
        self.vocab_size = num_labels or vocab_size
        super().__init__(self.vocab_size, seed)
        self.max_length = max_length
        self.n_layers = n_layers
        self.d_model = d_model
        self.n_heads = n_heads
        self.d_ff = d_ff
        self.attn_dropout = attn_dropout

    def meta_data(self):
        return ModelMetaData(((self.max_length,),), 1, "rnn")

    def conf(self):
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .weight_init("xavier")
             .updater(Adam(3e-4)).graph_builder()
             .add_inputs("tokens")
             .set_input_types(InputType.recurrent(1, self.max_length)))
        g.add_layer("embed",
                    EmbeddingSequenceLayer(n_in=self.vocab_size,
                                           n_out=self.d_model), "tokens")
        g.add_layer("pos", PositionalEmbeddingLayer(n_in=self.d_model,
                                                    max_len=self.max_length),
                    "embed")
        src = "pos"
        for i in range(self.n_layers):
            src = transformer_decoder_block(g, f"block{i}", src,
                                            self.d_model, self.n_heads,
                                            self.d_ff, self.max_length,
                                            self.attn_dropout)
        g.add_layer("ln_f", LayerNormalizationLayer(), src)
        g.add_layer("out", RnnOutputLayer(n_in=self.d_model,
                                          n_out=self.vocab_size,
                                          activation="softmax", loss="mcxent"),
                    "ln_f")
        g.set_outputs("out")
        return g.build()


def transformer_encoder_block(g, name: str, src: str, d_model: int,
                              n_heads: int, d_ff: int,
                              attn_dropout: float = 0.0) -> str:
    """One post-LN (BERT-style) encoder block: self-attention → residual
    → LayerNorm, position-wise FFN → residual → LayerNorm. Returns the
    output vertex name."""
    g.add_layer(f"{name}-att",
                SelfAttentionLayer(n_heads=n_heads,
                                   head_size=d_model // n_heads,
                                   project_input=True,
                                   attn_dropout=attn_dropout), src)
    g.add_vertex(f"{name}-res1", ElementWiseVertex(op="add"),
                 src, f"{name}-att")
    g.add_layer(f"{name}-ln1", LayerNormalizationLayer(), f"{name}-res1")
    g.add_layer(f"{name}-ff1", DenseLayer(n_in=d_model, n_out=d_ff,
                                          activation="gelu"), f"{name}-ln1")
    g.add_layer(f"{name}-ff2", DenseLayer(n_in=d_ff, n_out=d_model,
                                          activation="identity"),
                f"{name}-ff1")
    g.add_vertex(f"{name}-res2", ElementWiseVertex(op="add"),
                 f"{name}-ln1", f"{name}-ff2")
    g.add_layer(f"{name}-ln2", LayerNormalizationLayer(), f"{name}-res2")
    return f"{name}-ln2"


def _encoder_head(g, src, n_layers, d_model, n_heads, d_ff, num_labels):
    """``n_layers`` encoder blocks after ``src``, mean pooling and a
    softmax classifier named "out"."""
    for i in range(n_layers):
        src = transformer_encoder_block(g, f"block{i}", src, d_model, n_heads, d_ff)
    g.add_layer("pool", GlobalPoolingLayer(pooling_type="avg"), src)
    g.add_layer("out", OutputLayer(n_in=d_model, n_out=num_labels,
                                   activation="softmax", loss="mcxent"), "pool")
    g.set_outputs("out")
    return g.build()


@register_zoo_model
class TransformerEncoder(ZooModel):
    """BERT-base-shape encoder for sequence classification: token ids
    [N,T] → embedding + learned positions → ``n_layers`` post-LN encoder
    blocks (full attention) → mean pooling → softmax classifier; xavier,
    Adam(1e-4). The defaults are BERT-base: 12 layers, 768 wide, 12
    heads, d_ff 3072, vocabulary 30522, T 128."""

    def __init__(self, num_labels: int = 2, seed: int = 123,
                 vocab_size: int = 30522, max_length: int = 128,
                 n_layers: int = 12, d_model: int = 768, n_heads: int = 12,
                 d_ff: int = 3072):
        super().__init__(num_labels, seed)
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.n_layers = n_layers
        self.d_model = d_model
        self.n_heads = n_heads
        self.d_ff = d_ff

    def meta_data(self):
        return ModelMetaData(((self.max_length,),), 1, "rnn")

    def conf(self):
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .weight_init("xavier").updater(Adam(1e-4)).graph_builder()
             .add_inputs("tokens")
             .set_input_types(InputType.recurrent(1, self.max_length)))
        g.add_layer("embed",
                    EmbeddingSequenceLayer(n_in=self.vocab_size,
                                           n_out=self.d_model), "tokens")
        g.add_layer("pos", PositionalEmbeddingLayer(n_in=self.d_model,
                                                    max_len=self.max_length),
                    "embed")
        return _encoder_head(g, "pos", self.n_layers, self.d_model,
                             self.n_heads, self.d_ff, self.num_labels)


@register_zoo_model
class VisionTransformer(ZooModel):
    """ViT (Dosovitskiy et al. 2020): images [N,H,W,C] → a patch
    embedding (one convolution with kernel = stride = patch) → a [N,
    (H/p)², d_model] token sequence (``ReshapeVertex``) → learned
    positions → the encoder blocks → mean pooling → softmax classifier;
    xavier, Adam(3e-4). The defaults are the reference's small ones; ViT-B/16
    is image 224, patch 16, 12 layers, 768 wide, 12 heads, d_ff 3072.
    Raises on an image size that the patch size does not divide."""

    def __init__(self, num_labels: int = 10, seed: int = 123,
                 image_size: int = 32, channels: int = 3,
                 patch_size: int = 4, n_layers: int = 4,
                 d_model: int = 64, n_heads: int = 4, d_ff: int = 128):
        super().__init__(num_labels, seed)
        if image_size % patch_size != 0:
            raise ValueError(
                f"image_size {image_size} not divisible by patch_size "
                f"{patch_size}")
        self.image_size = image_size
        self.channels = channels
        self.patch_size = patch_size
        self.n_layers = n_layers
        self.d_model = d_model
        self.n_heads = n_heads
        self.d_ff = d_ff

    @property
    def num_patches(self) -> int:
        side = self.image_size // self.patch_size
        return side * side

    def meta_data(self):
        return ModelMetaData(
            ((self.channels, self.image_size, self.image_size),), 1, "cnn")

    def conf(self):
        p = self.patch_size
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .weight_init("xavier").updater(Adam(3e-4)).graph_builder()
             .add_inputs("image")
             .set_input_types(InputType.convolutional(
                 self.image_size, self.image_size, self.channels)))
        g.add_layer("patch",
                    ConvolutionLayer(n_out=self.d_model, kernel_size=(p, p),
                                     stride=(p, p), activation="identity"), "image")
        g.add_vertex("tokens",
                     ReshapeVertex(shape=(self.num_patches, self.d_model)),
                     "patch")
        g.add_layer("pos",
                    PositionalEmbeddingLayer(n_in=self.d_model,
                                             max_len=self.num_patches),
                    "tokens")
        return _encoder_head(g, "pos", self.n_layers, self.d_model,
                             self.n_heads, self.d_ff, self.num_labels)


def lm_labels(tokens, vocab_size: int):
    """Next-token one-hot targets for causal LM training: labels[t] =
    onehot(tokens[t+1]); the last step repeats the last token."""
    ids = np.asarray(tokens).astype(np.int64)
    shifted = np.concatenate([ids[:, 1:], ids[:, -1:]], axis=1)
    out = np.zeros(shifted.shape + (vocab_size,), np.float32)
    np.put_along_axis(out, shifted[..., None], 1.0, axis=-1)
    return out


def generate(net, prompt_ids, n_new_tokens: int, temperature: float = 0.0,
             seed: int = 0):
    """Autoregressive sampling through ``net.rnn_time_step`` (a graph or a
    MultiLayerNetwork): the prompt once, then one step per token
    (``n_new_tokens - 1`` steps: the last token is not fed back). Each
    token's probabilities are read to numpy and sampled with
    ``np.random.default_rng(seed)``; ``temperature=0`` is greedy argmax.
    Returns ``[N, n_new_tokens]`` int64 ids."""
    rng = np.random.default_rng(seed)
    ids, empty = _prep_prompt(net, prompt_ids, n_new_tokens)
    if empty is not None:
        return empty
    net.rnn_clear_previous_state()
    # [N,T,1]: ids are features, and rnn_time_step keeps the time axis
    probs = net.rnn_time_step(ids[:, :, None].astype(np.float32))
    out = []
    for i in range(n_new_tokens):
        p_last = to_host(probs[:, -1, :] if probs.ndim == 3 else probs)
        if temperature and temperature > 0:
            logits = np.log(np.maximum(p_last, 1e-20)) / temperature
            z = np.exp(logits - logits.max(axis=-1, keepdims=True))
            p = (z / z.sum(axis=-1, keepdims=True)).astype(np.float64)
            p /= p.sum(axis=-1, keepdims=True)  # exact for rng.choice's check
            nxt = np.array([rng.choice(p.shape[-1], p=row) for row in p])
        else:
            nxt = np.argmax(p_last, axis=-1)
        out.append(nxt)
        if i < n_new_tokens - 1:
            probs = net.rnn_time_step(nxt[:, None, None].astype(np.float32))
    return np.stack(out, axis=1)


def _sampler(temperature: float, top_k: int, top_p: float, gen):
    """``sample(p) -> ids``: argmax when greedy; else the reference's
    filters over ``log(p) / temperature`` (top-k first, then the smallest
    nucleus whose mass reaches ``top_p``, at least one token) and one
    Gumbel-max draw from ``gen`` (what ``jax.random.categorical`` does)."""
    if not (temperature and temperature > 0):
        return lambda p: p.argmax(dim=-1)

    def sample(p):
        # masked_fill with Python scalars: no host-to-device copy in the loop
        ninf = float("-inf")
        logits = torch.log(p.clamp_min(1e-20)) / temperature
        if top_k or top_p:
            srt = torch.sort(logits, dim=-1, descending=True).values
            if top_k:
                kk = min(int(top_k), p.shape[-1])
                logits = logits.masked_fill(logits < srt[:, kk - 1:kk], ninf)
                # the nucleus then applies over the top-k survivors
                rank = torch.arange(srt.shape[-1], device=srt.device)
                srt = srt.masked_fill(rank >= kk, ninf)
            if top_p:
                probs = torch.softmax(srt, dim=-1)
                keep = torch.cumsum(probs, dim=-1) - probs < top_p
                cutoff = srt.masked_fill(~keep, -ninf).amin(dim=-1, keepdim=True)
                logits = logits.masked_fill(logits < cutoff, ninf)
        u = torch.rand(logits.shape, generator=gen, dtype=logits.dtype,
                       device=logits.device)
        u = u.clamp_min(torch.finfo(logits.dtype).tiny)
        return (logits - torch.log(-torch.log(u))).argmax(dim=-1)

    return sample


def _prefill(net, ids):
    """The prompt ``ids`` [N,T] through ``net`` from fresh carries:
    ``(last step's probabilities [N,V], carries)``."""
    prompt = torch.as_tensor(ids, dtype=net.dtype).to(net.device)
    carries = net.init_carries(prompt.shape[0])
    acts, carries, _ = net._forward_all(net.params, {net.conf.inputs[0]: prompt},
                                        carries=carries)
    return acts[net.conf.outputs[0]][:, -1], carries


def _step(net, tok, carries):
    """One decode step of the sampled ids ``tok`` [N] (in range by
    construction, so the embedding does not read them back):
    ``(probabilities [N,V], carries)``."""
    x = tok[:, None, None].to(net.dtype)
    with unchecked_token_ids():
        acts, carries, _ = net._forward_all(net.params, {net.conf.inputs[0]: x},
                                            carries=carries)
    return acts[net.conf.outputs[0]][:, -1], carries


@contextlib.contextmanager
def _sync_check(on: bool, device):
    """With ``on`` and a CUDA network, the block runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a call that waits for the
    device raises."""
    if not (on and torch.device(device).type == "cuda"):
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def generate_on_device(net, prompt_ids, n_new_tokens: int,
                       temperature: float = 0.0, seed: int = 0,
                       top_k: int = 0, top_p: float = 0.0, *,
                       check_no_sync: bool = False):
    """Autoregressive sampling with every token kept on the device: one
    prefill fills the KV caches, then one single-token step per token
    samples on the device (greedy argmax, or temperature with ``top_k``
    and ``top_p`` filters, drawn from a ``torch.Generator`` on the
    network's device seeded with ``seed``); the ids are read once, at the
    end. Greedy matches :func:`generate` exactly; sampled draws differ
    from the host loop's numpy draws (the distributions match).
    ``check_no_sync=True`` runs the loop (from the end of the prefill to
    the read) under ``torch.cuda.set_sync_debug_mode("error")``, so any
    call in it that waits for the device raises. Returns
    ``[N, n_new_tokens]`` int64 ids. A graph only: ``TypeError`` for
    other networks."""
    _require_graph(net, "generate_on_device")
    ids, empty = _prep_prompt(net, prompt_ids, n_new_tokens)
    if empty is not None:
        return empty
    greedy = not (temperature and temperature > 0)
    vocab_n = getattr(net.conf.vertices[net.conf.outputs[0]].obj, "n_out", 0)
    if greedy or top_k < 0 or (vocab_n and top_k >= vocab_n):
        top_k = 0
    if greedy or not (top_p and 0.0 < top_p < 1.0):
        top_p = 0.0
    gen = None
    if not greedy:
        gen = torch.Generator(device=net.device)
        gen.manual_seed(int(seed))
    sample = _sampler(temperature, top_k, top_p, gen)
    with torch.inference_mode():
        p, carries = _prefill(net, ids)
        with _sync_check(check_no_sync, net.device):
            toks = [sample(p)]
            for _ in range(n_new_tokens - 1):
                p, carries = _step(net, toks[-1], carries)
                toks.append(sample(p))
            out = torch.stack(toks, dim=1)
        return out.cpu().numpy().astype(np.int64)


def beam_search(net, prompt_ids, n_new_tokens: int, beam_size: int = 4,
                eos_id: int = None, length_penalty: float = 0.0):
    """Beam search on the device: the beams ride the batch axis (N*beam
    KV caches). One prefill per batch row; its caches are repeated across
    the beams; each step scores beam*vocab continuations, keeps the top
    ``beam_size`` and re-indexes every batch-leading carry leaf (KV caches
    included) by the surviving beams. With ``eos_id``, a finished beam only
    extends with ``eos_id`` at zero cost. ``length_penalty`` > 0 ranks the
    beams on ``score / length**length_penalty`` (GNMT-style; 0 ranks raw
    log-prob sums). Returns ``(tokens [N, n_new_tokens], scores [N])`` of
    each row's best beam. A graph only: ``TypeError`` for other
    networks."""
    _require_graph(net, "beam_search")
    if length_penalty < 0:
        raise ValueError(
            f"length_penalty must be >= 0 (got {length_penalty}); 0 disables "
            "normalization, larger values favor longer beams")
    ids, empty = _prep_prompt(net, prompt_ids, n_new_tokens)
    if empty is not None:
        return empty, np.zeros((ids.shape[0],), np.float32)
    n, b = ids.shape[0], int(beam_size)
    nb = n * b
    use_len = length_penalty > 0
    with torch.inference_mode():
        p, carries = _prefill(net, ids)
        logp = torch.log(p.clamp_min(1e-20)).float()
        v = logp.shape[-1]
        # the prompt's caches, repeated across the beam axis
        carries = {k: map_carry(
            lambda a: a.repeat_interleave(b, dim=0)
            if a.ndim >= 1 and a.shape[0] == n else a, c)
            for k, c in carries.items()}
        # the first selection: b distinct tokens of the prompt's distribution
        scores, tok = torch.topk(logp, b, dim=-1)            # [N, B]
        dev = scores.device
        finished = (tok == eos_id if eos_id is not None
                    else torch.zeros((n, b), dtype=torch.bool, device=dev))
        row = torch.arange(n, device=dev)[:, None] * b
        toks = torch.zeros((n, b, n_new_tokens), dtype=torch.int64, device=dev)
        toks[:, :, 0] = tok
        length = torch.ones((n, b), device=dev) if use_len else None
        if eos_id is not None:
            cont = torch.full((v,), -1e30, device=dev)
            cont[eos_id] = 0.0
        for i in range(1, n_new_tokens):
            p, carries = _step(net, tok.reshape(nb), carries)
            logp = torch.log(p.clamp_min(1e-20)).float().reshape(n, b, v)
            if eos_id is not None:
                logp = torch.where(finished[..., None], cont, logp)
            total = scores[..., None] + logp                  # [N, B, V]
            scores, flat = torch.topk(total.reshape(n, b * v), b, dim=-1)
            beam_idx = torch.div(flat, v, rounding_mode="floor")
            tok = flat % v
            flat_idx = (row + beam_idx).reshape(-1)
            carries = {k: map_carry(
                lambda a: a.index_select(0, flat_idx)
                if a.ndim >= 1 and a.shape[0] == nb else a, c)
                for k, c in carries.items()}
            toks = torch.gather(toks, 1, beam_idx[:, :, None].expand_as(toks))
            finished = torch.gather(finished, 1, beam_idx)
            if use_len:
                length = torch.gather(length, 1, beam_idx)
                length = torch.where(finished, length, length + 1.0)
            toks[:, :, i] = tok
            if eos_id is not None:
                finished = finished | (tok == eos_id)
        if use_len:
            scores = scores / length.clamp_min(1.0) ** length_penalty
        best = scores.argmax(dim=1)
        best_toks = toks[torch.arange(n, device=dev), best]
        best_scores = scores[torch.arange(n, device=dev), best]
        return (best_toks.cpu().numpy().astype(np.int64),
                best_scores.cpu().numpy())


def _require_graph(net, fn_name: str) -> None:
    """The on-device decode paths drive ``ComputationGraph`` internals; any
    other network gets the reference's ``TypeError`` (:func:`generate`
    serves a MultiLayerNetwork)."""
    conf = getattr(net, "conf", None)
    if not (hasattr(conf, "vertices") and hasattr(conf, "inputs")):
        raise TypeError(
            f"{fn_name} requires a ComputationGraph-based network "
            f"(e.g. TransformerLM.build()); got {type(net).__name__}. "
            "Use generate() for MultiLayerNetwork models.")


def _prep_prompt(net, prompt_ids, n_new_tokens: int):
    """The prompt as [N,T] and, for ``n_new_tokens <= 0``, the empty
    answer; refuses a prompt the decode caches cannot hold. Returns
    ``(ids, empty_result_or_None)``."""
    ids = np.asarray(prompt_ids)
    if ids.ndim == 1:
        ids = ids[None]
    if n_new_tokens <= 0:
        return ids, np.zeros((ids.shape[0], 0), np.int64)
    cap = _kv_capacity(net)
    total = ids.shape[1] + n_new_tokens - 1  # the last token is never fed back
    if cap is not None and total > cap:
        raise ValueError(
            f"prompt ({ids.shape[1]}) + {n_new_tokens} new tokens needs "
            f"{total} cache slots but the model holds {cap} "
            f"(max_length/max_cache)")
    return ids, None


def _kv_capacity(net):
    """The smallest stateful-decode capacity of the network's layers (KV
    caches and positional tables), or None when none has one."""
    layer_vertices = getattr(net.conf, "layer_vertices", None)
    layers = ([vd.obj for vd in layer_vertices()] if layer_vertices
              else getattr(net, "layers", []))
    caps = [obj.carry_capacity() for obj in layers
            if isinstance(obj, BaseRecurrentLayer)
            and obj.carry_capacity() is not None]
    return min(caps) if caps else None
