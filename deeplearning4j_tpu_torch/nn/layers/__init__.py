"""Layers of the PyTorch/CUDA port."""

from deeplearning4j_tpu_torch.nn.layers.attention import (  # noqa: F401
    CausalSelfAttentionLayer,
    CrossAttentionLayer,
    LearnedSelfAttentionLayer,
    SelfAttentionLayer,
)
from deeplearning4j_tpu_torch.nn.layers.autoencoder import AutoEncoderLayer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.base import (  # noqa: F401
    LAYER_REGISTRY,
    Layer,
    register_layer,
)
from deeplearning4j_tpu_torch.nn.layers.conv import (  # noqa: F401
    Convolution1DLayer,
    ConvolutionLayer,
    CropLayer,
    Deconvolution2DLayer,
    DepthwiseConvolution2DLayer,
    SeparableConvolution2DLayer,
    SpaceToBatchLayer,
    SpaceToDepthLayer,
    Upsampling1DLayer,
    UpsamplingLayer,
    ZeroPadding1DLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.core import (  # noqa: F401
    ActivationLayer,
    DenseLayer,
    DropoutLayer,
    ElementWiseMultiplicationLayer,
    EmbeddingLayer,
    EmbeddingSequenceLayer,
    MaskLayer,
    PositionalEmbeddingLayer,
    PReLULayer,
)
from deeplearning4j_tpu_torch.nn.layers.moe import (  # noqa: F401
    MixtureOfExpertsLayer,
    load_balancing_loss,
)
from deeplearning4j_tpu_torch.nn.layers.norm import (  # noqa: F401
    BatchNormalizationLayer,
    LayerNormalizationLayer,
    LocalResponseNormalizationLayer,
)
from deeplearning4j_tpu_torch.nn.layers.objdetect import (  # noqa: F401
    DetectedObject,
    Yolo2OutputLayer,
    get_predicted_objects,
    nms,
)
from deeplearning4j_tpu_torch.nn.layers.output import (  # noqa: F401
    CenterLossOutputLayer,
    CnnLossLayer,
    LossLayer,
    OutputLayer,
    RnnLossLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.layers.pooling import (  # noqa: F401
    GlobalPoolingLayer,
    Subsampling1DLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import (  # noqa: F401
    BaseRecurrentLayer,
    BidirectionalWrapper,
    ConvLSTM2DLayer,
    GravesBidirectionalLSTMLayer,
    GravesLSTMLayer,
    GRULayer,
    LastTimeStepWrapper,
    LSTMLayer,
    MaskZeroLayer,
    SimpleRnnLayer,
)
from deeplearning4j_tpu_torch.nn.layers.samediff import (  # noqa: F401
    SameDiffLambdaLayer,
    SameDiffLayer,
)
from deeplearning4j_tpu_torch.nn.layers.vae import VariationalAutoencoderLayer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.vae_distributions import (  # noqa: F401
    BernoulliReconstructionDistribution,
    CompositeReconstructionDistribution,
    ExponentialReconstructionDistribution,
    GaussianReconstructionDistribution,
    LossFunctionWrapper,
    ReconstructionDistribution,
)
from deeplearning4j_tpu_torch.nn.layers.wrappers import (  # noqa: F401
    FrozenLayer,
    TimeDistributedWrapper,
)
