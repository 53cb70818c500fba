"""Model zoo of the PyTorch/CUDA port."""

from deeplearning4j_tpu_torch.zoo.labels import (  # noqa: F401
    ClassPrediction,
    COCOLabels,
    ImageNetLabels,
    Labels,
    VOCLabels,
)
from deeplearning4j_tpu_torch.zoo.models import (  # noqa: F401
    AlexNet,
    Darknet19,
    FaceNetNN4Small2,
    GoogLeNet,
    InceptionResNetV1,
    LeNet,
    ResNet50,
    SimpleCNN,
    TINY_YOLO_ANCHORS,
    TextGenerationLSTM,
    TinyYOLO,
    TransformerEncoder,
    TransformerLM,
    VGG16,
    VGG19,
    VisionTransformer,
    YOLO2,
    YOLO2_ANCHORS,
    beam_search,
    generate,
    generate_on_device,
    lm_labels,
    transformer_decoder_block,
    transformer_encoder_block,
)

from deeplearning4j_tpu_torch.zoo.zoo_model import (  # noqa: F401
    ModelMetaData,
    ModelSelector,
    PretrainedType,
    ZooModel,
    register_zoo_model,
)

__all__ = ["ModelMetaData", "ModelSelector", "PretrainedType", "ZooModel",
           "register_zoo_model", "AlexNet", "Darknet19", "FaceNetNN4Small2", "GoogLeNet",
           "InceptionResNetV1", "LeNet", "ResNet50", "SimpleCNN",
           "TINY_YOLO_ANCHORS", "TextGenerationLSTM", "TinyYOLO",
           "TransformerEncoder", "TransformerLM", "VGG16", "VGG19",
           "VisionTransformer", "YOLO2", "YOLO2_ANCHORS", "beam_search", "generate",
           "generate_on_device", "lm_labels", "transformer_decoder_block",
           "transformer_encoder_block"]
