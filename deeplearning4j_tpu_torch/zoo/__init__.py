"""Model zoo of the PyTorch/CUDA port."""

from deeplearning4j_tpu_torch.zoo.models import (  # noqa: F401
    AlexNet,
    Darknet19,
    GoogLeNet,
    LeNet,
    ResNet50,
    SimpleCNN,
    TextGenerationLSTM,
    TransformerEncoder,
    TransformerLM,
    VGG16,
    VGG19,
    VisionTransformer,
    beam_search,
    generate,
    generate_on_device,
    lm_labels,
    transformer_decoder_block,
    transformer_encoder_block,
)

__all__ = ["AlexNet", "Darknet19", "GoogLeNet", "LeNet", "ResNet50", "SimpleCNN",
           "TextGenerationLSTM",
           "TransformerEncoder", "TransformerLM", "VGG16", "VGG19",
           "VisionTransformer", "beam_search", "generate", "generate_on_device",
           "lm_labels", "transformer_decoder_block", "transformer_encoder_block"]
