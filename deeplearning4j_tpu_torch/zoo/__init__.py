"""Model zoo of the PyTorch/CUDA port."""

from deeplearning4j_tpu_torch.zoo.models import (  # noqa: F401
    LeNet,
    ResNet50,
    TransformerLM,
    beam_search,
    generate,
    generate_on_device,
    lm_labels,
    transformer_decoder_block,
)

__all__ = ["LeNet", "ResNet50", "TransformerLM", "beam_search", "generate",
           "generate_on_device", "lm_labels", "transformer_decoder_block"]
