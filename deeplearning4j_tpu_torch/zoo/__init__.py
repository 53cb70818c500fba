"""Model zoo of the PyTorch/CUDA port."""

from deeplearning4j_tpu_torch.zoo.models import (  # noqa: F401
    LeNet,
    TransformerLM,
    lm_labels,
    transformer_decoder_block,
)
