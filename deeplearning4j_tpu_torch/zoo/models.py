"""Model zoo: LeNet and the GPT-style TransformerLM.

Counterpart of ``LeNet``, ``transformer_decoder_block``, ``TransformerLM``
and ``lm_labels`` in ``deeplearning4j_tpu/zoo/models.py``. The same
layers, vertex names and parameter shapes; ``init(device=None)`` builds
the network on ``cuda`` (``device="cpu"`` for the CPU). No pretrained
weights are fetched: the zoo's pretrained LeNet zip is not in the
repository.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    CausalSelfAttentionLayer,
    ConvolutionLayer,
    DenseLayer,
    EmbeddingSequenceLayer,
    LayerNormalizationLayer,
    OutputLayer,
    PositionalEmbeddingLayer,
    RnnOutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.updaters import AdaDelta, Adam
from deeplearning4j_tpu_torch.nn.vertices import ElementWiseVertex


class LeNet:
    """LeNet-5-style CNN (``zoo/model/LeNet.java``): two 5x5 "same"
    convolutions of 20 and 50 channels, each followed by a 2x2 max pool,
    a dense 500 and a softmax output, trained with AdaDelta.
    ``input_shape`` is (channels, height, width), as in the reference."""

    def __init__(self, num_labels: int = 10, seed: int = 123,
                 input_shape=(1, 28, 28)):
        self.num_labels = num_labels
        self.seed = seed
        self.input_shape = tuple(input_shape)

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

    def init(self, device=None):
        """The initialized network (seeded with this model's seed)."""
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        return MultiLayerNetwork(self.conf(), device=device).init(seed=self.seed)


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


class TransformerLM:
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
        self.num_labels = self.vocab_size
        self.seed = seed
        self.max_length = max_length
        self.n_layers = n_layers
        self.d_model = d_model
        self.n_heads = n_heads
        self.d_ff = d_ff
        self.attn_dropout = attn_dropout

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

    def init(self, device=None):
        """The initialized network (seeded with this model's seed)."""
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        return ComputationGraph(self.conf(), device=device).init(seed=self.seed)


def lm_labels(tokens, vocab_size: int):
    """Next-token one-hot targets for causal LM training: labels[t] =
    onehot(tokens[t+1]); the last step repeats the last token."""
    ids = np.asarray(tokens).astype(np.int64)
    shifted = np.concatenate([ids[:, 1:], ids[:, -1:]], axis=1)
    out = np.zeros(shifted.shape + (vocab_size,), np.float32)
    np.put_along_axis(out, shifted[..., None], 1.0, axis=-1)
    return out
