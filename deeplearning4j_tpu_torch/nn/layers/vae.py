"""Variational autoencoder layer.

Counterpart of ``deeplearning4j_tpu/nn/layers/vae.py``
(``VariationalAutoencoder.java``): the parameters under the reference's
names and in its order (``eW{i}``, ``eb{i}``, ``pZXMeanW``, ``pZXMeanb``,
``pZXLogStd2W``, ``pZXLogStd2b``, ``dW{i}``, ``db{i}``, ``pXZW``,
``pXZb``), any reconstruction distribution of
``vae_distributions.py``. In a network its forward is the encoder's mean;
``pretrain_loss`` is the negative ELBO with the reparameterization trick
(mean over the batch of KL(q(z|x) ‖ N(0, I)) minus the mean over
``num_samples`` draws of log p(x|z)), which layerwise pretraining
minimizes; ``reconstruction_log_probability`` is the reference's
Monte-Carlo estimate of log p(x), ``reconstruction_error`` the loss of a
``LossFunctionWrapper`` configuration.

Draws: ε comes from a ``torch.Generator`` through ``nn/dropout.py``'s
``normal``, once per sample, as the reference draws once per key of
``split(rng, num_samples)``; without a generator ε is 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn import activations as act_mod
from deeplearning4j_tpu_torch.nn import dropout as _dropout
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer, matmul, register_layer
from deeplearning4j_tpu_torch.nn.layers.vae_distributions import (
    ReconstructionDistribution,
    resolve_reconstruction,
)


@register_layer
@dataclasses.dataclass
class VariationalAutoencoderLayer(Layer):
    n_in: int = 0
    n_out: int = 0  # the latent size
    encoder_layer_sizes: Tuple[int, ...] = (100,)
    decoder_layer_sizes: Tuple[int, ...] = (100,)
    # "bernoulli" | "gaussian" | "exponential", or any
    # ReconstructionDistribution (composite, loss-function wrapper, ...)
    reconstruction_distribution: object = "bernoulli"
    pzx_activation: str = "identity"
    num_samples: int = 1

    def __post_init__(self):
        if self.activation is None:
            self.activation = "leakyrelu"
        if isinstance(self.encoder_layer_sizes, list):
            self.encoder_layer_sizes = tuple(self.encoder_layer_sizes)
        if isinstance(self.decoder_layer_sizes, list):
            self.decoder_layer_sizes = tuple(self.decoder_layer_sizes)

    @property
    def recon(self) -> ReconstructionDistribution:
        return resolve_reconstruction(self.reconstruction_distribution)

    def has_loss_function(self) -> bool:
        """True when the reconstruction is a plain loss (a loss-function
        wrapper, or a composite of them), not a distribution."""
        return self.recon.has_loss_function()

    def is_pretrain_layer(self) -> bool:
        return True

    def set_n_in(self, input_type: InputType) -> None:
        if not self.n_in:
            self.n_in = input_type.flat_size()

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def _recon_out_size(self) -> int:
        return self.recon.distribution_input_size(self.n_in)

    def param_shapes(self):
        shapes = {}
        prev = self.n_in
        for i, h in enumerate(self.encoder_layer_sizes):
            shapes[f"eW{i}"] = (prev, h)
            shapes[f"eb{i}"] = (h,)
            prev = h
        shapes["pZXMeanW"] = (prev, self.n_out)
        shapes["pZXMeanb"] = (self.n_out,)
        shapes["pZXLogStd2W"] = (prev, self.n_out)
        shapes["pZXLogStd2b"] = (self.n_out,)
        prev = self.n_out
        for i, h in enumerate(self.decoder_layer_sizes):
            shapes[f"dW{i}"] = (prev, h)
            shapes[f"db{i}"] = (h,)
            prev = h
        shapes["pXZW"] = (prev, self._recon_out_size())
        shapes["pXZb"] = (self._recon_out_size(),)
        return shapes

    def init_params(self, gen, dtype=torch.float32, device=None):
        params = {}
        for name, shape in self.param_shapes().items():
            if name.endswith("b") and len(shape) == 1:
                params[name] = torch.zeros(shape, dtype=dtype, device=device)
            else:
                params[name] = self._init_w(gen, shape, shape[0], shape[-1], dtype,
                                            device)
        return params

    def _encode(self, params, x):
        act = self.act_fn()
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = act(matmul(h, params[f"eW{i}"]) + params[f"eb{i}"])
        pzx_act = act_mod.resolve(self.pzx_activation)
        mean = pzx_act(matmul(h, params["pZXMeanW"]) + params["pZXMeanb"])
        log_var = pzx_act(matmul(h, params["pZXLogStd2W"]) + params["pZXLogStd2b"])
        return mean, log_var

    def _decode(self, params, z):
        act = self.act_fn()
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = act(matmul(h, params[f"dW{i}"]) + params[f"db{i}"])
        return matmul(h, params["pXZW"]) + params["pXZb"]

    def forward(self, params, x, *, mask=None, train=False, gen=None):
        return self._encode(params, x)[0]

    def generate(self, params, z):
        """Latent values decoded to E[P(x|z)] (``generateAtMeanGivenZ``)."""
        return self.recon.generate_at_mean(self._decode(params, z))

    def generate_random(self, params, z, gen: torch.Generator):
        """Latent values decoded and P(x|z) sampled from ``gen``
        (``generateRandomGivenZ``)."""
        return self.recon.generate_random(gen, self._decode(params, z))

    def reconstruction_log_prob(self, params, x, z):
        """Per-example log p(x|z): the distribution's cost, negated."""
        return -self.recon.example_neg_log_prob(x, self._decode(params, z))

    def _sample_z(self, mean, sigma, gen):
        return mean + sigma * _dropout.normal(mean.shape, gen, mean.device, mean.dtype)

    def reconstruction_log_probability(self, params, x, gen: torch.Generator,
                                       num_samples: Optional[int] = None):
        """The Monte-Carlo estimate of each example's log p(x): the mean over
        ``num_samples`` draws z ~ q(z|x) (from ``gen``) of log p(x|z)
        (``VariationalAutoencoder.java:998``). Shape [N]."""
        if self.has_loss_function():
            raise ValueError(
                "Cannot calculate reconstruction log probability when using "
                "a LossFunctionWrapper: loss functions are not probabilistic. "
                "Use reconstruction_error instead")
        k = num_samples if num_samples is not None else self.num_samples
        if k <= 0:
            raise ValueError(f"num_samples must be > 0, got {k}")
        mean, log_var = self._encode(params, x)
        sigma = torch.exp(0.5 * log_var)
        total = 0.0
        for _ in range(k):
            total = total + self.reconstruction_log_prob(
                params, x, self._sample_z(mean, sigma, gen))
        return total / k

    def reconstruction_probability(self, params, x, gen: torch.Generator,
                                   num_samples: Optional[int] = None):
        """exp of :meth:`reconstruction_log_probability`."""
        return torch.exp(self.reconstruction_log_probability(params, x, gen,
                                                             num_samples))

    def reconstruction_error(self, params, x):
        """Each example's deterministic reconstruction error; only for a
        loss-function configuration (``:1146``)."""
        if not self.has_loss_function():
            raise ValueError(
                "reconstruction_error requires a loss-function configuration "
                "(LossFunctionWrapper / all-loss Composite); probabilistic "
                "distributions use reconstruction_log_probability")
        mean, _ = self._encode(params, x)
        return self.recon.score_array(x, self.generate(params, mean))

    def pretrain_loss(self, params, x, gen: Optional[torch.Generator]):
        """The negative ELBO, a mean over the batch; ε from ``gen`` (0
        without one)."""
        mean, log_var = self._encode(params, x)
        sigma = torch.exp(0.5 * log_var)
        total = 0.0
        for _ in range(self.num_samples if gen is not None else 1):
            z = mean + sigma * 0.0 if gen is None else self._sample_z(mean, sigma, gen)
            total = total + self.reconstruction_log_prob(params, x, z).mean()
        recon = total / self.num_samples
        kl = -0.5 * (1 + log_var - mean ** 2 - torch.exp(log_var)).sum(dim=-1)
        return kl.mean() - recon
