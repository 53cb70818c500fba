"""The VAE's reconstruction distributions.

Counterpart of ``deeplearning4j_tpu/nn/layers/vae_distributions.py``: the
same classes, fields and ``@recon`` serde (``to_dict`` / ``from_dict``,
the registry), so a VAE's configuration reads back in both packages.
``BernoulliReconstructionDistribution`` (sigmoid by default, then the
stable form on the logits), ``GaussianReconstructionDistribution`` (the
decoder emits ``[mean | log σ²]``), ``ExponentialReconstructionDistribution``
(γ = log λ), ``LossFunctionWrapper`` (a plain loss as the
reconstruction error, not a probability) and
``CompositeReconstructionDistribution`` (distributions over column
ranges). ``example_neg_log_prob`` is a function of tensors that autograd
differentiates.

Draws: ``generate_random`` draws from a ``torch.Generator`` through
``nn/dropout.py``'s ``bernoulli``, ``normal`` and ``uniform``, in the
reference's order (a composite draws part by part).

Gradients at the ties are the reference's, as ``jax.grad`` gives them:
the stable Bernoulli form's ``max(l, 0)`` is ``torch.maximum`` against a
0-dim zero (a tie splits in half) and its ``|l|`` is ``l·s`` with the sign
``s`` (+1 at 0) held constant (``jnp.abs``'s gradient at 0 is +1); the
clips are ``minimum(maximum(·))`` (``jnp.clip``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn import activations as act_mod
from deeplearning4j_tpu_torch.nn import dropout as _dropout
from deeplearning4j_tpu_torch.nn.activations import _clip, _max, signed_abs

RECONSTRUCTION_REGISTRY: Dict[str, type] = {}


def register_reconstruction(cls):
    RECONSTRUCTION_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass
class ReconstructionDistribution:
    """The distribution SPI (``ReconstructionDistribution.java``)."""

    activation: str = "identity"

    def act(self):
        return act_mod.resolve(self.activation)

    def has_loss_function(self) -> bool:
        return False

    def distribution_input_size(self, data_size: int) -> int:
        raise NotImplementedError

    def example_neg_log_prob(self, x: torch.Tensor, pre_out: torch.Tensor) -> torch.Tensor:
        """Per-example -log p(x | params), shape [N]."""
        raise NotImplementedError

    def generate_at_mean(self, pre_out: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def generate_random(self, gen: torch.Generator, pre_out: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # -- serde -------------------------------------------------------------
    def to_dict(self) -> dict:
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "distributions" and v is not None:
                v = [[int(sz), dist.to_dict()] for sz, dist in v]
            d[f.name] = v
        d["@recon"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d: dict) -> "ReconstructionDistribution":
        d = dict(d)
        cls = RECONSTRUCTION_REGISTRY[d.pop("@recon")]
        if isinstance(d.get("distributions"), list):
            d["distributions"] = [
                (int(sz), ReconstructionDistribution.from_dict(dd))
                for sz, dd in d["distributions"]]
        return cls(**d)


@register_reconstruction
@dataclasses.dataclass
class BernoulliReconstructionDistribution(ReconstructionDistribution):
    """Binary or [0, 1] data; the sigmoid maps the pre-output to
    probabilities, and with it the stable form on the logits is used."""

    activation: str = "sigmoid"

    def distribution_input_size(self, data_size: int) -> int:
        return data_size

    def example_neg_log_prob(self, x, pre_out):
        if self.activation == "sigmoid":
            # -log p = softplus(-|l|) + max(l, 0) - l·x
            nlp = (_max(pre_out, 0.0) - pre_out * x
                   + torch.log1p(torch.exp(-signed_abs(pre_out))))
            return nlp.sum(dim=-1)
        p = _clip(self.act()(pre_out), 1e-10, 1.0 - 1e-10)
        return -(x * torch.log(p) + (1 - x) * torch.log1p(-p)).sum(dim=-1)

    def generate_at_mean(self, pre_out):
        return self.act()(pre_out)

    def generate_random(self, gen, pre_out):
        p = self.act()(pre_out)
        return _dropout.bernoulli(p, p.shape, gen, p.device).to(p.dtype)


@register_reconstruction
@dataclasses.dataclass
class GaussianReconstructionDistribution(ReconstructionDistribution):
    """Real-valued data: the decoder emits ``[mean | log σ²]`` (twice the
    data size); the activation applies to the whole pre-output."""

    def distribution_input_size(self, data_size: int) -> int:
        return 2 * data_size

    def _split(self, pre_out):
        return torch.chunk(self.act()(pre_out), 2, dim=-1)

    def example_neg_log_prob(self, x, pre_out):
        mean, log_var = self._split(pre_out)
        nlp = 0.5 * (math.log(2 * math.pi) + log_var
                     + (x - mean) ** 2 / torch.exp(log_var))
        return nlp.sum(dim=-1)

    def generate_at_mean(self, pre_out):
        return self._split(pre_out)[0]

    def generate_random(self, gen, pre_out):
        mean, log_var = self._split(pre_out)
        return mean + torch.exp(0.5 * log_var) * _dropout.normal(
            mean.shape, gen, mean.device, mean.dtype)


@register_reconstruction
@dataclasses.dataclass
class ExponentialReconstructionDistribution(ReconstructionDistribution):
    """Data in [0, ∞): the network models γ = log λ, so -log p(x) = λx - γ;
    the mean is 1/λ; a draw is -log(u)/λ (the inverse CDF)."""

    def distribution_input_size(self, data_size: int) -> int:
        return data_size

    def example_neg_log_prob(self, x, pre_out):
        gamma = self.act()(pre_out)
        return (torch.exp(gamma) * x - gamma).sum(dim=-1)

    def generate_at_mean(self, pre_out):
        return torch.exp(-self.act()(pre_out))

    def generate_random(self, gen, pre_out):
        lam = torch.exp(self.act()(pre_out))
        u = _dropout.uniform(lam.shape, gen, lam.device, lam.dtype, 1e-10, 1.0)
        return -torch.log(u) / lam


def _loss_score_array(loss: str, labels: torch.Tensor, output: torch.Tensor) -> torch.Tensor:
    """Per-example loss score (``ILossFunction.computeScoreArray``) of the
    losses ``LossFunctionWrapper`` wraps: MSE and MAE divide the summed
    per-element scores by the output size, as DL4J's do."""
    n_out = labels.shape[-1]
    if loss in ("mse", "l2"):
        per = (labels - output) ** 2
        return per.sum(dim=-1) / (n_out if loss == "mse" else 1)
    if loss in ("mae", "l1"):
        per = signed_abs(labels - output)
        return per.sum(dim=-1) / (n_out if loss == "mae" else 1)
    if loss == "xent":
        p = _clip(output, 1e-10, 1.0 - 1e-10)
        return -(labels * torch.log(p) + (1 - labels) * torch.log1p(-p)).sum(dim=-1)
    if loss in ("mcxent", "negativeloglikelihood"):
        p = _clip(output, 1e-10, 1.0)
        return -(labels * torch.log(p)).sum(dim=-1)
    raise ValueError(
        f"LossFunctionWrapper: unsupported loss {loss!r} (supported: mse, "
        "l2, mae, l1, xent, mcxent, negativeloglikelihood)")


@register_reconstruction
@dataclasses.dataclass
class LossFunctionWrapper(ReconstructionDistribution):
    """A plain loss function in place of a distribution
    (``LossFunctionWrapper.java``): a reconstruction error, no
    reconstruction probability."""

    loss: str = "mse"

    def has_loss_function(self) -> bool:
        return True

    def distribution_input_size(self, data_size: int) -> int:
        return data_size

    def example_neg_log_prob(self, x, pre_out):
        return self.score_array(x, self.act()(pre_out))

    def score_array(self, x, output):
        """Per-example score of ``output`` (the activation applied)."""
        return _loss_score_array(self.loss, x, output)

    def generate_at_mean(self, pre_out):
        return self.act()(pre_out)

    def generate_random(self, gen, pre_out):
        # not probabilistic: a "draw" is the deterministic output
        return self.generate_at_mean(pre_out)


@register_reconstruction
@dataclasses.dataclass
class CompositeReconstructionDistribution(ReconstructionDistribution):
    """Distributions over column ranges of the data: ``distributions`` is a
    list of ``(data_size, distribution)`` pairs, in column order."""

    distributions: Optional[List[Tuple[int, ReconstructionDistribution]]] = None

    def __post_init__(self):
        if not self.distributions:
            raise ValueError("CompositeReconstructionDistribution requires "
                             "a non-empty list of (size, distribution) pairs")
        self.distributions = [(int(sz), d) for sz, d in self.distributions]

    @property
    def total_size(self) -> int:
        return sum(sz for sz, _ in self.distributions)

    def has_loss_function(self) -> bool:
        return all(d.has_loss_function() for _, d in self.distributions)

    def distribution_input_size(self, data_size: int) -> int:
        if data_size != self.total_size:
            raise ValueError(
                f"Invalid input size: got {data_size} but the composite's "
                f"distribution sizes sum to {self.total_size} "
                f"({[sz for sz, _ in self.distributions]})")
        return sum(d.distribution_input_size(sz) for sz, d in self.distributions)

    def _slices(self):
        x_at, p_at = 0, 0
        for sz, d in self.distributions:
            psz = d.distribution_input_size(sz)
            yield d, slice(x_at, x_at + sz), slice(p_at, p_at + psz)
            x_at += sz
            p_at += psz

    def example_neg_log_prob(self, x, pre_out):
        total = None
        for d, xs, ps in self._slices():
            part = d.example_neg_log_prob(x[..., xs], pre_out[..., ps])
            total = part if total is None else total + part
        return total

    def score_array(self, x, reconstruction):
        """Summed per-example loss scores; every part must wrap a loss."""
        if not self.has_loss_function():
            raise ValueError("Cannot compute score array unless every "
                             "component has a loss function")
        total = None
        for d, xs, _ in self._slices():
            part = d.score_array(x[..., xs], reconstruction[..., xs])
            total = part if total is None else total + part
        return total

    def generate_at_mean(self, pre_out):
        return torch.cat([d.generate_at_mean(pre_out[..., ps])
                          for d, _, ps in self._slices()], dim=-1)

    def generate_random(self, gen, pre_out):
        return torch.cat([d.generate_random(gen, pre_out[..., ps])
                          for d, _, ps in self._slices()], dim=-1)


def resolve_reconstruction(v) -> ReconstructionDistribution:
    """The VAE's configuration value as a distribution: the shorthands
    ``"bernoulli"``, ``"gaussian"`` and ``"exponential"`` (default
    activations), a ``@recon`` dict, or an instance as it is."""
    if isinstance(v, ReconstructionDistribution):
        return v
    if isinstance(v, dict) and "@recon" in v:
        return ReconstructionDistribution.from_dict(v)
    name = str(v).lower()
    if name == "bernoulli":
        return BernoulliReconstructionDistribution()
    if name == "gaussian":
        return GaussianReconstructionDistribution()
    if name == "exponential":
        return ExponentialReconstructionDistribution()
    raise ValueError(
        f"Unknown reconstruction distribution {v!r}; use 'bernoulli', "
        "'gaussian', 'exponential', or a ReconstructionDistribution instance")
