"""Loss functions with ND4J ``ILossFunction`` parity.

Counterpart of ``deeplearning4j_tpu/nn/losses.py``, same names and math:
every loss is ``loss(labels, preactivation_or_probs, mask=None,
weights=None) -> scalar mean score``. Losses that fuse with their
canonical activation (softmax+MCXENT, sigmoid+XENT) are computed from
*logits*; ``resolve`` says when the output layer should feed logits.

Masks broadcast like DL4J's: shape [N] or [N, T] (per example / per
timestep) or full label shape. A masked mean divides by the count of
unmasked entries (at least 1).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from deeplearning4j_tpu_torch.nn.dtensor import log_softmax, mean

_EPS = 1e-7


def _apply_mask_mean(per_elem: torch.Tensor, mask) -> torch.Tensor:
    """Mean of per-example scores ([N] or [N, T]), honouring a
    broadcastable mask: the masked sum over the number of unmasked
    entries (BaseOutputLayer.computeScore)."""
    if mask is None:
        return mean(per_elem)
    mask = torch.broadcast_to(mask.to(per_elem.dtype), per_elem.shape)
    total = torch.sum(per_elem * mask)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return total / denom


def _featurewise(per_out: torch.Tensor, weights) -> torch.Tensor:
    """Apply per-output weights then reduce feature axis → per-example score."""
    if weights is not None:
        per_out = per_out * weights
    return torch.sum(per_out, dim=-1)


def mse(labels, preds, mask=None, weights=None):
    # DL4J LossMSE = LossL2 / nOut (mean over outputs)
    per = _featurewise((preds - labels) ** 2, weights) / labels.shape[-1]
    return _apply_mask_mean(per, mask)


def l2(labels, preds, mask=None, weights=None):
    per = _featurewise((preds - labels) ** 2, weights)
    return _apply_mask_mean(per, mask)


def l1(labels, preds, mask=None, weights=None):
    per = _featurewise(torch.abs(preds - labels), weights)
    return _apply_mask_mean(per, mask)


def mae(labels, preds, mask=None, weights=None):
    per = _featurewise(torch.abs(preds - labels), weights) / labels.shape[-1]
    return _apply_mask_mean(per, mask)


def mape(labels, preds, mask=None, weights=None):
    safe = torch.where(torch.abs(labels) < _EPS,
                       torch.full_like(labels, _EPS), labels)
    per = _featurewise(torch.abs((preds - labels) / safe), weights) \
        * (100.0 / labels.shape[-1])
    return _apply_mask_mean(per, mask)


def msle(labels, preds, mask=None, weights=None):
    per = _featurewise(
        (torch.log1p(torch.clamp(preds, min=-1 + _EPS))
         - torch.log1p(torch.clamp(labels, min=-1 + _EPS))) ** 2,
        weights) / labels.shape[-1]
    return _apply_mask_mean(per, mask)


def mcxent_logits(labels, logits, mask=None, weights=None):
    """Multi-class cross entropy fused with softmax (stable); column-
    parallel logits keep their classes sharded (``nn/dtensor.py``)."""
    logp = log_softmax(logits)
    per = -_featurewise(labels * logp, weights)
    return _apply_mask_mean(per, mask)


def mcxent_probs(labels, probs, mask=None, weights=None):
    per = -_featurewise(labels * torch.log(torch.clamp(probs, _EPS, 1.0)),
                        weights)
    return _apply_mask_mean(per, mask)


def sparse_mcxent_logits(labels, logits, mask=None, weights=None):
    """Labels are integer class indices, not one-hot."""
    logp = log_softmax(logits)
    idx = labels.to(torch.int64)
    per = -torch.take_along_dim(logp, idx[..., None], dim=-1)[..., 0]
    if weights is not None:
        per = per * weights[idx]
    return _apply_mask_mean(per, mask)


def xent_logits(labels, logits, mask=None, weights=None):
    """Binary cross entropy fused with sigmoid (stable)."""
    per_out = (torch.clamp(logits, min=0) - logits * labels
               + torch.log1p(torch.exp(-torch.abs(logits))))
    return _apply_mask_mean(_featurewise(per_out, weights), mask)


def xent_probs(labels, probs, mask=None, weights=None):
    p = torch.clamp(probs, _EPS, 1.0 - _EPS)
    per = -_featurewise(labels * torch.log(p) + (1 - labels) * torch.log1p(-p),
                        weights)
    return _apply_mask_mean(per, mask)


def negativeloglikelihood_logits(labels, logits, mask=None, weights=None):
    # DL4J LossNegativeLogLikelihood extends LossMCXENT
    return mcxent_logits(labels, logits, mask, weights)


def hinge(labels, preds, mask=None, weights=None):
    # labels in {-1, +1}
    per = _featurewise(torch.clamp(1.0 - labels * preds, min=0.0), weights)
    return _apply_mask_mean(per, mask)


def squared_hinge(labels, preds, mask=None, weights=None):
    per = _featurewise(torch.clamp(1.0 - labels * preds, min=0.0) ** 2,
                       weights)
    return _apply_mask_mean(per, mask)


def kl_divergence(labels, preds, mask=None, weights=None):
    lab = torch.clamp(labels, _EPS, 1.0)
    prd = torch.clamp(preds, _EPS, 1.0)
    per = _featurewise(lab * (torch.log(lab) - torch.log(prd)), weights)
    return _apply_mask_mean(per, mask)


def poisson(labels, preds, mask=None, weights=None):
    per = _featurewise(preds - labels * torch.log(torch.clamp(preds, min=_EPS)),
                       weights)
    return _apply_mask_mean(per, mask)


def cosine_proximity(labels, preds, mask=None, weights=None):
    ln = torch.linalg.vector_norm(labels, dim=-1)
    pn = torch.linalg.vector_norm(preds, dim=-1)
    dot = torch.sum(labels * preds, dim=-1)
    per = -dot / torch.clamp(ln * pn, min=_EPS)
    return _apply_mask_mean(per, mask)


def wasserstein(labels, preds, mask=None, weights=None):
    per = _featurewise(labels * preds, weights)
    return _apply_mask_mean(per, mask)


LossFn = Callable[..., torch.Tensor]

# name -> (loss_from_canonical_input, fused_activation or None); when the
# fused activation matches the output layer's, the loss takes raw logits
_REGISTRY: dict = {
    "mse": (mse, None),
    "l2": (l2, None),
    "l1": (l1, None),
    "mae": (mae, None),
    "mean_absolute_error": (mae, None),
    "mean_squared_logarithmic_error": (msle, None),
    "msle": (msle, None),
    "mape": (mape, None),
    "mean_absolute_percentage_error": (mape, None),
    "mcxent": (mcxent_logits, "softmax"),
    "negativeloglikelihood": (negativeloglikelihood_logits, "softmax"),
    "sparse_mcxent": (sparse_mcxent_logits, "softmax"),
    "xent": (xent_logits, "sigmoid"),
    "binary_xent": (xent_logits, "sigmoid"),
    "hinge": (hinge, None),
    "squared_hinge": (squared_hinge, None),
    "kl_divergence": (kl_divergence, None),
    "reconstruction_crossentropy": (xent_probs, None),
    "poisson": (poisson, None),
    "cosine_proximity": (cosine_proximity, None),
    "wasserstein": (wasserstein, None),
}

# probability-space versions of the fused losses, for an output activation
# that is NOT the canonical pairing (e.g. MCXENT with sigmoid outputs)
_PROB_SPACE: dict = {
    "mcxent": mcxent_probs,
    "negativeloglikelihood": mcxent_probs,
    "xent": xent_probs,
    "binary_xent": xent_probs,
}


def names() -> list:
    return sorted(_REGISTRY)


def resolve(loss: Union[str, LossFn], activation: Optional[str] = None):
    """Resolve a loss spec to ``(fn, wants_logits: bool)``: ``wants_logits``
    is True when the loss's canonical activation equals ``activation``, and
    ``fn`` then takes the final layer's pre-activation output."""
    if callable(loss):
        return loss, False
    key = loss.lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown loss {loss!r}; known: {names()}")
    fn, fused_act = _REGISTRY[key]
    if fused_act is not None:
        if activation is None or activation.lower() == fused_act:
            return fn, True
        return _PROB_SPACE[key], False
    return fn, False
