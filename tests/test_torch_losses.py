"""Every loss of the port against the JAX package's, with and without masks.

Labels, predictions, masks and weights are drawn with numpy from a seed
and fed to both; each loss sees inputs of its own domain (one-hot labels
for the cross entropies, {-1, +1} for the hinges, probabilities where a
log is taken). Tolerance rtol 1e-5 / atol 1e-6: float32 reductions on the
CPU, only XLA's and ATen's summation orders differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import losses as J
from deeplearning4j_tpu_torch.nn import losses as P

RTOL, ATOL = 1e-5, 1e-6
N, T, C = 4, 6, 5


def _inputs(name, rng, shape):
    """(labels, predictions) of the loss's domain."""
    if name in ("mcxent", "negativeloglikelihood", "kl_divergence"):
        lab = np.eye(C, dtype=np.float32)[rng.integers(0, C, shape[:-1])]
    elif name in ("xent", "binary_xent", "reconstruction_crossentropy"):
        lab = rng.integers(0, 2, shape).astype(np.float32)
    elif name in ("hinge", "squared_hinge"):
        lab = rng.choice([-1.0, 1.0], shape).astype(np.float32)
    elif name == "sparse_mcxent":
        lab = rng.integers(0, C, shape[:-1]).astype(np.float32)
    else:
        lab = rng.normal(size=shape).astype(np.float32)
    pred = rng.normal(size=shape).astype(np.float32)
    if name in ("kl_divergence", "reconstruction_crossentropy", "poisson"):
        pred = rng.uniform(0.05, 0.95, shape).astype(np.float32)
    return lab, pred


def _masks(rng, per_elem_shape):
    m = rng.integers(0, 2, per_elem_shape).astype(np.float32)
    m.reshape(-1)[0] = 1.0
    return {"none": None, "mask": m,
            "all_zero": np.zeros(per_elem_shape, np.float32)}


def _both(fn_j, fn_p, lab, pred, mask, weights):
    jm = None if mask is None else jnp.asarray(mask)
    pm = None if mask is None else torch.from_numpy(mask)
    jw = None if weights is None else jnp.asarray(weights)
    pw = None if weights is None else torch.from_numpy(weights)
    want = fn_j(jnp.asarray(lab), jnp.asarray(pred), mask=jm, weights=jw)
    got = fn_p(torch.from_numpy(lab), torch.from_numpy(pred), mask=pm,
               weights=pw)
    return float(got), float(want)


@pytest.mark.parametrize("masked", ["none", "mask", "all_zero"])
@pytest.mark.parametrize("seq", [False, True], ids=["2d", "3d"])
@pytest.mark.parametrize("name", sorted(J._REGISTRY))
def test_loss_matches_reference(name, seq, masked, rng):
    shape = (N, T, C) if seq else (N, C)
    lab, pred = _inputs(name, rng, shape)
    mask = _masks(rng, shape[:-1])[masked]
    for activation in (None, "identity", "sigmoid"):
        if name == "sparse_mcxent" and activation is not None:
            # no probability-space version: both refuse the same way
            for mod in (J, P):
                with pytest.raises(KeyError):
                    mod.resolve(name, activation)
            continue
        fn_j, logits_j = J.resolve(name, activation)
        fn_p, logits_p = P.resolve(name, activation)
        assert logits_p == logits_j and fn_p.__name__ == fn_j.__name__
        got, want = _both(fn_j, fn_p, lab, pred, mask, None)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} act={activation}")


@pytest.mark.parametrize("name", ["mse", "l1", "mcxent", "xent", "hinge",
                                  "sparse_mcxent", "wasserstein"])
def test_weighted_losses_match_reference(name, rng):
    lab, pred = _inputs(name, rng, (N, T, C))
    weights = rng.uniform(0.5, 2.0, C).astype(np.float32)
    mask = _masks(rng, (N, T))["mask"]
    fn_j, _ = J.resolve(name)
    fn_p, _ = P.resolve(name)
    got, want = _both(fn_j, fn_p, lab, pred, mask, weights)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_mask_mean_counts_unmasked_entries():
    per = torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    mask = torch.tensor([[1.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    assert float(P._apply_mask_mean(per, mask)) == pytest.approx(10.0 / 3)
    # an all-zero mask divides by 1, not by 0
    assert float(P._apply_mask_mean(per, torch.zeros(2, 3))) == 0.0
    assert float(P._apply_mask_mean(per, None)) == pytest.approx(3.5)


def test_resolve_names_and_errors():
    assert P.names() == J.names()
    fn, logits = P.resolve("MCXENT", "softmax")
    assert fn is P.mcxent_logits and logits
    fn, logits = P.resolve("mcxent", "sigmoid")
    assert fn is P.mcxent_probs and not logits
    custom = lambda lab, pred, mask=None, weights=None: pred.sum()  # noqa: E731
    assert P.resolve(custom, "softmax") == (custom, False)
    with pytest.raises(ValueError, match="Unknown loss"):
        P.resolve("nope")
