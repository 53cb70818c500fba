"""Gradient check harness — the correctness backbone.

Counterpart of ``deeplearning4j_tpu/util/gradient_check.py`` (reference
``deeplearning4j-nn/.../gradientcheck/GradientCheckUtil.java:109``):
central finite differences ``(C(w+ε)−C(w−ε))/2ε`` against autograd's
gradient, the relative error of each checked coordinate against
``max_rel_error`` (errors below ``min_abs_error`` pass).

Runs in float64 (DL4J requires double precision too, GradientCheckUtil doc
``:47``) on copies of the parameters, states and inputs, on the model's
device. Leaves are visited in the JAX package's ``tree_flatten`` order
(dict keys sorted, lists in order) and each leaf's ``subset`` coordinates
drawn from one ``np.random.default_rng(seed)`` in that order, so both
packages check the same coordinates.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _leaves(tree, path=()):
    """``[(path, tensor)]`` in ``tree_flatten`` order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree) for leaf in _leaves(v, path + (i,))]
    return [(path, tree)]


def _rebuild(tree, values, it=None):
    """``tree``'s structure with its leaves taken from ``values`` in order."""
    it = iter(values) if it is None else it
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], None, it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, None, it) for v in tree)
    return next(it)


def _to64(t, device=None) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(t) if not isinstance(t, torch.Tensor) else t)
    return t.detach().to(device=device or t.device, dtype=torch.float64).clone()


def check_gradients_fn(loss_fn: Callable, params, *, epsilon: float = 1e-6,
                       max_rel_error: float = 1e-5, min_abs_error: float = 1e-8,
                       print_results: bool = False, subset: Optional[int] = None,
                       seed: int = 0, report: Optional[dict] = None) -> bool:
    """Check autograd's gradient of ``loss_fn`` against central finite
    differences.

    loss_fn: params -> scalar tensor. params: a tree of tensors (dicts and
    lists). subset: if set, check only this many randomly chosen
    coordinates per parameter (large layers would otherwise need millions
    of evaluations). ``report`` (a dict), when given, receives
    ``max_rel_error`` (the largest significant relative error: the
    reference's reading), ``max_rel_error_any`` (the largest over every
    checked coordinate), ``coordinates`` (``(leaf index, flat index)``
    checked, in order) and ``failures``.
    """
    leaves = [_to64(t) for _, t in _leaves(params)]
    live = [t.clone().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        loss = loss_fn(_rebuild(params, live))
        analytic = torch.autograd.grad(loss, live, allow_unused=True,
                                       materialize_grads=True)
    rng = np.random.default_rng(seed)
    ok = True
    max_err_seen = max_err_any = 0.0
    coords, failures = [], []
    with torch.no_grad():
        for li, (leaf, g) in enumerate(zip(leaves, analytic)):
            flat = leaf.view(-1)  # perturbed in place, restored after
            gflat = g.reshape(-1).cpu().numpy()
            n = flat.numel()
            idxs = (rng.choice(n, size=min(subset, n), replace=False)
                    if subset is not None and subset < n else range(n))
            for i in idxs:
                i = int(i)
                orig = float(flat[i])
                flat[i] = orig + epsilon
                lp = float(loss_fn(_rebuild(params, leaves)))
                flat[i] = orig - epsilon
                lm = float(loss_fn(_rebuild(params, leaves)))
                flat[i] = orig
                numeric = (lp - lm) / (2 * epsilon)
                a = float(gflat[i])
                abs_err = abs(a - numeric)
                denom = abs(a) + abs(numeric)
                rel = abs_err / denom if denom > 0 else 0.0
                max_err_seen = max(max_err_seen, rel if abs_err > min_abs_error else 0.0)
                max_err_any = max(max_err_any, rel)
                coords.append((li, i))
                if rel > max_rel_error and abs_err > min_abs_error:
                    ok = False
                    failures.append((li, i, a, numeric, rel))
                    if print_results:
                        print(f"  FAIL leaf {li} idx {i}: analytic={a:.3e} "
                              f"numeric={numeric:.3e} rel={rel:.3e}")
    if print_results:
        print(f"gradient check {'PASSED' if ok else 'FAILED'}; "
              f"max rel error (significant): {max_err_seen:.3e}")
    if report is not None:
        report.update(max_rel_error=max_err_seen, max_rel_error_any=max_err_any,
                      coordinates=coords, failures=failures)
    return ok


class _States64:
    """The model's layer states swapped for float64 copies while the check
    runs (the loss reads them from the model)."""

    def __init__(self, model):
        self.model = model

    def __enter__(self):
        self.saved = self.model.states
        self.model.states = {k: {n: _to64(t) for n, t in named.items()}
                             for k, named in (self.saved or {}).items()}

    def __exit__(self, *exc):
        self.model.states = self.saved


def check_model_gradients(model, x, y, *, features_mask=None, labels_mask=None,
                          epsilon: float = 1e-6,
                          max_rel_error: float = 1e-5, min_abs_error: float = 1e-8,
                          subset: Optional[int] = 64, seed: int = 0,
                          print_results: bool = False,
                          report: Optional[dict] = None) -> bool:
    """GradientCheckUtil.checkGradients for a ``MultiLayerNetwork``: its
    inference loss (``_loss_fn``, l1/l2 included) in float64 on its
    device."""
    dev = model.device
    x, y = _to64(x, dev), _to64(y, dev)
    fm = None if features_mask is None else _to64(features_mask, dev)
    lm = None if labels_mask is None else _to64(labels_mask, dev)
    with _States64(model):
        return check_gradients_fn(
            lambda p: model._loss_fn(p, x, y, fm, lm)[0], model.params,
            epsilon=epsilon, max_rel_error=max_rel_error,
            min_abs_error=min_abs_error, subset=subset, seed=seed,
            print_results=print_results, report=report)


def check_graph_gradients(graph, features, labels, *, epsilon: float = 1e-6,
                          max_rel_error: float = 1e-5, min_abs_error: float = 1e-8,
                          subset: Optional[int] = 64, seed: int = 0,
                          print_results: bool = False,
                          report: Optional[dict] = None) -> bool:
    """Gradient check for a ``ComputationGraph`` (multi-input/multi-output;
    reference ``GradientCheckUtil.checkGradients`` ComputationGraph
    overload)."""
    if not isinstance(features, (list, tuple)):
        features = [features]
    if not isinstance(labels, (list, tuple)):
        labels = [labels]
    dev = graph.device
    inputs = {n: _to64(f, dev) for n, f in zip(graph.conf.inputs, features)}
    labs = [_to64(l, dev) for l in labels]
    with _States64(graph):
        return check_gradients_fn(
            lambda p: graph._loss_fn(p, inputs, labs, None, None), graph.params,
            epsilon=epsilon, max_rel_error=max_rel_error,
            min_abs_error=min_abs_error, subset=subset, seed=seed,
            print_results=print_results, report=report)
