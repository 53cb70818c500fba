"""Convex optimizers: SGD, line-search gradient descent, conjugate gradient,
L-BFGS, with backtracking line search.

Counterpart of ``deeplearning4j_tpu/optimize/solvers.py`` (reference
``optimize/solvers/``: ``BaseOptimizer.java``,
``StochasticGradientDescent.java:42``, ``LineGradientDescent.java``,
``ConjugateGradient.java`` (Polak-Ribiere+, the max(gamma, 0) descent
guarantee), ``LBFGS.java`` (m=4 two-loop recursion),
``BackTrackLineSearch.java`` (Armijo backtracking with quadratic/cubic
interpolation, relTolx/absTolx exits)).

The state is one flat parameter vector on the network's device.
Directions, gradients and the L-BFGS history are float64 tensors there;
what a branch decides on (scores, the slope, the step floors, the
curvature test) is read to the host as a Python float, so that every
branch is the JAX package's. ``value_and_grad(x) -> (score, grad)`` is
one autograd pass; the line search's trip count is data-dependent and
tiny (at most ``max_iterations`` forward passes), so its loop runs on the
host.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch

ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _f64(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to(torch.float64)


# --------------------------------------------------------------------------
# termination conditions (optimize/terminations/ parity)
# --------------------------------------------------------------------------
class TerminationCondition:
    def terminate(self, new_score: float, old_score: float, grad) -> bool:
        raise NotImplementedError


class EpsTermination(TerminationCondition):
    """Stop when the relative score improvement drops below eps."""

    def __init__(self, eps: float = 1e-5, tolerance: float = 1e-8):
        self.eps = eps
        self.tolerance = tolerance

    def terminate(self, new_score, old_score, grad):
        return (2.0 * abs(old_score - new_score)
                <= self.tolerance + self.eps * (abs(old_score) + abs(new_score)))


class Norm2Termination(TerminationCondition):
    """Stop when the gradient 2-norm drops below the threshold."""

    def __init__(self, gradient_norm_threshold: float = 1e-6):
        self.threshold = gradient_norm_threshold

    def terminate(self, new_score, old_score, grad):
        return float(torch.linalg.norm(_f64(grad))) < self.threshold


class ZeroDirection(TerminationCondition):
    """Stop when the search direction is numerically zero."""

    def terminate(self, new_score, old_score, grad):
        return float(_f64(grad).abs().max()) == 0.0


# --------------------------------------------------------------------------
# line search
# --------------------------------------------------------------------------
class BackTrackLineSearch:
    """Armijo backtracking with quadratic-then-cubic interpolation.

    Minimises phi(step) = f(x - step * d) where d is a descent-compatible
    direction (slope -d.g < 0). Exits: sufficient decrease (Armijo,
    ALF=1e-4), step below the relative-tolerance floor (returns 0: the
    caller keeps x), or max iterations (returns the best step seen if it
    improved). Mirrors ``BackTrackLineSearch.java:159`` behaviourally.
    """

    ALF = 1e-4

    def __init__(self, value_fn: Callable[[torch.Tensor], torch.Tensor],
                 max_iterations: int = 5, step_max: float = 100.0,
                 rel_tolx: float = 1e-7, abs_tolx: float = 1e-4):
        self.value_fn = value_fn
        self.max_iterations = max_iterations
        self.step_max = step_max
        self.rel_tolx = rel_tolx
        self.abs_tolx = abs_tolx

    def optimize(self, x: torch.Tensor, score0: float, grad,
                 direction) -> float:
        d = _f64(direction).to(x.device)
        g = _f64(grad).to(x.device)
        dnorm = float(torch.linalg.norm(d))
        if dnorm == 0.0:
            return 0.0
        scale = 1.0
        if dnorm > self.step_max:
            # attempted step too big: scale (BackTrackLineSearch.java:195-198).
            # The returned step is rescaled so callers can apply it to the
            # ORIGINAL direction.
            scale = self.step_max / dnorm
            d = d * scale
        xs = x.detach().to(torch.float64)
        # the slope, the tolerance floor from the search DIRECTION (the
        # quantity actually scaled by step, as in NR lnsrch) and the
        # largest entry of d, read in one transfer
        slope, test, dmax = torch.stack([
            -torch.dot(d, g),
            (d.abs() / xs.abs().clamp_min(1.0)).max(),
            d.abs().max()]).tolist()
        if slope >= 0.0:
            return 0.0  # not a descent direction
        step_min = self.rel_tolx / max(test, 1e-300)
        step, step2 = 1.0, 0.0
        score2 = score0
        best_score, best_step = score0, 0.0
        d_dev = d.to(x.dtype)
        for _ in range(self.max_iterations):
            if step < step_min:
                return 0.0  # jump too small; keep original params
            if step * dmax < self.abs_tolx:
                return 0.0
            score = float(self.value_fn(x - step * d_dev))
            if math.isfinite(score) and score < best_score:
                best_score, best_step = score, step
            # Armijo sufficient decrease
            if score <= score0 + self.ALF * step * slope:
                return step * scale
            # backtrack: quadratic on first shrink, cubic after
            if not math.isfinite(score):
                tmp = 0.1 * step
            elif step == 1.0:
                denom = 2.0 * (score - score0 - slope)
                tmp = -slope / denom if denom != 0 else 0.5 * step
            else:
                rhs1 = score - score0 - step * slope
                rhs2 = score2 - score0 - step2 * slope
                denom = step - step2
                a = (rhs1 / step**2 - rhs2 / step2**2) / denom
                b = (-step2 * rhs1 / step**2 + step * rhs2 / step2**2) / denom
                if a == 0.0:
                    tmp = -slope / (2.0 * b) if b != 0 else 0.5 * step
                else:
                    disc = b * b - 3.0 * a * slope
                    if disc < 0.0:
                        tmp = 0.5 * step
                    else:
                        tmp = (-b + math.sqrt(disc)) / (3.0 * a)
                tmp = min(tmp, 0.5 * step)
            step2, score2 = step, score
            step = max(tmp, 0.1 * step)
        # exited on maxIterations: use best step if it improved the score
        return best_step * scale if best_score < score0 else 0.0


# --------------------------------------------------------------------------
# optimizers
# --------------------------------------------------------------------------
class ConvexOptimizer:
    """Full-batch iterative optimizer over a flat parameter vector.

    ``optimize(value_and_grad, x0)`` runs up to ``max_iterations`` outer
    iterations: compute score and gradient (one autograd pass), choose a
    search direction, line-search along it, update history. Subclasses
    define the direction (``BaseOptimizer.optimize`` structure).
    """

    def __init__(self, max_iterations: int = 100, line_search_iterations: int = 5,
                 step_max: float = 100.0,
                 termination_conditions: Optional[List[TerminationCondition]] = None):
        self.max_iterations = max_iterations
        self.line_search_iterations = line_search_iterations
        self.step_max = step_max
        self.terminations = (termination_conditions
                             if termination_conditions is not None
                             else [EpsTermination(), Norm2Termination(), ZeroDirection()])
        self.score_history: List[float] = []

    # subclass hooks
    def _reset(self, n: int):
        pass

    def _direction(self, grad: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _post_step(self, x_old, x_new, g_old, g_new, direction, step):
        pass

    def optimize(self, value_and_grad: ValueAndGrad, x0) -> torch.Tensor:
        x = torch.as_tensor(x0)
        self._reset(x.shape[0])
        self.score_history = []
        score_dev, grad_dev = value_and_grad(x)
        score, grad = float(score_dev), _f64(grad_dev)
        self.score_history.append(score)
        ls = BackTrackLineSearch(lambda p: value_and_grad(p)[0],
                                 self.line_search_iterations, self.step_max)
        for _ in range(self.max_iterations):
            d = self._direction(grad)
            step = ls.optimize(x, score, grad, d)
            if step == 0.0 and d is not grad:
                # stale curvature can make the direction fail the line search
                # (Armijo is inexact): restart from steepest descent
                self._reset(x.shape[0])
                d = grad
                step = ls.optimize(x, score, grad, d)
            if step == 0.0:
                break
            x_new = x - step * d.to(x.dtype)
            new_score_dev, new_grad_dev = value_and_grad(x_new)
            new_score = float(new_score_dev)
            new_grad = _f64(new_grad_dev)
            self._post_step(_f64(x), _f64(x_new), grad, new_grad, d, step)
            stop = any(t.terminate(new_score, score, new_grad)
                       for t in self.terminations)
            x, score, grad = x_new, new_score, new_grad
            self.score_history.append(score)
            if stop:
                break
        self.final_score = score
        return x


class StochasticGradientDescent(ConvexOptimizer):
    """Fixed-step SGD on the flat vector (``StochasticGradientDescent.java:42``
    runs one gradient step per call; the network's own train step is the
    production path — this class exists for the solver SPI)."""

    def __init__(self, learning_rate: float = 0.1, max_iterations: int = 100,
                 **kw):
        super().__init__(max_iterations=max_iterations, **kw)
        self.learning_rate = learning_rate

    def optimize(self, value_and_grad: ValueAndGrad, x0) -> torch.Tensor:
        x = torch.as_tensor(x0)
        self.score_history = []
        score = None
        for _ in range(self.max_iterations):
            score_dev, grad_dev = value_and_grad(x)
            new_score = float(score_dev)
            if self.score_history and any(
                    t.terminate(new_score, self.score_history[-1], grad_dev)
                    for t in self.terminations):
                self.score_history.append(new_score)
                break
            self.score_history.append(new_score)
            x = x - self.learning_rate * grad_dev
            score = new_score
        self.final_score = self.score_history[-1] if self.score_history else score
        return x


class LineGradientDescent(ConvexOptimizer):
    """Steepest descent with backtracking line search
    (``LineGradientDescent.java``: search direction == gradient)."""

    def _direction(self, grad):
        return grad


class ConjugateGradient(ConvexOptimizer):
    """Nonlinear CG, Polak-Ribiere+ (``ConjugateGradient.java``): gamma =
    max(((g_new - g_old) . g_new) / (g_old . g_old), 0) guarantees a descent
    direction (Nocedal & Wright Ch5); gamma == 0 degrades to steepest
    descent."""

    def _reset(self, n):
        self._search_dir = None

    def _direction(self, grad):
        return grad if self._search_dir is None else self._search_dir

    def _post_step(self, x_old, x_new, g_old, g_new, direction, step):
        gg = torch.dot(g_old, g_old)
        dgg = torch.dot(g_new - g_old, g_new)
        gamma = torch.where(gg > 0, (dgg / gg).clamp_min(0.0), torch.zeros_like(gg))
        self._search_dir = g_new + gamma * direction


class LBFGS(ConvexOptimizer):
    """Limited-memory BFGS with the standard two-loop recursion
    (``LBFGS.java``, m=4; Nocedal & Wright 7.2). History pairs with
    non-positive curvature (s.y <= 1e-10) are skipped to keep the implicit
    Hessian positive-definite."""

    def __init__(self, m: int = 4, **kw):
        super().__init__(**kw)
        self.m = m

    def _reset(self, n):
        self._s: List[torch.Tensor] = []  # param diffs, most recent first
        self._y: List[torch.Tensor] = []  # grad diffs, most recent first
        self._rho: List[torch.Tensor] = []

    def _direction(self, grad):
        q = grad.clone()
        if not self._s:
            return q
        alpha = []
        for s, y_, rho in zip(self._s, self._y, self._rho):
            a = rho * torch.dot(s, q)
            q -= a * y_
            alpha.append(a)
        # initial Hessian scaling gamma = (s.y)/(y.y) of most recent pair
        s0, y0 = self._s[0], self._y[0]
        gamma = torch.dot(s0, y0) / torch.dot(y0, y0).clamp_min(1e-300)
        r = gamma * q
        for (s, y_, rho), a in zip(
                reversed(list(zip(self._s, self._y, self._rho))), reversed(alpha)):
            beta = rho * torch.dot(y_, r)
            r += (a - beta) * s
        return r

    def _post_step(self, x_old, x_new, g_old, g_new, direction, step):
        s = x_new - x_old
        y_ = g_new - g_old
        sy = torch.dot(s, y_)
        if float(sy) <= 1e-10:
            return  # curvature condition failed; skip pair
        self._s.insert(0, s)
        self._y.insert(0, y_)
        self._rho.insert(0, 1.0 / sy)
        if len(self._s) > self.m:
            self._s.pop()
            self._y.pop()
            self._rho.pop()


# --------------------------------------------------------------------------
# Solver: model-level front end
# --------------------------------------------------------------------------
_ALGOS = {
    "stochastic_gradient_descent": StochasticGradientDescent,
    "line_gradient_descent": LineGradientDescent,
    "conjugate_gradient": ConjugateGradient,
    "lbfgs": LBFGS,
}


def flat_leaves(params):
    """``[(key, name, tensor)]`` in the JAX package's flat order
    (``ravel_pytree``): keys sorted (layer indices in order, vertex names
    by name), each key's parameter names sorted."""
    return [(k, n, params[k][n]) for k in sorted(params) for n in sorted(params[k])]


def unflatten(flat: torch.Tensor, params):
    """Views of ``flat`` keyed and shaped as ``params`` (a layer with no
    parameters keeps its empty dict), in :func:`flat_leaves` order."""
    out, offset = {k: {} for k in params}, 0
    for k, n, t in flat_leaves(params):
        out[k][n] = flat[offset:offset + t.numel()].view(t.shape)
        offset += t.numel()
    return out


class Solver:
    """Full-batch solver for a ``MultiLayerNetwork``, dispatching on
    ``conf.optimization_algo`` (``Solver.Builder`` →
    ``NeuralNetConfiguration.optimizationAlgo`` parity). Flattens the
    parameters once in the JAX package's order, builds one (score,
    gradient) closure over the DataSet with autograd on the network's
    inference loss, runs the chosen optimizer on the network's device, and
    writes the result back into the parameter tensors in place."""

    def __init__(self, model, algo: Optional[str] = None,
                 max_iterations: int = 100, **opt_kwargs):
        self.model = model
        self.algo = algo or model.conf.global_conf.optimization_algo
        self.max_iterations = max_iterations
        self.opt_kwargs = opt_kwargs

    class Builder:
        def __init__(self):
            self._model = None
            self._algo = None
            self._max_iterations = 100

        def model(self, m):
            self._model = m
            return self

        def configure(self, conf):
            self._algo = getattr(conf, "optimization_algo", None)
            return self

        def max_iterations(self, n):
            self._max_iterations = n
            return self

        def build(self) -> "Solver":
            return Solver(self._model, self._algo, self._max_iterations)

    def optimize(self, ds) -> float:
        """Optimize the model's params on the (full-batch) DataSet; returns
        the final score."""
        net = self.model
        if net.params is None:
            net.init()
        if self.algo not in _ALGOS:
            raise ValueError(f"Unknown optimization algorithm: {self.algo!r} "
                             f"(choose from {sorted(_ALGOS)})")
        # the inference loss (no train-time noise, inference statistics)
        x, y, mask, lmask = net._batch(ds)
        flat0 = torch.cat([t.detach().reshape(-1) for _, _, t in flat_leaves(net.params)])

        def vag(flat):
            f = flat.detach().requires_grad_(True)
            with torch.enable_grad():
                loss, _ = net._loss_fn(unflatten(f, net.params), x, y, mask, lmask)
                (grad,) = torch.autograd.grad(loss, f)
            return loss.detach(), grad

        kwargs = dict(self.opt_kwargs)
        if self.algo != "stochastic_gradient_descent":
            kwargs.setdefault("line_search_iterations",
                              net.conf.global_conf.max_num_line_search_iterations)
        opt = _ALGOS[self.algo](max_iterations=self.max_iterations, **kwargs)
        flat = opt.optimize(vag, flat0)
        with torch.no_grad():
            for k, named in unflatten(flat, net.params).items():
                for n, v in named.items():
                    net.params[k][n].copy_(v)
        self.score_history = opt.score_history
        return opt.final_score
