"""What both networks offer beside training and inference.

``MultiLayerNetwork`` (``nn/multilayer.py``) and ``ComputationGraph``
(``nn/graph.py``) mix in :class:`NetworkApi`: listeners, the runtime
learning-rate override, parameter counts, ``clone`` and the ROC
evaluators, as the reference's two networks each define them. The module
functions are the parts of ``fit_batches_on_device``,
``to_computation_graph`` and ``score_examples`` that do not depend on the
network's shape.

Listeners are duck-typed, as in the reference: any object with
``on_epoch_start(model)``, ``on_epoch_end(model)`` or
``iteration_done(model, iteration, epoch)`` hears that event; a listener
reading ``model.score_`` gets that step's loss (one host read, which the
step itself never makes).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from deeplearning4j_tpu_torch.eval.roc import ROC, ROCBinary, ROCMultiClass
from deeplearning4j_tpu_torch.nn.layers.core import (
    EmbeddingSequenceLayer,
    unchecked_token_ids,
)
from deeplearning4j_tpu_torch.nn.dtensor import full, mesh_scope
from deeplearning4j_tpu_torch.nn.train_step import as_tensor


class NetworkApi:
    """Mixed into both networks; reads their ``conf``, ``device``,
    ``params``, ``states``, ``updater_states``, ``_updaters``,
    ``dropout_generator``, ``listeners``, ``step_end_hooks``,
    ``_step_depth``, ``_named_layers()`` and ``_host_outputs(iterator,
    masks)``."""

    # ------------------------------------------------------------ listeners
    def set_listeners(self, *listeners) -> None:
        self.listeners = list(listeners)

    def add_listeners(self, *listeners) -> None:
        self.listeners.extend(listeners)

    def _notify(self, hook: str, *args) -> None:
        """``hook(self, *args)`` on every listener that has it."""
        for listener in self.listeners:
            if hasattr(listener, hook):
                getattr(listener, hook)(self, *args)

    @contextlib.contextmanager
    def training_step(self):
        """Marks the training step that runs inside it: ``in_step`` is
        true there, and each of ``step_end_hooks`` runs when the outermost
        such step ends. A preemption signal that lands inside a step
        (between two in-place updates of one batch, or before its
        iteration is counted) is saved by such a hook at the step's end
        (``util/preemption.py``)."""
        depth = self._step_depth
        self._step_depth = depth + 1
        try:
            with mesh_scope(self):
                yield
        finally:
            self._step_depth = depth
        if not depth:
            for hook in list(self.step_end_hooks):
                hook()

    @property
    def in_step(self) -> bool:
        return self._step_depth > 0

    def _window_done(self, first_iteration: int, losses) -> None:
        """After a window of steps (``fit_batches_on_device``): each step's
        loss, iteration and ``iteration_done`` in turn, as if each batch
        had been fitted alone (the reference's order)."""
        for i, loss in enumerate(losses):
            self._score = loss
            self.iteration = first_iteration + i + 1
            self._notify("iteration_done", self.iteration, self.epoch)

    # ----------------------------------------------------------- parameters
    def set_learning_rate(self, lr) -> None:
        """Every updater's learning rate set to ``lr`` (``setLearningRate``).
        The updaters are frozen dataclasses, so each is replaced by a copy
        of its own type; the updater state carries over, and a helper that
        took a tensor's updater (the fused Adam kernel) still takes it. The
        layers' and the global updater are replaced too, so that a
        configuration written afterwards carries ``lr``."""
        def rep(u):
            return (dataclasses.replace(u, learning_rate=lr)
                    if hasattr(u, "learning_rate") else u)

        self._updaters = {k: {n: rep(u) for n, u in named.items()}
                          for k, named in self._updaters.items()}
        for _, layer in self._named_layers():
            if layer.updater is not None:
                layer.updater = rep(layer.updater)
        g = self.conf.global_conf
        if g.updater is not None:
            g.updater = rep(g.updater)

    def num_params(self) -> int:
        """The number of parameters: the configuration's count before
        ``init``, the tensors' after it (``numParams``)."""
        if self.params is None:
            return self.conf.num_params()
        return sum(t.numel() for named in self.params.values()
                   for t in named.values())

    def clone(self):
        """An independent copy (``clone``) on the same device and
        configuration: copies of the parameters, layer states and updater
        states, the same updaters, iteration and epoch, and the dropout
        generator's state, so that the copy draws the same masks."""
        other = type(self)(self.conf, device=self.device)
        if self.params is None:
            return other
        other.init()
        carry_over(other, self)
        other._updaters = {k: dict(named) for k, named in self._updaters.items()}
        return other

    # ------------------------------------------------------------ evaluation
    def _evaluated(self, evaluator, iterator, masks: bool = True):
        """``evaluator`` after ``eval`` of every batch's labels and output
        (on the host, bf16 widened) with the label mask."""
        for labels, out, lmask, _ in self._host_outputs(iterator, masks):
            evaluator.eval(labels, out, mask=lmask)
        return evaluator

    def evaluate_roc(self, iterator, threshold_steps: int = 0) -> ROC:
        """Binary ROC of the output over an iterator (``evaluateROC``);
        ``threshold_steps > 0`` is the binned, mergeable mode."""
        return self._evaluated(ROC(threshold_steps=threshold_steps), iterator)

    def evaluate_roc_multi_class(self, iterator,
                                 threshold_steps: int = 0) -> ROCMultiClass:
        """One-vs-all ROC per class (``evaluateROCMultiClass``)."""
        return self._evaluated(ROCMultiClass(threshold_steps=threshold_steps),
                               iterator)

    def evaluate_roc_binary(self, iterator,
                            threshold_steps: int = 0) -> ROCBinary:
        """Per-output binary ROC of a multi-label head."""
        return self._evaluated(ROCBinary(threshold_steps=threshold_steps),
                               iterator)


def _copy_tree(dst: dict, src: dict) -> None:
    for n, v in src.items():
        if isinstance(v, dict):
            _copy_tree(dst[n], v)
        elif isinstance(v, torch.Tensor):
            dst[n].copy_(full(v))  # a network on a mesh: the full value
        else:
            dst[n] = v


def carry_over(dst, src, keys=None) -> None:
    """``src``'s parameters, layer states and updater states copied into
    ``dst``'s tensors in place (``keys``: src key -> dst key, identity by
    default), with its iteration, epoch and dropout generator state."""
    keys = keys or {k: k for k in src.params}
    with torch.no_grad():
        for mine, theirs in ((dst.params, src.params), (dst.states, src.states),
                             (dst.updater_states, src.updater_states)):
            for k_src, k_dst in keys.items():
                _copy_tree(mine[k_dst], theirs[k_src])
    dst.iteration, dst.epoch = src.iteration, src.epoch
    dst.dropout_generator.set_state(src.dropout_generator.get_state())


def stack_window(arrays, dtype: torch.dtype, device) -> torch.Tensor:
    """Equal-shape batches as one ``[K, ...]`` tensor on ``device``, stacked
    where they lie (host batches: one host-to-device copy for the window);
    floating data in ``dtype``, as :func:`as_tensor` casts one batch."""
    ts = [a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
          for a in arrays]
    shapes = sorted({tuple(t.shape) for t in ts})
    if len(shapes) > 1:
        raise ValueError(f"fit_batches_on_device needs batches of one shape; "
                         f"got {shapes}")
    return as_tensor(torch.stack([t.to(ts[0].device) for t in ts]), dtype,
                     device)


def checked_window_ids(fed):
    """``fed``: one ``(layer, ids)`` for each embedding layer of a network,
    ``ids`` the window's stacked ids of the input that feeds it (None when
    another layer feeds it). Checks each window's ids once, before the
    steps, and returns the context the steps run in: when every
    embedding's ids were checked, one that skips the per-step check
    (which reads the ids back and waits for the device)."""
    for layer, ids in fed:
        if ids is not None:
            layer.check_ids(ids)
    if all(ids is not None for _, ids in fed):
        return unchecked_token_ids()
    return contextlib.nullcontext()


def summary_table(headers, widths, rows, total: int) -> str:
    """The reference's ``summary()`` text: ``headers`` are the titles of
    the first, second and last columns (the third is the parameter
    count), ``widths`` the least widths of the first two, one row
    ``(first, second, count, last)`` a layer, then the total."""
    h0, h1, last = headers
    w0 = max(widths[0], max(len(r[0]) for r in rows))
    w1 = max(widths[1], max(len(r[1]) for r in rows))
    w2 = max(8, max(len(r[2]) for r in rows))
    lines = ["=" * 76, f"{h0:<{w0}}  {h1:<{w1}}  {'params':>{w2}}  {last}",
             "-" * 76]
    lines += [f"{r[0]:<{w0}}  {r[1]:<{w1}}  {r[2]:>{w2}}  {r[3]}" for r in rows]
    lines += ["-" * 76, f"Total parameters: {total:,}", "=" * 76]
    return "\n".join(lines)


def example_losses(layer, params, h, labels, mask=None) -> torch.Tensor:
    """Each row's loss from the output layer's input ``h`` ([N, ...]): the
    layer's ``compute_loss`` on a batch of that one row (with its row of
    ``mask``), vmapped over the rows. Only the loss head runs under the
    ``vmap``; the layers before it (and their kernels) ran batched."""
    if mask is None:
        return torch.func.vmap(
            lambda hi, yi: layer.compute_loss(params, hi[None], yi[None]))(h, labels)
    return torch.func.vmap(
        lambda hi, yi, mi: layer.compute_loss(params, hi[None], yi[None],
                                              mask=mi[None]))(h, labels, mask)
