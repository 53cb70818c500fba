"""MultiLayerNetwork — a sequential network over a MultiLayerConfiguration.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py``: ``init``
(parameters and one updater state per tensor), ``_forward_all`` with
recurrent carries, ``_regularization``, ``_loss_fn``, ``_apply_updates``
(the "updater" helper seam consulted per tensor), ``fit`` over arrays,
``DataSet`` or iterators with standard backprop or truncated BPTT,
``output``, ``predict``, ``score``, ``compute_gradient_and_score``, the
stateful RNN API (``rnn_time_step`` and the stored-state accessors),
``feed_forward``/``feed_forward_to_layer``, ``evaluate``, ``f1_score``,
``label_probabilities``, the parameter accessors (``param_table``,
``get_param``, ``set_param``, ``num_labels``, ``params_flat`` /
``set_params_flat``, ``num_params``, ``set_learning_rate``), the getters
(``n_layers``, ``get_layer``, ``get_layers``, ``get_output_layer``,
``get_layer_names``, ``layer_size``), ``summary``, ``clone``,
``to_computation_graph``, ``score_examples``, the evaluators
(``evaluate``, ``evaluate_roc``, ``evaluate_roc_multi_class``,
``evaluate_roc_binary``, ``evaluate_regression``), listeners,
``fit_batches_on_device`` and the model zip (``save``,
``MultiLayerNetwork.load``, through ``util/model_serializer.py``).

The network is an ``nn.Module`` whose parameters keep the reference's
names and layouts, registered as ``<layer index>/<param>``; ``params`` holds
the same tensors as ``{index: {param: tensor}}`` (the reference keeps a
list of per-layer dicts; ``util/convert.py`` carries them across). The
step's pieces are the ones ``ComputationGraph`` uses too
(``nn/train_step.py``): parameters never require grad, a step
differentiates detached aliases of them and updates them in place.

Layer state (BatchNorm's running statistics) sits in ``states``, keyed
by layer index like ``params``: a train forward returns each stateful
layer's new state and the step writes it over the old one, once per
``fit`` step or TBPTT chunk; ``output``, ``feed_forward``, ``evaluate``,
``score`` and ``compute_gradient_and_score`` read it (inference
statistics).

Truncated BPTT cuts each sequence into chunks of ``tbptt_fwd_length``
steps; each chunk is one iteration (one update, one Adam step count) and
hands its final recurrent carry, detached, to the next chunk.

Regularizers: a train step runs inside ``schedule_tick(iteration,
epoch)`` and draws from the network's own dropout generator
(``dropout_generator``, on its device, apart from the init generator), in
layer order: each layer's weight noise before its forward, its input
dropout in the forward, the output layer's weight noise after all the
others; each TBPTT chunk draws anew. ``output``, ``evaluate``,
``feed_forward``, ``score`` and ``compute_gradient_and_score`` never draw.
Gradient normalization and constraints run per layer around the updater
seam (``nn/train_step.py``). ``fit`` wraps an iterator in asynchronous
prefetch (``datasets/iterators.py``, ``prefetch_depth``), whose batches
reach the step already on the device.

Mixed precision (``compute_dtype``) is the reference's: the f32 master
parameters and floating inputs are cast to the compute dtype inside the
forward, so gradients, updates, optimizer state and layer state stay
f32; the loss head runs in f32; ``output`` and ``rnn_time_step`` answer
in the compute dtype; ``feed_forward`` runs uncast, as the reference's
does. Integer inputs are never cast.

Parameters are written in place: ``set_param``, ``set_params_flat`` and
every update copy into the tensors that the updater state and a fused
updater kernel point at. ``fit_batches_on_device`` stacks a window of
batches on the device once and runs the same step once per batch with no
host synchronisation between steps; listeners then hear each step (the
reference's order). Listeners hear ``on_epoch_start``/``on_epoch_end``
around each epoch of ``fit``, and ``iteration_done`` after each step (once
after the chunks of a TBPTT batch, as in the reference).

Layerwise pretraining (``pretrain``, ``pretrain_layer``): each layer with
a ``pretrain_loss`` (VAE, autoencoder) minimizes it alone on the
features of the layers below, through the same updater seam and updater
state as ``fit`` (``nn/train_step.py`` ``pretrain_step``).

Gradient checkpointing (``gradient_checkpointing`` in the configuration):
in a train forward each layer outside a carried recurrence runs under
``nn/train_step.py`` ``checkpointed_forward``, so its activations are
recomputed in the backward pass, the same draws replayed (the
reference's ``jax.checkpoint`` per layer). Weight noise is drawn before,
outside the recompute.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, batch_nbytes
from deeplearning4j_tpu_torch.datasets.iterators import wrap_for_prefetch
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation
from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphBuilder
from deeplearning4j_tpu_torch.nn.conf.network import (
    MultiLayerConfiguration,
    normalize_backprop_type,
)
from deeplearning4j_tpu_torch.nn.dtensor import full, inference, mesh_scope, place_input
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers.core import EmbeddingSequenceLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    BaseRecurrentLayer,
    check_carry_capacity,
    map_carry,
    own_carry,
)
from deeplearning4j_tpu_torch.nn.network_api import (
    NetworkApi,
    carry_over,
    checked_window_ids,
    example_losses,
    stack_window,
    summary_table,
)
from deeplearning4j_tpu_torch.nn.tick import schedule_tick
from deeplearning4j_tpu_torch.nn.train_step import (
    apply_updates,
    as_tensor,
    checkpointed_forward,
    commit_states,
    compute_cast,
    compute_cast_tree,
    dropout_generator,
    gradients,
    init_parameters,
    init_states,
    pretrain_batches,
    pretrain_step,
    regularization,
    to_host,
)
from deeplearning4j_tpu_torch.util import model_serializer


class MultiLayerNetwork(NetworkApi, nn.Module):
    """Sequential network. ``device=None`` places it on ``cuda`` and raises
    when there is none; ``device="cpu"`` runs it on the CPU."""

    def __init__(self, conf: MultiLayerConfiguration, device=None):
        super().__init__()
        conf.finalize()
        self.conf = conf
        self.layers = conf.layers
        self.device = resolve_device(device)
        self.dtype = conf.global_conf.torch_dtype()
        # mixed precision: the forward's dtype (None: the parameters' own)
        self.compute_dtype = conf.global_conf.torch_compute_dtype()
        self.params: Optional[Dict[int, Dict[str, torch.Tensor]]] = None
        # non-trainable layer state (BatchNorm's running statistics)
        self.states: Optional[Dict[int, Dict[str, torch.Tensor]]] = None
        self.updater_states: Optional[Dict[int, Dict[str, Dict[str, torch.Tensor]]]] = None
        self._updaters: Dict[int, dict] = {}
        self.iteration = 0
        self.epoch = 0
        self._score: Optional[torch.Tensor] = None
        self.last_batch_size: Optional[int] = None
        # cumulative batch payload handed to fit()
        self.transfer_bytes = 0
        self._rnn_carries: Optional[List] = None
        self._rnn_pos = 0
        # every train-time draw (dropout, weight noise); made by init()
        self.dropout_generator: Optional[torch.Generator] = None
        self.listeners: List = []
        # the device mesh the network is placed on (parallel/sharding.py)
        self._mesh = None
        self.step_end_hooks: List = []
        self._step_depth = 0

    @property
    def score_(self) -> float:
        """The last fit iteration's loss (NaN before the first). Reading it
        syncs with the device; the train loop never blocks on it."""
        return float("nan") if self._score is None else float(full(self._score))

    @score_.setter
    def score_(self, v) -> None:
        # a float or a (device) tensor, kept as given until it is read
        self._score = v

    # ----------------------------------------------------------------- init
    def init(self, seed: Optional[int] = None) -> "MultiLayerNetwork":
        """Random parameters from a ``torch.Generator`` seeded with the
        conf's seed (or ``seed``): the reference's schemes, not its draws;
        each tensor gets its updater and that updater's zero state; each
        layer its initial state. The dropout generator starts from the
        same seed."""
        g = self.conf.global_conf
        seed = g.seed if seed is None else seed
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.params, self._updaters, self.updater_states = init_parameters(
            self, self._named_layers(), g, gen, self.dtype, self.device)
        self.states = init_states(self, self._named_layers(), self.device)
        self.dropout_generator = dropout_generator(seed, self.device)
        self.iteration = 0
        self.epoch = 0
        return self

    def _named_layers(self):
        return list(enumerate(self.layers))

    def _as_tensor(self, x, cast_float: bool = True) -> torch.Tensor:
        return place_input(self, as_tensor(x, self.dtype, self.device, cast_float))

    def _require_params(self) -> None:
        if self.params is None:
            raise RuntimeError("call init() (or load parameters) first")

    # -------------------------------------------------------------- forward
    def _forward_all(self, params, x, mask=None, carries=None,
                     upto: Optional[int] = None, train: bool = False,
                     gen: Optional[torch.Generator] = None):
        """Run layers [0, upto); returns ``(activation, new_carries,
        new_states)``. With ``carries`` (one per layer, None for the
        non-recurrent ones), recurrent layers start from them and report
        their final carry. ``train`` with ``gen`` draws each layer's weight
        noise before its forward and its dropout in it. Each layer reads
        its state; a train forward returns each stateful layer's new state
        by index (empty otherwise). Under a compute dtype the parameters and
        a floating input are cast to it first (the reference's
        ``_forward_all``); carries and masks are not."""
        n_layers = len(self.layers) if upto is None else upto
        params = compute_cast_tree(params, self.compute_dtype)
        x = compute_cast(x, self.compute_dtype)
        h, cur_mask, new_carries, new_states = x, mask, [], {}
        for i, layer in enumerate(self.layers):
            if i >= n_layers:
                new_carries.append(None if carries is None else carries[i])
                continue
            if i in self.conf.preprocessors:
                h = self.conf.preprocessors[i](h)
            p_i = params[i]
            if train and gen is not None and layer.weight_noise is not None:
                p_i = layer.weight_noise.apply(layer, p_i, gen, train)
            if carries is not None and isinstance(layer, BaseRecurrentLayer):
                h, c = layer.forward_seq(p_i, h, carry=carries[i],
                                         mask=cur_mask, train=train, gen=gen)
                new_carries.append(c)
            else:
                fwd = lambda p, hh, _l=layer, _s=self.states[i], _m=cur_mask: \
                    _l.forward_state(p, _s, hh, mask=_m, train=train, gen=gen)
                if train and self.conf.global_conf.gradient_checkpointing:
                    # recompute this layer's activations in the backward
                    # pass instead of keeping them
                    h, st = checkpointed_forward(fwd, gen, p_i, h)
                else:
                    h, st = fwd(p_i, h)
                if train and st:
                    new_states[i] = st
                new_carries.append(None)
            # per-timestep masks collapse when the time dimension disappears;
            # a per-example [N]/[N,1] mask stays valid on 2-d activations
            if (cur_mask is not None and h.ndim == 2 and cur_mask.ndim == 2
                    and cur_mask.shape[1] > 1):
                cur_mask = None
        return h, new_carries, new_states

    def _regularization(self, params):
        return regularization(self._named_layers(), params)

    def _head_input(self, params, x, mask=None, carries=None,
                    train: bool = False, gen: Optional[torch.Generator] = None):
        """The output layer's input (its preprocessor applied; f32 under a
        compute dtype, for a stable softmax and log), with what
        :meth:`_forward_all` returns beside the activation."""
        if not self.layers[-1].has_loss():
            raise ValueError("Last layer must be an output/loss layer for fit()")
        last = len(self.layers) - 1
        h, new_carries, new_states = self._forward_all(
            params, x, mask, carries, upto=last, train=train, gen=gen)
        if last in self.conf.preprocessors:
            h = self.conf.preprocessors[last](h)
        if self.compute_dtype is not None:
            h = h.float()
        return h, new_carries, new_states

    def _loss_fn(self, params, x, y, mask, label_mask, carries=None,
                 train: bool = False, gen: Optional[torch.Generator] = None):
        """``(loss, (new_carries, new_states))``: the output layer's loss
        from its INPUT activation plus the l1/l2 penalty, and what
        :meth:`_forward_all` returns beside the activation. The label mask
        is the given one, else the feature mask (per timestep for a
        sequence output, per example for a 2-d one). ``train`` with ``gen``
        draws the train-time noise, the output layer's weight noise
        last. Under a compute dtype the loss head runs in f32: its input is
        cast up and its parameters are the f32 masters (only the layers
        before it run in the compute dtype)."""
        out_layer, last = self.layers[-1], len(self.layers) - 1
        h, new_carries, new_states = self._head_input(
            params, x, mask, carries, train=train, gen=gen)
        if label_mask is not None:
            lm = label_mask
        elif mask is None:
            lm = None
        elif h.ndim == 3:
            lm = mask
        elif mask.ndim == 1 or (mask.ndim == 2 and mask.shape[-1] == 1):
            lm = mask.reshape(mask.shape[0])
        else:
            lm = None
        p_out = params[last]
        if train and gen is not None and out_layer.weight_noise is not None:
            p_out = out_layer.weight_noise.apply(out_layer, p_out, gen, train)
        loss = out_layer.compute_loss(p_out, h, y, mask=lm)
        return loss + self._regularization(params), (new_carries, new_states)

    # ------------------------------------------------------------ train step
    def _apply_updates(self, grads) -> None:
        """One updater step per parameter tensor, in place, through the
        "updater" helper seam (:func:`apply_updates`)."""
        apply_updates(self.params, grads, self._updaters, self.updater_states,
                      self.iteration, self.epoch, dict(self._named_layers()))

    def _batch(self, ds):
        """(features, labels, mask, label mask) of a DataSet as tensors on
        the network's device (masks keep their dtype)."""
        x, y = self._as_tensor(ds.features), self._as_tensor(ds.labels)
        mask = None if ds.features_mask is None else self._as_tensor(ds.features_mask, False)
        lmask = None if ds.labels_mask is None else self._as_tensor(ds.labels_mask, False)
        return x, y, mask, lmask

    def _train_step(self, x, y, mask, lmask) -> torch.Tensor:
        """One standard-backprop update on one batch; returns its loss, a
        device scalar (no host synchronisation)."""
        with schedule_tick(self.iteration, self.epoch):
            loss, grads, (_, new_states) = gradients(
                lambda live: self._loss_fn(live, x, y, mask, lmask, train=True,
                                           gen=self.dropout_generator),
                self.params)
        commit_states(self.states, new_states)
        self._apply_updates(grads)
        self.iteration += 1
        return loss

    def _fit_batch(self, ds) -> None:
        x, y, mask, lmask = self._batch(ds)
        if (normalize_backprop_type(self.conf.backprop_type) == "truncated_bptt"
                and x.ndim == 3):
            self._fit_tbptt(x, y, mask, lmask)
            return
        self._score = self._train_step(x, y, mask, lmask)
        self.last_batch_size = int(x.shape[0])
        self._notify("iteration_done", self.iteration, self.epoch)

    def fit_batches_on_device(self, datasets) -> "MultiLayerNetwork":
        """Train on a window of equal-shape batches
        (``fitBatchesOnDevice``), with the same result as ``fit`` once per
        batch: the window is stacked on the device once (one host-to-device
        copy for the features, one for the labels), then the step runs once
        per batch with no host synchronisation between steps, each loss
        left on the device. Then ``score_`` and ``iteration`` are set and
        ``iteration_done`` is heard once per step, in order. Standard
        backprop only and no masks (``ValueError``); an empty window does
        nothing."""
        if self.params is None:
            self.init()
        if normalize_backprop_type(self.conf.backprop_type) != "standard":
            raise ValueError("fit_batches_on_device supports standard "
                             "backprop only (not TBPTT)")
        datasets = list(datasets)
        if not datasets:
            return self
        if any(ds.features_mask is not None or ds.labels_mask is not None
               for ds in datasets):
            raise ValueError("fit_batches_on_device does not carry masks")
        xs = stack_window([ds.features for ds in datasets], self.dtype, self.device)
        ys = stack_window([ds.labels for ds in datasets], self.dtype, self.device)
        # an embedding that reads the input as it is (under a compute
        # dtype, as the forward casts it)
        fed = [(layer, compute_cast(xs, self.compute_dtype)
                if i == 0 and 0 not in self.conf.preprocessors else None)
               for i, layer in enumerate(self.layers)
               if isinstance(layer, EmbeddingSequenceLayer)]
        first = self.iteration
        with self.training_step():
            with checked_window_ids(fed):
                losses = [self._train_step(x, y, None, None) for x, y in zip(xs, ys)]
            self.last_batch_size = int(xs.shape[1])
            self._window_done(first, losses)
        return self

    def _fit_tbptt(self, x, y, mask, lmask) -> None:
        """Truncated BPTT (``doTruncatedBPTT``): chunks of
        ``tbptt_fwd_length`` steps, one update each, the recurrent carries
        handed on detached."""
        t_total = x.shape[1]
        check_carry_capacity(
            ((f"layer {i} ({type(l).__name__})", l)
             for i, l in enumerate(self.layers)), t_total, "TBPTT")
        length = self.conf.tbptt_fwd_length
        batch = x.shape[0]
        self.last_batch_size = int(batch)
        carries = [l.init_carry(batch, x.dtype, x.device)
                   if isinstance(l, BaseRecurrentLayer) else None
                   for l in self.layers]
        for c in range(max(1, math.ceil(t_total / length))):
            s, e = c * length, min((c + 1) * length, t_total)
            xc = x[:, s:e]
            yc = y[:, s:e] if y.ndim == 3 else y
            mc = None if mask is None else mask[:, s:e]
            lc = None if lmask is None else lmask[:, s:e]
            with schedule_tick(self.iteration, self.epoch):
                loss, grads, (carries, new_states) = gradients(
                    lambda live, _c=carries: self._loss_fn(
                        live, xc, yc, mc, lc, _c, train=True,
                        gen=self.dropout_generator),
                    self.params)
            carries = [map_carry(torch.Tensor.detach, cr) for cr in carries]
            self._score = loss
            commit_states(self.states, new_states)
            self._apply_updates(grads)
            self.iteration += 1
        self._notify("iteration_done", self.iteration, self.epoch)

    # ------------------------------------------------------------- pretrain
    def pretrain_layer(self, layer_idx: int, data, epochs: int = 1
                       ) -> "MultiLayerNetwork":
        """Unsupervised pretraining of one layer (``pretrainLayer``): each
        batch's features go through the layers below it (no train-time
        noise, no gradient), then one :func:`pretrain_step` of the layer's
        ``pretrain_loss`` (a VAE's negative ELBO, an autoencoder's
        reconstruction loss), its draws from the dropout generator. The
        step count starts at 0 in each call; ``iteration`` does not move;
        ``score_`` is the last loss."""
        if self.params is None:
            self.init()
        layer = self.layers[layer_idx]
        if not hasattr(layer, "pretrain_loss"):
            raise ValueError(
                f"layer {layer_idx} ({type(layer).__name__}) has no "
                "pretrain_loss — only VAE/autoencoder layers pretrain")
        batches = pretrain_batches(data)
        step = 0
        for _ in range(epochs):
            if hasattr(batches, "reset"):
                batches.reset()
            for ds in batches:
                with torch.no_grad():
                    h, _, _ = self._forward_all(self.params, self._as_tensor(ds.features),
                                                upto=layer_idx)
                self._score = pretrain_step(layer, layer_idx, self.params,
                                            self._updaters, self.updater_states, h,
                                            self.dropout_generator, step)
                step += 1
        return self

    def pretrain(self, data, epochs: int = 1) -> "MultiLayerNetwork":
        """Layerwise pretraining of every layer that has a
        ``pretrain_loss``, in order (``pretrain(DataSetIterator)``)."""
        if self.params is None:
            self.init()
        for i, layer in enumerate(self.layers):
            if hasattr(layer, "pretrain_loss"):
                self.pretrain_layer(i, data, epochs=epochs)
        return self

    # ------------------------------------------------------------------- fit
    def fit(self, data, labels=None, *, epochs: int = 1, features_mask=None,
            labels_mask=None, prefetch_depth: Optional[int] = None
            ) -> "MultiLayerNetwork":
        """Train: ``fit(features, labels)`` (arrays or tensors, with optional
        masks), ``fit(DataSet)`` or ``fit(iterator)`` (reset before each
        epoch when it has ``reset``). An iterator is wrapped in
        asynchronous host-to-device prefetch of ``prefetch_depth`` batches
        (default 2; 0 turns it off; see ``wrap_for_prefetch`` for what is
        never wrapped)."""
        if self.params is None:
            self.init()
        if labels is not None:
            iterator = [DataSet(data, labels, features_mask, labels_mask)]
        elif isinstance(data, DataSet):
            iterator = [data]
        else:
            iterator = data
        iterator = wrap_for_prefetch(iterator, prefetch_depth, self.device)
        for _ in range(epochs):
            self._notify("on_epoch_start")
            if hasattr(iterator, "reset"):
                iterator.reset()
            for ds in iterator:
                self.transfer_bytes += batch_nbytes(ds)
                with self.training_step():
                    self._fit_batch(ds)
            self.epoch += 1
            self._notify("on_epoch_end")
        return self

    # ------------------------------------------------------------- inference
    def output(self, x, mask=None) -> torch.Tensor:
        """Inference forward over an array or tensor (or a DataSet, or an
        iterator of them: the batch outputs are concatenated), under
        ``torch.inference_mode()``. Returns a tensor on the network's
        device."""
        self._require_params()
        if hasattr(x, "features") or (hasattr(x, "__iter__")
                                      and not hasattr(x, "shape")
                                      and not isinstance(x, (list, tuple))):
            it = [x] if hasattr(x, "features") else x
            if hasattr(it, "reset"):
                it.reset()
            return torch.cat([self.output(ds.features, mask=ds.features_mask)
                              for ds in it], dim=0)
        with inference(self), mesh_scope(self):
            x = self._as_tensor(x)
            mask = None if mask is None else self._as_tensor(mask, False)
            h, _, _ = self._forward_all(self.params, x, mask)
            return full(h)

    def predict(self, x) -> np.ndarray:
        return self.output(x).argmax(dim=-1).cpu().numpy()

    def feed_forward(self, x, train: bool = False) -> List[torch.Tensor]:
        """The input and every layer's activation (``feedForward``)."""
        return self.feed_forward_to_layer(len(self.layers) - 1, x, train=train)

    def feed_forward_to_layer(self, layer_num: int, x,
                              train: bool = False) -> List[torch.Tensor]:
        """The input and the activations of layers 0..``layer_num``
        inclusive (``feedForwardToLayer``), under inference mode. ``train``
        runs the layers in training mode (batch statistics), as the
        reference does, with no train-time draws."""
        if not 0 <= layer_num < len(self.layers):
            raise ValueError(f"layer_num {layer_num} out of range "
                             f"[0, {len(self.layers)})")
        self._require_params()
        with torch.inference_mode():
            h = self._as_tensor(x)
            acts = [h]
            for i in range(layer_num + 1):
                if i in self.conf.preprocessors:
                    h = self.conf.preprocessors[i](h)
                h, _ = self.layers[i].forward_state(self.params[i],
                                                    self.states[i], h,
                                                    train=train)
                acts.append(h)
        return acts

    def _host_outputs(self, iterator, masks: bool = True):
        """``(labels, output, label mask, DataSet)`` on the host for each
        batch of an iterator (or one DataSet), ``output`` taking the
        features mask; without ``masks`` neither mask is used."""
        it = [iterator] if isinstance(iterator, DataSet) else iterator
        if hasattr(it, "reset"):
            it.reset()
        for ds in it:
            out = self.output(ds.features, mask=ds.features_mask if masks else None)
            lmask = ds.labels_mask if masks else None
            yield (to_host(ds.labels), to_host(out),
                   None if lmask is None else to_host(lmask), ds)

    def evaluate(self, iterator, top_n: int = 1) -> Evaluation:
        """Classification metrics of ``output`` over an iterator (or one
        DataSet), label masks honoured (``MultiLayerNetwork.evaluate``)."""
        e = Evaluation(top_n=top_n)
        for labels, out, lmask, ds in self._host_outputs(iterator):
            e.eval(labels, out, mask=lmask,
                   record_meta_data=getattr(ds, "example_meta_data", None))
        return e

    def evaluate_regression(self, iterator) -> RegressionEvaluation:
        """Per-column regression metrics of ``output`` over an iterator
        (``evaluateRegression``); as in the reference, masks are not
        used."""
        return self._evaluated(RegressionEvaluation(), iterator, masks=False)

    def f1_score(self, features, labels) -> float:
        """Macro F1 on one batch (``f1Score``)."""
        e = Evaluation()
        e.eval(to_host(labels), to_host(self.output(features)))
        return float(e.f1())

    def label_probabilities(self, x) -> torch.Tensor:
        """Per-class probabilities (``labelProbabilities``): the output
        activations of a softmax or sigmoid head."""
        return self.output(x)

    # ------------------------------------------------ parameter accessors
    def param_table(self) -> Dict[str, torch.Tensor]:
        """Every parameter keyed ``"<layer index>_<name>"`` (``paramTable``)."""
        self._require_params()
        return {f"{i}_{n}": t for i, named in self.params.items()
                for n, t in named.items()}

    def get_param(self, key: str) -> torch.Tensor:
        """One parameter by its ``"<layer index>_<name>"`` key."""
        idx, name = key.split("_", 1)
        return self.params[int(idx)][name]

    def set_param(self, key: str, value) -> None:
        """Overwrite one parameter in place (``setParam``); the shape must
        match."""
        old = self.get_param(key)
        new = self._as_tensor(value)
        if tuple(new.shape) != tuple(old.shape):
            raise ValueError(f"shape mismatch for {key}: {tuple(new.shape)} "
                             f"vs {tuple(old.shape)}")
        with torch.no_grad():
            old.copy_(new)

    def num_labels(self) -> int:
        """Output width of the final layer (``numLabels``)."""
        out = getattr(self.layers[-1], "n_out", None)
        if not out:
            raise ValueError("output layer has no n_out")
        return int(out)

    def _flat_order(self):
        """Every parameter tensor in the reference's flat order: layers in
        order, each layer's names sorted."""
        return [self.params[i][n] for i in range(len(self.layers))
                for n in sorted(self.params[i])]

    def params_flat(self) -> np.ndarray:
        """Every parameter in one host vector (``params()``), in
        :meth:`_flat_order`."""
        self._require_params()
        leaves = [to_host(t).ravel() for t in self._flat_order()]
        return np.concatenate(leaves) if leaves else np.zeros(0)

    def set_params_flat(self, flat) -> None:
        """Overwrite every parameter from one vector (``setParams``), in
        :meth:`_flat_order`, in place: the updater state and a fused
        updater kernel keep pointing at the same tensors."""
        self._require_params()
        flat = torch.as_tensor(np.asarray(flat))
        tensors = self._flat_order()
        if flat.numel() != sum(t.numel() for t in tensors):
            raise ValueError(f"flat vector of {flat.numel()} values for "
                             f"{sum(t.numel() for t in tensors)} parameters")
        offset = 0
        with torch.no_grad():
            for t in tensors:
                t.copy_(flat[offset:offset + t.numel()].reshape(t.shape))
                offset += t.numel()

    # ------------------------------------------------------------- getters
    @property
    def n_layers(self) -> int:
        """``getnLayers()``."""
        return len(self.layers)

    def get_layer(self, idx):
        """A layer by index or by name (``getLayer``)."""
        if isinstance(idx, str):
            for layer in self.layers:
                if layer.name == idx:
                    return layer
            raise KeyError(f"no layer named {idx!r}")
        return self.layers[idx]

    def get_layers(self) -> list:
        return list(self.layers)

    def get_output_layer(self):
        """The final layer (``getOutputLayer``)."""
        return self.layers[-1]

    def get_layer_names(self) -> List[str]:
        """Each layer's name, its class name when unnamed
        (``getLayerNames``)."""
        return [layer.name or type(layer).__name__ for layer in self.layers]

    def layer_size(self, layer_idx: int) -> int:
        """A layer's output size (``layerSize``): its ``n_out``, else its
        ``W``'s last axis."""
        n = getattr(self.layers[layer_idx], "n_out", None)
        if n:
            return int(n)
        p = self.params[layer_idx] if self.params is not None else {}
        if "W" in p:
            return int(p["W"].shape[-1])
        raise ValueError(f"layer {layer_idx} has no defined output size")

    def summary(self) -> str:
        """The layer table with parameter counts and shapes
        (``summary()``), the reference's text; initialises the network
        when it has no parameters yet."""
        if self.params is None:
            self.init()
        rows, total = [], 0
        for i, layer in enumerate(self.layers):
            p = self.params[i]
            n = sum(t.numel() for t in p.values())
            total += n
            shapes = ", ".join(f"{k}{tuple(v.shape)}" for k, v in sorted(p.items()))
            rows.append((str(i), type(layer).__name__
                         + (f" ({layer.name})" if layer.name else ""),
                         f"{n:,}", shapes))
        return summary_table(("index", "layer", "shapes"), (5, 10), rows, total)

    def to_computation_graph(self) -> ComputationGraph:
        """The same network as a single-chain ``ComputationGraph``
        (``toComputationGraph``) on the same device. Vertices are named as
        the reference names them: the layer's name, else its lower-cased
        class name, with ``_2``, ``_3`` on repeats. The layers and global
        settings are copied, and so are the input type, the explicit
        preprocessors and the backprop settings (which the reference
        drops). Once initialised, the graph gets copies of the parameters,
        layer states, updater states, iteration, epoch and dropout
        generator state."""
        names, counts = [], {}
        for layer in self.layers:
            base = layer.name or type(layer).__name__.lower()
            counts[base] = counts.get(base, 0) + 1
            names.append(base if counts[base] == 1 else f"{base}_{counts[base]}")
        b = GraphBuilder(copy.deepcopy(self.conf.global_conf))
        b.add_inputs("input")
        prev = "input"
        for name, layer in zip(names, self.layers):
            b.add_layer(name, copy.deepcopy(layer), prev)
            prev = name
        for i, spec in self.conf.input_pre_processors.items():
            b.input_pre_processor(names[i], spec)
        if self.conf.input_type is not None:
            b.set_input_types(self.conf.input_type)
        b.backprop_type(self.conf.backprop_type)
        if normalize_backprop_type(self.conf.backprop_type) == "truncated_bptt":
            b.t_bptt_length(self.conf.tbptt_fwd_length, self.conf.tbptt_bwd_length)
        net = ComputationGraph(b.set_outputs(prev).build(), device=self.device)
        if self.params is not None:
            net.init()
            carry_over(net, self, dict(enumerate(names)))
        return net

    def score_examples(self, ds, add_regularization: bool = False) -> np.ndarray:
        """Each example's loss at inference (``scoreExamples``): the data
        term, plus the l1/l2 term when ``add_regularization``. As in the
        reference the features mask is not used and the labels mask is.
        One batched forward to the output layer's input, then the output
        layer's loss of each row (:func:`example_losses`)."""
        self._require_params()
        x, y, _, lmask = self._batch(ds)
        with torch.no_grad():
            h, _, _ = self._head_input(self.params, x)
            scores = example_losses(self.layers[-1], self.params[len(self.layers) - 1],
                                    h, y, lmask)
            if add_regularization:
                scores = scores + self._regularization(self.params)
        return to_host(scores)

    # ------------------------------------------------------------ model zip
    def save(self, path, save_updater: bool = True) -> None:
        """Write this network's model zip (``MultiLayerNetwork.save``)."""
        model_serializer.write_model(self, path, save_updater=save_updater)

    @staticmethod
    def load(path, load_updater: bool = True,
             device=None) -> "MultiLayerNetwork":
        """The network a model zip holds (``MultiLayerNetwork.load``), on
        ``device``: ``cuda`` unless the caller passes ``"cpu"``."""
        return model_serializer.restore_multi_layer_network(
            path, load_updater=load_updater, device=device)

    def score(self, ds=None) -> float:
        """The last fit iteration's loss, or the loss on ``ds`` (no update,
        masks honoured)."""
        if ds is None:
            return self.score_
        self._require_params()
        x, y, mask, lmask = self._batch(ds)
        with torch.no_grad(), mesh_scope(self):
            loss, _ = self._loss_fn(self.params, x, y, mask, lmask)
            return float(full(loss))

    def compute_gradient_and_score(self, x, y, features_mask=None,
                                   labels_mask=None):
        """``({index: {param: grad}}, loss)`` on one batch over the whole
        sequence, no update (the gradient-check hook)."""
        self._require_params()
        x, y, mask, lmask = self._batch(DataSet(x, y, features_mask, labels_mask))
        loss, grads, _ = gradients(
            lambda live: self._loss_fn(live, x, y, mask, lmask), self.params)
        return grads, float(loss)

    # ------------------------------------------------------ stateful RNN API
    def rnn_clear_previous_state(self) -> None:
        self._rnn_carries = None
        self._rnn_pos = 0

    def rnn_get_previous_state(self, layer: int):
        """A copy of the stored carry of a recurrent layer
        (``rnnGetPreviousState``; decoding writes KV caches in place), or
        None before any ``rnn_time_step`` call."""
        if self._rnn_carries is None:
            return None
        return map_carry(torch.clone, self._rnn_carries[layer])

    def rnn_set_previous_state(self, layer: int, state,
                               position: Optional[int] = None) -> None:
        """Overwrite a recurrent layer's stored carry with a copy of
        ``state`` on the network's device (``rnnSetPreviousState``); needs
        a prior ``rnn_time_step``.
        ``position`` (the timesteps ``state`` has absorbed) is mandatory
        when a layer's carry has a finite capacity."""
        if self._rnn_carries is None:
            raise ValueError(
                "no stored rnn state to overwrite; call rnn_time_step "
                "first to initialize the carries")
        if position is not None:
            self._rnn_pos = int(position)
        elif any(isinstance(l, BaseRecurrentLayer)
                 and l.carry_capacity() is not None for l in self.layers):
            raise ValueError(
                "rnn_set_previous_state needs position= when a layer has "
                "a finite carry capacity")
        with torch.inference_mode():
            self._rnn_carries[layer] = own_carry(state, self.device)

    def rnn_time_step(self, x) -> torch.Tensor:
        """Stateful inference (``rnnTimeStep``): ``x`` [N,T,C], or [N,C]
        for one step (the answer is then [N,out]); each recurrent layer
        starts from its stored carry and stores its final one."""
        self._require_params()
        with torch.inference_mode():
            x = self._as_tensor(x)
            squeeze = x.ndim == 2
            if squeeze:
                x = x[:, None, :]
            if self._rnn_carries is None:
                # in the parameters' dtype, as the reference's (under a
                # compute dtype too)
                self._rnn_pos = 0
                self._rnn_carries = [
                    l.init_carry(x.shape[0], self.dtype, x.device)
                    if isinstance(l, BaseRecurrentLayer) else None
                    for l in self.layers]
            t_new = x.shape[1]
            check_carry_capacity(
                ((f"layer {i}", l) for i, l in enumerate(self.layers)),
                self._rnn_pos + t_new,
                f"rnn_time_step at position {self._rnn_pos}+{t_new}")
            h, self._rnn_carries, _ = self._forward_all(
                self.params, x, carries=self._rnn_carries)
            self._rnn_pos += t_new
        return h[:, -1, :] if squeeze and h.ndim == 3 else h
