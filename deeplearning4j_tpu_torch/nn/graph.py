"""ComputationGraph — DAG network over a ComputationGraphConfiguration.

Counterpart of ``deeplearning4j_tpu/nn/graph.py``: ``init`` (parameters
and one updater state per ``<vertex>/<param>``), ``_forward_all``,
``output``, training with standard backprop or truncated BPTT:
``_loss_fn`` (the summed losses of the output layers plus the l1/l2
penalty), ``_apply_updates`` (the "updater" helper seam consulted per
tensor), ``fit`` over arrays, ``DataSet``, ``MultiDataSet`` or
iterators, ``score`` and ``compute_gradient_and_score``; the stateful RNN
API (``rnn_time_step``, ``rnn_clear_previous_state`` and the stored-state
accessors), the model zip (``save``, ``ComputationGraph.load``),
``fit_batches_on_device``, listeners, ``feed_forward``, ``predict``,
``summary``, the getters (``get_vertex``, ``get_layer``, ``get_vertices``,
``get_num_layers``, ``get_num_input_arrays``, ``get_num_output_arrays``,
``get_output_layer``, ``topological_sort_order``, ``get_layers``), the
parameter accessors (``param_table``, ``get_param``, ``set_param``,
``layer_size``, ``num_params``, ``set_learning_rate``), ``clone``,
``score_examples`` and the evaluators of the first output (``evaluate``,
``evaluate_regression``, ``evaluate_roc``, ``evaluate_roc_multi_class``,
``evaluate_roc_binary``).

Carries: with ``carries`` (one per recurrent layer vertex, by name),
``_forward_all`` runs each such layer's ``forward_seq`` and reports its
final carry (KV caches and write positions, positional offsets, LSTM
states). Truncated BPTT cuts the temporal inputs (and per-timestep labels
and masks) into ``tbptt_fwd_length`` chunks; each chunk is one update and
one iteration, and hands its carries on detached, so a chunk attends over
the cached keys of the chunks before it (Transformer-XL style).
``rnn_time_step`` keeps the carries between calls; the stored-state
accessors hand out and take copies, since decoding writes the caches in
place.

The network is an ``nn.Module`` whose parameters keep the reference's
names and layouts, registered as ``<vertex>/<param>``; ``params`` holds the
same tensors as ``{vertex: {param: tensor}}``. The step's pieces are the
ones ``MultiLayerNetwork`` uses too (``nn/train_step.py``): the parameters
never require grad, a step differentiates detached aliases of them and
updates them in place, so the serving path (``output``, under
``torch.inference_mode()``) never meets an autograd graph. The step runs
eagerly; where the reference jits one fused step, the port launches
kernels one by one.

Layer state (BatchNorm's running statistics) sits in ``states``, keyed
by vertex name, and is replaced as in ``MultiLayerNetwork``: once per
step or TBPTT chunk from a train forward; inference reads it.
The evaluators score the first output on the port's ``eval/`` classes.

Regularizers as in ``MultiLayerNetwork``: each step runs inside
``schedule_tick`` and draws from the network's dropout generator, vertex
by vertex in topological order (a layer's weight noise before its
forward, then its dropout and attention dropout); a loss layer's loss
sees the same noised weights as its forward. Gradient normalization and
constraints run per layer around the updater seam. ``output`` never
draws. ``fit`` prefetches iterators as ``MultiLayerNetwork.fit`` does.

Mixed precision (``compute_dtype``) is the reference's: parameters and
floating inputs are cast to the compute dtype inside ``_forward_all``,
the loss heads run in f32 on the f32 masters, and the gradients, updates,
optimizer and layer state stay f32; ``output`` answers in the compute
dtype. Integer inputs (token ids) are never cast.

A multi-input layer (``consumes_multiple_inputs``: cross-attention) takes
every input's activation and mask apart through its ``forward_multi``,
after its weight noise, as in the reference.

``fit_batches_on_device`` and the listeners are ``MultiLayerNetwork``'s,
over MultiDataSets: each input and each label stacked for the window.
``param_table`` keys are ``"<vertex>_<param>"``, the vertex matched
longest-first; ``set_param`` writes in place.

Gradient checkpointing is ``MultiLayerNetwork``'s: each single-input layer
vertex outside a carried recurrence recomputes its train forward in the
backward pass (``checkpointed_forward``); a multi-input layer keeps its
activations, as in the reference.

Layerwise pretraining (``pretrain``, ``pretrain_layer(vertex_name)``) is
``MultiLayerNetwork``'s: a vertex's inputs, concatenated on the last axis,
feed its ``pretrain_loss`` alone (``nn/train_step.py`` ``pretrain_step``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.datasets.dataset import (
    DataSet,
    MultiDataSet,
    batch_nbytes,
)
from deeplearning4j_tpu_torch.datasets.iterators import wrap_for_prefetch
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation
from deeplearning4j_tpu_torch.nn.conf.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.network import normalize_backprop_type
from deeplearning4j_tpu_torch.nn.layers.core import EmbeddingSequenceLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    BaseRecurrentLayer,
    check_carry_capacity,
    map_carry,
    own_carry,
)
from deeplearning4j_tpu_torch.nn.network_api import (
    NetworkApi,
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

Grads = Dict[str, Dict[str, torch.Tensor]]


class ComputationGraph(NetworkApi, nn.Module):
    """DAG network. ``device=None`` places it on ``cuda`` and raises when
    there is none; ``device="cpu"`` runs it on the CPU."""

    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        super().__init__()
        conf.finalize()
        self.conf = conf
        self.device = resolve_device(device)
        self.dtype = conf.global_conf.torch_dtype()
        # mixed precision: the forward's dtype (None: the parameters' own)
        self.compute_dtype = conf.global_conf.torch_compute_dtype()
        self.params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        # non-trainable layer state (BatchNorm's running statistics)
        self.states: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self.updater_states: Optional[Dict[str, Dict[str, Dict[str, torch.Tensor]]]] = None
        self._updaters: Dict[str, dict] = {}
        self.iteration = 0
        self.epoch = 0
        self._score: Optional[torch.Tensor] = None
        self.last_batch_size: Optional[int] = None
        # cumulative batch payload handed to fit()
        self.transfer_bytes = 0
        # vertices whose activation another vertex reads
        self._consumed = {s for vd in conf.vertices.values() for s in vd.inputs}
        # every train-time draw (dropout, weight noise); made by init()
        self.dropout_generator: Optional[torch.Generator] = None
        # the stateful RNN API's carries and the timesteps they absorbed
        self._rnn_carries: Optional[Dict[str, object]] = None
        self._rnn_pos = 0
        self.listeners: List = []
        self.step_end_hooks: List = []
        self._step_depth = 0

    # ---------------------------------------------------------------- score
    @property
    def score_(self) -> float:
        """The last fit step's loss (NaN before the first). Reading it
        syncs with the device; the train loop never blocks on it."""
        return float("nan") if self._score is None else float(self._score)

    @score_.setter
    def score_(self, v) -> None:
        # a float or a (device) tensor, kept as given until it is read
        self._score = v

    # ----------------------------------------------------------------- init
    def init(self, seed: Optional[int] = None) -> "ComputationGraph":
        """Random parameters from a ``torch.Generator`` seeded with the
        conf's seed (or ``seed``): the reference's schemes, not its draws.
        Each parameter gets its updater (the layer's, else the network's,
        else ``Sgd(0.1)``; ``b`` takes the bias updater when one is set) and
        that updater's zero state; each layer its initial state. The
        dropout generator starts from the same seed."""
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
        return [(vd.name, vd.obj) for vd in self.conf.layer_vertices()]

    # -------------------------------------------------------------- forward
    def _recurrent_layers(self):
        return [(vd.name, vd.obj) for vd in self.conf.layer_vertices()
                if isinstance(vd.obj, BaseRecurrentLayer)]

    def init_carries(self, batch: int) -> Dict[str, object]:
        """Fresh carries of every recurrent layer vertex for ``batch``
        sequences, on the network's device, in the parameters' dtype: the
        reference's TBPTT and ``rnn_time_step`` build them in ``jnp_dtype()``
        under a compute dtype too (a bf16 KV cache write is cast up, its
        read cast down)."""
        return {name: layer.init_carry(batch, self.dtype, self.device)
                for name, layer in self._recurrent_layers()}

    def _forward_all(self, params, inputs: Dict[str, torch.Tensor],
                     masks: Optional[Dict[str, Optional[torch.Tensor]]] = None,
                     loss_inputs: bool = False, train: bool = False,
                     gen: Optional[torch.Generator] = None,
                     carries: Optional[Dict[str, object]] = None):
        """Execute the DAG in topo order; returns ``(activations,
        new_carries, new_states)``: every vertex activation, with
        ``carries`` each recurrent layer's final carry (None without), and
        in a train forward each stateful layer's new state by name (empty
        otherwise).

        With ``loss_inputs``, each loss layer also stores its input under
        ``name + ":in"``, its mask under ``name + ":mask"`` and the
        parameters its loss uses (weight noise applied) under
        ``name + ":params"``, and a loss layer whose activation no vertex
        reads is not run (the loss starts from its input). ``train`` with
        ``gen`` draws each layer's weight noise before its forward and its
        dropout in it. With ``carries`` (by vertex name) each recurrent
        layer runs ``forward_seq`` from its carry. Each other layer reads
        its state.

        Under a compute dtype the parameters and every floating input are
        cast to it first (the reference's ``_forward_all``), so weight
        noise is drawn in that dtype; a loss layer's ``:params`` are then
        its f32 masters, noised again in f32 from the same generator state
        (the reference re-noises ``params[out_name]`` with the same key),
        for the f32 loss head."""
        conf = self.conf
        cd = self.compute_dtype
        master = params
        params = compute_cast_tree(params, cd)
        inputs = {k: compute_cast(v, cd) for k, v in inputs.items()}
        new_carries = None if carries is None else {}
        new_states = {}
        acts: Dict[str, torch.Tensor] = dict(inputs)
        m: Dict[str, Optional[torch.Tensor]] = dict(masks or {})
        for name in conf.inputs:
            m.setdefault(name, None)
        for name in conf.topo_order:
            vd = conf.vertices[name]
            in_acts = [acts[s] for s in vd.inputs]
            in_masks = [m.get(s) for s in vd.inputs]
            if vd.is_layer:
                layer = vd.obj
                p_v = params[name]
                # under a compute dtype a loss head keeps the f32 masters
                head = (master[name] if cd is not None and loss_inputs
                        and layer.has_loss() else None)
                if train and gen is not None and layer.weight_noise is not None:
                    drawn_from = None if head is None else gen.get_state()
                    p_v = layer.weight_noise.apply(layer, p_v, gen, train)
                    if head is not None:
                        after = gen.get_state()
                        gen.set_state(drawn_from)
                        head = layer.weight_noise.apply(layer, head, gen, train)
                        gen.set_state(after)
                if getattr(layer, "consumes_multiple_inputs", False):
                    # every input's activation and mask, weight noise drawn
                    acts[name] = layer.forward_multi(p_v, in_acts, masks=in_masks,
                                                     train=train, gen=gen)
                    m[name] = in_masks[0]
                    continue
                h = in_acts[0] if len(in_acts) == 1 else torch.cat(in_acts, -1)
                if name in conf.preprocessors:
                    h = conf.preprocessors[name](h)
                cur_mask = in_masks[0]
                if loss_inputs and layer.has_loss():
                    acts[name + ":in"] = h
                    acts[name + ":mask"] = cur_mask
                    acts[name + ":params"] = p_v if head is None else head
                    if name not in self._consumed:
                        continue
                if carries is not None and isinstance(layer, BaseRecurrentLayer):
                    y, new_carries[name] = layer.forward_seq(
                        p_v, h, carry=carries.get(name), mask=cur_mask,
                        train=train, gen=gen)
                else:
                    fwd = lambda p, hh, _l=layer, _s=self.states[name], _m=cur_mask: \
                        _l.forward_state(p, _s, hh, mask=_m, train=train, gen=gen)
                    if train and conf.global_conf.gradient_checkpointing:
                        # recompute the activations in the backward pass
                        y, st = checkpointed_forward(fwd, gen, p_v, h)
                    else:
                        y, st = fwd(p_v, h)
                    if train and st:
                        new_states[name] = st
                acts[name] = y
                # a per-timestep mask collapses when the time dim disappears
                if (cur_mask is not None and y.ndim == 2
                        and cur_mask.ndim == 2 and cur_mask.shape[1] > 1):
                    m[name] = None
                else:
                    m[name] = cur_mask
            else:
                acts[name] = vd.obj.forward(in_acts, in_masks)
                m[name] = vd.obj.output_mask(in_masks)
        return acts, new_carries, new_states

    def forward(self, inputs: Dict[str, torch.Tensor],
                masks: Optional[Dict[str, Optional[torch.Tensor]]] = None
                ) -> List[torch.Tensor]:
        acts, _, _ = self._forward_all(self.params, inputs, masks)
        return [acts[n] for n in self.conf.outputs]

    def _as_tensor(self, x, cast_float: bool = True) -> torch.Tensor:
        return as_tensor(x, self.dtype, self.device, cast_float)

    def output(self, *xs, masks=None) -> Union[torch.Tensor, List[torch.Tensor]]:
        """Inference over numpy arrays or tensors (floating inputs are cast
        to the network dtype, as the reference does; token ids arrive as
        floats). Returns tensors on the network's device."""
        if self.params is None:
            raise RuntimeError("call init() (or load parameters) first")
        if len(xs) == 1 and isinstance(xs[0], (list, tuple)):
            xs = tuple(xs[0])
        with torch.inference_mode():
            inputs = {n: self._as_tensor(x) for n, x in zip(self.conf.inputs, xs)}
            mask_d = None
            if masks is not None:
                mask_d = {n: (None if mk is None else self._as_tensor(mk, False))
                          for n, mk in zip(self.conf.inputs, masks)}
            outs = self.forward(inputs, mask_d)
        return outs[0] if len(outs) == 1 else outs

    def output_single(self, *xs) -> torch.Tensor:
        """First output as a single tensor (``outputSingle``)."""
        out = self.output(*xs)
        return out[0] if isinstance(out, list) else out

    # ----------------------------------------------------------------- loss
    def _loss_fn(self, params, inputs, labels, masks, label_masks,
                 train: bool = False, gen: Optional[torch.Generator] = None):
        """The summed losses of the output layers, each from its INPUT
        activation (its ``compute_loss``), plus the l1/l2 penalty; the label
        mask is the given one, else the feature mask that reached the layer
        (per timestep for a sequence output, per example for a 2-d one).
        ``train`` with ``gen`` draws the train-time noise."""
        return self._loss_and_aux(params, inputs, labels, masks,
                                  label_masks, train=train, gen=gen)[0]

    def _loss_and_aux(self, params, inputs, labels, masks, label_masks,
                      carries=None, train: bool = False,
                      gen: Optional[torch.Generator] = None):
        """``(loss, (new_carries, new_states))``: :meth:`_loss_fn`'s loss,
        the recurrent layers starting from ``carries`` when given, and the
        train forward's new layer states."""
        acts, new_carries, new_states = self._forward_all(
            params, inputs, masks, loss_inputs=True, train=train, gen=gen,
            carries=carries)
        loss = 0.0
        for oi, out_name in enumerate(self.conf.outputs):
            vd = self.conf.vertices[out_name]
            layer = vd.obj
            if not (vd.is_layer and layer.has_loss()):
                raise ValueError(f"output vertex {out_name!r} is not a loss layer")
            h = acts[out_name + ":in"]
            if self.compute_dtype is not None:
                h = h.float()  # a stable softmax and log under mixed precision
            lm = None
            if label_masks is not None and label_masks[oi] is not None:
                lm = label_masks[oi]
            elif h.ndim == 3:
                lm = acts.get(out_name + ":mask")
            else:
                fm = acts.get(out_name + ":mask")
                if fm is not None and (fm.ndim == 1 or
                                       (fm.ndim == 2 and fm.shape[-1] == 1)):
                    # per-example feature mask masks the score
                    lm = fm.reshape(fm.shape[0])
            loss = loss + layer.compute_loss(acts[out_name + ":params"], h,
                                             labels[oi], mask=lm)
        return (loss + regularization(self._named_layers(), params),
                (new_carries, new_states))

    def _batch(self, mds):
        """(inputs, labels, masks, label masks) of a MultiDataSet as tensors
        on the network's device (floating features and labels in its dtype;
        masks keep theirs)."""
        inputs = {n: self._as_tensor(f) for n, f in zip(self.conf.inputs, mds.features)}
        labels = [self._as_tensor(l) for l in mds.labels]
        masks = None
        if mds.features_masks is not None:
            masks = {n: (None if mk is None else self._as_tensor(mk, False))
                     for n, mk in zip(self.conf.inputs, mds.features_masks)}
        lmasks = None
        if mds.labels_masks is not None:
            lmasks = [None if mk is None else self._as_tensor(mk, False)
                      for mk in mds.labels_masks]
        return inputs, labels, masks, lmasks

    def _gradients(self, inputs, labels, masks=None, lmasks=None,
                   train: bool = False):
        """``(loss, {vertex: {param: grad}}, new_states)``, by
        :func:`gradients`; with ``train`` the train-time noise is drawn and
        the batch statistics used, whose new layer states come back."""
        if self.params is None:
            raise RuntimeError("call init() (or load parameters) first")
        gen = self.dropout_generator if train else None
        loss, grads, (_, new_states) = gradients(
            lambda live: self._loss_and_aux(live, inputs, labels, masks,
                                            lmasks, train=train, gen=gen),
            self.params)
        return loss, grads, new_states

    # ------------------------------------------------------------ train step
    def _apply_updates(self, grads: Grads) -> None:
        """One updater step per parameter tensor, in place, through the
        "updater" helper seam (:func:`apply_updates`)."""
        apply_updates(self.params, grads, self._updaters, self.updater_states,
                      self.iteration, self.epoch, dict(self._named_layers()))

    def _train_step(self, inputs, labels, masks, lmasks) -> torch.Tensor:
        """One standard-backprop update on one batch; returns its loss, a
        device scalar (no host synchronisation)."""
        with schedule_tick(self.iteration, self.epoch):
            loss, grads, new_states = self._gradients(
                inputs, labels, masks, lmasks, train=True)
        commit_states(self.states, new_states)
        self._apply_updates(grads)
        self.iteration += 1
        return loss

    def _fit_batch(self, ds) -> None:
        inputs, labels, masks, lmasks = self._batch(self._to_mds(ds))
        if normalize_backprop_type(self.conf.backprop_type) == "truncated_bptt":
            t_total = self._temporal_length(inputs)
            if t_total is not None:
                self._fit_tbptt(inputs, labels, masks, lmasks, t_total)
                return
        self._score = self._train_step(inputs, labels, masks, lmasks)
        self.last_batch_size = int(next(iter(inputs.values())).shape[0])
        self._notify("iteration_done", self.iteration, self.epoch)

    def fit_batches_on_device(self, datasets) -> "ComputationGraph":
        """Train on a window of equal-shape DataSets or MultiDataSets
        (``fitBatchesOnDevice``), with the same result as ``fit`` once per
        batch: each input and each label is stacked on the device once,
        then the step runs once per batch with no host synchronisation
        between steps. Then ``score_`` and ``iteration`` are set and
        ``iteration_done`` is heard once per step, in order. Standard
        backprop only and no masks (``ValueError``); an empty window does
        nothing."""
        if self.params is None:
            self.init()
        if normalize_backprop_type(self.conf.backprop_type) != "standard":
            raise ValueError("fit_batches_on_device supports standard "
                             "backprop only (not TBPTT)")
        window = [self._to_mds(ds) for ds in datasets]
        if not window:
            return self
        if any(m.features_masks is not None or m.labels_masks is not None
               for m in window):
            raise ValueError("fit_batches_on_device does not carry masks")
        inputs = {n: stack_window([m.features[i] for m in window], self.dtype,
                                  self.device)
                  for i, n in enumerate(self.conf.inputs)}
        labels = [stack_window([m.labels[i] for m in window], self.dtype, self.device)
                  for i in range(len(window[0].labels))]
        # the embeddings that read a network input as it is (under a
        # compute dtype, as the forward casts it)
        fed = [(vd.obj, compute_cast(inputs[vd.inputs[0]], self.compute_dtype)
                if len(vd.inputs) == 1 and vd.inputs[0] in inputs
                and vd.name not in self.conf.preprocessors else None)
               for vd in self.conf.layer_vertices()
               if isinstance(vd.obj, EmbeddingSequenceLayer)]
        first = self.iteration
        with self.training_step():
            with checked_window_ids(fed):
                losses = [self._train_step({n: a[k] for n, a in inputs.items()},
                                           [a[k] for a in labels], None, None)
                          for k in range(len(window))]
            self.last_batch_size = int(next(iter(inputs.values())).shape[1])
            self._window_done(first, losses)
        return self

    def _temporal_inputs(self, inputs) -> set:
        """The inputs with a time axis: by the declared input types when
        every input has one (``rnn``, ``cnn_seq``), else by rank 3."""
        types = self.conf.input_types
        if (types and len(types) == len(self.conf.inputs)
                and all(t is not None for t in types)):
            return {n for n, t in zip(self.conf.inputs, types)
                    if t.kind in ("rnn", "cnn_seq")}
        return {n for n, a in inputs.items() if a.ndim == 3}

    def _temporal_length(self, inputs) -> Optional[int]:
        ts = {inputs[n].shape[1] for n in self._temporal_inputs(inputs)}
        if len(ts) > 1:
            raise ValueError(f"temporal inputs disagree on sequence length: {ts}")
        return ts.pop() if ts else None

    def _fit_tbptt(self, inputs, labels, masks, lmasks, t_total: int) -> None:
        """Truncated BPTT over the DAG: chunks of ``tbptt_fwd_length`` steps
        of the temporal inputs and of the per-timestep labels and masks
        (a per-sequence label goes whole to every chunk), one update each,
        the carries handed on detached."""
        check_carry_capacity(self._named_layers(), t_total, "TBPTT")
        temporal = self._temporal_inputs(inputs)
        length = self.conf.tbptt_fwd_length
        batch = next(iter(inputs.values())).shape[0]
        self.last_batch_size = int(batch)
        carries = self.init_carries(batch)

        def cut(a, s, e, per_step):
            return a[:, s:e] if per_step and a.shape[1] == t_total else a

        for c in range(max(1, math.ceil(t_total / length))):
            s, e = c * length, min((c + 1) * length, t_total)
            ic = {n: cut(a, s, e, n in temporal) for n, a in inputs.items()}
            lc = [cut(a, s, e, a.ndim == 3) for a in labels]
            mc = None if masks is None else {
                n: None if a is None else cut(a, s, e, n in temporal)
                for n, a in masks.items()}
            lmc = None if lmasks is None else [
                None if a is None else cut(a, s, e, labels[i].ndim == 3)
                for i, a in enumerate(lmasks)]
            with schedule_tick(self.iteration, self.epoch):
                loss, grads, (carries, new_states) = gradients(
                    lambda live, _c=carries: self._loss_and_aux(
                        live, ic, lc, mc, lmc, _c, train=True,
                        gen=self.dropout_generator),
                    self.params)
            carries = {n: map_carry(torch.Tensor.detach, cr)
                       for n, cr in carries.items()}
            self._score = loss
            commit_states(self.states, new_states)
            self._apply_updates(grads)
            self.iteration += 1
        self._notify("iteration_done", self.iteration, self.epoch)

    # ------------------------------------------------------------- pretrain
    def pretrain_layer(self, vertex_name: str, data, epochs: int = 1
                       ) -> "ComputationGraph":
        """Unsupervised pretraining of one layer vertex (``pretrainLayer``):
        each batch runs through the graph (no train-time noise, no
        gradient), the vertex's inputs are concatenated on the last axis,
        and one :func:`pretrain_step` of its ``pretrain_loss`` follows, its
        draws from the dropout generator. The step count starts at 0 in
        each call; ``iteration`` does not move; ``score_`` is the last
        loss."""
        if self.params is None:
            self.init()
        vd = self.conf.vertices[vertex_name]
        layer = vd.obj if vd.is_layer else None
        if layer is None or not hasattr(layer, "pretrain_loss"):
            raise ValueError(
                f"vertex {vertex_name!r} is not a pretrainable layer "
                "(needs pretrain_loss — VAE/autoencoder)")
        batches = pretrain_batches(data)
        step = 0
        for _ in range(epochs):
            if hasattr(batches, "reset"):
                batches.reset()
            for ds in batches:
                mds = self._to_mds(ds)
                inputs = {n: self._as_tensor(f) for n, f in zip(self.conf.inputs,
                                                                mds.features)}
                with torch.no_grad():
                    acts, _, _ = self._forward_all(self.params, inputs)
                ins = [acts[s] for s in vd.inputs]
                h = ins[0] if len(ins) == 1 else torch.cat(ins, -1)
                self._score = pretrain_step(layer, vertex_name, self.params,
                                            self._updaters, self.updater_states, h,
                                            self.dropout_generator, step)
                step += 1
        return self

    def pretrain(self, data, epochs: int = 1) -> "ComputationGraph":
        """Layerwise pretraining of every layer vertex that has a
        ``pretrain_loss``, in topological order (``pretrain``)."""
        if self.params is None:
            self.init()
        for name in self.conf.topo_order:
            vd = self.conf.vertices[name]
            if vd.is_layer and hasattr(vd.obj, "pretrain_loss"):
                self.pretrain_layer(name, data, epochs=epochs)
        return self

    # ------------------------------------------------------------------- fit
    def fit(self, data, labels=None, *, epochs: int = 1,
            prefetch_depth: Optional[int] = None) -> "ComputationGraph":
        """Train: ``fit(features, labels)`` (arrays, tensors or lists of
        them, one per input/output), ``fit(DataSet | MultiDataSet)`` or
        ``fit(iterator)`` (reset before each epoch when it has ``reset``).
        An iterator is prefetched as in ``MultiLayerNetwork.fit``
        (``prefetch_depth`` batches, default 2, 0 off)."""
        if self.params is None:
            self.init()
        if labels is not None:
            iterator = [self._wrap(data, labels)]
        elif isinstance(data, (DataSet, MultiDataSet)):
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

    @staticmethod
    def _to_mds(ds):
        if isinstance(ds, DataSet):
            return MultiDataSet(
                [ds.features], [ds.labels],
                None if ds.features_mask is None else [ds.features_mask],
                None if ds.labels_mask is None else [ds.labels_mask])
        return ds

    @staticmethod
    def _wrap(features, labels):
        return MultiDataSet(
            features if isinstance(features, (list, tuple)) else [features],
            labels if isinstance(labels, (list, tuple)) else [labels])

    def score(self, ds=None) -> float:
        """The last fit step's loss, or the loss on ``ds`` (no update)."""
        if ds is None:
            return self.score_
        # as the reference: the score of a DataSet ignores its masks
        inputs, labels, _, _ = self._batch(self._to_mds(ds))
        with torch.no_grad():
            return float(self._loss_fn(self.params, inputs, labels, None, None))

    def compute_gradient_and_score(self, features, labels):
        """``({vertex: {param: grad}}, loss)`` on one batch, no update
        (the gradient-check hook)."""
        inputs, labels_t, _, _ = self._batch(self._wrap(features, labels))
        loss, grads, _ = self._gradients(inputs, labels_t)
        return grads, float(loss)

    def score_examples(self, ds, add_regularization: bool = False) -> np.ndarray:
        """Each example's loss at inference (``scoreExamples``): the summed
        data terms of the output layers, plus the l1/l2 term when
        ``add_regularization``; masks are not used, as in the reference.
        One batched forward to each output layer's input, then that
        layer's loss of each row (``example_losses``)."""
        if self.params is None:
            raise RuntimeError("call init() (or load parameters) first")
        inputs, labels, _, _ = self._batch(self._to_mds(ds))
        with torch.no_grad():
            acts, _, _ = self._forward_all(self.params, inputs, loss_inputs=True)
            scores = 0.0
            for oi, name in enumerate(self.conf.outputs):
                h = acts[name + ":in"]
                if self.compute_dtype is not None:
                    h = h.float()
                scores = scores + example_losses(
                    self.conf.vertices[name].obj, acts[name + ":params"], h,
                    labels[oi])
            if add_regularization:
                scores = scores + regularization(self._named_layers(), self.params)
        return to_host(scores)

    # ------------------------------------------------------------ evaluation
    def _host_outputs(self, iterator, masks: bool = True):
        """``(labels, output, label mask, DataSet)`` of the first output on
        the host for each batch of an iterator (or one DataSet /
        MultiDataSet), ``output`` taking the features masks."""
        it = [iterator] if isinstance(iterator, (DataSet, MultiDataSet)) else iterator
        if hasattr(it, "reset"):
            it.reset()
        for ds in it:
            mds = self._to_mds(ds)
            out = self.output(*mds.features,
                              masks=mds.features_masks if masks else None)
            if isinstance(out, list):
                out = out[0]
            lm = None if mds.labels_masks is None or not masks else mds.labels_masks[0]
            yield (to_host(mds.labels[0]), to_host(out),
                   None if lm is None else to_host(lm), ds)

    def evaluate(self, iterator, top_n: int = 1) -> Evaluation:
        """Classification metrics of the first output over an iterator (or
        one DataSet / MultiDataSet), feature and label masks honoured
        (``ComputationGraph.evaluate``)."""
        e = Evaluation(top_n=top_n)
        for labels, out, lmask, ds in self._host_outputs(iterator):
            e.eval(labels, out, mask=lmask,
                   record_meta_data=getattr(ds, "example_meta_data", None))
        return e

    def evaluate_regression(self, iterator) -> RegressionEvaluation:
        """Per-column regression metrics of the first output
        (``evaluateRegression``), masks honoured."""
        return self._evaluated(RegressionEvaluation(), iterator)

    # ---------------------------------------------------------- inspection
    def feed_forward(self, *xs, train: bool = False) -> Dict[str, torch.Tensor]:
        """Every input's and vertex's activation by name (``feedForward``),
        under inference mode; ``train`` runs the layers in training mode
        (batch statistics) with no train-time draws, as the reference."""
        if self.params is None:
            raise RuntimeError("call init() (or load parameters) first")
        if len(xs) == 1 and isinstance(xs[0], (list, tuple)):
            xs = tuple(xs[0])
        with torch.inference_mode():
            inputs = {n: self._as_tensor(x) for n, x in zip(self.conf.inputs, xs)}
            acts, _, _ = self._forward_all(self.params, inputs, train=train)
        return {k: v for k, v in acts.items() if ":" not in k}

    def predict(self, *xs) -> np.ndarray:
        """The arg-max class of the first output."""
        out = self.output(*xs)
        if isinstance(out, list):
            out = out[0]
        return out.argmax(dim=-1).cpu().numpy()

    def summary(self) -> str:
        """The vertex table with parameter counts and inputs
        (``summary()``), the reference's text; initialises the network when
        it has no parameters yet."""
        if self.params is None:
            self.init()
        rows, total = [], 0
        for name in self.conf.topo_order:
            vd = self.conf.vertices[name]
            n = (sum(t.numel() for t in self.params.get(name, {}).values())
                 if vd.is_layer else 0)
            total += n
            rows.append((name, type(vd.obj).__name__, f"{n:,}", ", ".join(vd.inputs)))
        return summary_table(("vertex", "type", "inputs"), (6, 10), rows, total)

    def get_vertex(self, name: str):
        """A vertex's definition by name (``getVertex``)."""
        return self.conf.vertices[name]

    def get_layer(self, name: str):
        """The layer of a layer vertex (``getLayer``)."""
        vd = self.conf.vertices[name]
        if not vd.is_layer:
            raise KeyError(f"vertex {name!r} is not a layer vertex")
        return vd.obj

    def get_vertices(self) -> dict:
        """Every vertex definition by name (``getVertices``)."""
        return dict(self.conf.vertices)

    def get_num_layers(self) -> int:
        """The number of layer vertices (``getNumLayers``)."""
        return len(self.conf.layer_vertices())

    def get_num_input_arrays(self) -> int:
        return len(self.conf.inputs)

    def get_num_output_arrays(self) -> int:
        return len(self.conf.outputs)

    def get_output_layer(self, index: int = 0):
        """The layer of the ``index``-th output vertex (``getOutputLayer``)."""
        return self.get_layer(self.conf.outputs[index])

    def topological_sort_order(self) -> List[str]:
        """Vertex names in execution order (``topologicalSortOrder``)."""
        return list(self.conf.topo_order)

    def get_layers(self) -> list:
        """Every layer in topological order (``getLayers``)."""
        return [vd.obj for vd in self.conf.layer_vertices()]

    def layer_size(self, name: str) -> int:
        """A layer vertex's output size (``layerSize``): its ``n_out``, else
        its ``W``'s last axis."""
        vd = self.conf.vertices[name]
        n = getattr(vd.obj, "n_out", None) if vd.is_layer else None
        if n:
            return int(n)
        p = (self.params or {}).get(name, {})
        if "W" in p:
            return int(p["W"].shape[-1])
        raise ValueError(f"vertex {name!r} has no defined output size")

    # ------------------------------------------------ parameter accessors
    def param_table(self) -> Dict[str, torch.Tensor]:
        """Every parameter keyed ``"<vertex>_<param>"`` (``paramTable``)."""
        return {f"{v}_{n}": t for v, named in (self.params or {}).items()
                for n, t in named.items()}

    def _split_param_key(self, key: str):
        """``(vertex, param)`` of a ``param_table`` key, the vertex matched
        longest-first (names may hold underscores)."""
        for vname in sorted(self.params or {}, key=len, reverse=True):
            prefix = f"{vname}_"
            if key.startswith(prefix) and key[len(prefix):] in self.params[vname]:
                return vname, key[len(prefix):]
        raise KeyError(f"no parameter {key!r}")

    def get_param(self, key: str) -> torch.Tensor:
        """One parameter by its ``"<vertex>_<param>"`` key (``getParam``)."""
        vname, pname = self._split_param_key(key)
        return self.params[vname][pname]

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

    # ------------------------------------------------------ stateful RNN API
    def rnn_clear_previous_state(self) -> None:
        self._rnn_carries = None
        self._rnn_pos = 0

    def rnn_time_step(self, *xs) -> Union[torch.Tensor, List[torch.Tensor]]:
        """Stateful inference (``rnnTimeStep``), one array per input:
        [N,T,C], or [N,C] for one step (each sequence output is then
        [N,out]). Each recurrent layer starts from its stored carry and
        stores its final one; a step that would overflow a finite carry
        (a KV cache, a positional table) is refused before it runs."""
        if self.params is None:
            raise RuntimeError("call init() (or load parameters) first")
        if len(xs) == 1 and isinstance(xs[0], (list, tuple)):
            xs = tuple(xs[0])
        with torch.inference_mode():
            xs = [self._as_tensor(x) for x in xs]
            squeeze = xs[0].ndim == 2
            if squeeze:
                xs = [x[:, None, :] for x in xs]
            if self._rnn_carries is None:
                self._rnn_pos = 0
                self._rnn_carries = self.init_carries(xs[0].shape[0])
            t_new = xs[0].shape[1]
            check_carry_capacity(
                self._named_layers(), self._rnn_pos + t_new,
                f"rnn_time_step at position {self._rnn_pos}+{t_new}")
            acts, self._rnn_carries, _ = self._forward_all(
                self.params, dict(zip(self.conf.inputs, xs)),
                carries=self._rnn_carries)
            self._rnn_pos += t_new
            outs = [acts[n] for n in self.conf.outputs]
        if squeeze:
            outs = [o[:, -1, :] if o.ndim == 3 else o for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def rnn_get_previous_state(self, name: str):
        """A copy of the stored carry of a recurrent layer vertex
        (``rnnGetPreviousState``), or None before any ``rnn_time_step``."""
        if self._rnn_carries is None or name not in self._rnn_carries:
            return None
        return map_carry(torch.clone, self._rnn_carries[name])

    def rnn_get_previous_states(self) -> dict:
        """Copies of every stored carry by vertex name
        (``rnnGetPreviousStates``)."""
        return {n: self.rnn_get_previous_state(n)
                for n in (self._rnn_carries or {})}

    def rnn_set_previous_state(self, name: str, state,
                               position: Optional[int] = None) -> None:
        """Overwrite a recurrent vertex's stored carry with a copy of
        ``state`` on the network's device (``rnnSetPreviousState``); needs
        a prior ``rnn_time_step``. ``position`` (the timesteps ``state`` has
        absorbed) is mandatory when a layer's carry has a finite capacity."""
        if self._rnn_carries is None:
            raise ValueError(
                "no stored rnn state to overwrite; call rnn_time_step "
                "first to initialize the carries")
        if position is not None:
            self._rnn_pos = int(position)
        elif any(l.carry_capacity() is not None
                 for _, l in self._recurrent_layers()):
            raise ValueError(
                "rnn_set_previous_state needs position= when a layer "
                "has a finite carry capacity (KV cache)")
        with torch.inference_mode():
            self._rnn_carries[name] = own_carry(state, self.device)

    def rnn_set_previous_states(self, states: dict,
                                position: Optional[int] = None) -> None:
        """Overwrite several carries at once (``rnnSetPreviousStates``)."""
        for name, state in states.items():
            self.rnn_set_previous_state(name, state, position=position)

    # ------------------------------------------------------------ model zip
    def save(self, path, save_updater: bool = True) -> None:
        """Write this network's model zip (``ComputationGraph.save``)."""
        model_serializer.write_model(self, path, save_updater=save_updater)

    @staticmethod
    def load(path, load_updater: bool = True,
             device=None) -> "ComputationGraph":
        """The network a model zip holds (``ComputationGraph.load``), on
        ``device``: ``cuda`` unless the caller passes ``"cpu"``."""
        return model_serializer.restore_computation_graph(
            path, load_updater=load_updater, device=device)
