"""ComputationGraph — DAG network over a ComputationGraphConfiguration.

Counterpart of ``deeplearning4j_tpu/nn/graph.py``: ``init`` (parameters
and one updater state per ``<vertex>/<param>``), ``_forward_all``,
``output``, and standard-backprop training: ``_loss_fn`` (the summed
losses of the output layers plus the l1/l2 penalty), ``_apply_updates``
(the "updater" helper seam consulted per tensor), ``fit`` over arrays,
``DataSet``, ``MultiDataSet`` or iterators, ``score`` and
``compute_gradient_and_score``.

The network is an ``nn.Module`` whose parameters keep the reference's
names and layouts, registered as ``<vertex>/<param>``; ``params`` holds the
same tensors as ``{vertex: {param: tensor}}``. The step's pieces are the
ones ``MultiLayerNetwork`` uses too (``nn/train_step.py``): the parameters
never require grad, a step differentiates detached aliases of them and
updates them in place, so the serving path (``output``, under
``torch.inference_mode()``) never meets an autograd graph. The step runs
eagerly; where the reference jits one fused step, the port launches
kernels one by one.

Regularizers as in ``MultiLayerNetwork``: each step runs inside
``schedule_tick`` and draws from the network's dropout generator, vertex
by vertex in topological order (a layer's weight noise before its
forward, then its dropout and attention dropout); a loss layer's loss
sees the same noised weights as its forward. Gradient normalization and
constraints run per layer around the updater seam. ``output`` never
draws. ``fit`` prefetches iterators as ``MultiLayerNetwork.fit`` does.

Not ported yet: mixed precision, TBPTT, ``rnn_time_step``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch
from torch import nn

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.datasets.dataset import (
    DataSet,
    MultiDataSet,
    batch_nbytes,
)
from deeplearning4j_tpu_torch.datasets.iterators import wrap_for_prefetch
from deeplearning4j_tpu_torch.nn.conf.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.tick import schedule_tick
from deeplearning4j_tpu_torch.nn.train_step import (
    apply_updates,
    as_tensor,
    dropout_generator,
    gradients,
    init_parameters,
    regularization,
)

Grads = Dict[str, Dict[str, torch.Tensor]]


class ComputationGraph(nn.Module):
    """DAG network. ``device=None`` places it on ``cuda`` and raises when
    there is none; ``device="cpu"`` runs it on the CPU."""

    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        super().__init__()
        conf.finalize()
        if conf.global_conf.compute_dtype is not None:
            raise NotImplementedError(
                "compute_dtype (mixed precision) is not supported by the "
                "PyTorch port yet")
        self.conf = conf
        self.device = resolve_device(device)
        self.dtype = conf.global_conf.torch_dtype()
        self.params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
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

    # ---------------------------------------------------------------- score
    @property
    def score_(self) -> float:
        """The last fit step's loss (NaN before the first)."""
        return float("nan") if self._score is None else float(self._score)

    # ----------------------------------------------------------------- init
    def init(self, seed: Optional[int] = None) -> "ComputationGraph":
        """Random parameters from a ``torch.Generator`` seeded with the
        conf's seed (or ``seed``): the reference's schemes, not its draws.
        Each parameter gets its updater (the layer's, else the network's,
        else ``Sgd(0.1)``; ``b`` takes the bias updater when one is set) and
        that updater's zero state. The dropout generator starts from the
        same seed."""
        g = self.conf.global_conf
        seed = g.seed if seed is None else seed
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.params, self._updaters, self.updater_states = init_parameters(
            self, self._named_layers(), g, gen, self.dtype, self.device)
        self.dropout_generator = dropout_generator(seed, self.device)
        self.iteration = 0
        self.epoch = 0
        return self

    def _named_layers(self):
        return [(vd.name, vd.obj) for vd in self.conf.layer_vertices()]

    # -------------------------------------------------------------- forward
    def _forward_all(self, params, inputs: Dict[str, torch.Tensor],
                     masks: Optional[Dict[str, Optional[torch.Tensor]]] = None,
                     loss_inputs: bool = False, train: bool = False,
                     gen: Optional[torch.Generator] = None) -> Dict:
        """Execute the DAG in topo order; returns every vertex activation.

        With ``loss_inputs``, each loss layer also stores its input under
        ``name + ":in"``, its mask under ``name + ":mask"`` and the
        parameters its loss uses (weight noise applied) under
        ``name + ":params"``, and a loss layer whose activation no vertex
        reads is not run (the loss starts from its input). ``train`` with
        ``gen`` draws each layer's weight noise before its forward and its
        dropout in it."""
        conf = self.conf
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
                if train and gen is not None and layer.weight_noise is not None:
                    p_v = layer.weight_noise.apply(layer, p_v, gen, train)
                h = in_acts[0] if len(in_acts) == 1 else torch.cat(in_acts, -1)
                cur_mask = in_masks[0]
                if loss_inputs and layer.has_loss():
                    acts[name + ":in"] = h
                    acts[name + ":mask"] = cur_mask
                    acts[name + ":params"] = p_v
                    if name not in self._consumed:
                        continue
                y = layer.forward(p_v, h, mask=cur_mask, train=train, gen=gen)
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
        return acts

    def forward(self, inputs: Dict[str, torch.Tensor],
                masks: Optional[Dict[str, Optional[torch.Tensor]]] = None
                ) -> List[torch.Tensor]:
        acts = self._forward_all(self.params, inputs, masks)
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
        acts = self._forward_all(params, inputs, masks, loss_inputs=True,
                                 train=train, gen=gen)
        loss = 0.0
        for oi, out_name in enumerate(self.conf.outputs):
            vd = self.conf.vertices[out_name]
            layer = vd.obj
            if not (vd.is_layer and layer.has_loss()):
                raise ValueError(f"output vertex {out_name!r} is not a loss layer")
            h = acts[out_name + ":in"]
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
        return loss + regularization(self._named_layers(), params)

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
        """``(loss, {vertex: {param: grad}})``, by :func:`gradients`; with
        ``train`` the train-time noise is drawn."""
        if self.params is None:
            raise RuntimeError("call init() (or load parameters) first")
        gen = self.dropout_generator if train else None
        loss, grads, _ = gradients(
            lambda live: (self._loss_fn(live, inputs, labels, masks, lmasks,
                                        train=train, gen=gen), None),
            self.params)
        return loss, grads

    # ------------------------------------------------------------ train step
    def _apply_updates(self, grads: Grads) -> None:
        """One updater step per parameter tensor, in place, through the
        "updater" helper seam (:func:`apply_updates`)."""
        apply_updates(self.params, grads, self._updaters, self.updater_states,
                      self.iteration, self.epoch, dict(self._named_layers()))

    def _fit_batch(self, ds) -> None:
        inputs, labels, masks, lmasks = self._batch(self._to_mds(ds))
        with schedule_tick(self.iteration, self.epoch):
            loss, grads = self._gradients(inputs, labels, masks, lmasks,
                                          train=True)
        self._apply_updates(grads)
        self._score = loss
        self.last_batch_size = int(next(iter(inputs.values())).shape[0])
        self.iteration += 1

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
            if hasattr(iterator, "reset"):
                iterator.reset()
            for ds in iterator:
                self.transfer_bytes += batch_nbytes(ds)
                self._fit_batch(ds)
            self.epoch += 1
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
        loss, grads = self._gradients(inputs, labels_t)
        return grads, float(loss)
