"""ParallelWrapper — mesh-sharded distributed training.

Counterpart of ``deeplearning4j_tpu/parallel/trainer.py``, with the
reference's semantics (``ParallelWrapper.java:58-137``):

- **shared_gradients** (default): the network's own step on the global
  batch sharded over the mesh's ``data`` axis, with its parameters
  replicated (or placed by the Megatron specs with ``tp_axis``). The
  network holds DTensors (``parallel/sharding.py``), so the loss, the
  gradients and BatchNorm's batch statistics are the whole batch's, as
  GSPMD makes them in the reference; a gradient comes back as a
  ``Partial`` sum and is reduced onto its parameter's placements before
  the update (``nn/train_step.py`` ``apply_updates``).
- **averaging**: each rank runs ``averaging_frequency`` independent local
  steps of the network's own step on its block of each batch, from the
  same start, then the parameters, the updater state and the layer
  states are averaged over the ``data`` axis (one ``all_reduce`` a
  tensor), as the reference's ``shard_map`` + ``pmean`` does. The local
  steps run on plain tensors: each rank holds a whole replica. Each
  rank's train-time draws come from a generator of its own, seeded from
  the network's and the rank.

Every rank of the ``torch.distributed`` world runs the same program and
passes the same global batch (the reference's single-controller
contract). A batch the data axis does not divide runs unsharded on every
rank, in both modes.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, batch_nbytes
from deeplearning4j_tpu_torch.datasets.iterators import wrap_for_prefetch
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.nn.dtensor import full
from deeplearning4j_tpu_torch.nn.train_step import as_tensor, to_host
from deeplearning4j_tpu_torch.observe import trace as _trace
from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    P,
    axis_size,
    make_mesh,
    pmean_,
    shard_map,
)
from deeplearning4j_tpu_torch.parallel.sharding import place_batch, shard_model, unshard_model

#: the golden-ratio step that separates the ranks' draw seeds
_RANK_SEED_STEP = 0x9E3779B97F4A7C15


class ParallelWrapper:
    """Data-parallel trainer over a device mesh (ParallelWrapper parity).

    Usage (every rank of the world)::

        net = MultiLayerNetwork(conf).init()
        pw = ParallelWrapper(net, make_mesh({"data": 4}), mode="shared_gradients")
        pw.fit(iterator, epochs=2)
    """

    def __init__(self, model, mesh=None, *,
                 mode: str = "shared_gradients",
                 averaging_frequency: int = 5,
                 tp_axis: Optional[str] = None,
                 data_axis: str = DATA_AXIS,
                 metrics=None, metrics_name: str = "default"):
        if mode not in ("shared_gradients", "averaging"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "averaging" and tp_axis is not None:
            raise ValueError("averaging mode runs workers on replicated params; "
                             "tensor parallelism requires mode='shared_gradients'")
        self.model = model
        self.mesh = (mesh if mesh is not None
                     else make_mesh(device_type=torch.device(model.device).type))
        self.mode = mode
        self.averaging_frequency = max(1, int(averaging_frequency))
        self.data_axis = data_axis
        self.tp_axis = tp_axis
        if model.params is None:
            model.init()
        if mode == "shared_gradients":
            shard_model(model, self.mesh, tp_axis=tp_axis)
        else:
            unshard_model(model)  # each rank a whole replica
        self.n_workers = axis_size(self.mesh, data_axis)
        # optional duck-typed registry (observe.metrics): training-side
        # host→device transfer accounting next to the listener's series
        self._metrics_name = metrics_name
        self._m_transfer = None
        if metrics is not None:
            self._m_transfer = metrics.counter(
                "training_transfer_bytes_total",
                "Host to device bytes shipped with training batches",
                ("model",))

    # -------------------------------------------------------------- helpers
    def _count_transfer(self, *batches) -> None:
        if self._m_transfer is not None:
            self._m_transfer.inc(sum(batch_nbytes(d) for d in batches),
                                 model=self._metrics_name)

    def _put(self, a):
        return None if a is None else place_batch(a, self.mesh, self.data_axis)

    def _output(self, x, fm, shardable: bool):
        """The model's first output on a batch, as a full tensor: sharded
        over the data axis when ``shardable``, else unsharded on every
        rank."""
        net = self.model
        is_graph = hasattr(net, "_to_mds")

        def forward(xx, mm):
            if is_graph:
                return net.output(xx, masks=None if mm is None else [mm])
            return net.output(xx, mask=mm)

        if not shardable:
            out = forward(x, fm)
        elif getattr(net, "_mesh", None) is not None:
            out = forward(self._put(x), self._put(fm))
        else:  # averaging: plain replicas, each rank scores its block
            spec = P(self.data_axis)
            out = shard_map(lambda xx, mm: _first(forward(xx, mm)), mesh=self.mesh,
                            in_specs=(spec, None if fm is None else spec),
                            out_specs=spec)(self._tensor(x), self._tensor(fm))
        return full(_first(out))

    def _tensor(self, a, cast_float: bool = True):
        net = self.model
        return None if a is None else as_tensor(a, net.dtype, net.device, cast_float)

    # ------------------------------------------------------------- evaluate
    def evaluate(self, iterator, top_n: int = 1) -> Evaluation:
        """Data-parallel evaluation over the mesh
        (``SparkDl4jMultiLayer.evaluate`` role): each batch's features (and
        feature mask) are sharded over the 'data' axis, each rank scores
        its block, and the metrics accumulate in one Evaluation. Ragged
        batches run unsharded, the same policy as training."""
        e = Evaluation(top_n=top_n)
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            x = ds.features
            shardable = int(x.shape[0]) % self.n_workers == 0
            out = self._output(x, ds.features_mask, shardable)
            e.eval(to_host(ds.labels), to_host(out),
                   mask=None if ds.labels_mask is None else to_host(ds.labels_mask),
                   record_meta_data=getattr(ds, "example_meta_data", None))
        return e

    # ------------------------------------------------------------------ fit
    def fit(self, data, labels=None, *, epochs: int = 1,
            prefetch_depth: Optional[int] = None) -> "ParallelWrapper":
        """``prefetch_depth`` (default 2, 0 disables) wraps iterator sources
        in asynchronous prefetch onto the model's device
        (``wrap_for_prefetch(..., device=)``), the ParallelWrapperMain
        ``--prefetchSize`` semantics; the batches are then placed over the
        mesh step by step."""
        if labels is not None:
            iterator = [DataSet(data, labels)]
        elif isinstance(data, DataSet):
            iterator = [data]
        else:
            iterator = data
        iterator = wrap_for_prefetch(iterator, prefetch_depth, self.model.device)
        net = self.model
        with _trace.span("parallel_fit", category="train",
                         attrs={"mode": self.mode, "workers": self.n_workers,
                                "epochs": epochs}):
            for _ in range(epochs):
                net._notify("on_epoch_start")
                if hasattr(iterator, "reset"):
                    iterator.reset()
                if self.mode == "shared_gradients":
                    for ds in iterator:
                        self._fit_step_traced(ds)
                else:
                    self._fit_averaging(iterator)
                net.epoch += 1
                net._notify("on_epoch_end")
        return self

    def _fit_step_traced(self, ds) -> None:
        """One step, wrapped in a ``train_step`` span when tracing is on
        (the span then waits for the loss, so it covers the step's device
        time)."""
        tracer = _trace.get_active_tracer()
        if tracer is None:
            self._fit_batch_sync(ds)
            return
        net = self.model
        with tracer.span("train_step", category="train",
                         attrs={"mode": self.mode}) as sp:
            self._fit_batch_sync(ds)
            sp.set_attribute("loss", net.score_)
            sp.set_attribute("iteration", int(net.iteration))
            sp.set_attribute("batch", int(net.last_batch_size or 0))

    # ------------------------------------------- shared-gradients (per step)
    def _fit_batch_sync(self, ds) -> None:
        """One globally-synchronous step: the batch sharded over 'data',
        the network's own step on it. A ragged batch (not divisible by the
        data-axis size) runs unsharded on every rank."""
        net = self.model
        self._count_transfer(ds)
        if int(ds.features.shape[0]) % self.n_workers == 0:
            ds = DataSet(self._put(ds.features), self._put(ds.labels),
                         self._put(ds.features_mask), self._put(ds.labels_mask))
        with net.training_step():
            net._fit_batch(ds)

    # ----------------------------------------------------- averaging mode
    def _rank_generator(self) -> torch.Generator:
        """This rank's generator for a flush's train-time draws
        (:func:`rank_generator`)."""
        return rank_generator(self.model, self.mesh, self.data_axis)

    def _local_step(self, x, y, fm, lm) -> torch.Tensor:
        """The network's own step on this rank's block (plain tensors)."""
        net = self.model
        ds = DataSet(x, y, fm, lm)
        batch = net._batch(net._to_mds(ds)) if hasattr(net, "_to_mds") else net._batch(ds)
        return net._train_step(*batch)

    def _average(self, loss: torch.Tensor) -> torch.Tensor:
        """Parameters, updater state, layer states and ``loss`` averaged
        over the data axis, in place (one all-reduce a tensor, in one
        order on every rank)."""
        net = self.model
        tensors = [p for named in net.params.values() for p in named.values()]
        tensors += [s for named in (net.updater_states or {}).values()
                    for slots in named.values() for s in (slots or {}).values()
                    if isinstance(s, torch.Tensor)]
        tensors += [t for named in (net.states or {}).values() for t in named.values()]
        with torch.no_grad():
            pmean_(tensors + [loss], self.mesh, self.data_axis)
        return loss

    def _fit_averaging(self, iterator) -> None:
        """Accumulate averaging_frequency batches of one shape, then run K
        local steps per rank on its block of each and average (one
        ``shard_map`` call). Batches whose size doesn't divide the worker
        count run unsharded through the model's own step."""
        net = self.model
        k = self.averaging_frequency
        pending: List[Any] = []

        def stack_masks(masks, arrays):
            """None-mixed masks → all-ones of [batch, T] (DataSet.merge policy)."""
            if all(m is None for m in masks):
                return None
            out = []
            for m, a in zip(masks, arrays):
                if m is None:
                    shape = a.shape[:2] if a.ndim >= 3 else a.shape[:1]
                    m = torch.ones(tuple(shape), dtype=torch.float32)
                out.append(self._tensor(m, False))
            return torch.stack(out)

        def worker(xs, ys, fms, lms):
            saved = net.dropout_generator
            net.dropout_generator = self._rank_generator()
            try:
                losses = [self._local_step(xs[i], ys[i],
                                           None if fms is None else fms[i],
                                           None if lms is None else lms[i])
                          for i in range(xs.shape[0])]
            finally:
                net.dropout_generator = saved
            return self._average(torch.stack(losses).mean())

        def flush():
            if not pending:
                return
            tracer = _trace.get_active_tracer()
            if tracer is None:
                flush_inner()
                return
            with tracer.span("train_step", category="train",
                             attrs={"mode": "averaging",
                                    "local_steps": len(pending)}) as sp:
                flush_inner()
                sp.set_attribute("loss", net.score_)
                sp.set_attribute("iteration", int(net.iteration))

        def flush_inner():
            self._count_transfer(*pending)
            xs = torch.stack([self._tensor(d.features) for d in pending])
            ys = torch.stack([self._tensor(d.labels) for d in pending])
            fms = stack_masks([d.features_mask for d in pending],
                              [d.features for d in pending])
            lms = stack_masks([d.labels_mask for d in pending],
                              [d.labels for d in pending])
            spec = P(None, self.data_axis)
            step = shard_map(worker, mesh=self.mesh,
                             in_specs=(spec, spec, None if fms is None else spec,
                                       None if lms is None else spec),
                             out_specs=P())
            with net.training_step():
                loss = step(xs, ys, fms, lms)
            net._score = full(loss)
            net.last_batch_size = int(xs.shape[1])
            net._notify("iteration_done", net.iteration, net.epoch)
            pending.clear()

        for ds in iterator:
            if int(ds.features.shape[0]) % self.n_workers:
                flush()
                self._count_transfer(ds)
                with net.training_step():
                    net._fit_batch(ds)  # ragged batch: unsharded
                continue
            if pending and tuple(ds.features.shape) != tuple(pending[-1].features.shape):
                flush()  # shape change (e.g. smaller tail): can't stack
            pending.append(ds)
            if len(pending) == k:
                flush()
        flush()


def rank_generator(net, mesh, data_axis: str = DATA_AXIS) -> torch.Generator:
    """This rank's generator for a step's train-time draws: seeded from a
    draw of the network's generator (which every rank makes alike) and
    the rank's index on the data axis (the reference's ``fold_in(rng,
    axis_index)``)."""
    gen = net.dropout_generator
    base = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                             device=gen.device).item())
    rank = int(mesh.get_local_rank(data_axis))
    mine = torch.Generator(device=gen.device)
    mine.manual_seed((base + _RANK_SEED_STEP * (rank + 1)) % 2 ** 63)
    return mine


def _first(out):
    return out[0] if isinstance(out, list) else out
