"""TrainingMaster layer: cluster-style training drivers over the mesh.

Counterpart of ``deeplearning4j_tpu/parallel/master.py`` (the reference's
Spark scale-out layer: ``TrainingMaster.java:28``,
``ParameterAveragingTrainingMaster.java`` split sizing ``:287-298`` and
training ``:308``, ``SharedTrainingMaster.java:493`` threshold-compressed
gradient sharing, ``ExportSupport.java``, ``CommonSparkTrainingStats``).

In the port every rank of a ``torch.distributed`` world is one worker of
the mesh's ``data`` axis (C29):

- :func:`init_distributed` joins a world through a TCP store at the
  coordinator's address, the process id as the rank (gloo on the CPU,
  NCCL on ``cuda``); one process is a no-op, as in the reference;
- :class:`ParameterAveragingTrainingMaster` runs each split on
  ``ParallelWrapper(mode="averaging")``;
- :class:`SharedTrainingMaster` runs each step on every rank in this
  order: the rank's gradient on its block of the batch with its own
  draws, the local updater (the fused Adam kernel updates the parameters
  in place, so the update is taken against a copy made before it), the
  update added to the rank's residual, the sum quantized to ±threshold,
  one SUM all-reduce of the quantized update over the data axis, every
  rank setting its parameters to the copy minus the sum, and the layer
  states, the updater state, the loss and the sparsity averaged. The
  adaptive threshold of ``EncodingHandler.java:69-94`` runs between steps
  on the sparsity read to the host (``float(sparsity)``, as the
  reference does).
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.train_step import to_host
from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_size,
    is_multiprocess,
    make_mesh,
    pmean_,
)
from deeplearning4j_tpu_torch.parallel.sharding import unshard_model
from deeplearning4j_tpu_torch.parallel.trainer import ParallelWrapper, rank_generator

#: how long a rank waits in a collective or for the store before it fails
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     coordinator_bind_address: Optional[str] = None, *,
                     device_type: str = "cuda") -> None:
    """Join a multi-process world (the reference joins the jax
    coordination service). ``coordinator_address`` is ``host:port`` of
    process 0's TCP store; ``process_id`` becomes the rank and
    ``num_processes`` the world size. The backend is gloo for
    ``device_type="cpu"`` and NCCL for ``cuda`` (each process then on
    the card of its local index). ``coordinator_bind_address`` is the
    address process 0 listens on when it differs from the advertised one.
    No-op for one process."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("init_distributed needs coordinator_address and process_id "
                         "for more than one process")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu'; got {device_type!r}")
    host, _, port = str(coordinator_address).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator_address must be host:port, got "
                         f"{coordinator_address!r}")
    leader = int(process_id) == 0
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass "
                               "device_type='cpu' for a gloo world")
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    store = dist.TCPStore(coordinator_bind_address if leader and coordinator_bind_address
                          else host, int(port), world_size=int(num_processes),
                          is_master=leader, timeout=DEFAULT_TIMEOUT)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", store=store,
                            rank=int(process_id), world_size=int(num_processes),
                            timeout=DEFAULT_TIMEOUT)


class TrainingStats:
    """Per-phase wall-clock timings (``CommonSparkTrainingStats.java``),
    each event stamped by the process-wide TimeSource, so events of
    several hosts line up on one timeline under an NTP clock."""

    def __init__(self, time_source=None):
        self.phase_times: dict = {}
        self.events: list = []  # (phase, start_millis, duration_millis)
        self._ts = time_source  # None: resolved at each add()

    def add(self, phase: str, seconds: float) -> None:
        from deeplearning4j_tpu_torch.parallel.time_source import get_time_source
        self.phase_times.setdefault(phase, []).append(seconds)
        ts = self._ts if self._ts is not None else get_time_source()
        end_ms = ts.current_time_millis()
        self.events.append((phase, int(end_ms - seconds * 1000), int(seconds * 1000)))

    def total(self, phase: str) -> float:
        return sum(self.phase_times.get(phase, []))

    def as_dict(self) -> dict:
        return {k: {"count": len(v), "total_s": sum(v)}
                for k, v in self.phase_times.items()}


class TrainingMaster:
    """SPI: how distributed fitting is orchestrated (``TrainingMaster.java:28``)."""

    def execute_training(self, network, data_iterator: Iterable) -> None:
        raise NotImplementedError

    def get_training_stats(self) -> TrainingStats:
        return getattr(self, "stats", TrainingStats())


def _rows(a):
    """A batch's array as it came (a tensor) or as a host array."""
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


def _cat(parts):
    """The non-empty parts joined along the rows, on their device."""
    parts = [p for p in parts if p.shape[0]] or parts[:1]
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts) if isinstance(parts[0], torch.Tensor) else np.concatenate(parts)


def _leaves(params) -> list:
    """A network's parameter tensors in the reference's leaf order (its
    pytree's: layers, then names, each sorted)."""
    return [params[k][n] for k in sorted(params) for n in sorted(params[k])]


def _local_batch(net, ds: DataSet):
    """``net._batch`` of a DataSet, for either network kind."""
    return net._batch(net._to_mds(ds)) if hasattr(net, "_to_mds") else net._batch(ds)


class ParameterAveragingTrainingMaster(TrainingMaster):
    """Synchronous periodic parameter averaging
    (``ParameterAveragingTrainingMaster.java``): the stream is regrouped
    into batches of ``num_workers * batch_size_per_worker`` examples, and
    each run of ``averaging_frequency`` of them trains on
    ``ParallelWrapper(mode="averaging")``: every rank's local steps on its
    block, then parameters, updater state and layer states averaged."""

    def __init__(self, batch_size_per_worker: int = 16,
                 averaging_frequency: int = 5,
                 num_workers: Optional[int] = None,
                 aggregation_depth: int = 2,
                 repartition: str = "always",
                 export_directory: Optional[str] = None,
                 mesh=None, data_axis: str = DATA_AXIS):
        self.batch_size_per_worker = batch_size_per_worker
        self.averaging_frequency = max(1, averaging_frequency)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.data_axis = data_axis
        self.num_workers = num_workers or axis_size(self.mesh, data_axis)
        # accepted for parity: the all-reduce picks its own reduction order
        self.aggregation_depth = aggregation_depth
        self.repartition = repartition
        self.export_directory = export_directory
        self.stats = TrainingStats()
        self._pw: Optional[ParallelWrapper] = None

    class Builder:
        def __init__(self, batch_size_per_worker: int = 16):
            self._kw = {"batch_size_per_worker": batch_size_per_worker}

        def averaging_frequency(self, f):
            self._kw["averaging_frequency"] = f
            return self

        def aggregation_depth(self, d):
            self._kw["aggregation_depth"] = d
            return self

        def workers(self, n):
            self._kw["num_workers"] = n
            return self

        def export_directory(self, d):
            self._kw["export_directory"] = d
            return self

        def mesh(self, m):
            self._kw["mesh"] = m
            return self

        def build(self):
            return ParameterAveragingTrainingMaster(**self._kw)

    # -- data staging ------------------------------------------------------
    def _repartition(self, data_iterator) -> List[DataSet]:
        """Regroup the stream into batches of ``batch_size_per_worker *
        num_workers`` examples (the reference repartitions the RDD so that
        every executor sees equal counts); masked data passes through
        as it came, and the tail is one smaller batch. Tensors stay on
        their device; arrays stay on the host."""
        t0 = time.perf_counter()
        per_round = self.batch_size_per_worker * self.num_workers
        feats, labs, n_buf = [], [], 0
        out: List[DataSet] = []
        for ds in data_iterator:
            if ds.features_mask is not None or ds.labels_mask is not None:
                out.append(ds)
                continue
            feats.append(_rows(ds.features))
            labs.append(_rows(ds.labels))
            n_buf += feats[-1].shape[0]
            while n_buf >= per_round:
                f, l = _cat(feats), _cat(labs)
                out.append(DataSet(f[:per_round], l[:per_round]))
                feats, labs = [f[per_round:]], [l[per_round:]]
                n_buf = feats[0].shape[0]
        if n_buf:
            out.append(DataSet(_cat(feats), _cat(labs)))
        if self.export_directory:
            os.makedirs(self.export_directory, exist_ok=True)
            for i, ds in enumerate(out):
                arrays = {"features": to_host(ds.features), "labels": to_host(ds.labels)}
                if ds.features_mask is not None:
                    arrays["features_mask"] = to_host(ds.features_mask)
                if ds.labels_mask is not None:
                    arrays["labels_mask"] = to_host(ds.labels_mask)
                # a zero-padded index: the names sort in replay order
                np.savez(os.path.join(self.export_directory, f"split{i:06d}.npz"), **arrays)
        self.stats.add("split", time.perf_counter() - t0)
        return out

    @staticmethod
    def load_exported(directory: str) -> List[DataSet]:
        """Replay an export directory (``ExportSupport.java``) in the
        original split order."""
        names = [f for f in os.listdir(directory) if f.endswith(".npz")]
        names.sort(key=lambda f: (len(f), f))  # unpadded names sort too
        out = []
        for f in names:
            z = np.load(os.path.join(directory, f))
            out.append(DataSet(z["features"], z["labels"],
                               z["features_mask"] if "features_mask" in z else None,
                               z["labels_mask"] if "labels_mask" in z else None))
        return out

    # -- training ----------------------------------------------------------
    def execute_training(self, network, data_iterator: Iterable) -> None:
        batches = self._repartition(data_iterator)
        pw = self._pw
        if pw is None or pw.model is not network:
            pw = self._pw = ParallelWrapper(
                network, self.mesh, mode="averaging",
                averaging_frequency=self.averaging_frequency, data_axis=self.data_axis)
        t0 = time.perf_counter()
        pw.fit(batches)
        network.epoch -= 1  # the wrapper counts an epoch; the master's caller owns them
        self.stats.add("fit", time.perf_counter() - t0)


class SharedTrainingMaster(TrainingMaster):
    """Per-step threshold-compressed update sharing
    (``SharedTrainingMaster.java`` + ``EncodedGradientsAccumulator.java:33``),
    one worker a rank (see the module's docstring for the step's order).
    Entries of the accumulated update below ``threshold`` stay in the
    rank's residual; the others are sent as ±threshold."""

    def __init__(self, batch_size_per_worker: int = 16,
                 threshold: float = 1e-3, min_threshold: float = 1e-5,
                 threshold_step: float = 1e-5, step_trigger: float = 0.05,
                 step_delay: int = 50, shake_frequency: int = 0,
                 mesh=None, data_axis: str = DATA_AXIS):
        self.batch_size_per_worker = batch_size_per_worker
        self.threshold = float(threshold)
        self.min_threshold = float(min_threshold)
        self.threshold_step = float(threshold_step)
        self.step_trigger = float(step_trigger)  # the target sparsity
        self.step_delay = step_delay
        self.shake_frequency = shake_frequency
        self.mesh = mesh if mesh is not None else make_mesh()
        self.data_axis = data_axis
        self.num_workers = axis_size(self.mesh, data_axis)
        self.stats = TrainingStats()
        self._net_ref = None
        # {key: {name: [1, *shape]}}: this rank's slice of the reference's
        # worker-stacked residual
        self._residual = None
        self._steps_done = 0
        self._shake_restore: Optional[float] = None
        self._residual_restore = None
        #: the share of entries the last shared step sent (averaged over
        #: the workers), as read for the threshold's adaptation
        self.last_sparsity: Optional[float] = None

    class Builder:
        def __init__(self, batch_size_per_worker: int = 16):
            self._kw = {"batch_size_per_worker": batch_size_per_worker}

        def update_threshold(self, t):
            self._kw["threshold"] = t
            return self

        def min_update_threshold(self, t):
            self._kw["min_threshold"] = t
            return self

        def workers_per_node(self, n):
            return self  # the mesh decides the worker count; accepted for parity

        def mesh(self, m):
            self._kw["mesh"] = m
            return self

        def build(self):
            return SharedTrainingMaster(**self._kw)

    # -- the compression state ---------------------------------------------
    def state_snapshot(self) -> dict:
        """This rank's compression state (the threshold machinery and its
        residual) as host arrays, under the reference's keys: ``res{i}``
        is the i-th parameter leaf's residual with a leading worker axis
        of 1 (the reference's multi-process shard)."""
        snap = {
            "threshold": np.float64(self.threshold),
            "steps_done": np.int64(self._steps_done),
            "shake_restore": np.float64(-1.0 if self._shake_restore is None
                                        else self._shake_restore),
        }
        if self._residual is not None:
            for i, leaf in enumerate(_leaves(self._residual)):
                snap[f"res{i}"] = to_host(leaf).copy()
        return snap

    @staticmethod
    def write_state_snapshot(snapshot: dict, path: str) -> None:
        """Write a :meth:`state_snapshot` npz atomically (a temporary file
        renamed over ``path``), so a save cut short never leaves a torn
        file under the name."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as fh:  # a handle: savez would append .npz to a name
            np.savez(fh, **snapshot)
        os.replace(tmp, path)

    def save_state(self, path: str) -> None:
        """Write this rank's compression state as an npz. In a world of
        several ranks every rank saves its own file."""
        self.write_state_snapshot(self.state_snapshot(), path)

    def load_state(self, path: str) -> None:
        """Restore a state written by :meth:`save_state` (or the
        reference's). Each saved residual leaf has a leading worker axis
        of n entries (C36): n = 1 is this rank's own slice; n equal to
        the worker count W is a stack of the same workers, and rank r
        takes its row r; any other n is a stack of another worker count,
        whose sum is spread evenly over the W workers (total / W on every
        rank), so the unsent update mass survives (a world of one takes
        the whole sum). The per-parameter shapes must match. A master
        already bound to a network places the residual now; else at the
        next ``execute_training``."""
        data = np.load(path)
        self.threshold = float(data["threshold"])
        self._steps_done = int(data["steps_done"])
        sr = float(data["shake_restore"])
        self._shake_restore = None if sr < 0 else sr
        res = [data[k] for k in sorted((k for k in data.files if k.startswith("res")),
                                       key=lambda k: int(k[3:]))]
        self._residual_restore = res or None
        if self._residual is not None and self._residual_restore is not None:
            self._place_restored_residual()

    def _place_restored_residual(self) -> None:
        saved, self._residual_restore = self._residual_restore, None
        leaves = _leaves(self._residual)
        if len(saved) != len(leaves):
            raise ValueError(f"restored residual has {len(saved)} leaves, model needs "
                             f"{len(leaves)} — was the checkpoint from this architecture?")
        w = self.num_workers
        rank = int(self.mesh.get_local_rank(self.data_axis))
        for z, s in zip(leaves, saved):
            if tuple(s.shape[1:]) != tuple(z.shape[1:]):
                raise ValueError(
                    f"restored residual shape {s.shape} does not match {tuple(z.shape)}"
                    " — the checkpoint is from a different architecture, not just a "
                    "different worker count: skip load_state and re-accumulate")
            n = s.shape[0]
            if n == 1:
                mine = s[0]
            elif n == w:
                mine = s[rank]
            else:  # another worker count: conserve the unsent mass
                mine = np.asarray(s, np.float64).sum(axis=0) / w
            with torch.no_grad():
                z.copy_(torch.as_tensor(np.asarray(mine, np.float32)).reshape(z.shape))

    def _adapt_threshold(self, sparsity: float) -> None:
        """``EncodingHandler.java:69-94``: lower the threshold toward its
        minimum when almost nothing passes, raise it when too much does,
        and every ``shake_frequency`` steps halve it for one step."""
        self._steps_done += 1
        if self._shake_restore is not None:
            # the step before was a shake: back to the working threshold
            self.threshold = self._shake_restore
            self._shake_restore = None
        if self._steps_done < self.step_delay:
            return
        if sparsity < 1e-4:
            self.threshold = max(self.min_threshold, self.threshold - self.threshold_step)
        elif sparsity > self.step_trigger:
            self.threshold = self.threshold + self.threshold_step
        if self.shake_frequency and self._steps_done % self.shake_frequency == 0:
            self._shake_restore = self.threshold
            self.threshold = max(self.min_threshold, self.threshold * 0.5)

    # -- training ----------------------------------------------------------
    def _bind(self, network) -> None:
        """Each rank a whole replica on plain tensors, and a zero residual
        of each parameter's shape (or the restored one)."""
        self._net_ref = network
        unshard_model(network)
        self._residual = {k: {n: torch.zeros((1,) + tuple(p.shape), dtype=p.dtype,
                                             device=p.device)
                              for n, p in named.items()}
                          for k, named in network.params.items()}
        if self._residual_restore is not None:
            self._place_restored_residual()

    def _step(self, network, ds: DataSet):
        """One shared step on this rank's block of ``ds``; returns the
        averaged loss and sparsity (device scalars)."""
        w = self.num_workers
        rank = int(self.mesh.get_local_rank(self.data_axis))
        n = int(ds.features.shape[0])
        block = slice(rank * (n // w), (rank + 1) * (n // w))
        batch = _local_batch(network, DataSet(ds.features[block], ds.labels[block]))
        params = _leaves(network.params)
        residual = _leaves(self._residual)
        group = self.mesh.get_group(self.data_axis)
        thr = np.float32(self.threshold)
        with torch.no_grad():
            before = [p.detach().clone() for p in params]
        saved = network.dropout_generator
        network.dropout_generator = rank_generator(network, self.mesh, self.data_axis)
        try:
            loss = network._train_step(*batch)  # the gradient, then the updater
        finally:
            network.dropout_generator = saved
        with torch.no_grad():
            nz = torch.zeros((), dtype=torch.int64, device=loss.device)
            total = 0
            for p, b, r in zip(params, before, residual):
                acc = r + (b - p)[None]
                quant = torch.where(acc.abs() >= thr, torch.sign(acc) * thr,
                                    torch.zeros((), dtype=acc.dtype, device=acc.device))
                r.copy_(acc - quant)
                nz += (quant != 0).sum()
                total += quant.numel()
                dist.all_reduce(quant, op=dist.ReduceOp.SUM, group=group)
                p.copy_(b - quant[0])
            sparsity = nz.to(torch.float32) / total
            averaged = [t for named in (network.states or {}).values() for t in named.values()]
            averaged += [s for named in (network.updater_states or {}).values()
                         for slots in named.values() for s in (slots or {}).values()
                         if isinstance(s, torch.Tensor)]
            pmean_(averaged + [loss, sparsity], self.mesh, self.data_axis)
        return loss, sparsity

    def execute_training(self, network, data_iterator: Iterable) -> None:
        if network.params is None:
            network.init()
        mp = is_multiprocess(self.mesh)
        if self._net_ref is not network:
            self._bind(network)
        t0 = time.perf_counter()
        for ds in data_iterator:
            n = int(ds.features.shape[0])
            if n % self.num_workers or ds.features_mask is not None \
                    or ds.labels_mask is not None:
                if mp:
                    raise ValueError(
                        "multi-process SharedTrainingMaster requires batch sizes "
                        f"divisible by {self.num_workers} workers and no masks (got "
                        f"batch {n}, masks={ds.features_mask is not None})")
                # a ragged tail or masked data: the plain step, unsharded
                with network.training_step():
                    network._fit_batch(ds)
                continue
            with network.training_step():
                loss, sparsity = self._step(network, ds)
            network.score_ = loss
            network.last_batch_size = n
            self.last_sparsity = float(sparsity)
            self._adapt_threshold(self.last_sparsity)
            network._notify("iteration_done", network.iteration, network.epoch)
        self.stats.add("fit", time.perf_counter() - t0)


class DistributedMultiLayerNetwork:
    """A network paired with a TrainingMaster (``SparkDl4jMultiLayer.java:71``:
    ``fit`` hands each epoch's data to the master)."""

    def __init__(self, network, training_master: TrainingMaster):
        self.network = network
        self.master = training_master

    def fit(self, data_iterator, epochs: int = 1):
        if self.network.params is None:
            self.network.init()
        # settle the NTP offset before the first phase stamp, so that the
        # timeline never jumps mid-run
        from deeplearning4j_tpu_torch.parallel.time_source import get_time_source
        get_time_source().ensure_synced()
        for _ in range(epochs):
            if hasattr(data_iterator, "reset"):
                data_iterator.reset()
            self.master.execute_training(self.network, data_iterator)
            self.network.epoch += 1
        return self.network

    def evaluate(self, iterator):
        return self.network.evaluate(iterator)

    def get_training_stats(self) -> TrainingStats:
        return self.master.get_training_stats()
