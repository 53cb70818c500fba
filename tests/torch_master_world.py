"""The port's side of the training masters' parity tests
(``tests/test_torch_parallel_master.py``), run in the 4-rank gloo world of
``tests/torch_parallel_world.py``: each scenario here joins its
``SCENARIOS`` when a rank imports this module.

Every rank is one worker of the mesh's ``data`` axis. A scenario's result
holds rank 0's parameters (and, where the case reads it, the residual of
every rank, gathered in rank order into the reference's worker-stacked
layout).

This module imports torch and the port only.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from torch_parallel_world import mesh, scenario


def master_net(seed=7, lr=0.1):
    """The reference test's network: Dense(12, tanh) and a 3-class
    output over 6 features, plain SGD."""
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Sgd

    conf = (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(lr)).list()
            .layer(DenseLayer(n_out=12, activation="tanh"))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(6)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def carried(net, inp, key="params"):
    from deeplearning4j_tpu_torch.util import convert

    convert.load_reference_params(net, inp[key])
    return net


def params_of(net):
    from deeplearning4j_tpu_torch.util import convert

    return convert.export_params(net)


def dataset(inp, x="x", y="y"):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    return DataSet(inp[x], inp[y])


def gathered_residual(master):
    """Every rank's residual, stacked in rank order along the worker axis
    (the reference's single-process layout), as a list of layer dicts."""
    out = []
    for k in sorted(master._residual):
        layer = {}
        for n in sorted(master._residual[k]):
            mine = master._residual[k][n].contiguous()
            parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
            dist.all_gather(parts, mine)
            layer[n] = torch.cat(parts).numpy()
        out.append(layer)
    return out


def accuracy(net, inp):
    from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator

    return net.evaluate(ListDataSetIterator(dataset(inp), 128)).accuracy()


# --------------------------------------------------- ParameterAveraging
@scenario
def joined_world(inp):
    """The world as ``init_distributed`` joined it: the backend, the size,
    each rank's process id, one SUM all-reduce and the store behind it."""
    ranks = [torch.zeros(1) for _ in range(dist.get_world_size())]
    dist.all_gather(ranks, torch.tensor([float(dist.get_rank())]))
    total = torch.tensor([dist.get_rank() + 1.0])
    dist.all_reduce(total)
    store = dist.distributed_c10d._get_default_store()
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "ranks": [int(r) for r in ranks], "sum": float(total),
            "store": type(getattr(store, "underlying_store", store)).__name__}


@scenario
def pa_matches_single(inp):
    from deeplearning4j_tpu_torch.parallel import (DistributedMultiLayerNetwork,
                                                   ParameterAveragingTrainingMaster)

    net = carried(master_net(seed=3), inp)
    master = ParameterAveragingTrainingMaster(batch_size_per_worker=16,
                                              averaging_frequency=1, mesh=mesh({"data": 4}))
    DistributedMultiLayerNetwork(net, master).fit([dataset(inp)])
    return {"params": params_of(net), "iteration": net.iteration, "epoch": net.epoch}


@scenario
def pa_split_sizing(inp):
    from deeplearning4j_tpu_torch.parallel import (DistributedMultiLayerNetwork,
                                                   ParameterAveragingTrainingMaster)

    net = carried(master_net(), inp)
    master = ParameterAveragingTrainingMaster.Builder(8).averaging_frequency(3).build()
    master.mesh = mesh({"data": 4})
    master.num_workers = 4
    front = DistributedMultiLayerNetwork(net, master)
    front.fit([dataset(inp)], epochs=10)
    stats = front.get_training_stats().as_dict()
    return {"params": params_of(net), "accuracy": accuracy(net, inp),
            "stats": sorted(stats), "iteration": net.iteration, "epoch": net.epoch,
            "evaluate": front.evaluate([dataset(inp)]).accuracy()}


@scenario
def pa_tail_split(inp):
    from deeplearning4j_tpu_torch.parallel import (DistributedMultiLayerNetwork,
                                                   ParameterAveragingTrainingMaster)

    net = carried(master_net(), inp)
    master = ParameterAveragingTrainingMaster(batch_size_per_worker=16,
                                              averaging_frequency=5, mesh=mesh({"data": 4}))
    DistributedMultiLayerNetwork(net, master).fit([dataset(inp)], epochs=2)
    return {"params": params_of(net), "iteration": net.iteration,
            "splits": [int(d.features.shape[0]) for d in master._repartition([dataset(inp)])]}


@scenario
def pa_export_replay(inp):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import ParameterAveragingTrainingMaster

    d = os.path.join(inp["dir"], f"rank{dist.get_rank()}")
    master = ParameterAveragingTrainingMaster(batch_size_per_worker=8, export_directory=d,
                                              mesh=mesh({"data": 4}))
    m = np.ones((inp["x"].shape[0], 1), np.float32)
    staged = master._repartition([dataset(inp), DataSet(inp["x"][:8], inp["y"][:8], m[:8])])
    loaded = ParameterAveragingTrainingMaster.load_exported(d)
    return {"staged": [tuple(s.features.shape) for s in staged],
            "loaded": [tuple(s.features.shape) for s in loaded],
            "masked": [s.features_mask is not None for s in loaded],
            "same": all(np.array_equal(np.asarray(a.features), b.features)
                        for a, b in zip(staged, loaded)),
            "files": sorted(os.listdir(d))}


# ------------------------------------------------------ SharedTraining
def shared(inp, **kw):
    from deeplearning4j_tpu_torch.parallel import SharedTrainingMaster

    return SharedTrainingMaster(mesh=mesh({"data": 4}), **kw)


@scenario
def shared_trains(inp):
    from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import DistributedMultiLayerNetwork

    net = carried(master_net(lr=0.05), inp)
    master = shared(inp, batch_size_per_worker=16, threshold=1e-3)
    front = DistributedMultiLayerNetwork(net, master)
    front.fit(ListDataSetIterator(dataset(inp), 128, shuffle=True, seed=1), epochs=15)
    return {"accuracy": accuracy(net, inp), "iteration": net.iteration,
            "threshold": master.threshold, "steps_done": master._steps_done}


@scenario
def shared_steps(inp):
    """Three steps at a threshold that many entries reach, step_delay 0:
    the parameters, every worker's residual, each step's loss and the
    threshold after each step."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import DistributedMultiLayerNetwork

    net = carried(master_net(lr=0.05), inp)
    master = shared(inp, batch_size_per_worker=16, threshold=1e-3, step_delay=0,
                    threshold_step=1e-4)
    front = DistributedMultiLayerNetwork(net, master)
    losses, thresholds, heard = [], [], []

    class Heard:
        def iteration_done(self, model, iteration, epoch):
            heard.append(iteration)

    net.set_listeners(Heard())
    for i in range(3):
        front.fit([DataSet(inp["x"][i * 64:(i + 1) * 64], inp["y"][i * 64:(i + 1) * 64])])
        losses.append(net.score_)
        thresholds.append(master.threshold)
    return {"params": params_of(net), "residual": gathered_residual(master),
            "losses": losses, "thresholds": thresholds, "heard": heard,
            "iteration": net.iteration, "epoch": net.epoch}


@scenario
def shared_residual_kept(inp):
    from deeplearning4j_tpu_torch.parallel import DistributedMultiLayerNetwork

    net = carried(master_net(lr=0.05), inp)
    before = params_of(net)
    master = shared(inp, batch_size_per_worker=8, threshold=1e6)
    DistributedMultiLayerNetwork(net, master).fit([dataset(inp)])
    return {"before": before, "params": params_of(net),
            "residual": gathered_residual(master)}


@scenario
def shared_threshold_and_builder(inp):
    from deeplearning4j_tpu_torch.parallel import SharedTrainingMaster

    m = shared(inp, batch_size_per_worker=8, threshold=1e-3, threshold_step=1e-4,
               step_delay=0, shake_frequency=3)
    seq = []
    for s in (0.0, 0.5, 0.01, 0.0, 0.5, 0.5):
        m._adapt_threshold(s)
        seq.append(m.threshold)
    b = (SharedTrainingMaster.Builder(32).update_threshold(5e-4)
         .min_update_threshold(1e-6).workers_per_node(4).build())
    return {"seq": seq, "builder": [b.batch_size_per_worker, b.threshold, b.min_threshold,
                                    b.num_workers]}


@scenario
def shared_ragged_raises(inp):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import DistributedMultiLayerNetwork

    out = {}
    net = carried(master_net(lr=0.05), inp)
    for name, ds in (("ragged", DataSet(inp["x"][:30], inp["y"][:30])),
                     ("masked", DataSet(inp["x"][:32], inp["y"][:32], None,
                                        np.ones((32,), np.float32)))):
        try:
            DistributedMultiLayerNetwork(net, shared(inp, threshold=1e-3)).fit([ds])
            out[name] = "trained"
        except ValueError as e:
            out[name] = str(e)
    return out


# ------------------------------------------------------ the state file
def _fits(front, inp, n):
    for _ in range(n):
        front.fit([dataset(inp)])


@scenario
def state_resume(inp):
    """Six fits uninterrupted against three, every rank's state saved, a
    fresh master restoring it, three more: equal bit for bit."""
    from deeplearning4j_tpu_torch.parallel import DistributedMultiLayerNetwork

    kw = dict(batch_size_per_worker=32, threshold=1e-3, step_delay=0, threshold_step=1e-4)
    net_a = carried(master_net(lr=0.05), inp)
    _fits(DistributedMultiLayerNetwork(net_a, shared(inp, **kw)), inp, 6)
    net_b = carried(master_net(lr=0.05), inp)
    m_b = shared(inp, **kw)
    _fits(DistributedMultiLayerNetwork(net_b, m_b), inp, 3)
    path = os.path.join(inp["dir"], f"state{dist.get_rank()}.npz")
    m_b.save_state(path)
    m_b2 = shared(inp, **kw)
    m_b2.load_state(path)
    restored = [m_b2.threshold == m_b.threshold, m_b2._steps_done == m_b._steps_done]
    _fits(DistributedMultiLayerNetwork(net_b, m_b2), inp, 3)
    saved = dict(np.load(path))
    return {"a": params_of(net_a), "b": params_of(net_b), "restored": restored,
            "keys": sorted(saved), "res0_shape": saved["res0"].shape,
            "no_tmp": not any(".tmp." in f for f in os.listdir(inp["dir"]))}


@scenario
def state_reshape(inp):
    """The reference's state file of 4 workers (``inp["stack"]``) loaded on
    a ``data=2, model=2`` mesh (two workers: each rank takes half the
    summed residual), then one fit."""
    from deeplearning4j_tpu_torch.parallel import (DistributedMultiLayerNetwork,
                                                   SharedTrainingMaster)

    net = carried(master_net(lr=0.05), inp, key="trained")
    m = SharedTrainingMaster(batch_size_per_worker=16, threshold=1e-3,
                             mesh=mesh({"data": 2, "model": 2}))
    m.load_state(inp["stack"])
    front = DistributedMultiLayerNetwork(net, m)
    loaded = m._residual_restore is not None
    front.fit([dataset(inp)])
    return {"params": params_of(net), "residual": gathered_residual(m),
            "threshold": m.threshold, "pending_before_fit": loaded,
            "iteration": net.iteration}


@scenario
def state_cross_package(inp):
    """The reference's state file of the same 4 workers loads row by row
    (each rank its own); two fits from there; then every rank's own file
    is written for the reference to load back."""
    from deeplearning4j_tpu_torch.parallel import DistributedMultiLayerNetwork

    kw = dict(batch_size_per_worker=16, threshold=1e-3, step_delay=0, threshold_step=1e-4)
    net = carried(master_net(lr=0.05), inp, key="trained")
    m = shared(inp, **kw)
    front = DistributedMultiLayerNetwork(net, m)
    m.load_state(inp["stack"])
    _fits(front, inp, 2)
    m.save_state(os.path.join(inp["dir"], f"port{dist.get_rank()}.npz"))
    return {"params": params_of(net), "residual": gathered_residual(m),
            "threshold": m.threshold, "steps_done": m._steps_done}
