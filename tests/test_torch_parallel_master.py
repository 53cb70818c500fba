"""The port's training masters (``parallel/master.py``) in a 4-rank gloo
world, held against the JAX package's on a mesh of the same shape.

One module-scoped fixture writes the scenarios' inputs (the reference
networks' initial parameters, the seeded data, the reference's state
files) to a pickle and spawns one world of 4 CPU ranks that runs only
this file's scenarios (``tests/torch_master_world.py`` through
``tests/torch_parallel_world.py``'s ``run_world``). The ranks join that
world as a launcher joins them, through the port's ``init_distributed``
on a TCP store on the loopback address. Each case then runs
the reference's ``tests/test_master.py`` case on the first 4 of its 8
virtual CPU devices (``data=4`` where the reference uses 8, the batch
per worker doubled so that each split or step sees the same examples)
and compares at the reference file's tolerance (rtol 2e-4, atol 2e-5).
The cases the reference checks by accuracy alone are also held
parameter by parameter where the run is deterministic. The world-of-one
cases (the unsharded ragged path, a world of one loading a stack of
workers) run in this process in a gloo world of one rank.
"""

from __future__ import annotations

import functools
import os
import pickle
import socket

import jax
import numpy as np
import pytest

import torch_parallel_world as W
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JListIt
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Sgd as JSgd
from deeplearning4j_tpu.parallel import DistributedMultiLayerNetwork as JDist
from deeplearning4j_tpu.parallel import ParameterAveragingTrainingMaster as JPA
from deeplearning4j_tpu.parallel import SharedTrainingMaster as JShared
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh

RTOL, ATOL = 2e-4, 2e-5
SHARED_KW = dict(threshold=1e-3, step_delay=0, threshold_step=1e-4)


def jmesh(axes):
    return jmake_mesh(axes, jax.devices()[:W.WORLD])


def j_net(seed=7, lr=0.1):
    conf = (JNNC.builder().seed(seed).updater(JSgd(lr)).list()
            .layer(JDense(n_out=12, activation="tanh"))
            .layer(JOut(n_out=3))
            .set_input_type(JIT.feed_forward(6)).build())
    return JMLN(conf).init()


def data(n=256, seed=0):
    """The reference test's data: 3 classes over 6 features."""
    rng = np.random.default_rng(seed)
    y_idx = rng.integers(0, 3, n)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    x[np.arange(n), y_idx] += 2.5
    return x, np.eye(3, dtype=np.float32)[y_idx]


def host(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a).copy(), tree)


def initial(net) -> dict:
    return {"params": host(net.params)}


def assert_trees_close(port, ref, rtol=RTOL, atol=ATOL):
    ref = host(ref)
    assert len(port) == len(ref)
    for k, (pl, rl) in enumerate(zip(port, ref)):
        assert set(pl) == set(rl)
        for n in rl:
            np.testing.assert_allclose(np.asarray(pl[n]), np.asarray(rl[n]),
                                       rtol=rtol, atol=atol, err_msg=f"{k}/{n}")


@functools.lru_cache(maxsize=None)
def reference_stack(tmp):
    """The reference's SharedTrainingMaster on data=4 after one fit: its
    parameters and its state file (a 4-worker residual stack)."""
    x, y = data(64, seed=5)
    net = j_net(lr=0.05)
    m = JShared(batch_size_per_worker=16, mesh=jmesh({"data": 4}), **SHARED_KW)
    JDist(net, m).fit([JDataSet(x, y)])
    path = os.path.join(tmp, "reference_state.npz")
    m.save_state(path)
    return host(net.params), path


def scenario_inputs(tmp) -> dict:
    x64, y64 = data(64)
    trained, stack = reference_stack(tmp)
    x5, y5 = data(64, seed=5)
    return {
        "joined_world": {},
        "pa_matches_single": {**initial(j_net(seed=3)), "x": x64, "y": y64},
        "pa_split_sizing": {**initial(j_net()), **dict(zip("xy", data(300)))},
        "pa_tail_split": {**initial(j_net()), **dict(zip("xy", data(96)))},
        "pa_export_replay": {"x": x64, "y": y64, "dir": tmp},
        "shared_trains": {**initial(j_net(lr=0.05)), **dict(zip("xy", data(512)))},
        "shared_steps": {**initial(j_net(lr=0.05)), **dict(zip("xy", data(192, seed=2)))},
        "shared_residual_kept": {**initial(j_net(lr=0.05)), "x": x64, "y": y64},
        "shared_threshold_and_builder": {},
        "shared_ragged_raises": {**initial(j_net(lr=0.05)), "x": x64, "y": y64},
        "state_resume": {**initial(j_net(lr=0.05)), **dict(zip("xy", data(128))),
                         "dir": tmp},
        "state_reshape": {"trained": trained, "stack": stack, "x": x5, "y": y5},
        "state_cross_package": {"trained": trained, "stack": stack, "x": x5, "y": y5,
                                "dir": tmp},
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("master_world")
    inputs = scenario_inputs(str(d))
    with open(d / "in.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    with socket.socket() as s:  # a free port for rank 0's TCP store
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    W.run_world(str(d / "in.pkl"), str(d / "out.pkl"), f"localhost:{port}",
                modules=("torch_master_world",))
    with open(d / "out.pkl", "rb") as fh:
        results = pickle.load(fh)

    def get(name):
        got = results[name]
        if isinstance(got, dict) and "__error__" in got:
            pytest.fail(f"the port's {name} scenario raised:\n{got['__error__']}")
        return inputs[name], got

    return get


def j_carried(inp, seed=7, lr=0.1, key="params"):
    net = j_net(seed=seed, lr=lr)
    net.params = jax.tree_util.tree_map(np.asarray, inp[key])
    return net


# ------------------------------------------------------ parameter averaging
class TestParameterAveragingMaster:
    def test_matches_single_machine_sgd(self, world):
        """averaging_frequency=1 with SGD: the averaged parameters equal one
        step of the whole batch on one machine."""
        inp, got = world("pa_matches_single")
        ref = j_carried(inp, seed=3)
        JDist(ref, JPA(batch_size_per_worker=16, averaging_frequency=1,
                       mesh=jmesh({"data": 4}))).fit([JDataSet(inp["x"], inp["y"])])
        local = j_net(seed=3)
        local.fit(JDataSet(inp["x"], inp["y"]))
        assert_trees_close(got["params"], ref.params)
        assert_trees_close(got["params"], local.params)
        assert got["iteration"] == ref.iteration and got["epoch"] == ref.epoch == 1

    def test_split_sizing_and_training(self, world):
        inp, got = world("pa_split_sizing")
        ref = j_carried(inp)
        master = JPA.Builder(8).averaging_frequency(3).build()
        master.mesh = jmesh({"data": 4})
        master.num_workers = 4
        front = JDist(ref, master)
        front.fit([JDataSet(inp["x"], inp["y"])], epochs=10)
        ev = ref.evaluate(JListIt(JDataSet(inp["x"], inp["y"]), 128))
        assert got["accuracy"] > 0.85 and ev.accuracy() > 0.85
        assert got["accuracy"] == got["evaluate"]
        assert got["stats"] == sorted(front.get_training_stats().as_dict()) == ["fit", "split"]
        assert got["iteration"] == ref.iteration and got["epoch"] == ref.epoch == 10
        assert_trees_close(got["params"], ref.params)

    def test_worker_divisible_tail_split(self, world):
        """96 examples in rounds of 64 leave a 32-example tail that divides
        the 4 workers: it trains (not a crash on stacking mixed shapes)."""
        inp, got = world("pa_tail_split")
        ref = j_carried(inp)
        master = JPA(batch_size_per_worker=16, averaging_frequency=5, mesh=jmesh({"data": 4}))
        JDist(ref, master).fit([JDataSet(inp["x"], inp["y"])], epochs=2)
        assert got["splits"] == [64, 32]
        assert got["iteration"] == ref.iteration > 0
        assert_trees_close(got["params"], ref.params)

    def test_export_and_replay(self, world, tmp_path):
        inp, got = world("pa_export_replay")
        master = JPA(batch_size_per_worker=8, export_directory=str(tmp_path),
                     mesh=jmesh({"data": 4}))
        m = np.ones((64, 1), np.float32)
        master._repartition([JDataSet(inp["x"], inp["y"]),
                             JDataSet(inp["x"][:8], inp["y"][:8], m[:8])])
        loaded = JPA.load_exported(str(tmp_path))
        assert got["files"] == sorted(os.listdir(tmp_path))
        assert got["loaded"] == [tuple(d.features.shape) for d in loaded] == got["staged"]
        assert got["masked"] == [d.features_mask is not None for d in loaded]
        assert got["same"] and got["loaded"][0] == (32, 6)


# ------------------------------------------------------- shared training
class TestSharedTrainingMaster:
    def test_trains_with_threshold_compression(self, world):
        inp, got = world("shared_trains")
        ref = j_carried(inp, lr=0.05)
        master = JShared(batch_size_per_worker=16, threshold=1e-3, mesh=jmesh({"data": 4}))
        JDist(ref, master).fit(JListIt(JDataSet(inp["x"], inp["y"]), 128, shuffle=True,
                                       seed=1), epochs=15)
        ev = ref.evaluate(JListIt(JDataSet(inp["x"], inp["y"]), 256))
        assert got["accuracy"] > 0.85 and ev.accuracy() > 0.85
        assert got["iteration"] == ref.iteration == 60
        assert got["steps_done"] == master._steps_done == 60

    def test_steps_match_the_reference(self, world):
        """Three steps with entries on both sides of the threshold: every
        parameter, every worker's residual, each loss and the adapted
        threshold after each step."""
        inp, got = world("shared_steps")
        ref = j_carried(inp, lr=0.05)
        master = JShared(batch_size_per_worker=16, mesh=jmesh({"data": 4}), **SHARED_KW)
        front = JDist(ref, master)
        losses, thresholds = [], []
        for i in range(3):
            front.fit([JDataSet(inp["x"][i * 64:(i + 1) * 64], inp["y"][i * 64:(i + 1) * 64])])
            losses.append(float(ref.score_))
            thresholds.append(master.threshold)
        np.testing.assert_allclose(got["losses"], losses, rtol=RTOL, atol=ATOL)
        assert got["thresholds"] == pytest.approx(thresholds, rel=1e-12)
        assert got["heard"] == [1, 2, 3] and got["iteration"] == ref.iteration == 3
        assert got["epoch"] == ref.epoch == 3
        assert_trees_close(got["params"], ref.params)
        assert_trees_close(got["residual"], master._residual)
        # updates passed the threshold (the parameters moved and the
        # sparsity raised the threshold each step) and remainders wait
        moved = [np.abs(got["params"][k][n] - inp["params"][k][n]).max()
                 for k in range(2) for n in got["params"][k]]
        assert min(moved) > 0 and got["thresholds"] == sorted(set(got["thresholds"]))
        assert all(np.abs(r).max() > 0 for layer in got["residual"] for r in layer.values())

    def test_residual_preserved_between_steps(self, world):
        """Update mass below the threshold accumulates in the residual
        (nothing passes a threshold of 1e6), and the parameters stay."""
        inp, got = world("shared_residual_kept")
        ref = j_carried(inp, lr=0.05)
        master = JShared(batch_size_per_worker=8, threshold=1e6, mesh=jmesh({"data": 4}))
        JDist(ref, master).fit([JDataSet(inp["x"], inp["y"])])
        for before, after in zip(got["before"], got["params"]):
            for k in before:
                np.testing.assert_array_equal(before[k], after[k])
        total = sum(float(np.abs(r).sum()) for layer in got["residual"] for r in layer.values())
        assert total > 0
        assert_trees_close(got["residual"], master._residual)

    def test_threshold_adapts_and_builder(self, world):
        _, got = world("shared_threshold_and_builder")
        m = JShared(batch_size_per_worker=8, threshold=1e-3, threshold_step=1e-4,
                    step_delay=0, shake_frequency=3, mesh=jmesh({"data": 4}))
        seq = []
        for s in (0.0, 0.5, 0.01, 0.0, 0.5, 0.5):
            m._adapt_threshold(s)
            seq.append(m.threshold)
        assert got["seq"] == seq
        assert got["seq"][0] < 1e-3 and got["seq"][1] > got["seq"][0]
        b = (JShared.Builder(32).update_threshold(5e-4).min_update_threshold(1e-6)
             .workers_per_node(4).build())
        assert got["builder"][:3] == [b.batch_size_per_worker, b.threshold,
                                      b.min_threshold] == [32, 5e-4, 1e-6]
        assert got["builder"][3] == W.WORLD

    def test_multi_process_rejects_ragged_and_masked_batches(self, world):
        _, got = world("shared_ragged_raises")
        assert "divisible by 4 workers" in got["ragged"]
        assert "masks=False" in got["ragged"] and "batch 30" in got["ragged"]
        assert "divisible by 4 workers" in got["masked"]


# ------------------------------------------------------------ the state
class TestMasterStateCheckpoint:
    def test_save_load_state_resume_equality(self, world):
        inp, got = world("state_resume")
        assert got["restored"] == [True, True]
        for la, lb in zip(got["a"], got["b"]):
            for k in la:
                np.testing.assert_array_equal(la[k], lb[k])
        assert got["keys"] == ["res0", "res1", "res2", "res3", "shake_restore",
                               "steps_done", "threshold"]
        assert got["res0_shape"] == (1, 6, 12)  # the rank's worker slice
        assert got["no_tmp"]

    def test_load_state_worker_count_reshape_trains(self, world):
        """A 4-worker file on a mesh of 2 workers: each worker takes half the
        saved sum, then trains as the reference does."""
        inp, got = world("state_reshape")
        ref = j_carried(inp, lr=0.05, key="trained")
        m = JShared(batch_size_per_worker=16, threshold=1e-3,
                    mesh=jmesh({"data": 2, "model": 2}))
        m.load_state(inp["stack"])
        JDist(ref, m).fit([JDataSet(inp["x"], inp["y"])])
        assert got["pending_before_fit"] and got["iteration"] == ref.iteration > 0
        assert got["threshold"] == m.threshold
        assert_trees_close(got["params"], ref.params)
        # the port gathers its 4 ranks; ranks of one data index agree
        for layer, rlayer in zip(got["residual"], m._residual):
            for n, r in layer.items():
                np.testing.assert_array_equal(r[0], r[1])
                np.testing.assert_array_equal(r[2], r[3])
                np.testing.assert_allclose(r[[0, 2]], np.asarray(rlayer[n]), rtol=RTOL, atol=ATOL)

    def test_state_files_cross_between_the_packages(self, world, tmp_path):
        """The reference's 4-worker file loads in the port's world (rank r
        takes row r); the ranks' own files, stacked, load in the
        reference; either way training continues alike."""
        inp, got = world("state_cross_package")
        ref = j_carried(inp, lr=0.05, key="trained")
        m = JShared(batch_size_per_worker=16, mesh=jmesh({"data": 4}), **SHARED_KW)
        front = JDist(ref, m)
        m.load_state(inp["stack"])
        for _ in range(2):
            front.fit([JDataSet(inp["x"], inp["y"])])
        assert got["steps_done"] == m._steps_done == 3
        assert got["threshold"] == pytest.approx(m.threshold, rel=1e-12)
        assert_trees_close(got["params"], ref.params)
        assert_trees_close(got["residual"], m._residual)

        files = [np.load(os.path.join(inp["dir"], f"port{r}.npz")) for r in range(W.WORLD)]
        stacked = {k: files[0][k] for k in ("threshold", "steps_done", "shake_restore")}
        for k in files[0].files:
            if k.startswith("res"):
                stacked[k] = np.concatenate([f[k] for f in files])
        path = str(tmp_path / "from_port.npz")
        np.savez(path, **stacked)
        back = j_net(lr=0.05)
        back.params = jax.tree_util.tree_map(np.asarray, got["params"])
        m_back = JShared(batch_size_per_worker=16, mesh=jmesh({"data": 4}), **SHARED_KW)
        m_back.load_state(path)
        JDist(back, m_back).fit([JDataSet(inp["x"], inp["y"])])
        front.fit([JDataSet(inp["x"], inp["y"])])
        assert m_back.threshold == pytest.approx(m.threshold, rel=1e-12)
        assert_trees_close(host(back.params), ref.params)


# ------------------------------------------------------------ one process
class TestTimeSource:
    def test_training_stats_events_use_time_source(self):
        from deeplearning4j_tpu.parallel.master import TrainingStats as JStats
        from deeplearning4j_tpu_torch.parallel.master import TrainingStats
        from deeplearning4j_tpu_torch.parallel.time_source import TimeSource

        class Fixed(TimeSource):
            def current_time_millis(self):
                return 1_000_000

        st, ref = TrainingStats(time_source=Fixed()), JStats(time_source=Fixed())
        for s in (st, ref):
            s.add("fit", 2.0)
            s.add("split", 0.25)
        phase, start, dur = st.events[0]
        assert phase == "fit" and dur == 2000 and start == 1_000_000 - 2000
        assert st.total("fit") == 2.0
        assert st.events == ref.events and st.as_dict() == ref.as_dict()


def test_init_distributed_joins_a_gloo_world_over_tcp(world):
    """The file's world was joined through ``init_distributed``: each
    process id became its rank, gloo on the CPU, one SUM all-reduce over
    the 4 ranks, the group's store a TCP store."""
    _, got = world("joined_world")
    assert got == {"backend": "gloo", "world": W.WORLD, "ranks": list(range(W.WORLD)),
                   "sum": float(sum(range(1, W.WORLD + 1))), "store": "TCPStore"}


def test_init_distributed_is_a_no_op_for_one_process():
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.master import init_distributed

    init_distributed()
    init_distributed("127.0.0.1:1", num_processes=1, process_id=0)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="host:port"):
        init_distributed("no-port", num_processes=2, process_id=0, device_type="cpu")


def test_world_of_one_ragged_path_and_stack_reshape(tmp_path):
    """In a world of one: a masked batch takes the unsharded plain step
    (as the reference's single process does), and a saved
    stack of 4 workers loads as its sum, as the reference's data=1 mesh
    loads it."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import DistributedMultiLayerNetwork, SharedTrainingMaster
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    from torch_master_world import carried, master_net, params_of

    x, y = data(64, seed=5)
    trained, stack = reference_stack(str(tmp_path))
    try:
        one = make_mesh({"data": 1}, device_type="cpu")
        net = carried(master_net(lr=0.05), {"params": trained})
        twin = carried(master_net(lr=0.05), {"params": trained})
        m = SharedTrainingMaster(batch_size_per_worker=16, threshold=1e-3, mesh=one)
        masked = [DataSet(x[:32], y[:32], None, np.ones(32, np.float32)),
                  DataSet(x[32:62], y[32:62], np.ones((30, 1), np.float32))]
        DistributedMultiLayerNetwork(net, m).fit(masked)
        for ds in masked:
            twin.fit(ds)
        assert m._steps_done == 0 and net.iteration == twin.iteration == 2
        for a, b in zip(params_of(net), params_of(twin)):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])

        port = SharedTrainingMaster(batch_size_per_worker=16, mesh=one, **SHARED_KW)
        pnet = carried(master_net(lr=0.05), {"params": trained})
        port.load_state(stack)
        DistributedMultiLayerNetwork(pnet, port).fit([DataSet(x, y)])
    finally:
        dist.destroy_process_group()
    ref = j_net(lr=0.05)
    ref.params = jax.tree_util.tree_map(np.asarray, trained)
    jm = JShared(batch_size_per_worker=16, mesh=jmake_mesh({"data": 1}, jax.devices()[:1]),
                 **SHARED_KW)
    jm.load_state(stack)
    JDist(ref, jm).fit([JDataSet(x, y)])
    assert port.threshold == pytest.approx(jm.threshold, rel=1e-12)
    assert_trees_close(params_of(pnet), ref.params)
    saved = np.load(stack)
    port_res = [{n: port._residual[k][n].numpy() for n in port._residual[k]}
                for k in sorted(port._residual)]
    assert_trees_close(port_res, jm._residual)
    assert saved["res0"].shape == (4, 6, 12)
