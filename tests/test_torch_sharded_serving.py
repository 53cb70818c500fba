"""The port's sharded serving (``ParallelInference(mesh=)``, the
registry's ``register(mesh=, sharding_rules=)``, ``cli.py serve --mesh``)
in a 4-rank gloo world, held against the JAX package's registry on a
mesh of the same shape.

One module-scoped fixture spawns one world of 4 CPU ranks that runs only
this file's scenarios (``tests/torch_serving_world.py``): every rank
registers the same versions, rank 0 serves and the others follow its
forwards in lockstep (``parallel/lockstep.py``). Each case mirrors the
reference's ``tests/test_sharding_2d.py`` ``TestShardedServing`` on the
first 4 of its 8 virtual CPU devices (``data=2, model=2`` where the
reference uses ``data=4, model=2``) and compares the answers within 1e-5.
The world-of-one and argument cases run in this process.
"""

from __future__ import annotations

import pickle

import jax
import numpy as np
import pytest

import torch_parallel_world as W
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel.sharding import P as JP
from deeplearning4j_tpu.serving import ModelRegistry as JRegistry

ANSWER_TOL = 1e-5
J_RULES = [("(^|/)0/W$", JP(None, "model")), ("(^|/)1/W$", JP("model", None)), (".*", JP())]


def j_dense(seed):
    conf = (JNNC.builder().seed(seed).list()
            .layer(JDense(n_in=12, n_out=16, activation="tanh"))
            .layer(JOut(n_in=16, n_out=4, activation="softmax",
                        loss="negativeloglikelihood"))
            .build())
    return JMLN(conf).init()


def jmesh(axes):
    return jmake_mesh(axes, jax.devices()[:W.WORLD])


def host(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a).copy(), tree)


def rows(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 12)).astype(np.float32)


def scenario_inputs(tmp) -> dict:
    nets = {f"v{s}": host(j_dense(s).params) for s in (1, 2, 3)}
    common = {**nets, "x3": rows(3, 1), "x8": rows(8, 2), "dir": tmp}
    return {name: common for name in ("sharded_hot_swap", "sharded_rejects_quantized",
                                      "cli_serve_mesh", "close_ends_follow")}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving_world")
    inputs = scenario_inputs(str(d))
    with open(d / "in.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    W.run_world(str(d / "in.pkl"), str(d / "out.pkl"), f"file://{d}/store",
                modules=("torch_serving_world",))
    with open(d / "out.pkl", "rb") as fh:
        results = pickle.load(fh)

    def get(name):
        got = results[name]
        if isinstance(got, dict) and "__error__" in got:
            pytest.fail(f"the port's {name} scenario raised:\n{got['__error__']}")
        return inputs[name], got

    return get


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=ANSWER_TOL)


class TestShardedServing:
    def test_sharded_register_warmup_hot_swap_zero_compiles(self, world):
        """v1 placed by the rules and warmed, a hot swap to v2 under load
        from a client thread, then the steady state builds nothing; every
        answer within 1e-5 of the reference registry's on the same mesh,
        and every follower's ``follow()`` ended by rank 0's shutdown."""
        inp, got = world("sharded_hot_swap")
        reg = JRegistry(max_batch_size=8, warmup="sync")
        try:
            mesh = jmesh({"data": 2, "model": 2})
            reg.register("clf", j_dense(1), mesh=mesh, sharding_rules=J_RULES,
                         input_shape=(12,))
            served = reg._models["clf"]
            want_v1 = reg.predict("clf", inp["x3"])
            reg.register("clf", j_dense(2), mesh=mesh, sharding_rules=J_RULES,
                         input_shape=(12,))
            assert got["buckets"] == list(served.inference.buckets) == [2, 4, 8]
            assert all(b % 2 == 0 for b in got["buckets"])
            assert got["describe_mesh"] == {"data": 2, "model": 2}
            assert served.describe()["versions"][0]["mesh"] == got["describe_mesh"]
            close(got["v1_answer"], want_v1)
            assert not got["errors"] and got["hammered"] > 0
            assert got["versions"] == [1, 2, 2]
            assert got["builds_after_swap"] == 0 and got["warm"]
            for n, out in got["answers"].items():
                assert out.shape == (n, 4)
                close(out, reg.predict("clf", inp["x8"][:n]))
            close(got["pinned_v1"], reg.predict("clf", inp["x3"], version=1))
        finally:
            reg.shutdown()
        followers = got["ranks"][1:]
        assert all(r["followed"] and r["followed"] > 0 for r in followers)
        # every forward rank 0 ran was run on every follower
        assert len({r["followed"] for r in followers}) == 1

    def test_sharded_register_rejects_quantized_policy(self, world):
        _, got = world("sharded_rejects_quantized")
        reg = JRegistry(warmup="off")
        try:
            with pytest.raises(ValueError, match="float32"):
                reg.register("q", j_dense(3), mesh=jmesh({"data": 2, "model": 2}),
                             dtype_policy="int8")
        finally:
            reg.shutdown()
        assert "float32-only" in got["raised"] and "int8" in got["raised"]


class TestCliServeMesh:
    def test_serve_mesh_answers_over_http_and_stops_the_followers(self, world):
        inp, got = world("cli_serve_mesh")
        reg = JRegistry(max_batch_size=4, warmup="off")
        try:
            reg.register("clf", j_dense(1), mesh=jmesh({"data": 2, "model": 2}))
            close(got["answer"], reg.predict("clf", inp["x3"]))
        finally:
            reg.shutdown()
        assert got["describe"] == {"data": 2, "model": 2}
        assert all(r["closed"] for r in got["ranks"][1:])

    def test_serve_rejects_mesh_plus_quantization(self, capsys):
        from deeplearning4j_tpu.cli import serve_main as j_serve_main
        from deeplearning4j_tpu_torch.cli import serve_main

        argv = ["--model", "m=/nonexistent/m.zip", "--mesh", "data=4,model=2",
                "--dtype-policy", "m=int8"]
        for main in (j_serve_main, serve_main):
            with pytest.raises(SystemExit) as exc:
                main(argv, block=False)
            assert exc.value.code == 2
            assert "float32-only" in capsys.readouterr().err

    @pytest.mark.parametrize("argv,said", [
        (["--sharding-rules", "/tmp/rules.json"], "needs --mesh"),
        (["--mesh", "data=4,model"], "--mesh"),
        (["--mesh", "data=1", "--sharding-rules", "/nonexistent/rules.json"],
         "--sharding-rules"),
    ])
    def test_serve_reports_bad_mesh_arguments(self, capsys, argv, said):
        from deeplearning4j_tpu_torch.cli import serve_main

        with pytest.raises(SystemExit) as exc:
            serve_main(["--model", "m=/nonexistent/m.zip", *argv], block=False)
        assert exc.value.code == 2
        assert said in capsys.readouterr().err


class TestLockstep:
    def test_closing_rank_0_ends_every_follow(self, world):
        inp, got = world("close_ends_follow")
        from deeplearning4j_tpu_torch.parallel import lockstep

        assert got["buckets"] == [4]
        ref = JMLN(j_dense(1).conf).init()
        ref.params = jax.tree_util.tree_map(np.asarray, inp["v1"])
        for k, out in zip((1, 2, 3), got["answers"]):
            close(out, np.asarray(ref.output(inp["x3"][:k])))
        assert got["ops"] == 4  # one warm-up, three dispatches
        followers = got["ranks"][1:]
        assert all(r["returned"] and r["followed"] == 4 for r in followers)
        # the followers waited through the idle heartbeats and returned at
        # the stop, well inside their timeout
        assert all(r["elapsed_s"] < lockstep.BIND_TIMEOUT_S for r in followers)
        assert "shut down" in got["after_shutdown"]


def test_world_of_one_runs_the_same_stream_with_no_followers():
    """A mesh of one rank: the registry's sharded version answers as the
    unplaced network does, through the stream (its operations counted),
    ``follow()`` returns at once, the buckets round to the data axis, and
    a version registered off the mesh is served directly."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import ParallelInference, lockstep
    from deeplearning4j_tpu_torch.parallel.mesh import P, make_mesh, mesh_axes
    from deeplearning4j_tpu_torch.serving import ModelRegistry
    from torch_serving_world import dense

    inp = {f"v{s}": host(j_dense(s).params) for s in (1, 2)}
    x = rows(5, 3)
    rules = [("(^|/)0/W$", P(None, "model")), ("(^|/)1/W$", P("model", None)), (".*", P())]
    try:
        mesh = make_mesh({"data": 1, "model": 1}, device_type="cpu")
        reg = ModelRegistry(max_batch_size=4, warmup="sync")
        try:
            reg.register("clf", dense(inp, 1), mesh=mesh, sharding_rules=rules,
                         input_shape=(12,))
            ops0 = lockstep.stream().ops_sent
            out = reg.predict("clf", x)
            assert lockstep.stream().ops_sent > ops0
            np.testing.assert_array_equal(out, dense(inp, 1).output(x).numpy())
            assert reg.follow() == 0
            reg.register("clf", dense(inp, 2), input_shape=(12,))  # one device
            served = reg.get("clf")
            assert "mesh" in served.describe()["versions"][0]
            assert "mesh" not in served.describe()["versions"][1]
            ops1 = lockstep.stream().ops_sent
            np.testing.assert_array_equal(reg.predict("clf", x),
                                          dense(inp, 2).output(x).numpy())
            assert lockstep.stream().ops_sent == ops1
        finally:
            reg.shutdown()
        pi = ParallelInference(dense(inp, 1), mode="inplace", max_batch_size=6,
                               buckets=[3, 6])
        try:
            four = make_mesh({"data": 1}, device_type="cpu")
            pi.set_mesh(four)
            assert pi.buckets == (3, 6) and mesh_axes(pi.mesh) == {"data": 1}
            np.testing.assert_array_equal(pi.output(x), dense(inp, 1).output(x).numpy())
        finally:
            pi.shutdown()
    finally:
        dist.destroy_process_group()


def test_buckets_round_up_to_the_data_axis():
    """The reference's rounding: every declared bucket up to a multiple of
    the data-axis size, and a cold batch past the buckets as well."""
    from deeplearning4j_tpu_torch.parallel.inference import _round_up

    class Mesh:
        mesh_dim_names, shape = ("data", "model"), (4, 2)

    assert _round_up([1, 2, 4, 8, 10], Mesh()) == (4, 8, 12)
    assert _round_up([1, 3], None) == (1, 3)
