"""The port's ParallelWrapper, sharding and mesh in a 4-rank gloo world,
held against the JAX package on a mesh of the same shape.

One module-scoped fixture writes every scenario's inputs (the JAX
networks' initial parameters as numpy arrays, and the data, made with
numpy from seeds) to a pickle and spawns one world of 4 CPU ranks
(``tests/torch_parallel_world.py``: ``torch.multiprocessing`` spawn, a
``file://`` store under the test's temporary directory, one torch thread
a rank). Every rank runs every scenario; rank 0 writes the results. Each
case then runs the same scenario in the JAX package on the first 4 of its
8 virtual CPU devices, meshes ``data=4`` and ``data=2, model=2``, and
compares, each at the tolerance of the reference's own case
(``tests/test_parallel.py``, ``tests/test_sharding_2d.py``). The
reference's 8-way ragged cases (100 examples in batches of 16, an
evaluation batch of 20) become 102 in batches of 16 and an evaluation
batch of 18 here, so that the data axis of 4 still leaves a ragged batch
on both sides. The reference's compiled-HLO collective counts map to
``CommDebugMode``'s counts on the port's forward and step.
"""

from __future__ import annotations

import pickle
import re

import jax
import numpy as np
import pytest

import torch_parallel_world as W
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JListIt
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import (
    BatchNormalizationLayer as JBN,
    ConvolutionLayer as JConv,
    DenseLayer as JDense,
    LSTMLayer as JLSTM,
    OutputLayer as JOut,
    RnnOutputLayer as JRnnOut,
    SubsamplingLayer as JSub,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.nn.updaters import Sgd as JSgd
from deeplearning4j_tpu.optimize import earlystopping as jes
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel.mesh import parse_mesh_axes as jparse
from deeplearning4j_tpu.parallel.sharding import P as JP
from deeplearning4j_tpu.parallel.sharding import place_batch as jplace
from deeplearning4j_tpu.parallel.sharding import shard_model as jshard_model
from deeplearning4j_tpu.parallel.sharding import shard_model_with_rules as jrules
from deeplearning4j_tpu.parallel.sharding import tp_param_specs as jtp_specs
from deeplearning4j_tpu.zoo.models import TransformerEncoder as JEncoder
from deeplearning4j_tpu.zoo.models import TransformerLM as JLM
from deeplearning4j_tpu.zoo.models import lm_labels as jlm_labels


def jmesh(axes):
    """The reference's mesh of the port world's shape, on the first 4
    virtual devices."""
    return jmake_mesh(axes, jax.devices()[:W.WORLD])


# ------------------------------------------------ the reference's networks
def j_small_net(updater="sgd", lr=0.1, seed=7):
    u = JSgd(lr) if updater == "sgd" else JAdam(lr)
    conf = (JNNC.builder().seed(seed).updater(u).list()
            .layer(JDense(n_in=12, n_out=16, activation="tanh"))
            .layer(JOut(n_in=16, n_out=4, activation="softmax",
                        loss="negativeloglikelihood"))
            .build())
    return JMLN(conf).init()


def j_ffn_net():
    conf = (JNNC.builder().seed(3).list()
            .layer(JDense(n_in=32, n_out=128, activation="relu"))
            .layer(JDense(n_in=128, n_out=32, activation="identity"))
            .layer(JOut(n_in=32, n_out=8, activation="softmax",
                        loss="negativeloglikelihood"))
            .build())
    return JMLN(conf).init()


def j_conv_bn_net(seed=3, lr=0.05):
    conf = (JNNC.builder().seed(seed).updater(JSgd(lr)).list()
            .layer(JConv(n_out=8, kernel_size=(3, 3), convolution_mode="same",
                         activation="identity"))
            .layer(JBN())
            .layer(JConv(n_out=8, kernel_size=(3, 3), convolution_mode="same",
                         activation="relu"))
            .layer(JSub(kernel_size=(2, 2), stride=(2, 2)))
            .layer(JDense(n_out=16, activation="relu"))
            .layer(JOut(n_out=4, activation="softmax", loss="negativeloglikelihood"))
            .set_input_type(JIT.convolutional(8, 8, 1)).build())
    return JMLN(conf).init()


def j_lstm_net():
    conf = (JNNC.builder().seed(1).updater(JAdam(0.01)).list()
            .layer(JLSTM(n_in=4, n_out=8))
            .layer(JRnnOut(n_in=8, n_out=3))
            .build())
    return JMLN(conf).init()


def j_encoder(d_model=16, n_heads=2, d_ff=32, seed=11):
    return JGraph(JEncoder(num_labels=4, vocab_size=32, max_length=8, n_layers=1,
                           d_model=d_model, n_heads=n_heads, d_ff=d_ff,
                           seed=seed).conf()).init()


def j_tiny_lm(seed=7):
    return JLM(vocab_size=64, max_length=8, n_layers=1, d_model=16, n_heads=4,
               d_ff=32, seed=seed).init()


def norm_spec(spec) -> tuple:
    """A spec's entries with trailing Nones dropped (``P("model", None)``
    and ``P("model")`` place a tensor alike)."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def initial(net, states: bool = False) -> dict:
    out = {"params": host(net.params)}
    if states:
        out["states"] = host(net.states)
    return out


# ------------------------------------------------------------------ data
def data(seed, n, shape=(12,), classes=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, *shape)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, size=n)]
    return x, y


def masked_sequences():
    rng = np.random.default_rng(5)
    n, t, f, c = 16, 6, 4, 3
    x = rng.normal(size=(n, t, f)).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, (n, t))]
    lengths = rng.integers(2, t + 1, n)
    m = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    return x, y, m


def lm_data(seed=3, vocab=64, t=8, batch=8):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(batch, t))
    return toks.astype(np.float32), np.asarray(jlm_labels(toks, vocab))


def scenario_inputs() -> dict:
    x, y = data(0, 64)
    xi, yi = data(1, 64, (8, 8, 1))
    toks = np.random.default_rng(2).integers(0, 32, size=(8, 8)).astype(np.float32)
    enc_y = np.eye(4, dtype=np.float32)[np.random.default_rng(2).integers(0, 4, 8)]
    lx, ly = lm_data()
    sx, sy, sm = masked_sequences()
    x8, y8 = data(6, 8)
    xt, yt = data(7, 32)
    fx = np.random.default_rng(0).normal(size=(8, 32)).astype(np.float32)
    ftoks = np.random.default_rng(4).integers(0, 64, size=(4, 128))
    return {
        "mesh_infer": {}, "mesh_2d": {}, "mesh_infers_one_axis": {},
        "rules_degrade": initial(j_tiny_lm()),
        "sg_matches_single": {**initial(j_small_net()), "x": x, "y": y},
        "sg_adam_multi": {**initial(j_small_net(updater="adam")), "x": x, "y": y},
        "avg_freq1": {**initial(j_small_net()), "x": x, "y": y},
        "avg_freq4": {**initial(j_small_net()), **dict(zip("xy", data(8, 256)))},
        "ragged_tail": {**initial(j_small_net()), **dict(zip("xy", data(9, 102)))},
        "avg_rejects_tp": {},
        "tp_step": {**initial(j_small_net()), "x": x, "y": y},
        "tp_transformer": {**initial(j_encoder()), "x": toks, "y": enc_y},
        "bn_shared": {**initial(j_conv_bn_net(), True), "x": xi, "y": yi},
        "bn_avg_sim": {**initial(j_conv_bn_net(), True), "x": xi, "y": yi},
        "bn_avg_mean": {**initial(j_conv_bn_net(), True), "x": xi, "y": yi},
        "evaluate": {**initial(j_small_net()), **dict(zip("xy", data(10, 96)))},
        "evaluate_masked": {**initial(j_lstm_net()), "x": sx, "y": sy, "m": sm},
        "e2e_graph_2d": {**initial(j_tiny_lm(seed=11)), "x": lx, "y": ly},
        "e2e_mln_2d": {**initial(j_small_net(seed=5)), "x": x8, "y": y8},
        "comm_vocab": {**initial(j_tiny_lm()), "x": lx, "y": ly},
        "comm_megatron": {**initial(j_ffn_net()), "x": fx},
        "comm_attention": initial(j_encoder(d_model=32, n_heads=4, d_ff=64, seed=2)),
        "kernel_placements": {},
        "draws": {"x": x, "y": y},
        "flash_lm_2d": {"x": ftoks.astype(np.float32), "y": jlm_labels(ftoks, 64)},
        "early_stopping": {**initial(j_small_net(updater="adam", lr=0.01)), "x": x, "y": y,
                           "xt": xt, "yt": yt},
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``{scenario: (inputs, the port's results)}`` from one 4-rank world."""
    d = tmp_path_factory.mktemp("parallel_world")
    inputs = scenario_inputs()
    with open(d / "in.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    W.run_world(str(d / "in.pkl"), str(d / "out.pkl"), f"file://{d}/store")
    with open(d / "out.pkl", "rb") as fh:
        results = pickle.load(fh)

    def get(name):
        got = results[name]
        if isinstance(got, dict) and "__error__" in got:
            pytest.fail(f"the port's {name} scenario raised:\n{got['__error__']}")
        return inputs[name], got

    return get


def j_carried(net, inp):
    """A fresh reference network with the scenario's initial parameters
    (the same values it was built with: the inits are seeded)."""
    for mine, theirs in zip(jax.tree_util.tree_leaves(host(net.params)),
                            jax.tree_util.tree_leaves(inp["params"])):
        np.testing.assert_array_equal(mine, theirs)
    return net


def assert_trees_close(port, ref, rtol, atol):
    """Leaf by leaf: the port's exported tree (a list of layer dicts, or a
    dict of vertex dicts) against the reference's."""
    ref = host(ref)
    if isinstance(port, list):
        port, ref = dict(enumerate(port)), dict(enumerate(ref))
    assert set(port) == set(ref)
    for k in ref:
        for n in ref[k]:
            np.testing.assert_allclose(np.asarray(port[k][n]), np.asarray(ref[k][n]),
                                       rtol=rtol, atol=atol, err_msg=f"{k}/{n}")


# ---------------------------------------------------------------- the mesh
class TestMesh:
    def test_make_mesh_infer(self, world):
        _, got = world("mesh_infer")
        ref = jmake_mesh({"data": -1}, jax.devices()[:W.WORLD])
        assert got["axes"] == dict(ref.shape) == {"data": W.WORLD}

    def test_make_mesh_2d(self, world):
        _, got = world("mesh_2d")
        ref = jmesh({"data": 2, "model": 2})
        assert got["axes"] == dict(ref.shape) == {"data": 2, "model": 2}


class TestMeshGrammarOnTheWorld:
    def test_make_mesh_infers_one_axis(self, world):
        _, got = world("mesh_infers_one_axis")
        ref = jmake_mesh(jparse("data=-1,model=2"), jax.devices()[:W.WORLD])
        assert got["axes"] == dict(ref.shape) == {"data": 2, "model": 2}

    def test_2d_rules_on_data_only_mesh_degrade_to_replicated(self, world):
        inp, got = world("rules_degrade")
        net = j_carried(j_tiny_lm(), inp)
        jrules(net, jmesh({"data": 4}))
        ref = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
               norm_spec(leaf.sharding.spec)
               for path, leaf in jax.tree_util.tree_flatten_with_path(net.params)[0]}
        assert got["specs"] == ref
        assert all(s == () for s in got["specs"].values())


# ---------------------------------------------------------- ParallelWrapper
class TestSharedGradients:
    def test_matches_single_machine(self, world):
        inp, got = world("sg_matches_single")
        ref = j_carried(j_small_net(), inp)
        JPW(ref, jmesh({"data": 4}), mode="shared_gradients").fit(inp["x"], inp["y"])
        single = j_small_net()
        single.fit(inp["x"], inp["y"])
        assert_trees_close(got["params"], ref.params, 1e-5, 1e-6)
        assert_trees_close(got["params"], single.params, 1e-5, 1e-6)

    def test_multiple_steps_adam(self, world):
        inp, got = world("sg_adam_multi")
        ref = j_carried(j_small_net(updater="adam"), inp)
        data = [JDataSet(inp["x"][i * 16:(i + 1) * 16], inp["y"][i * 16:(i + 1) * 16])
                for i in range(4)]
        JPW(ref, jmesh({"data": 4}), mode="shared_gradients").fit(data, epochs=2)
        assert_trees_close(got["params"], ref.params, 1e-4, 1e-5)


class TestAveraging:
    def test_freq1_sgd_equals_single_machine(self, world):
        inp, got = world("avg_freq1")
        ref = j_carried(j_small_net(), inp)
        JPW(ref, jmesh({"data": 4}), mode="averaging",
            averaging_frequency=1).fit(inp["x"], inp["y"])
        single = j_small_net()
        single.fit(inp["x"], inp["y"])
        assert_trees_close(got["params"], ref.params, 1e-5, 1e-6)
        assert_trees_close(got["params"], single.params, 1e-5, 1e-6)

    def test_freq4_runs_and_learns(self, world):
        inp, got = world("avg_freq4")
        ref = j_carried(j_small_net(), inp)
        data = [JDataSet(inp["x"][i * 32:(i + 1) * 32], inp["y"][i * 32:(i + 1) * 32])
                for i in range(8)]
        pw = JPW(ref, jmesh({"data": 4}), mode="averaging", averaging_frequency=4)
        scores = []
        for _ in range(6):
            pw.fit(data)
            scores.append(float(ref.score_))
        assert got["iteration"] == ref.iteration == 48
        assert got["scores"][-1] < got["scores"][0]
        # one iteration_done a flush, after its K steps
        assert got["heard"] == list(range(4, 49, 4))
        np.testing.assert_allclose(got["scores"], scores, rtol=1e-4, atol=1e-5)
        assert_trees_close(got["params"], ref.params, 1e-4, 1e-5)


class TestRaggedBatches:
    @pytest.mark.parametrize("mode", ["shared_gradients", "averaging"])
    def test_tail_batch_not_divisible(self, world, mode):
        """102 examples in batches of 16: the tail of 6 does not divide the
        data axis of 4 and runs unsharded, on both sides."""
        inp, got = world("ragged_tail")
        ref = j_carried(j_small_net(), inp)
        data = [JDataSet(inp["x"][s:s + 16], inp["y"][s:s + 16]) for s in range(0, 102, 16)]
        assert data[-1].features.shape[0] % 4
        JPW(ref, jmesh({"data": 4}), mode=mode, averaging_frequency=1).fit(data)
        assert_trees_close(got[mode]["params"], ref.params, 1e-4, 1e-5)

    def test_averaging_rejects_tp(self, world):
        _, got = world("avg_rejects_tp")
        with pytest.raises(ValueError, match="tensor parallelism") as ref:
            JPW(j_small_net(), jmesh({"data": 2, "model": 2}), mode="averaging",
                tp_axis="model")
        assert got["error"] == str(ref.value)


class TestTensorParallel:
    def test_tp_sharded_step(self, world):
        inp, got = world("tp_step")
        ref = j_carried(j_small_net(), inp)
        JPW(ref, jmesh({"data": 2, "model": 2}), mode="shared_gradients",
            tp_axis="model").fit(inp["x"], inp["y"])
        assert_trees_close(got["params"], ref.params, 1e-4, 1e-5)
        specs = jtp_specs(j_small_net(), "model", jmesh({"data": 2, "model": 2}))
        assert {f"{i}/{n}": norm_spec(s) for i, d in enumerate(specs)
                for n, s in d.items()} == got["specs"]

    def test_tp_transformer_graph_matches_replicated(self, world):
        inp, got = world("tp_transformer")
        ref, dist = j_carried(j_encoder(), inp), j_carried(j_encoder(), inp)
        jshard_model(dist, jmesh({"data": 2, "model": 2}), tp_axis="model")
        x, y = inp["x"], inp["y"]
        before = np.asarray(ref.output_single(x))
        np.testing.assert_allclose(np.asarray(dist.output_single(x)), before,
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(got["before"], before, rtol=2e-4, atol=1e-5)
        ref.fit(x, y)
        after = np.asarray(ref.output_single(x))
        np.testing.assert_allclose(got["after"], after, rtol=2e-4, atol=1e-5)
        assert got["specs"]["block0-att/Wqkv"] == (None, "model")
        assert got["specs"]["block0-att/Wo"] == ("model",)


class TestCollectives:
    """The reference's compiled-HLO collective counts, read on the port by
    ``CommDebugMode`` on the same mesh shape (data=2, model=2)."""

    @staticmethod
    def _hlo_counts(txt):
        counts = {}
        for m in re.finditer(r"\b(all-gather|all-reduce|reduce-scatter|collective-permute"
                             r"|all-to-all)\b", txt):
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
        return counts

    def test_megatron_specs_fewer_collectives(self, world):
        from jax.sharding import NamedSharding

        inp, got = world("comm_megatron")
        mesh = jmesh({"data": 2, "model": 2})
        xs = jax.device_put(inp["x"], NamedSharding(mesh, JP("data", None)))

        def count(specs_fn):
            net = j_ffn_net()
            placed = [{n: jax.device_put(v, NamedSharding(mesh, sd[n])) for n, v in pd.items()}
                      for pd, sd in zip(net.params, specs_fn(net))]

            def forward(params, xin):
                return net._forward_all(params, net.states, xin, train=False, rng=None,
                                        mask=None)[0]

            return sum(self._hlo_counts(jax.jit(forward).lower(placed, xs).compile()
                                        .as_text()).values())

        def legacy(net):
            return [{n: (JP(*([None] * (v.ndim - 1)), "model") if v.ndim >= 2 and v.shape[-1] > 1
                         else JP("model") if v.ndim == 1 and v.shape[0] > 1 else JP())
                     for n, v in p.items()} for p in net.params]

        ref_legacy, ref_megatron = count(legacy), count(lambda n: jtp_specs(n, "model", mesh))
        assert ref_megatron < ref_legacy
        port_legacy = sum(got["legacy"].values())
        port_megatron = sum(got["megatron"].values())
        assert port_megatron < port_legacy, got
        assert got["megatron"].get("all_gather_into_tensor", 0) == 0

    def test_attention_collectives(self, world):
        import jax.numpy as jnp
        from jax.sharding import NamedSharding

        inp, got = world("comm_attention")
        mesh = jmesh({"data": 2, "model": 2})
        net = j_carried(j_encoder(d_model=32, n_heads=4, d_ff=64, seed=2), inp)
        jshard_model(net, mesh, tp_axis="model")
        x = jax.device_put(jnp.zeros((8, 8)), NamedSharding(mesh, JP("data", None)))

        def forward(params, xin):
            return net._forward_all(params, net.states, {"tokens": xin}, train=False,
                                    rng=None)[0]

        txt = jax.jit(forward).lower(net.params, x).compile().as_text()
        assert self._hlo_counts(txt).get("all-gather", 0) == 0
        assert got["counts"].get("all_gather_into_tensor", 0) == 0, got["counts"]
        assert got["counts"].get("all_reduce", 0) > 0


class TestVocabPath:
    """The default 2-D rules' vocab path: a row-sharded embedding and
    column-sharded logits with the sharded LSE loss, zero all-gathers."""

    def _ref(self, inp):
        mesh = jmesh({"data": 2, "model": 2})
        net = j_carried(j_tiny_lm(), inp)
        jrules(net, mesh)
        return net, mesh

    def _forward_counts(self, net, inp, mesh):
        import jax.numpy as jnp

        xj = jplace(jnp.asarray(inp["x"]), mesh)
        txt = net._output_fn().lower(net.params, net.states, {"tokens": xj},
                                     None).compile().as_text()
        return TestCollectives._hlo_counts(txt)

    def test_forward_zero_all_gathers(self, world):
        inp, got = world("comm_vocab")
        net, mesh = self._ref(inp)
        ref = self._forward_counts(net, inp, mesh)
        assert ref.get("all-gather", 0) == 0 and ref.get("all-reduce", 0) > 0
        assert got["forward"].get("all_gather_into_tensor", 0) == 0, got["forward"]
        assert got["forward"].get("all_reduce", 0) > 0

    def test_forward_zero_all_gathers_after_fit(self, world):
        inp, got = world("comm_vocab")
        net, mesh = self._ref(inp)
        net.fit(JDataSet(inp["x"], inp["y"]))
        assert self._forward_counts(net, inp, mesh).get("all-gather", 0) == 0
        assert got["after_fit"].get("all_gather_into_tensor", 0) == 0, got["after_fit"]
        assert got["specs"]["embed/W"] == ("model",)
        assert got["specs"]["out/W"] == (None, "model")

    def test_train_step_zero_all_gathers(self, world):
        import jax.numpy as jnp

        inp, got = world("comm_vocab")
        net, mesh = self._ref(inp)
        step = net._get_train_step()
        it, ep, rng_k = net._device_tick()
        xj = jplace(jnp.asarray(inp["x"]), mesh)
        yj = jplace(jnp.asarray(inp["y"]), mesh)
        txt = step.lower(net.params, net.states, net.updater_states, it, ep,
                         {"tokens": xj}, [yj], None, None, rng_k).compile().as_text()
        ref = TestCollectives._hlo_counts(txt)
        assert ref.get("all-gather", 0) == 0 and ref.get("all-reduce", 0) > 0
        assert got["step"].get("all_gather_into_tensor", 0) == 0, got["step"]
        assert got["step"].get("all_reduce", 0) > 0


# ---------------------------------------------------------- conv + BatchNorm
class TestConvBnDataParallel:
    def test_shared_gradients_exact_including_bn_stats(self, world):
        inp, got = world("bn_shared")
        ref = j_carried(j_conv_bn_net(), inp)
        pw = JPW(ref, jmesh({"data": 4}), mode="shared_gradients")
        for _ in range(3):
            pw.fit(inp["x"], inp["y"])
        single = j_conv_bn_net()
        for _ in range(3):
            single.fit(inp["x"], inp["y"])
        for other in (ref, single):
            assert_trees_close(got["params"], other.params, 1e-4, 1e-5)
            assert_trees_close(got["states"], other.states, 1e-4, 1e-5)
        assert np.abs(got["states"][1]["mean"]).max() > 1e-4

    def test_averaging_matches_manual_per_worker_simulation(self, world):
        """Each of the 4 workers' k local steps on its block from the same
        start, then the average: the port's wrapper against the port's own
        simulation (the reference's oracle) and the reference's wrapper."""
        inp, got = world("bn_avg_sim")
        for part in ("params", "states", "updater"):
            sim = got["simulation"][part]
            mine = got["wrapper"][part]
            jax.tree_util.tree_map(
                lambda s, g: np.testing.assert_allclose(g, s, rtol=2e-4, atol=1e-5),
                sim, mine)
        ref = j_carried(j_conv_bn_net(), inp)
        x, y = inp["x"], inp["y"]
        JPW(ref, jmesh({"data": 4}), mode="averaging", averaging_frequency=2).fit(
            [JDataSet(x[i * 32:(i + 1) * 32], y[i * 32:(i + 1) * 32]) for i in range(2)])
        assert_trees_close(got["wrapper"]["params"], ref.params, 2e-4, 1e-5)
        assert_trees_close(got["wrapper"]["states"], ref.states, 2e-4, 1e-5)

    def test_averaging_bn_running_mean_tracks_single_device(self, world):
        inp, got = world("bn_avg_mean")
        ref = j_carried(j_conv_bn_net(), inp)
        JPW(ref, jmesh({"data": 4}), mode="averaging", averaging_frequency=1).fit(
            inp["x"], inp["y"])
        np.testing.assert_allclose(got["states"][1]["mean"],
                                   got["single"]["states"][1]["mean"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["states"][1]["mean"],
                                   np.asarray(ref.states[1]["mean"]), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["states"][1]["var"],
                                   np.asarray(ref.states[1]["var"]), rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------- evaluate
class TestDistributedEvaluate:
    @pytest.mark.parametrize("mode", ["shared_gradients", "averaging"])
    def test_mesh_evaluate_equals_single_device(self, world, mode):
        inp, got = world("evaluate")
        net = j_carried(j_small_net(), inp)
        net.fit(inp["x"], inp["y"])
        single = net.evaluate(JListIt(JDataSet(inp["x"], inp["y"]), 16))
        pw = JPW(net, jmesh({"data": 4}), mode=mode)
        ref = pw.evaluate(JListIt(JDataSet(inp["x"], inp["y"]), 16), top_n=2)
        np.testing.assert_array_equal(got["single"], single.confusion)
        np.testing.assert_array_equal(got[mode]["confusion"], ref.confusion)
        assert got[mode]["top_n"] == pytest.approx(ref.top_n_accuracy())
        assert got[mode]["top_n"] >= got[mode]["accuracy"]
        # a ragged batch (18 over 4 workers) takes the unsharded path
        np.testing.assert_array_equal(got[mode]["ragged"], single.confusion)


def test_mesh_evaluate_masked_sequences(world):
    inp, got = world("evaluate_masked")
    net = j_carried(j_lstm_net(), inp)
    ds = JDataSet(inp["x"], inp["y"], inp["m"], inp["m"])
    pw = JPW(net, jmesh({"data": 4}), mode="shared_gradients")
    ref = pw.evaluate(JListIt(ds, 8))
    np.testing.assert_array_equal(got["mesh"], ref.confusion)
    np.testing.assert_array_equal(got["mesh"], got["single"])
    assert got["mesh"].sum() == int(inp["m"].sum())


# ----------------------------------------------------------- 2-D end to end
class TestEndToEnd2D:
    def test_graph_2d_fit_matches_replicated(self, world):
        inp, got = world("e2e_graph_2d")
        ref = j_carried(j_tiny_lm(seed=11), inp)
        net = j_carried(j_tiny_lm(seed=11), inp)
        jrules(net, jmesh({"data": 2, "model": 2}))
        ds = JDataSet(inp["x"], inp["y"])
        for _ in range(2):
            ref.fit(ds)
            net.fit(ds)
        assert np.isfinite(got["scores"][-1])
        assert got["scores"][-1] == pytest.approx(float(ref.score_), abs=1e-4)
        assert_trees_close(got["params"], ref.params, 0, 2e-5)
        np.testing.assert_allclose(got["output"], np.asarray(ref.output(inp["x"])), atol=1e-4)
        assert got["specs"]["embed/W"] == ("model",)

    def test_mln_2d_fit_honors_rules(self, world):
        inp, got = world("e2e_mln_2d")
        net = j_carried(j_small_net(seed=5), inp)
        jrules(net, jmesh({"data": 2, "model": 2}), [
            ("(^|/)0/W$", JP(None, "model")), ("(^|/)0/b$", JP("model")),
            ("(^|/)1/W$", JP("model", None)), (".*", JP())])
        net.fit(JDataSet(inp["x"], inp["y"]))
        for key in ("placed", "after"):
            assert got[key]["0/W"] == (None, "model")
            assert got[key]["1/W"] == ("model",)
        assert np.isfinite(got["score"])
        assert got["score"] == pytest.approx(float(net.score_), rel=1e-5)
        assert_trees_close(got["params"], net.params, 1e-5, 1e-6)
        assert got["output"].shape == (8, 4)


# ------------------------------------------------------------ the kernels
def test_kernel_wrappers_run_on_admitted_placements_and_refuse_the_rest(world):
    """The kernel wrappers on DTensors (their plain versions here): batch-
    and head-sharded attention, a column-sharded Adam tensor and a batch-
    sharded LSTM sequence equal the plain tensors' results; a sequence
    shard, mixed placements, a plain tensor among DTensors, a Partial and a
    time shard raise."""
    _, got = world("kernel_placements")
    assert got["attention_err"] == 0.0 and got["adam_err"] == 0.0 and got["lstm_err"] == 0.0
    assert set(got["attention_placements"]) == {"(Shard(dim=0), Shard(dim=1))"}
    assert "no placement it admits" in got["attention_seq_shard"]
    assert "one placement" in got["attention_mixed"]
    assert "plain tensors mixed" in got["attention_plain_mixed"]
    assert "no placement it admits" in got["adam_partial"]
    assert "no placement it admits" in got["lstm_time_shard"]


def test_flash_seam_lm_step_on_a_2d_mesh_matches_the_unplaced_step(world):
    """A causal LM at T 128 takes the flash seam (the kernels' plain
    versions here) with heads sharded over the model axis and the vocab
    path sharded; one SGD step equals the unplaced port's within 1e-5 of
    each tensor's largest entry."""
    _, got = world("flash_lm_2d")
    assert got["score"] == pytest.approx(got["ref_score"], rel=1e-6)
    assert max(got["err"].values()) < 1e-5, got["err"]


# ------------------------------------------------------------------ draws
def test_draws_are_the_whole_batch_s_or_a_rank_s_own(world):
    """Shared gradients: the network's generator draws each dropout mask
    for the whole batch, so a dropout step on the mesh equals the unplaced
    step (1e-6). Averaging: each rank's generator is its own (4 different
    streams), and repeats from the same state of the network's generator
    (the reference's ``fold_in(rng, axis_index)``; jax's draws themselves
    cannot be reproduced, ROADMAP §C C31)."""
    _, got = world("draws")
    assert got["shared_err"] < 1e-6
    assert len({tuple(r) for r in got["ranks"]}) == len(got["ranks"]) == W.WORLD
    assert got["repeat_equal"]


# ----------------------------------------------------------- early stopping
@pytest.mark.parametrize("mode", ["shared_gradients", "averaging"])
def test_early_stopping_parallel_trainer_matches_reference(world, mode):
    inp, got = world("early_stopping")
    net = j_carried(j_small_net(updater="adam", lr=0.01), inp)
    cfg = jes.EarlyStoppingConfiguration(
        score_calculator=jes.DataSetLossCalculator(
            JListIt(JDataSet(inp["xt"], inp["yt"]), 16), average=True),
        epoch_termination_conditions=[jes.MaxEpochsTerminationCondition(3)])
    result = jes.EarlyStoppingParallelTrainer(
        cfg, net, JListIt(JDataSet(inp["x"], inp["y"]), 16), mesh=jmesh({"data": 4}),
        mode=mode, averaging_frequency=2).fit()
    mine = got[mode]
    assert mine["reason"] == result.termination_reason
    assert mine["epochs"] == result.total_epochs
    assert mine["best_epoch"] == result.best_model_epoch
    assert sorted(mine["scores"]) == sorted(result.score_vs_epoch)
    np.testing.assert_allclose([mine["scores"][e] for e in sorted(mine["scores"])],
                               [result.score_vs_epoch[e] for e in sorted(mine["scores"])],
                               rtol=1e-4, atol=1e-5)
    assert_trees_close(mine["params"], net.params, 1e-4, 1e-5)
