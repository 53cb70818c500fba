"""SameDiff layers, gradient checkpointing and memory reports in the port
against the JAX package, on numpy-seeded inputs and carried weights.

- ``SameDiffLayer`` (a dense ``relu(x @ W + b)`` subclass registered under
  one name in both packages) and ``SameDiffLambdaLayer`` in both networks:
  the init rule, ``output`` and 3 Adam steps with and without
  ``FusedUpdaterHelper`` within 1e-5 x each tensor's largest entry, the
  configuration's JSON and the model zip both ways (``fn`` dropped);
- the reference's checkpointing cases that ``test_torch_mixed_precision.py``
  left out: checkpointed training in both networks equal to the
  reference's rematerialized training and, bit for bit, to the port's own
  plain training; with dropout, from a handed generator state: the port's
  checkpointed step against the reference's with the same masks (the
  recompute must replay them) and against its own plain step bit for bit;
  a layer's new running statistics from the first forward only;
- ``GlobalConf`` serde with ``gradient_checkpointing`` set, both ways;
- ``network_memory_report`` and ``memory_report`` equal to the
  reference's, the report's JSON both ways; ``compiled_memory_analysis``
  is ``{}`` on a CPU network.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JIter
from deeplearning4j_tpu.nn import conf as jconf
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.graph_conf import ComputationGraphConfiguration as JGraphConf
from deeplearning4j_tpu.nn.conf.network import MultiLayerConfiguration as JMLConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import BatchNormalizationLayer as JBN
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.layers.base import register_layer as jregister
from deeplearning4j_tpu.nn.layers.samediff import SameDiffLambdaLayer as JLambda
from deeplearning4j_tpu.nn.layers.samediff import SameDiffLayer as JSDLayer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.util import model_serializer as jms
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn import conf as pconf
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn import updaters as PU
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNormalizationLayer,
    DenseLayer,
    OutputLayer,
    SameDiffLambdaLayer,
    SameDiffLayer,
)
from deeplearning4j_tpu_torch.nn.layers.base import register_layer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.train_step import gradients
from deeplearning4j_tpu_torch.util import model_serializer as pms
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    export_updater_state,
    load_reference_params,
)
from torch_putin import PutIn

TOL = 1e-5
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


@pytest.fixture(autouse=True)
def _clean_seams():
    thelpers.clear_all_helpers()
    yield
    thelpers.clear_all_helpers()


def _assert_tree(got, want, what, tol=TOL):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_tree(got[k], want[k], f"{what}/{k}", tol)
        return
    if isinstance(want, (list, tuple)):
        for i, w in enumerate(want):
            _assert_tree(got[i], w, f"{what}/{i}", tol)
        return
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale,
                               err_msg=what)


# ---------------------------------------------------------- SameDiff layers
def _jax_sd_dense():
    @jregister
    @dataclasses.dataclass
    class SDDenseParity(JSDLayer):
        def define_parameters(self):
            return {"W": (self.n_in, self.n_out), "b": (self.n_out,),
                    "gb": (self.n_out,)}

        def define_layer(self, params, x):
            return jax.nn.relu(x @ params["W"] + params["b"]) + params["gb"]
    return SDDenseParity


def _port_sd_dense():
    @register_layer
    @dataclasses.dataclass
    class SDDenseParity(SameDiffLayer):
        def define_parameters(self):
            return {"W": (self.n_in, self.n_out), "b": (self.n_out,),
                    "gb": (self.n_out,)}

        def define_layer(self, params, x):
            return torch.relu(x @ params["W"] + params["b"]) + params["gb"]
    return SDDenseParity


# one layer class under one name in both packages' registries
JaxSDDense, PortSDDense = _jax_sd_dense(), _port_sd_dense()


def _sd_conf(pkg, graph=False):
    j = pkg == "jax"
    nnc, it, dense, out, sdd, lam, adam = (
        (JNNC, JIT, JDense, JOut, JaxSDDense, JLambda, JU.Adam) if j else
        (NeuralNetConfiguration, InputType, DenseLayer, OutputLayer, PortSDDense,
         SameDiffLambdaLayer, PU.Adam))
    fn = (lambda x: jnp.tanh(x) * 2.0) if j else (lambda x: torch.tanh(x) * 2.0)
    b = nnc.builder().seed(3).updater(adam(0.02))
    if not graph:
        return (b.list().layer(dense(n_out=10, activation="tanh"))
                .layer(sdd(n_out=7)).layer(lam(fn=fn))
                .layer(out(n_out=3))
                .set_input_type(it.feed_forward(6)).build())
    g = b.graph_builder().add_inputs("in").set_input_types(it.feed_forward(6))
    g.add_layer("d", dense(n_out=10, activation="tanh"), "in")
    g.add_layer("sd", sdd(n_out=7), "d")
    g.add_layer("lam", lam(fn=fn), "sd")
    g.add_layer("out", out(n_out=3), "lam")
    return g.set_outputs("out").build()


def _sd_pair(graph):
    jnet = (JGraph if graph else JMLN)(_sd_conf("jax", graph)).init()
    tnet = (ComputationGraph if graph else MultiLayerNetwork)(
        _sd_conf("port", graph), device="cpu").init()
    return jnet, load_reference_params(tnet, to_np(jnet.params))


def _data(n=16, d=6, k=3, seed=0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, d)).astype(np.float32)
    return x, np.eye(k, dtype=np.float32)[r.integers(0, k, n)]


def test_samediff_layer_init_rule():
    tnet = MultiLayerNetwork(_sd_conf("port"), device="cpu").init()
    p = tnet.params[1]
    assert float(p["b"].abs().sum()) == 0.0 and float(p["gb"].abs().sum()) == 0.0
    assert float(p["W"].abs().sum()) > 0 and p["W"].shape == (10, 7)
    assert tnet.params[2] == {} and tnet.layers[2].num_params() == 0
    jnet = JMLN(_sd_conf("jax")).init()
    assert {k: v.shape for k, v in jnet.params[1].items()} == {
        k: tuple(v.shape) for k, v in p.items()}


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused"])
def test_samediff_layers_train_as_the_reference(graph, fused):
    jnet, tnet = _sd_pair(graph)
    if fused:
        thelpers.set_helper("updater", ck.FusedUpdaterHelper())
    x, y = _data()
    _assert_tree(tnet.output(x).numpy(), np.asarray(jnet.output(x)), "output")
    jnet.fit(JIter(JDataSet(x, y), 8))
    tnet.fit(ListDataSetIterator(DataSet(x, y), 8))
    jnet.fit(x[:8], y[:8])
    tnet.fit(x[:8], y[:8])
    np.testing.assert_allclose(tnet.score_, float(jnet.score_), rtol=TOL, atol=TOL)
    _assert_tree(export_params(tnet), to_np(jnet.params), "param")
    _assert_tree(export_updater_state(tnet), to_np(jnet.updater_states), "state")


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
def test_samediff_layers_serde_and_zip_both_ways(graph, tmp_path):
    jnet, tnet = _sd_pair(graph)
    jc, tc = jnet.conf.to_json(), tnet.conf.to_json()
    assert '"fn"' not in jc and '"fn"' not in tc
    conf_cls, jconf_cls = ((ComputationGraphConfiguration, JGraphConf) if graph
                           else (MultiLayerConfiguration, JMLConf))
    back = conf_cls.from_json(jc)
    names = [type(l).__name__ for l in (back.layers if not graph else
                                        [v.obj for v in back.layer_vertices()])]
    assert "SDDenseParity" in names and "SameDiffLambdaLayer" in names
    assert jconf_cls.from_json(tc).to_dict()["global"] == jnet.conf.to_dict()["global"]
    x, _ = _data()
    jms.write_model(jnet, str(tmp_path / "j.zip"))
    pms.write_model(tnet, str(tmp_path / "p.zip"))
    restored = pms.restore_model(str(tmp_path / "j.zip"), device="cpu")
    jrestored = jms.restore_model(str(tmp_path / "p.zip"))
    _assert_tree(export_params(restored), to_np(jnet.params), "port restore")
    _assert_tree(to_np(jrestored.params), export_params(tnet), "reference restore")
    # the lambda's fn is not serialized: re-attach it, then the output agrees
    lam = (restored.layers[2] if not graph else restored.conf.vertices["lam"].obj)
    assert lam.fn is None
    lam.fn = lambda h: torch.tanh(h) * 2.0
    _assert_tree(restored.output(x).numpy(), np.asarray(jnet.output(x)), "output")


# ------------------------------------------------------- checkpointing
def _ck_conf(pkg, remat, graph=False, dropout=None, bn=False):
    j = pkg == "jax"
    nnc, it, dense, out, bnl, adam = (
        (JNNC, JIT, JDense, JOut, JBN, JU.Adam) if j else
        (NeuralNetConfiguration, InputType, DenseLayer, OutputLayer,
         BatchNormalizationLayer, PU.Adam))
    b = nnc.builder().seed(1).updater(adam(0.01)).gradient_checkpointing(remat)
    if dropout is not None:
        b = b.dropout(dropout)
    layers = [dense(n_out=32, activation="tanh")]
    if bn:
        layers.append(bnl())
    layers += [dense(n_out=32, activation="tanh"), out(n_out=3)]
    if not graph:
        lb = b.list()
        for layer in layers:
            lb = lb.layer(layer)
        return lb.set_input_type(it.feed_forward(10)).build()
    g = b.graph_builder().add_inputs("in").set_input_types(it.feed_forward(10))
    src = "in"
    for i, layer in enumerate(layers):
        g.add_layer(f"l{i}", layer, src)
        src = f"l{i}"
    return g.set_outputs(src).build()


def _ck_nets(remat, graph=False, **kw):
    jnet = (JGraph if graph else JMLN)(_ck_conf("jax", remat, graph, **kw)).init()
    tnet = (ComputationGraph if graph else MultiLayerNetwork)(
        _ck_conf("port", remat, graph, **kw), device="cpu").init()
    return jnet, load_reference_params(tnet, to_np(jnet.params))


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
def test_checkpointed_training_matches_reference_and_plain(graph):
    """The reference's ``test_same_results_with_remat`` and
    ``test_graph_remat`` on the port: 2 epochs of 2 steps with batch
    normalization in the stack, against the reference's remat training and
    the port's plain training (bit for bit)."""
    x, y = _data(32, 10, seed=2)
    jnet, tnet = _ck_nets(True, graph, bn=True)
    _, plain = _ck_nets(False, graph, bn=True)
    load_reference_params(plain, export_params(tnet))
    jnet.fit(JIter(JDataSet(x, y), 16), epochs=2)
    for net in (tnet, plain):
        net.fit(ListDataSetIterator(DataSet(x, y), 16), epochs=2)
    np.testing.assert_allclose(tnet.score_, float(jnet.score_), rtol=TOL, atol=TOL)
    _assert_tree(export_params(tnet), to_np(jnet.params), "param")
    for a, b in zip(list(tnet.parameters()) + list(tnet.buffers()),
                    list(plain.parameters()) + list(plain.buffers())):
        assert torch.equal(a, b)
    assert tnet.score_ == plain.score_


class StatePutIn(PutIn):
    """The reference's draws handed to the port, keyed by the port
    generator's state: a draw from a state met before (the checkpoint's
    recompute) gets the array that state got first. Each port draw moves
    the generator on, as a real draw does."""

    def __init__(self, monkeypatch, seed=0):
        super().__init__(monkeypatch, seed)
        self.by_state = {}
        self.replays = 0

    def _port_bernoulli(self, p, shape, gen, device, dtype=torch.float32):
        key = bytes(gen.get_state().numpy())
        if key in self.by_state:
            self.replays += 1
        else:
            self.by_state[key] = super()._port_bernoulli(p, shape, gen, device, dtype)
        torch.rand(1, generator=gen, device=device)
        return self.by_state[key]


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
def test_checkpointed_dropout_step_replays_its_masks(monkeypatch, graph):
    x, y = _data(8, 10, seed=5)
    jnet, tnet = _ck_nets(True, graph, dropout=0.7, bn=True)
    put = StatePutIn(monkeypatch, seed=4)
    jx, jy = jnp.asarray(x), jnp.asarray(y)

    def jloss(p):
        if graph:
            return jnet._loss_fn(p, jnet.states, {"in": jx}, [jy], jax.random.PRNGKey(0),
                                 None, None, train=True)[0]
        return jnet._loss_fn(p, jnet.states, jx, jy, jax.random.PRNGKey(0), None, None,
                             train=True)[0]

    loss_j, grads_j = jax.value_and_grad(jloss)(jnet.params)
    # the input-dropout masks of the dense layers (and, in the graph, one
    # for the output layer's forward, whose activation no vertex reads: the
    # port does not run it, and the loss uses neither)
    assert [a.shape for _, a in put.drawn] == [(8, 10), (8, 32)] + [(8, 32)] * graph
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)

    def tloss(net):
        if graph:
            return lambda live: (net._loss_fn(live, {"in": tx}, [ty], None, None,
                                              train=True, gen=net.dropout_generator), None)
        return lambda live: (net._loss_fn(live, tx, ty, None, None, train=True,
                                          gen=net.dropout_generator)[0], None)

    loss_t, grads_t, _ = gradients(tloss(tnet), tnet.params)
    # each mask drawn once; the recompute of each checkpointed dense layer
    # found its mask by the generator state it started from (the output
    # layer's loss is not checkpointed)
    assert put.port_calls == len(put.by_state) == 2 and put.replays == 2
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=TOL)
    _assert_tree({k: {n: g.numpy() for n, g in v.items()} for k, v in grads_t.items()},
                 to_np(grads_j) if graph else dict(enumerate(to_np(grads_j))), "grad")


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
def test_checkpointed_dropout_equals_plain_from_a_handed_state(graph):
    x, y = _data(8, 10, seed=6)
    _, tnet = _ck_nets(True, graph, dropout=0.6, bn=True)
    _, plain = _ck_nets(False, graph, dropout=0.6, bn=True)
    load_reference_params(plain, export_params(tnet))
    handed = tnet.dropout_generator.get_state()
    plain.dropout_generator.set_state(handed)
    for _ in range(3):
        tnet.fit(x, y)
        plain.fit(x, y)
    assert tnet.score_ == plain.score_
    for a, b in zip(list(tnet.parameters()) + list(tnet.buffers()),
                    list(plain.parameters()) + list(plain.buffers())):
        assert torch.equal(a, b)
    assert torch.equal(tnet.dropout_generator.get_state(),
                       plain.dropout_generator.get_state())


def test_global_conf_serde_with_checkpointing_both_ways():
    tc = _ck_conf("port", True)
    jc = _ck_conf("jax", True)
    assert tc.global_conf.gradient_checkpointing
    assert JMLConf.from_json(tc.to_json()).global_conf.gradient_checkpointing
    assert MultiLayerConfiguration.from_json(jc.to_json()).global_conf.gradient_checkpointing
    assert not MultiLayerConfiguration.from_json(
        _ck_conf("jax", False).to_json()).global_conf.gradient_checkpointing
    gj = JGraphConf.from_json(_ck_conf("port", True, graph=True).to_json())
    assert gj.global_conf.gradient_checkpointing
    assert tc.to_dict()["global"] == jc.to_dict()["global"]
    # the Solver's settings: read, written and equal to the reference's
    # both ways
    lb_j, lb_t = jc.to_dict(), tc.to_dict()
    for d in (lb_j, lb_t):
        d["global"]["optimization_algo"] = "lbfgs"
        d["global"]["max_num_line_search_iterations"] = 7
    from_ref = MultiLayerConfiguration.from_dict(lb_j)
    assert from_ref.global_conf.optimization_algo == "lbfgs"
    assert from_ref.global_conf.max_num_line_search_iterations == 7
    assert from_ref.to_dict()["global"] == lb_j["global"]
    back = JMLConf.from_json(MultiLayerConfiguration.from_dict(lb_t).to_json())
    assert back.global_conf.optimization_algo == "lbfgs"
    assert back.global_conf.max_num_line_search_iterations == 7
    assert back.to_dict()["global"] == from_ref.to_dict()["global"]


# ------------------------------------------------------------- memory
def _mem_conf(pkg, updater, dtype="float32"):
    j = pkg == "jax"
    nnc, it, dense, out, u = ((JNNC, JIT, JDense, JOut, JU) if j else
                              (NeuralNetConfiguration, InputType, DenseLayer, OutputLayer, PU))
    return (nnc.builder().seed(1).updater(getattr(u, updater)(1e-3)).dtype(dtype).list()
            .layer(dense(n_out=32, activation="relu"))
            .layer(dense(n_out=16, activation="relu", updater=u.Sgd(0.1)))
            .layer(out(n_out=10))
            .set_input_type(it.feed_forward(20)).build())


@pytest.mark.parametrize("updater", ["Sgd", "Adam", "AMSGrad", "Nesterovs"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_memory_reports_equal_the_reference(updater, dtype):
    tc, jc = _mem_conf("port", updater, dtype), _mem_conf("jax", updater, dtype)
    tr = pconf.network_memory_report(tc, "net")
    jr = jconf.network_memory_report(jc, "net")
    assert tr.to_json() == jr.to_json()
    assert str(tr) == str(jr)
    for mb in (1, 7):
        for mode in pconf.MemoryUseMode:
            jmode = jconf.MemoryUseMode(mode.value)
            assert tr.get_total_memory_bytes(mb, mode) == jr.get_total_memory_bytes(mb, jmode)
            for t in pconf.MemoryType:
                assert tr.get_memory_bytes(t, mb, mode) == jr.get_memory_bytes(
                    jconf.MemoryType(t.value), mb, jmode)
    # JSON both ways
    assert pconf.NetworkMemoryReport.from_json(jr.to_json()).to_json() == jr.to_json()
    assert jconf.NetworkMemoryReport.from_json(tr.to_json()).to_json() == tr.to_json()
    assert tc.memory_report(batch=5) == jc.memory_report(batch=5)
    # the reference counts every dtype but float32 at 2 bytes here
    per = tc.memory_report()["layers"][0]
    assert per["param_bytes"] == per["params"] * (4 if dtype == "float32" else 2)
    assert [m.is_inference() for m in pconf.MemoryType] == [
        m.is_inference() for m in jconf.MemoryType]


def test_compiled_memory_analysis_is_empty_on_the_cpu():
    net = MultiLayerNetwork(_mem_conf("port", "Adam"), device="cpu").init()
    assert pconf.compiled_memory_analysis(net, batch=16) == {}
    no_type = (NeuralNetConfiguration.builder().list()
               .layer(DenseLayer(n_in=4, n_out=3)).layer(OutputLayer(n_in=3, n_out=2))
               .build())
    with pytest.raises(ValueError, match="input type"):
        pconf.compiled_memory_analysis(MultiLayerNetwork(no_type, device="cpu"), 4)
