"""The port's DL4J export against the JAX package's, byte for byte.

Each network is built by both packages from the same configuration code;
the JAX package's parameters, layer states and every updater slot are
drawn from a seed (as a trained network holds them) and carried into the
port's twin with the step and epoch counts. Both export a DL4J zip: the two
``configuration.json`` are equal as JSON, ``coefficients.bin`` and
``updaterState.bin`` are equal byte for byte (the 'f'-order rows, the conv
kernels' ``[out, in, kH, kW]`` order, the NHWC -> NCHW rows of a dense
layer after a convolution, the updater's block and slot order). Each
package's reader restores the other's zip: the output lies within 1e-5 of
the network that wrote it. Cases: a dense network, a conv network
(BatchNorm, pooling, the conv -> dense boundary), an LSTM network (a dense
layer between recurrent ones, TBPTT), a graph (Merge, ElementWise, a conv
-> dense LayerVertex), per-layer updaters with a bias updater, and a
normalizer. The configurations the JAX package refuses, the port refuses
with the same message.
"""

import json
import types
import zipfile
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deeplearning4j_tpu.datasets.normalizers as jnorm
import deeplearning4j_tpu.modelimport.dl4j as jdl4j
import deeplearning4j_tpu.modelimport.dl4j_export as jexport
import deeplearning4j_tpu.nn.conf as jconf
import deeplearning4j_tpu.nn.dropout as jdropout
import deeplearning4j_tpu.nn.layers.base as jbase
import deeplearning4j_tpu.nn.layers as jlayers
import deeplearning4j_tpu.nn.updaters as jupdaters
import deeplearning4j_tpu.nn.vertices as jvertices
import deeplearning4j_tpu_torch.datasets.normalizers as pnorm
import deeplearning4j_tpu_torch.modelimport.dl4j as pdl4j
import deeplearning4j_tpu_torch.modelimport.dl4j_export as pexport
import deeplearning4j_tpu_torch.nn.conf as pconf
import deeplearning4j_tpu_torch.nn.dropout as pdropout
import deeplearning4j_tpu_torch.nn.layers as players
import deeplearning4j_tpu_torch.nn.updaters as pupdaters
import deeplearning4j_tpu_torch.nn.vertices as pvertices
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.convert import (
    load_reference_params,
    load_reference_states,
    load_reference_updater_state,
)
from deeplearning4j_tpu_torch.util.model_guesser import load_model_guess, load_normalizer

OUT_TOL = 1e-5
REF = types.SimpleNamespace(conf=jconf, L=jlayers, U=jupdaters, V=jvertices, D=jdropout)
PORT = types.SimpleNamespace(conf=pconf, L=players, U=pupdaters, V=pvertices, D=pdropout)


# ------------------------------------------------------ the configurations
def _dense(k):
    return (k.conf.NeuralNetConfiguration.builder().seed(3).updater(k.U.Adam(1e-2))
            .list()
            .layer(k.L.DenseLayer(n_out=6, activation="tanh", l2=1e-3))
            .layer(k.L.DropoutLayer(dropout=0.9))
            .layer(k.L.DenseLayer(n_out=5, activation="relu", has_bias=False))
            .layer(k.L.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(k.conf.InputType.feed_forward(4)).build())


def _conv(k):
    return (k.conf.NeuralNetConfiguration.builder().seed(4).updater(k.U.Adam(1e-2))
            .list()
            .layer(k.L.ConvolutionLayer(n_out=3, kernel_size=(3, 2), stride=(1, 2),
                                        activation="relu"))
            .layer(k.L.BatchNormalizationLayer())
            .layer(k.L.SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                        stride=(1, 1), convolution_mode="same"))
            .layer(k.L.DenseLayer(n_out=5, activation="sigmoid"))
            .layer(k.L.OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(k.conf.InputType.convolutional(7, 6, 2)).build())


def _lstm(k):
    return (k.conf.NeuralNetConfiguration.builder().seed(5)
            .updater(k.U.Nesterovs(0.05, 0.9))
            .list()
            .layer(k.L.LSTMLayer(n_out=5))
            .layer(k.L.DenseLayer(n_out=4, activation="tanh"))
            .layer(k.L.GravesLSTMLayer(n_out=3))
            .layer(k.L.RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .t_bptt_length(4, 4)
            .set_input_type(k.conf.InputType.recurrent(3)).build())


def _updaters(k):
    """Three updaters and a bias updater: DL4J's blocks split where the
    updater changes."""
    return (k.conf.NeuralNetConfiguration.builder().seed(6).updater(k.U.RmsProp(1e-2))
            .bias_updater(k.U.Sgd(0.3))
            .list()
            .layer(k.L.DenseLayer(n_out=5, updater=k.U.Adam(1e-2)))
            .layer(k.L.DenseLayer(n_out=4, updater=k.U.AdaGrad(0.1)))
            .layer(k.L.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(k.conf.InputType.feed_forward(4)).build())


def _graph(k):
    g = (k.conf.NeuralNetConfiguration.builder().seed(7).updater(k.U.Adam(1e-2))
         .graph_builder().add_inputs("img", "vec")
         .set_input_types(k.conf.InputType.convolutional(5, 5, 2),
                          k.conf.InputType.feed_forward(3)))
    g.add_layer("c", k.L.ConvolutionLayer(n_out=3, kernel_size=(2, 2), activation="relu"),
                "img")
    g.add_layer("bn", k.L.BatchNormalizationLayer(), "c")
    g.add_layer("flat_dense", k.L.DenseLayer(n_out=4, activation="tanh"), "bn")
    g.add_layer("v1", k.L.DenseLayer(n_out=4, activation="relu"), "vec")
    g.add_layer("v2", k.L.DenseLayer(n_out=4, activation="sigmoid"), "vec")
    g.add_vertex("sum", k.V.ElementWiseVertex(op="add"), "v1", "v2")
    g.add_vertex("cat", k.V.MergeVertex(), "flat_dense", "sum")
    g.add_vertex("scaled", k.V.ScaleVertex(scale_factor=0.5), "cat")
    g.add_layer("out", k.L.OutputLayer(n_out=2, activation="softmax", loss="mcxent"),
                "scaled")
    return g.set_outputs("out").build()


CASES = {"dense": _dense, "conv": _conv, "lstm": _lstm, "updaters": _updaters,
         "graph": _graph}


def _inputs(name):
    rng = np.random.default_rng(len(name))
    shapes = {"graph": [(4, 5, 5, 2), (4, 3)], "conv": [(4, 7, 6, 2)], "lstm": [(3, 8, 3)]}
    return [rng.random(shape).astype(np.float32) for shape in shapes.get(name, [(4, 4)])]


def _numpy_draws():
    """The JAX package's initial arrays made by numpy (``jax.random`` and
    ``jnp``'s constructors compile a program per shape); the values are
    drawn again below."""
    def made(fn):
        return lambda shape, *a, dtype=np.float32, **k: jnp.asarray(fn(shape, *a, **k), dtype)

    return mock.patch.multiple(
        jnp, zeros=made(np.zeros), ones=made(np.ones), full=made(np.full),
        zeros_like=lambda a, dtype=None: jnp.asarray(np.zeros(np.shape(a)), dtype or a.dtype))


def _jax_net(cls, conf):
    weight = lambda key, shape, *a, dtype=np.float32, **k: jnp.zeros(shape, dtype)  # noqa: E731
    with _numpy_draws(), mock.patch.object(jbase, "init_weight", weight):
        return cls(conf).init()


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _drawn(tree, rng):
    """``tree`` with every leaf drawn anew (positive: variances and second
    moments must be)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.05, 1.0, np.shape(a)), np.float32)
        * np.where(rng.random(np.shape(a)) < 0.5, -1, 1).astype(np.float32)
        if np.ndim(a) else a, tree)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """``{case: (reference net, port net, ref zip, port zip, x)}``: the
    reference's parameters, layer states and every updater slot drawn from
    a seed (as a trained network would hold them), the port holding the
    same values and counters."""
    root = tmp_path_factory.mktemp("dl4j_export")
    out = {}
    for i, (name, build) in enumerate(CASES.items()):
        rng = np.random.default_rng(40 + i)
        jnet = _jax_net(JGraph if name == "graph" else JMLN, build(REF))
        jnet.params = _drawn(jnet.params, rng)
        jnet.states = jax.tree_util.tree_map(jnp.abs, _drawn(jnet.states, rng))
        jnet.updater_states = jax.tree_util.tree_map(jnp.abs, _drawn(jnet.updater_states, rng))
        jnet.iteration, jnet.epoch = 7, 2
        x = _inputs(name)
        net = (ComputationGraph if name == "graph" else MultiLayerNetwork)(
            build(PORT), device="cpu").init()
        load_reference_params(net, _host(jnet.params))
        load_reference_states(net, _host(jnet.states))
        load_reference_updater_state(net, _host(jnet.updater_states))
        net.iteration, net.epoch = jnet.iteration, jnet.epoch
        jpath, ppath = str(root / f"{name}_ref.zip"), str(root / f"{name}_port.zip")
        getattr(jexport, _export_fn(name))(jnet, jpath)
        getattr(pexport, _export_fn(name))(net, ppath)
        out[name] = (jnet, net, jpath, ppath, x)
    return out


def _export_fn(name):
    return "export_computation_graph" if "graph" in name else "export_multi_layer_network"


def _entries(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize("name", list(CASES))
def test_zip_equals_the_reference_s_byte_for_byte(exported, name):
    _, _, jpath, ppath, _ = exported[name]
    want, got = _entries(jpath), _entries(ppath)
    assert sorted(got) == sorted(want)
    assert json.loads(got.pop("configuration.json")) == json.loads(want.pop("configuration.json"))
    assert "coefficients.bin" in got and "updaterState.bin" in got
    for entry in got:
        assert got[entry] == want[entry], entry


@pytest.mark.parametrize("name", list(CASES))
def test_each_reader_restores_the_other_s_zip(exported, name):
    jnet, net, jpath, ppath, x = exported[name]
    restore = ("restore_computation_graph" if name == "graph"
               else "restore_multi_layer_network")
    mine = getattr(pdl4j, restore)(jpath, device="cpu")
    theirs = getattr(jdl4j, restore)(ppath)
    np.testing.assert_allclose(mine.output(*x).numpy(), net.output(*x).numpy(),
                               rtol=0, atol=OUT_TOL)
    np.testing.assert_allclose(np.asarray(theirs.output(*x)), np.asarray(jnet.output(*x)),
                               rtol=0, atol=OUT_TOL)
    assert (mine.iteration, mine.epoch) == (jnet.iteration, jnet.epoch)
    # restored and written again: the same bytes (a graph's conv -> dense
    # entry written back as read); a restored list network with that
    # boundary has no input type to write it from, and both refuse it
    again, jagain = str(ppath).replace(".zip", "_again.zip"), str(jpath).replace(".zip", "_again.zip")
    if name == "conv":
        with pytest.raises(jdl4j.UnsupportedDl4jConfigurationException):
            jexport.export_multi_layer_network(theirs, jagain)
        with pytest.raises(pdl4j.UnsupportedDl4jConfigurationException):
            pexport.export_multi_layer_network(mine, again)
        return
    getattr(pexport, _export_fn(name))(mine, again)
    getattr(jexport, _export_fn(name))(theirs, jagain)
    for entry in ("coefficients.bin", "updaterState.bin"):
        assert _entries(again)[entry] == _entries(jpath)[entry] == _entries(jagain)[entry]
    assert (json.loads(_entries(again)["configuration.json"])
            == json.loads(_entries(jagain)["configuration.json"]))


def test_model_guesser_dispatches_dl4j_and_the_port_s_own_zips(exported, tmp_path):
    _, net, _, ppath, x = exported["conv"]
    got = load_model_guess(ppath, device="cpu")
    assert type(got).__name__ == "MultiLayerNetwork"
    np.testing.assert_allclose(got.output(*x).numpy(), net.output(*x).numpy(),
                               rtol=0, atol=OUT_TOL)
    assert type(load_model_guess(exported["graph"][3], device="cpu")).__name__ == \
        "ComputationGraph"
    own = str(tmp_path / "own.zip")
    net.save(own)
    assert type(load_model_guess(own, device="cpu")).__name__ == "MultiLayerNetwork"
    with pytest.raises(Exception, match="Unable to load model"):
        load_model_guess(str(tmp_path / "missing.zip"), device="cpu")


def test_normalizer_travels_in_the_zip_as_the_reference_writes_it(exported, tmp_path):
    jnet, net, _, _, x = exported["dense"]
    data = np.random.default_rng(2).random((20, 4)).astype(np.float32)
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu_torch.datasets import DataSet

    jn, pn = jnorm.NormalizerStandardize(), pnorm.NormalizerStandardize()
    jn.fit(JDataSet(data, data[:, :3]))
    pn.fit(DataSet(data, data[:, :3]))
    jpath, ppath = str(tmp_path / "j.zip"), str(tmp_path / "p.zip")
    jexport.export_multi_layer_network(jnet, jpath, normalizer=jn)
    pexport.export_multi_layer_network(net, ppath, normalizer=pn)
    assert _entries(ppath)["normalizer.bin"] == _entries(jpath)["normalizer.bin"]
    back = load_normalizer(ppath)
    np.testing.assert_array_equal(np.asarray(back.mean), np.asarray(pn.mean))


def _refusal(k, case):
    L, conf = k.L, k.conf
    b = conf.NeuralNetConfiguration.builder().list()
    if case == "layer":
        b.layer(L.LayerNormalizationLayer()).layer(L.OutputLayer(n_out=2))
        return b.set_input_type(conf.InputType.feed_forward(3)).build()
    if case == "dropout object":
        b.layer(L.DenseLayer(n_out=3, dropout=k.D.GaussianDropout(rate=0.1)))
        return b.layer(L.OutputLayer(n_out=2)).set_input_type(
            conf.InputType.feed_forward(3)).build()
    if case == "explicit preprocessor":
        b.layer(L.DenseLayer(n_out=3)).layer(L.OutputLayer(n_out=2))
        b.input_pre_processor(0, "identity")
        return b.set_input_type(conf.InputType.feed_forward(3)).build()
    g = (conf.NeuralNetConfiguration.builder().graph_builder().add_inputs("in")
         .set_input_types(conf.InputType.recurrent_convolutional(4, 4, 1, 3)))
    g.add_layer("r", L.LSTMLayer(n_out=2), "in")
    g.add_layer("out", L.RnnOutputLayer(n_out=2), "r")
    return g.set_outputs("out").build()


@pytest.mark.parametrize("case", ["layer", "dropout object", "explicit preprocessor",
                                  "graph boundary"])
def test_refusals_match_the_reference(case, tmp_path):
    jnet = _jax_net(JGraph if case == "graph boundary" else JMLN, _refusal(REF, case))
    net = (ComputationGraph if case == "graph boundary" else MultiLayerNetwork)(
        _refusal(PORT, case), device="cpu").init()
    fn = _export_fn(case)
    with pytest.raises(jdl4j.UnsupportedDl4jConfigurationException) as want:
        getattr(jexport, fn)(jnet, str(tmp_path / "j.zip"))
    with pytest.raises(pdl4j.UnsupportedDl4jConfigurationException) as got:
        getattr(pexport, fn)(net, str(tmp_path / "p.zip"))
    assert str(got.value) == str(want.value)
