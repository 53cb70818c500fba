"""The port's DL4J checkpoint reader against the JAX package's.

The four DL4J-format fixtures (``tests/fixtures/dl4j_checkpoint_*.zip``:
a convnet with BatchNorm and Adam, a GravesLSTM with Nesterovs under
TBPTT, a dense graph with an ElementWise vertex, a branchy dense graph
with a Merge vertex) restored by the port reproduce their recorded
outputs at rtol 1e-5 / atol 1e-6, and their parameters, layer states and
updater states equal the JAX package's restore of the same zip. One more
``fit`` step of the convnet from its restored Adam state lands within
2e-5 of the JAX package's. A narrow bottleneck graph (conv, BatchNorm,
activation, the ``add`` vertex, a conv → dense flatten in DL4J's C, H, W
order) written as a DL4J zip by the JAX package's
``export_computation_graph`` restores in the port within 1e-5 of the JAX
package's restore. The error cases raise the JAX package's exception
types; every DL4J layer the port has not ported raises naming it (the
recurrent wrappers, SimpleRnn and the image-sequence preprocessors are
held in ``tests/test_torch_recurrent_stack.py``); the
ND4J and normalizer streams are byte-for-byte the JAX package's.
"""

import json
import os
import shutil
import warnings
import zipfile

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.normalizers import NormalizerStandardize as JNorm
from deeplearning4j_tpu.modelimport import dl4j as jdl4j
from deeplearning4j_tpu.modelimport import nd4j_binary as jnd4j
from deeplearning4j_tpu.modelimport import normalizer_serde as jserde
from deeplearning4j_tpu.modelimport.dl4j_export import export_computation_graph
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import ActivationLayer as JAct
from deeplearning4j_tpu.nn.layers import BatchNormalizationLayer as JBN
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.vertices import ElementWiseVertex as JEW
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.datasets.normalizers import NormalizerStandardize
from deeplearning4j_tpu_torch.modelimport import dl4j
from deeplearning4j_tpu_torch.modelimport import nd4j_binary
from deeplearning4j_tpu_torch.modelimport import normalizer_serde
from deeplearning4j_tpu_torch.nn.activations import names as act_names
from deeplearning4j_tpu_torch.nn.conf import InputType
from deeplearning4j_tpu_torch.nn.conf.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    export_states,
    export_updater_state,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
RTOL, ATOL, STEP_TOL, EXPORT_TOL = 1e-5, 1e-6, 2e-5, 1e-5
NAMES = ("convnet", "lstm", "graph", "branchy_graph")
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


def _zip(name):
    return f"{FIXTURES}/dl4j_checkpoint_{name}.zip"


def _restore_both(path, graph):
    if graph:
        return (jdl4j.restore_computation_graph(path),
                dl4j.restore_computation_graph(path, device="cpu"))
    return (jdl4j.restore_multi_layer_network(path),
            dl4j.restore_multi_layer_network(path, device="cpu"))


def _keyed(tree):
    return dict(enumerate(tree)) if isinstance(tree, list) else tree


def _assert_equal_trees(got, want, what):
    got, want = _keyed(got), _keyed(want)
    assert set(got) == set(want), what
    for k, named in want.items():
        assert set(got[k]) == set(named), f"{what} {k}"
        for n, w in named.items():
            if isinstance(w, dict):
                _assert_equal_trees({0: got[k][n]}, {0: w}, f"{what} {k}/{n}")
            else:
                np.testing.assert_array_equal(got[k][n], w, err_msg=f"{what} {k}/{n}")


@pytest.mark.parametrize("name", NAMES)
def test_fixture_reproduces_recorded_output(name):
    exp = np.load(f"{FIXTURES}/dl4j_checkpoint_{name}_expected.npz")
    _, net = _restore_both(_zip(name), "graph" in name)
    out = net.output(exp["x"])
    assert out.device.type == "cpu"
    np.testing.assert_allclose(out.numpy(), exp["out"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_fixture_restore_equals_reference(name):
    jnet, tnet = _restore_both(_zip(name), "graph" in name)
    _assert_equal_trees(export_params(tnet), to_np(jnet.params), "params")
    _assert_equal_trees(export_states(tnet), to_np(jnet.states), "states")
    _assert_equal_trees(export_updater_state(tnet), to_np(jnet.updater_states),
                        "updater state")
    assert (tnet.iteration, tnet.epoch) == (jnet.iteration, jnet.epoch)
    assert type(tnet.conf.to_dict()) is dict
    if name == "convnet":
        assert tnet.conf.input_pre_processors == {2: "cnn_to_ff_nchw"}
        np.testing.assert_array_equal(tnet.states[1]["mean"].numpy(),
                                      np.load(f"{FIXTURES}/dl4j_checkpoint_convnet_"
                                              "expected.npz")["bn_mean"])
    if name == "lstm":
        assert tnet.conf.backprop_type == "truncated_bptt"
        assert tnet.conf.tbptt_fwd_length == 8


def test_convnet_fine_tunes_from_restored_adam_state():
    jnet, tnet = _restore_both(_zip("convnet"), False)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 8, 8, 1)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    jnet.fit(JDataSet(x, y))
    tnet.fit(DataSet(x, y))
    np.testing.assert_allclose(tnet.score_, jnet.score_, rtol=STEP_TOL)
    for what, got, want in (("param", export_params(tnet), to_np(jnet.params)),
                            ("state", export_states(tnet), to_np(jnet.states))):
        for i, named in enumerate(want):
            for n, w in named.items():
                np.testing.assert_allclose(got[i][n], w, rtol=STEP_TOL,
                                           atol=STEP_TOL, err_msg=f"{what} {i}/{n}")
    for i, named in enumerate(to_np(jnet.updater_states)):
        for n, slots in named.items():
            for s, w in slots.items():
                np.testing.assert_allclose(export_updater_state(tnet)[i][n][s], w,
                                           rtol=STEP_TOL, atol=STEP_TOL)


def _bottleneck_net():
    """input [6,6,4] → 1x1 conv 2 → BN → relu → 3x3 "same" conv 4 → BN,
    added to the input → relu → dense 5 (flattened) → output 3. The
    convolutions keep their bias: the DL4J dialect's convolution always
    has one, and the JAX package's exporter writes none for a conv
    without."""
    g = (JNNC.builder().seed(5).updater(JU.Adam(1e-2)).graph_builder()
         .add_inputs("in").set_input_types(JIT.convolutional(6, 6, 4)))
    g.add_layer("c1", JConv(n_out=2, kernel_size=(1, 1), activation="identity"),
                "in")
    g.add_layer("b1", JBN(activation="identity"), "c1")
    g.add_layer("a1", JAct(activation="relu"), "b1")
    g.add_layer("c2", JConv(n_out=4, kernel_size=(3, 3), convolution_mode="same",
                            activation="identity"), "a1")
    g.add_layer("b2", JBN(activation="identity", decay=0.8), "c2")
    g.add_vertex("short", JEW(op="add"), "b2", "in")
    g.add_layer("a2", JAct(activation="relu"), "short")
    g.add_layer("d", JDense(n_out=5, activation="tanh"), "a2")
    g.add_layer("out", JOut(n_out=3, activation="softmax", loss="mcxent"), "d")
    net = JGraph(g.set_outputs("out").build()).init()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 6, 6, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    net.fit(x, y)  # moves the running statistics and the Adam state
    return net, x


def test_exported_bottleneck_graph_restores_as_the_reference(tmp_path):
    jsrc, x = _bottleneck_net()
    path = str(tmp_path / "bottleneck.zip")
    export_computation_graph(jsrc, path)
    jnet, tnet = _restore_both(path, True)
    assert tnet.conf.input_pre_processors == {"d": "cnn_to_ff_nchw"}
    _assert_equal_trees(export_params(tnet), to_np(jnet.params), "params")
    _assert_equal_trees(export_states(tnet), to_np(jnet.states), "states")
    _assert_equal_trees(export_updater_state(tnet), to_np(jnet.updater_states),
                        "updater state")
    want = np.asarray(jnet.output(x))
    np.testing.assert_allclose(tnet.output(x).numpy(), want, rtol=EXPORT_TOL,
                               atol=EXPORT_TOL)
    np.testing.assert_allclose(want, np.asarray(jsrc.output(x)), rtol=EXPORT_TOL,
                               atol=EXPORT_TOL)


def test_error_cases_raise_the_reference_types(tmp_path):
    bad = str(tmp_path / "bad.zip")
    with zipfile.ZipFile(bad, "w") as z:
        z.writestr("readme.txt", "nope")
    cases = [
        (lambda m: m.import_dl4j_zip(bad), "InvalidDl4jConfigurationException"),
        (lambda m: m.import_dl4j_configuration(json.dumps(
            {"confs": [{"layer": {"quantumLayer": {}}}]})),
         "UnsupportedDl4jConfigurationException"),
        (lambda m: m.import_dl4j_configuration(json.dumps({"vertices": {}})),
         "InvalidDl4jConfigurationException"),
        (lambda m: m.import_dl4j_graph_configuration(json.dumps({
            "networkInputs": ["in"], "networkOutputs": ["x"],
            "vertices": {"x": {"WarpVertex": {}}}, "vertexInputs": {"x": ["in"]}})),
         "UnsupportedDl4jConfigurationException"),
        (lambda m: m.restore_computation_graph(_zip("convnet"), **_cpu(m)),
         "UnsupportedDl4jConfigurationException"),
        (lambda m: m.restore_multi_layer_network(_zip("graph"), **_cpu(m)),
         "UnsupportedDl4jConfigurationException"),
    ]
    for call, exc in cases:
        for mod in (jdl4j, dl4j):
            with pytest.raises(getattr(mod, exc)):
                call(mod)


def _cpu(mod):
    return {"device": "cpu"} if mod is dl4j else {}


# a DL4J layer type neither reader takes (the last two the port refused,
# autoEncoder and FrozenLayer, read as the reference's: PRETRAIN_VOCABULARY)
UNKNOWN = ["quantumLayer"]


@pytest.mark.parametrize("layer_type", UNKNOWN)
def test_unported_layer_raises_naming_it(layer_type):
    for mod in (dl4j, jdl4j):
        with pytest.raises(mod.UnsupportedDl4jConfigurationException, match=layer_type):
            mod.import_dl4j_configuration({"confs": [{"layer": {layer_type: {}}}]})


def test_unported_activation_raises_naming_it():
    """Every activation both readers map is ported; one neither reads
    (DL4J's ActivationPReLU) raises in both, naming it."""
    conf = {"confs": [{"layer": {"dense": {
        "nin": 2, "nout": 2,
        "activationFn": {"@class": "org.nd4j.linalg.activations.impl.ActivationPReLU"}}}}]}
    for mod in (dl4j, jdl4j):
        with pytest.raises(mod.UnsupportedDl4jConfigurationException, match="PReLU"):
            mod.import_dl4j_configuration(conf)
    assert set(dl4j._ACTIVATIONS.values()) <= set(act_names())


def test_preprocessors_are_serializable_specs_in_dl4j_order():
    spec = dl4j._convert_dl4j_preprocessor(
        {"@class": "org.deeplearning4j.nn.conf.preprocessor.CnnToFeedForwardPreProcessor",
         "inputHeight": 4, "inputWidth": 4, "numChannels": 2})
    assert spec == "cnn_to_ff_nchw"
    x = np.arange(2 * 4 * 4 * 2, dtype=np.float32).reshape(2, 4, 4, 2)
    fn = jdl4j._convert_dl4j_preprocessor({"cnnToFeedForward": {}})
    from deeplearning4j_tpu_torch.nn.conf import preprocessors as pp
    np.testing.assert_array_equal(pp.apply(spec, torch.from_numpy(x)).numpy(),
                                  np.asarray(fn(x)))
    ff_cfg = {"feedForwardToCnn": {"inputHeight": 4, "inputWidth": 4,
                                   "numChannels": 2}}
    back = dl4j._convert_dl4j_preprocessor(ff_cfg)
    assert back == "ff_to_cnn_nchw:4,4,2"
    flat = np.arange(2 * 32, dtype=np.float32).reshape(2, 32)
    np.testing.assert_array_equal(
        pp.apply(back, torch.from_numpy(flat)).numpy(),
        np.asarray(jdl4j._convert_dl4j_preprocessor(ff_cfg)(flat)))
    assert pp.output_type(back, InputType.feed_forward(32)) == \
        InputType.convolutional(4, 4, 2)
    np.testing.assert_array_equal(
        pp.apply(back, pp.apply(spec, torch.from_numpy(x))).numpy(), x)
    # image sequences: each step in C, H, W order, as the reference's closures
    seq = np.arange(2 * 3 * 2 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 2, 4)
    for key, arr in (("cnnToRnn", seq), ("rnnToCnn", seq.reshape(2, 3, 16))):
        cfg = {key: {"inputHeight": 2, "inputWidth": 2, "numChannels": 4}}
        np.testing.assert_array_equal(
            pp.apply(dl4j._convert_dl4j_preprocessor(cfg), torch.from_numpy(arr)).numpy(),
            np.asarray(jdl4j._convert_dl4j_preprocessor(cfg)(arr)))
    assert dl4j._convert_dl4j_preprocessor({"rnnToFeedForward": {}}) is None
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert dl4j._convert_dl4j_preprocessor({"composableInputPreProcessor": {}}) is None
    assert any("unsupported" in str(m.message) for m in w)
    _, tnet = _restore_both(_zip("convnet"), False)
    again = MultiLayerConfiguration.from_json(tnet.conf.to_json())
    assert again.input_pre_processors == {2: "cnn_to_ff_nchw"}


def test_lock_gamma_beta_shifts_the_layout(tmp_path):
    conf = {"confs": [
        {"layer": {"dense": {"nin": 3, "nout": 2, "activationFn":
                             {"@class": "org.nd4j.linalg.activations.impl.ActivationTanH"}}}},
        {"layer": {"batchNormalization": {"nin": 2, "lockGammaBeta": True}}},
        {"layer": {"output": {"nin": 2, "nout": 2, "activationFn":
                              {"@class": "org.nd4j.linalg.activations.impl.ActivationSoftmax"},
                              "lossFn": {"@class": "org.nd4j.linalg.lossfunctions.impl.LossMCXENT"}}}},
    ]}
    W = np.arange(6, dtype=np.float32).reshape(3, 2)
    mean, var = np.array([1.0, 2.0], np.float32), np.array([3.0, 4.0], np.float32)
    oW = np.arange(4, dtype=np.float32).reshape(2, 2) + 10
    flat = np.concatenate([W.flatten("F"), [0.5, -0.5], mean, var, oW.flatten("F"),
                           np.zeros(2, np.float32)]).astype(np.float32)
    p = str(tmp_path / "locked.zip")
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("configuration.json", json.dumps(conf))
        z.writestr("coefficients.bin", nd4j_binary.nd4j_array_to_bytes(flat.reshape(1, -1)))
    jnet, tnet = _restore_both(p, False)
    assert "gamma" not in tnet.params[1]
    np.testing.assert_array_equal(tnet.states[1]["var"].numpy(), var)
    np.testing.assert_array_equal(tnet.params[2]["W"].numpy(), oW)
    with pytest.raises(dl4j.InvalidDl4jConfigurationException, match="too short"):
        dl4j.apply_coefficients(tnet, flat[:-3])


def test_topological_order_and_updater_blocks_match_reference():
    for name in ("graph", "branchy_graph"):
        jconf, _ = jdl4j.import_dl4j_zip(_zip(name))
        tconf, _ = dl4j.import_dl4j_zip(_zip(name))
        assert isinstance(tconf, ComputationGraphConfiguration)
        assert dl4j._dl4j_topological_order(tconf) == jdl4j._dl4j_topological_order(jconf)
    elems = [3, 40, 17, 1, 19, 33, 2]
    assert dl4j._java_int_set_iter(elems) == jdl4j._java_int_set_iter(elems)
    assert dl4j._java_int_set_iter(list(range(30, 0, -1))) == \
        jdl4j._java_int_set_iter(list(range(30, 0, -1)))
    jnet, tnet = _restore_both(_zip("convnet"), False)
    tb = dl4j._updater_blocks(tnet.conf, tnet._updaters)
    jb = jdl4j._updater_blocks(jnet.conf, jnet._updaters)
    assert [[(k, n, s) for k, n, s, _, _ in b] for _, b in tb] == \
        [[(k, n, s) for k, n, s, _, _ in b] for _, b in jb]
    assert len(tb) == 2  # BatchNorm's statistics split the Adam block


def test_nd4j_and_normalizer_streams_match_reference(tmp_path):
    arr = np.random.default_rng(3).normal(size=(3, 5)).astype(np.float32)
    for order in ("c", "f"):
        b = nd4j_binary.nd4j_array_to_bytes(arr, order=order)
        assert b == jnd4j.nd4j_array_to_bytes(arr, order=order)
        np.testing.assert_array_equal(nd4j_binary.read_nd4j_array_from_bytes(b), arr)
    x = np.random.default_rng(4).normal(2.0, 3.0, (20, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[np.arange(20) % 2]
    mine = NormalizerStandardize().fit(DataSet(x, y))
    ref = JNorm().fit(JDataSet(x, y))
    assert normalizer_serde.normalizer_to_bytes(mine) == jserde.normalizer_to_bytes(ref)
    path = str(tmp_path / "with_norm.zip")
    shutil.copy(_zip("convnet"), path)
    dl4j.add_normalizer_to_model(path, mine)
    back, jback = dl4j.restore_normalizer(path), jdl4j.restore_normalizer(path)
    np.testing.assert_array_equal(back.mean, jback.mean)
    np.testing.assert_array_equal(back.std, mine.std)
    _, meta = dl4j.import_dl4j_zip(path)
    assert meta["has_normalizer"] and isinstance(meta["normalizer"], NormalizerStandardize)
    assert dl4j.restore_normalizer(_zip("convnet")) is None
    net = dl4j.restore_multi_layer_network(path, device="cpu")
    np.testing.assert_allclose(net.output(x.reshape(-1)[:64].reshape(1, 8, 8, 1)).numpy(),
                               np.asarray(jdl4j.restore_multi_layer_network(path).output(
                                   x.reshape(-1)[:64].reshape(1, 8, 8, 1))),
                               rtol=RTOL, atol=ATOL)


_ACT = "org.nd4j.linalg.activations.impl.Activation"
_UPD = "org.nd4j.linalg.learning.config."
VOCABULARY = [
    ("dense", {"layerName": "d", "nin": 3, "nout": 4, "activationFn": "RELU",
               "weightInit": "XAVIER", "l1": 1e-4, "l2": 2e-4, "dropOut": 0.8,
               "iUpdater": {"@class": _UPD + "Nesterovs", "learningRate": 0.05,
                            "momentum": 0.8}}),
    ("dense", {"nin": 3, "nout": 4, "activationFn": {"@class": _ACT + "Sigmoid"},
               "weightInit": "DISTRIBUTION",
               "dist": {"normal": {"mean": 0.1, "std": 0.5}},
               "updater": "ADAM", "learningRate": 0.01, "adamMeanDecay": 0.8,
               "adamVarDecay": 0.99, "hasBias": False}),
    ("dense", {"nin": 3, "nout": 4, "activationFn": {"TanH": {}},
               "weightInit": "DISTRIBUTION",
               "dist": {"@class": "org.deeplearning4j.nn.conf.distribution.UniformDistribution",
                        "lower": -0.2, "upper": 0.3},
               "iDropout": {"@class": "org.deeplearning4j.nn.conf.dropout.GaussianDropout",
                            "rate": 0.2},
               "constraints": [{"@class": "org.deeplearning4j.nn.conf.constraint.MaxNormConstraint",
                                "maxNorm": 2.0, "params": ["W"], "dimensions": [1]}],
               "gradientNormalization": "ClipElementWiseAbsoluteValue",
               "gradientNormalizationThreshold": 0.5,
               "iUpdater": {"@class": _UPD + "RmsProp", "learningRate": 0.02,
                            "rmsDecay": 0.9},
               "biasUpdater": {"@class": _UPD + "Sgd", "learningRate": 0.1}}),
    ("output", {"nin": 4, "nout": 2, "activationFn": {"@class": _ACT + "Softmax"},
                "lossFn": {"@class": "org.nd4j.linalg.lossfunctions.impl.LossNegativeLogLikelihood"},
                "iUpdater": {"@class": _UPD + "AdaDelta"}}),
    ("rnnoutput", {"nin": 4, "nout": 2, "activationFn": "SIGMOID", "lossFn": "XENT",
                   "updater": "ADAGRAD", "learningRate": 0.1}),
    ("convolution", {"nin": 2, "nout": 3, "kernelSize": [5, 3], "stride": [2, 1],
                     "padding": [1, 0], "convolutionMode": "Same",
                     "activationFn": "IDENTITY", "iUpdater": {"@class": _UPD + "AdaMax"}}),
    ("subsampling", {"poolingType": "AVG", "kernelSize": [3, 3], "stride": [1, 1],
                     "convolutionMode": "Truncate", "padding": [1, 1]}),
    ("subsampling", {"poolingType": "PNORM", "kernelSize": [2, 2]}),
    ("batchNormalization", {"nin": 5, "eps": 1e-3, "decay": 0.95,
                            "activationFn": "RELU",
                            "iUpdater": {"@class": _UPD + "Nadam", "learningRate": 0.003}}),
    ("localResponseNormalization", {"k": 1.0, "n": 3, "alpha": 0.001, "beta": 0.5}),
    ("activation", {"activationFn": {"@class": _ACT + "SELU"}}),
    ("dropout", {"dropOut": 0.6}),
    ("LSTM", {"nin": 3, "nout": 4, "activationFn": "TANH", "forgetGateBiasInit": 2.0,
              "updater": "NONE"}),
    ("gravesLSTM", {"nin": 3, "nout": 4, "activationFn": "TANH"}),
    ("GlobalPooling", {"poolingType": "AVG"}),
    ("zeroPadding", {"padding": [1, 2, 3, 4]}),
]
# the types and activations of the small-layer slice
NEW_VOCABULARY = [
    ("CenterLossOutputLayer", {"nin": 4, "nout": 3, "alpha": 0.1, "lambda": 0.003,
                               "activationFn": "SOFTMAX", "lossFn": "MCXENT"}),
    ("loss", {"activationFn": {"@class": _ACT + "LReLU", "alpha": 0.2}}),
    ("RnnLossLayer", {"lossFn": {"@class": "org.nd4j.linalg.lossfunctions.impl.LossMCXENT"},
                      "activationFn": "SOFTMAX"}),
    ("CnnLossLayer", {"lossFn": "XENT", "activationFn": {"Sigmoid": {}}}),
    ("convolution1d", {"nin": 3, "nout": 5, "kernelSize": [4, 1], "stride": [2, 1],
                       "padding": [1, 0], "dilation": [2, 1], "convolutionMode": "Truncate",
                       "activationFn": {"@class": _ACT + "ELU", "alpha": 0.7}}),
    ("subsampling1d", {"poolingType": "MAX", "kernelSize": [3, 1], "stride": [2, 1],
                       "convolutionMode": "Same"}),
    ("embedding", {"nin": 100, "nout": 8, "hasBias": True, "activationFn": "RELU6"}),
    ("embedding", {"nin": 100, "nout": 8, "activationFn": "LEAKYRELU",
                   "leakyreluAlpha": 0.25}),
    ("Upsampling2D", {"size": [2, 3]}),
    ("Upsampling2D", {"size": 2}),
    ("ElementWiseMult", {"nin": 6, "nout": 6, "activationFn": "HARDSIGMOID"}),
] + [("activation", {"activationFn": a}) for a in (
    "RELU6", "LEAKYRELU", "ELU", "HARDSIGMOID", "HARDTANH", "RATIONALTANH",
    "SOFTPLUS", "SOFTSIGN", "CUBE", "SWISH", "THRESHOLDEDRELU", "RRELU", "LRELU",
    {"@class": _ACT + "RReLU", "alpha": 0.1}, {"@class": _ACT + "ThresholdedReLU",
                                               "theta": 0.4},
    {"ELU": {"alpha": 0.3}})]
VOCABULARY += NEW_VOCABULARY
# the pretraining slice's types
PRETRAIN_VOCABULARY = [
    ("autoEncoder", {"nin": 6, "nout": 4, "corruptionLevel": 0.2,
                     "activationFn": "SIGMOID"}),
    ("autoEncoder", {"nin": 6, "nout": 4, "l2": 1e-4}),
    ("FrozenLayer", {"layer": {"dense": {"nin": 3, "nout": 4, "activationFn": "TANH"}}}),
    ("FrozenLayer", {"layer": {"convolution": {"nin": 2, "nout": 3, "kernelSize": [3, 3],
                                               "convolutionMode": "Same"}}}),
]
VOCABULARY += PRETRAIN_VOCABULARY


@pytest.mark.parametrize("entry", VOCABULARY,
                         ids=[f"{i}-{t}" for i, (t, _) in enumerate(VOCABULARY)])
def test_layer_vocabulary_matches_reference(entry):
    t, cfg = entry
    mine, ref = dl4j.convert_dl4j_layer(t, dict(cfg)), jdl4j.convert_dl4j_layer(t, dict(cfg))
    assert type(mine).__name__ == type(ref).__name__
    assert mine.to_dict() == ref.to_dict()


def test_configuration_of_the_new_types_reads_as_the_reference():
    """One DL4J configuration that uses every newly accepted layer type
    and activation, read by both readers to equal configurations."""
    conf = {"confs": [{"seed": 7, "layer": {t: dict(cfg)}} for t, cfg in NEW_VOCABULARY]}
    mine, ref = dl4j.import_dl4j_configuration(conf), jdl4j.import_dl4j_configuration(conf)
    assert len(mine.layers) == len(ref.layers) == len(NEW_VOCABULARY)
    assert [type(layer).__name__ for layer in mine.layers] == \
        [type(layer).__name__ for layer in ref.layers]
    assert json.loads(mine.to_json()) == json.loads(ref.to_json())


@pytest.mark.parametrize("kind", ["feed_forward", "conv2d"])
def test_zip_of_the_new_layers_loads_both_ways(tmp_path, kind):
    """A network of the new layers (the embedding, PReLU and centre-loss
    one; the separable, depthwise and transposed convolutions into a
    CnnLossLayer), one Adam step in, through the model zip: the JAX
    package's zip in the port and the port's in the JAX package, with
    ``W``, ``b``, ``pW``, ``cL`` and PReLU's ``W`` and their Adam state
    carried exactly."""
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.util import model_serializer as jms
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from test_torch_conv_family import JPKG, _conv2d_net, _net_data, jax_init
    from test_torch_small_layers import JAdam, JL, _ff_net

    if kind == "feed_forward":
        jconf = _ff_net(JL, JAdam, JNNC, JIT)
        rng = np.random.default_rng(2)
        x = rng.integers(0, 50, (8, 1))
        y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 8)]
    else:
        jconf = _conv2d_net(JPKG, JNNC, JIT)
        x, y, _ = _net_data("conv2d")
    jnet = jax_init(JMLN, jconf)
    jnet.fit(x, y)
    jzip, pzip = tmp_path / "jax.zip", tmp_path / "port.zip"
    jms.write_model(jnet, jzip)
    net = MultiLayerNetwork.load(jzip, device="cpu")
    names = {n for named in export_params(net) for n in named}
    assert names >= ({"W", "cL"} if kind == "feed_forward" else {"W", "b", "pW"})
    np.testing.assert_allclose(net.output(x).numpy(), np.asarray(jnet.output(x)),
                               rtol=0, atol=EXPORT_TOL)
    _assert_equal_trees(export_params(net), to_np(jnet.params), "params")
    _assert_equal_trees(export_updater_state(net), to_np(jnet.updater_states), "updater")
    net.save(pzip)
    back = jms.restore_multi_layer_network(pzip)
    assert json.loads(back.conf.to_json()) == json.loads(jnet.conf.to_json())
    _assert_equal_trees(to_np(back.params), export_params(net), "params")
    _assert_equal_trees(to_np(back.updater_states), export_updater_state(net), "updater")


def _write_dl4j_zip(path, conf, flat):
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("configuration.json", json.dumps(conf))
        z.writestr("coefficients.bin",
                   nd4j_binary.nd4j_array_to_bytes(flat.reshape(1, -1).astype(np.float32)))


def test_frozen_layer_and_autoencoder_zips_read_as_the_reference(tmp_path):
    """A FrozenLayer over a dense layer reads its coefficients as the dense
    layer's in both readers; an autoEncoder's (W, b, vb) both refuse, and
    a FrozenLayer without its layer is invalid in both."""
    dense = {"nin": 3, "nout": 4, "activationFn": "TANH"}
    out = {"nin": 4, "nout": 2, "activationFn": "SOFTMAX", "lossFn": "MCXENT"}
    conf = {"confs": [{"layer": {"FrozenLayer": {"layer": {"dense": dense}}}},
                      {"layer": {"output": out}}]}
    flat = np.arange(3 * 4 + 4 + 4 * 2 + 2, dtype=np.float32) / 10.0
    path = str(tmp_path / "frozen.zip")
    _write_dl4j_zip(path, conf, flat)
    jnet, tnet = _restore_both(path, False)
    assert type(tnet.conf.layers[0]).__name__ == "FrozenLayer"
    _assert_equal_trees(export_params(tnet), to_np(jnet.params), "params")
    x = np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_allclose(tnet.output(x).numpy(), np.asarray(jnet.output(x)),
                               rtol=RTOL, atol=ATOL)
    ae = {"confs": [{"layer": {"autoEncoder": {"nin": 3, "nout": 2}}},
                    {"layer": {"output": dict(out, nin=2)}}]}
    path = str(tmp_path / "ae.zip")
    _write_dl4j_zip(path, ae, np.zeros(3 * 2 + 2 + 3 + 2 * 2 + 2, np.float32))
    for mod in (jdl4j, dl4j):
        with pytest.raises(mod.UnsupportedDl4jConfigurationException, match="AutoEncoder"):
            mod.restore_multi_layer_network(path, **_cpu(mod))
        with pytest.raises(mod.InvalidDl4jConfigurationException, match="FrozenLayer"):
            mod.import_dl4j_configuration({"confs": [{"layer": {"FrozenLayer": {}}}]})

