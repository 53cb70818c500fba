"""The port's Keras import against the JAX package's, from the same files.

One module fixture builds small Keras models with the installed Keras (their
weights drawn from a seed), saves each as a legacy full-model ``.h5`` and
records Keras' own ``predict``. Both packages import every file; the port's
configuration JSON and parameters must equal the JAX package's exactly, its
``output`` must lie within 1e-5 of the JAX package's (Keras' ``predict``
is the second check, 1e-4: it runs TensorFlow's kernels), and one ``fit``
step of the imported network (the framework's default ``Sgd(0.1)``) must
put each parameter within 1e-5 x its tensor's largest entry of the JAX
package's step. The models together take every branch of
``map_keras_layer``: Sequential and functional, a narrow BERT (2 layers, 64
wide, 4 heads, vocab 100, T 16, two inputs), BatchNorm, a channels-first
CNN, the recurrent layers and their wrappers (Bidirectional over LSTM as
keras-io's IMDB classifier has it), ConvLSTM2D, the noise layers, a
registered ``Lambda``, cross-attention, the merge vertices, Reshape and
Flatten. The two-file overload (model JSON + weights ``.h5``) and the
configuration-only entry points are held the same way. Every class name
the reference maps is also mapped from a configuration dict alone (the
layer's JSON and the weights it takes from random Keras-shaped arrays),
and every configuration the reference refuses, the port refuses with the
same exception and message. The committed Keras fixtures of the card
(``tests/fixtures/keras/``) import to the JAX package's configuration.
"""

import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

keras = pytest.importorskip("keras")
pytest.importorskip("h5py")

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet  # noqa: E402
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet  # noqa: E402
from deeplearning4j_tpu.modelimport import keras as jk  # noqa: E402
from deeplearning4j_tpu.modelimport.keras import layers as jkl  # noqa: E402
from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import keras as pk  # noqa: E402
from deeplearning4j_tpu_torch.modelimport.keras import layers as pkl  # noqa: E402
from deeplearning4j_tpu_torch.modelimport.keras import model as pkm  # noqa: E402
from deeplearning4j_tpu_torch.util.convert import export_params, export_states  # noqa: E402
from deeplearning4j_tpu_torch.util.model_guesser import load_model_guess  # noqa: E402

OUT_TOL, KERAS_TOL, STEP_TOL = 1e-5, 1e-4, 1e-5
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "keras")
kl = keras.layers


def _scale_shift(t):
    """The registered ``Lambda``: tensor arithmetic that torch, jax and
    Keras all run."""
    return t * 2.0 + 1.0


# ----------------------------------------------------------- the models
def _bert():
    t, v, d, nh, ff = 16, 100, 64, 4, 128
    tok = kl.Input((t,), dtype="int32", name="tokens")
    pos = kl.Input((t,), dtype="int32", name="positions")
    x = kl.Add(name="embed_add")([kl.Embedding(v, d, name="tok_emb")(tok),
                                  kl.Embedding(t, d, name="pos_emb")(pos)])
    for i in range(2):
        att = kl.MultiHeadAttention(num_heads=nh, key_dim=d // nh, name=f"mha_{i}")(x, x)
        x = kl.LayerNormalization(name=f"ln1_{i}")(kl.Add(name=f"add1_{i}")([x, att]))
        h = kl.Dense(ff, activation="gelu", name=f"ff1_{i}")(x)
        h = kl.Dense(d, name=f"ff2_{i}")(h)
        x = kl.LayerNormalization(name=f"ln2_{i}")(kl.Add(name=f"add2_{i}")([x, h]))
    out = kl.Dense(2, activation="softmax", name="cls")(kl.GlobalAveragePooling1D(name="pool")(x))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, v, (3, t)).astype(np.float32)
    pos_ids = np.tile(np.arange(t, dtype=np.float32), (3, 1))
    return keras.Model([tok, pos], out), "categorical_crossentropy", [ids, pos_ids], 2


def _cnn():
    m = keras.Sequential([
        kl.Input((12, 12, 3)),
        kl.Conv2D(4, 3, activation="relu", kernel_constraint=keras.constraints.MaxNorm(2.0),
                  name="c1"),
        kl.BatchNormalization(name="bn"),
        kl.MaxPooling2D(2, name="p1"),
        kl.ZeroPadding2D(1, name="zp"),
        kl.AveragePooling2D(2, name="p2"),
        kl.UpSampling2D(2, name="up"),
        kl.Activation("tanh", name="act"),
        kl.LeakyReLU(negative_slope=0.2, name="lrelu"),
        kl.ELU(name="elu"),
        kl.Conv2D(3, 3, strides=2, dilation_rate=1, activation="swish", name="c2"),
        kl.Flatten(name="flat"),
        kl.Dense(3, activation="softmax", name="out"),
    ])
    x = np.random.default_rng(2).random((3, 12, 12, 3)).astype(np.float32)
    return m, "categorical_crossentropy", [x], 3


def _depthwise():
    """SeparableConv2D and DepthwiseConv2D: the JAX package refuses their
    Keras kernels ([kh, kw, C, M] against its grouped [kh, kw, 1, C*M]),
    the port reshapes them (ROADMAP C10), so this file is held against
    Keras' ``predict`` and the JAX package's refusal."""
    m = keras.Sequential([
        kl.Input((8, 8, 3)),
        kl.SeparableConv2D(6, 3, padding="same", depth_multiplier=2, name="sep"),
        kl.DepthwiseConv2D(3, depth_multiplier=2, activation="relu", name="dw"),
        kl.GlobalAveragePooling2D(name="g"),
        kl.Dense(2, activation="softmax", name="out"),
    ])
    x = np.random.default_rng(11).random((3, 8, 8, 3)).astype(np.float32)
    return m, "categorical_crossentropy", [x], 2


def _channels_first():
    m = keras.Sequential([
        kl.Input((3, 10, 10)),
        kl.Conv2D(4, 3, data_format="channels_first", activation="relu", name="c1"),
        kl.MaxPooling2D(2, data_format="channels_first", name="p1"),
        kl.GlobalMaxPooling2D(data_format="channels_first", name="g"),
        kl.Dense(2, activation="softmax", name="out"),
    ])
    x = np.random.default_rng(3).random((3, 10, 10, 3)).astype(np.float32)
    return m, "categorical_crossentropy", [x], 2


def _conv1d():
    m = keras.Sequential([
        kl.Input((20, 4)),
        kl.Conv1D(6, 3, activation="relu", name="c1"),
        kl.MaxPooling1D(2, name="p1"),
        kl.ZeroPadding1D(1, name="zp"),
        kl.UpSampling1D(2, name="up"),
        kl.AveragePooling1D(2, name="p2"),
        kl.Conv1D(5, 3, padding="same", activation="elu", name="c2"),
        kl.GlobalAveragePooling1D(name="g"),
        kl.Dense(2, activation="softmax", name="out"),
    ])
    x = np.random.default_rng(4).random((3, 20, 4)).astype(np.float32)
    return m, "categorical_crossentropy", [x], 2


def _rnn():
    """Embedding -> Bidirectional(LSTM) -> GRU -> SimpleRNN ->
    TimeDistributed(Dense) -> Bidirectional(LSTM, summed), each over the
    whole sequence, then average pooling and a sigmoid."""
    m = keras.Sequential([
        kl.Input((7,), dtype="int32"),
        kl.Embedding(30, 8, name="emb"),
        kl.Bidirectional(kl.LSTM(6, return_sequences=True), name="bi1"),
        kl.GRU(5, return_sequences=True, name="gru"),
        kl.SimpleRNN(4, return_sequences=True, name="srnn"),
        kl.TimeDistributed(kl.Dense(3, activation="tanh"), name="td"),
        kl.Bidirectional(kl.LSTM(5, return_sequences=True), merge_mode="sum", name="bi2"),
        kl.GlobalAveragePooling1D(name="pool"),
        kl.Dense(1, activation="sigmoid", name="out"),
    ])
    x = np.random.default_rng(5).integers(0, 30, (3, 7)).astype(np.float32)
    return m, "binary_crossentropy", [x], 1


def _imdb():
    """keras-io's "Bidirectional LSTM on IMDB" at a narrow width:
    Embedding -> Bidirectional(LSTM, sequences) -> Bidirectional(LSTM, last
    step) -> sigmoid. Both packages take the backward direction's output
    at the last position, where Keras takes its final state (ROADMAP §C),
    so this file is held against the JAX package only."""
    m = keras.Sequential([
        kl.Input((9,), dtype="int32"),
        kl.Embedding(50, 8, name="emb"),
        kl.Bidirectional(kl.LSTM(6, return_sequences=True), name="bi1"),
        kl.Bidirectional(kl.LSTM(6), name="bi2"),
        kl.Dense(1, activation="sigmoid", name="out"),
    ])
    x = np.random.default_rng(12).integers(0, 50, (3, 9)).astype(np.float32)
    return m, "binary_crossentropy", [x], 1


def _last_steps():
    """LSTM, GRU and SimpleRNN answering their last step and the merge
    vertices, as a functional model."""
    inp = kl.Input((6, 4), name="seq")
    x = inp
    a = kl.LSTM(5, name="lstm")(x)
    b = kl.GRU(5, name="gru")(x)
    c = kl.SimpleRNN(5, name="srnn")(x)
    merged = kl.Concatenate(name="cat")([
        kl.Add(name="add")([a, b]), kl.Subtract(name="sub")([a, c]),
        kl.Multiply(name="mul")([b, c]), kl.Average(name="avg")([a, b, c]),
        kl.Maximum(name="max")([a, c])])
    out = kl.Dense(2, activation="softmax", name="out")(merged)
    x = np.random.default_rng(6).random((3, 6, 4)).astype(np.float32)
    return keras.Model(inp, out), "categorical_crossentropy", [x], 2


def _functional():
    """Two inputs merged, and a registered Lambda."""
    a = kl.Input((6,), name="a")
    b = kl.Input((6,), name="b")
    h = kl.Concatenate(name="cat")([kl.Dense(8, activation="relu", name="da")(a),
                                    kl.Dense(4, activation="sigmoid", name="db")(b)])
    h = kl.Dense(3, activation="softplus", name="out")(h)
    out = kl.Lambda(_scale_shift, name="scale_shift")(h)
    rng = np.random.default_rng(7)
    return (keras.Model([a, b], out), "mse",
            [rng.random((3, 6)).astype(np.float32), rng.random((3, 6)).astype(np.float32)], 3)


def _cross_attention():
    q = kl.Input((5, 16), name="q")
    v = kl.Input((7, 16), name="v")
    att = kl.MultiHeadAttention(num_heads=2, key_dim=8, name="xatt")(q, v)
    rng = np.random.default_rng(8)
    return (keras.Model([q, v], att), None,
            [rng.random((2, 5, 16)).astype(np.float32), rng.random((2, 7, 16)).astype(np.float32)],
            None)


def _noise():
    """The noise and dropout layers (identities in ``output``), and a
    Reshape into Flatten."""
    m = keras.Sequential([
        kl.Input((6,)),
        kl.Dense(8, activation="selu", name="d1"),
        kl.Dropout(0.3, name="drop"),
        kl.GaussianDropout(0.2, name="gdrop"),
        kl.GaussianNoise(0.1, name="gnoise"),
        kl.AlphaDropout(0.1, name="adrop"),
        kl.Reshape((2, 4), name="rs"),
        kl.Flatten(name="fl"),
        kl.Dense(2, activation="softsign", name="out"),
    ])
    x = np.random.default_rng(9).random((3, 6)).astype(np.float32)
    return m, None, [x], None


def _convlstm():
    m = keras.Sequential([
        kl.Input((3, 6, 6, 2)),
        kl.ConvLSTM2D(3, 3, padding="same", return_sequences=True, name="clstm"),
        kl.TimeDistributed(kl.Conv2D(2, 3), name="tdc"),
        kl.TimeDistributed(kl.Flatten(), name="tdf"),
        kl.LSTM(3, name="lstm"),
        kl.Dense(2, activation="softmax", name="out"),
    ])
    x = np.random.default_rng(10).random((2, 3, 6, 6, 2)).astype(np.float32)
    return m, "categorical_crossentropy", [x], 2


MODELS = {"bert": _bert, "cnn": _cnn, "depthwise": _depthwise,
          "channels_first": _channels_first,
          "conv1d": _conv1d, "rnn": _rnn, "imdb": _imdb, "last_steps": _last_steps,
          "functional": _functional, "cross_attention": _cross_attention,
          "noise": _noise, "convlstm": _convlstm}
# TensorFlow's CPU kernels run no channels-first convolution; the last-step
# Bidirectional LSTM is the reference's, not Keras' (ROADMAP §C)
NO_PREDICT = {"channels_first", "imdb"}
# one step of the attention graph, the BatchNorm list network and the
# two-input graph (the others' layers step in the port's layer tests)
FIT = {"bert", "cnn", "functional"}


def _seed_weights(m, seed):
    """Every weight drawn from a seed (BatchNorm's variances and scales
    positive), so that no bias or statistic is left at its default."""
    rng = np.random.default_rng(seed)
    vals = []
    for w in m.weights:
        shape = tuple(w.shape)
        if any(k in w.path for k in ("moving_variance", "gamma")):
            vals.append(rng.uniform(0.5, 1.5, shape))
        else:
            vals.append(rng.normal(0.0, 0.3, shape))
    m.set_weights([v.astype(np.float32) for v in vals])


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """``{name: (h5 path, json path, inputs, labels, keras predict)}``."""
    root = tmp_path_factory.mktemp("keras")
    out = {}
    for i, (name, build) in enumerate(MODELS.items()):
        m, loss, inputs, n_out = build()
        _seed_weights(m, 100 + i)
        if loss:
            m.compile(loss=loss, optimizer="sgd")
        path = str(root / f"{name}.h5")
        m.save(path)
        jpath = str(root / f"{name}.json")
        with open(jpath, "w") as f:
            f.write(m.to_json())
        want = None
        if name not in NO_PREDICT:
            want = m.predict([x.astype(np.int32) if name in ("bert", "rnn", "imdb") else x
                              for x in inputs], verbose=0)
        labels = None
        if n_out:
            rng = np.random.default_rng(i)
            labels = (rng.integers(0, 2, (inputs[0].shape[0], 1)).astype(np.float32)
                      if n_out == 1 else
                      np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, inputs[0].shape[0])])
        out[name] = (path, jpath, inputs, labels, want)
    return out


@pytest.fixture(autouse=True)
def _lambdas():
    for mod in (jk, pk):
        mod.register_lambda_layer("scale_shift", _scale_shift)
    yield
    for mod in (jk, pk):
        mod.clear_lambda_layers()


@pytest.fixture(autouse=True)
def _numpy_draws():
    """The JAX package's initial draws taken from numpy: ``jax.random``
    compiles a draw for every new shape, most of a reference import's cost
    here, and every parameter compared comes from the file."""
    rng = np.random.default_rng(11)

    def normal(key, shape=(), dtype=np.float32):
        return jnp.asarray(rng.standard_normal(tuple(shape)), dtype)

    def uniform(key, shape=(), dtype=np.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(rng.uniform(minval, maxval, tuple(shape)), dtype)

    def truncated_normal(key, lower, upper, shape=(), dtype=np.float32):
        return jnp.asarray(np.clip(rng.standard_normal(tuple(shape)), lower, upper), dtype)

    with mock.patch.object(jax.random, "normal", normal), \
            mock.patch.object(jax.random, "uniform", uniform), \
            mock.patch.object(jax.random, "truncated_normal", truncated_normal):
        yield


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _keyed(tree):
    return dict(enumerate(tree)) if isinstance(tree, (list, tuple)) else tree


def _out(x):
    x = x[0] if isinstance(x, (list, tuple)) else x
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _both(path, json_path=None, sequential_entry=False):
    if sequential_entry:
        return (jk.KerasModelImport.import_keras_sequential_model_and_weights(path, json_path),
                pk.KerasModelImport.import_keras_sequential_model_and_weights(
                    path, json_path, device="cpu"))
    return (jk.KerasModelImport.import_keras_model_and_weights(path, json_path),
            pk.KerasModelImport.import_keras_model_and_weights(path, json_path, device="cpu"))


def _same_network(jnet, net):
    assert net.conf.to_json() == jnet.conf.to_json()
    for kind, mine, theirs in (("params", export_params(net), jnet.params),
                               ("states", export_states(net), jnet.states)):
        mine, theirs = _keyed(mine), _keyed(_host(theirs))
        assert set(mine) == set(theirs), kind
        for key, named in mine.items():
            assert set(named) == set(theirs[key]), (kind, key)
            for n, arr in named.items():
                np.testing.assert_array_equal(arr, theirs[key][n], err_msg=f"{kind} {key}/{n}")


def _step(net, inputs, labels, mds, ds):
    if len(inputs) > 1:
        net.fit(mds(list(inputs), [labels]))
    else:
        net.fit(ds(inputs[0], labels))


# -------------------------------------------------------------- the files
@pytest.mark.parametrize("name", [n for n in MODELS if n != "depthwise"])
def test_import_matches_the_reference_and_keras(saved, name):
    path, _, inputs, labels, want = saved[name]
    jnet, net = _both(path)
    _same_network(jnet, net)
    ref = _out(jnet.output(*inputs))
    got = _out(net.output(*inputs))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=OUT_TOL)
    if want is not None:
        np.testing.assert_allclose(got, want, rtol=0, atol=KERAS_TOL)
    if name not in FIT:
        return
    _step(jnet, inputs, labels, JMultiDataSet, JDataSet)
    _step(net, inputs, labels, MultiDataSet, DataSet)
    ref = _keyed(_host(jnet.params))
    moved = 0
    for key, named in _keyed(export_params(net)).items():
        for n, arr in named.items():
            tol = STEP_TOL * max(np.abs(ref[key][n]).max(), 1e-30)
            np.testing.assert_allclose(arr, ref[key][n], rtol=0, atol=tol,
                                       err_msg=f"{name} {key}/{n}")
            moved += 1
    assert moved


def test_depthwise_kernels_import_where_the_reference_refuses_them(saved):
    path, _, inputs, _, want = saved["depthwise"]
    with pytest.raises(jkl.InvalidKerasConfigurationException, match="does not match"):
        jk.KerasModelImport.import_keras_model_and_weights(path)
    net = pk.KerasModelImport.import_keras_model_and_weights(path, device="cpu")
    np.testing.assert_allclose(_out(net.output(*inputs)), want, rtol=0, atol=KERAS_TOL)


def test_two_file_overload_and_configuration_entries(saved):
    """The model JSON with the weights of a full-model h5 (the two-file
    overload, functional and Sequential), and the configuration-only
    entry points."""
    for name in ("functional", "conv1d"):
        path, jpath, inputs, _, _ = saved[name]
        jnet, net = _both(jpath, path)
        _same_network(jnet, net)
        np.testing.assert_allclose(_out(net.output(*inputs)), _out(jnet.output(*inputs)),
                                   rtol=0, atol=OUT_TOL)
        assert (pk.KerasModelImport.import_keras_model_configuration(jpath).to_json()
                == jk.KerasModelImport.import_keras_model_configuration(jpath).to_json())
    path, jpath, inputs, _, _ = saved["conv1d"]
    jnet, net = _both(path, jpath, sequential_entry=True)
    _same_network(jnet, net)
    jnet, net = _both(path, sequential_entry=True)
    _same_network(jnet, net)
    assert (pk.KerasModelImport.import_keras_sequential_configuration(jpath).to_json()
            == jk.KerasModelImport.import_keras_sequential_configuration(jpath).to_json())
    for mod in (jk, pk):
        with pytest.raises(ValueError, match="not a Sequential model config"):
            mod.KerasModelImport.import_keras_sequential_configuration(saved["functional"][1])
    with open(jpath) as f:
        model_json = json.load(f)
    wrapper = pk.KerasModelImport.import_keras_model_from_json(json.dumps(model_json))
    assert isinstance(wrapper, pkm.KerasSequentialModel)
    net = wrapper.init(device="cpu")
    with pk.Hdf5Archive(path) as archive:
        wrapper.copy_weights(net, archive, "model_weights")
    jnet = jk.KerasModelImport.import_keras_sequential_model_and_weights(path, jpath)
    _same_network(jnet, net)


def test_copy_weights_writes_into_the_network_s_own_tensors(saved):
    """``copy_weights`` copies in place: the tensors the updater state and
    a fused updater hold stay the network's, and each keeps its dtype."""
    path, jpath, inputs, labels, _ = saved["cnn"]
    with open(jpath) as f:
        model_json = f.read()
    wrapper = pk.KerasModelImport.import_keras_model_from_json(model_json)
    net = wrapper.init(device="cpu")
    before = {(k, n): t for k, named in net.params.items() for n, t in named.items()}
    states = {(k, n): t for k, named in net.states.items() for n, t in named.items()}
    with pk.Hdf5Archive(path) as archive:
        wrapper.copy_weights(net, archive, "model_weights")
    assert all(net.params[k][n] is t for (k, n), t in before.items())
    assert all(net.states[k][n] is t and t.dtype == torch.float32
               for (k, n), t in states.items())
    jwrapper = jk.KerasModelImport.import_keras_model_from_json(model_json)
    jnet = jwrapper.init()
    with jk.Hdf5Archive(path) as archive:
        jwrapper.copy_weights(jnet, archive, "model_weights")
    _same_network(jnet, net)
    with pk.Hdf5Archive(path) as archive:
        bad = dict(wrapper.weight_fns)
        wrapper.weight_fns = {**bad, "out": lambda raw: ({"W": np.zeros((2, 2))}, {})}
        with pytest.raises(pk.InvalidKerasConfigurationException, match="shape"):
            wrapper.copy_weights(net, archive, "model_weights")
        wrapper.weight_fns = {**bad, "out": lambda raw: ({"nope": np.zeros(2)}, {})}
        with pytest.raises(pk.InvalidKerasConfigurationException, match="not in model"):
            wrapper.copy_weights(net, archive, "model_weights")
    assert all(net.params[k][n] is t for (k, n), t in before.items())


def test_imported_attention_weights_survive_the_port_s_zip(saved, tmp_path):
    """The imported MultiHeadAttention's head-major ``Wqkv`` is the layout
    the zip stamps (``qkv_layout``): restoring it repacks nothing."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    path, _, inputs, _, _ = saved["bert"]
    net = pk.KerasModelImport.import_keras_model_and_weights(path, device="cpu")
    zip_path = str(tmp_path / "bert.zip")
    net.save(zip_path)
    back = ComputationGraph.load(zip_path, device="cpu")
    restored = export_params(back)
    for key, named in export_params(net).items():
        for n, arr in named.items():
            np.testing.assert_array_equal(restored[key][n], arr)
    np.testing.assert_array_equal(_out(back.output(*inputs)), _out(net.output(*inputs)))


def test_model_guesser_reads_a_keras_h5(saved):
    path, _, inputs, _, _ = saved["functional"]
    net = load_model_guess(path, device="cpu")
    assert type(net).__name__ == "ComputationGraph"
    assert all(p.device.type == "cpu" for p in net.parameters())
    np.testing.assert_allclose(
        _out(net.output(*inputs)),
        _out(jk.KerasModelImport.import_keras_model_and_weights(path).output(*inputs)),
        rtol=0, atol=OUT_TOL)


# --------------------------------------------- every mapped class, by dict
def _cfg(**kw):
    return {"name": "L", **kw}


_CONSTRAINT = {"class_name": "MaxNorm", "config": {"max_value": 2.0, "axis": 0}}
_LSTM = {"class_name": "LSTM", "config": _cfg(units=4, return_sequences=True)}
MAPPED = {
    "InputLayer": _cfg(batch_shape=[None, 3]),
    "Flatten": _cfg(),
    "Masking": _cfg(mask_value=0.0),
    "Dense": _cfg(units=4, activation="relu", kernel_constraint=_CONSTRAINT,
                  bias_constraint={"class_name": "NonNeg", "config": {}}),
    "TimeDistributedDense": _cfg(output_dim=4, activation="tanh", bias=False),
    "Conv2D": _cfg(filters=3, kernel_size=[2, 3], strides=[1, 2], padding="same",
                   dilation_rate=[1, 1], activation="relu", use_bias=True,
                   kernel_constraint={"class_name": "UnitNorm", "config": {"axis": [0, 1, 2]}}),
    "Convolution2D": _cfg(nb_filter=3, nb_row=2, nb_col=2, subsample=[1, 1],
                          border_mode="valid", activation="linear"),
    "Conv1D": _cfg(filters=3, kernel_size=[3], strides=[1], padding="valid",
                   activation="elu"),
    "Convolution1D": _cfg(nb_filter=3, filter_length=2, subsample_length=1,
                          border_mode="same", activation="tanh"),
    "SeparableConv2D": _cfg(filters=4, kernel_size=[3, 3], strides=[1, 1],
                            depth_multiplier=2, padding="same", activation="relu"),
    "DepthwiseConv2D": _cfg(kernel_size=[3, 3], strides=[1, 1], depth_multiplier=2,
                            padding="valid", activation="linear"),
    "MaxPooling2D": _cfg(pool_size=[2, 2], strides=[2, 2], padding="valid"),
    "AveragePooling2D": _cfg(pool_size=[3, 3], strides=None, padding="same"),
    "MaxPooling1D": _cfg(pool_size=[2], strides=[2]),
    "AveragePooling1D": _cfg(pool_length=3, stride=None),
    "GlobalMaxPooling1D": _cfg(),
    "GlobalAveragePooling1D": _cfg(),
    "GlobalMaxPooling2D": _cfg(),
    "GlobalAveragePooling2D": _cfg(),
    "Dropout": _cfg(rate=0.25),
    "SpatialDropout1D": _cfg(rate=0.2),
    "SpatialDropout2D": _cfg(rate=0.3),
    "SpatialDropout3D": _cfg(p=0.4),
    "GaussianDropout": _cfg(rate=0.2),
    "GaussianNoise": _cfg(stddev=0.3),
    "AlphaDropout": _cfg(rate=0.1),
    "Activation": _cfg(activation="hard_sigmoid"),
    "LeakyReLU": _cfg(negative_slope=0.1),
    "ELU": _cfg(alpha=1.0),
    "ThresholdedReLU": _cfg(theta=0.7),
    "BatchNormalization": _cfg(epsilon=1e-3, momentum=0.9),
    "Embedding": _cfg(input_dim=10, output_dim=4,
                      embeddings_constraint={"class_name": "MinMaxNorm",
                                             "config": {"min_value": 0.1, "max_value": 2.0,
                                                        "rate": 0.5, "axis": 1}}),
    "LSTM": _cfg(units=4, activation="tanh", recurrent_activation="sigmoid",
                 unit_forget_bias=False, return_sequences=False,
                 recurrent_constraint={"name": "MaxNorm", "m": 3.0, "axis": 0}),
    "GRU": _cfg(units=4, reset_after=True, return_sequences=True),
    "TimeDistributed": _cfg(layer={"class_name": "Conv2D",
                                   "config": _cfg(filters=2, kernel_size=[3, 3])}),
    "Lambda": {"name": "scale_shift"},
    "ConvLSTM2D": _cfg(filters=2, kernel_size=[3, 3], padding="same", return_sequences=True),
    "SimpleRNN": _cfg(units=3, activation="relu", return_sequences=False),
    "Bidirectional": _cfg(layer=_LSTM, merge_mode="ave"),
    "ZeroPadding2D": _cfg(padding=[[1, 2], [0, 1]]),
    "ZeroPadding1D": _cfg(padding=[1, 2]),
    "UpSampling2D": _cfg(size=[2, 3]),
    "UpSampling1D": _cfg(size=3),
    "LayerNormalization": _cfg(axis=[-1], epsilon=1e-6),
    "MultiHeadAttention": _cfg(num_heads=2, key_dim=3, dropout=0.1),
}


def _raw_weights(layer, seed):
    """Random Keras-shaped weights for the mapped layer, derived from the
    layer the JAX package built (its parameter shapes)."""
    rng = np.random.default_rng(seed)
    draw = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    cls = type(layer).__name__
    inner = getattr(layer, "layer", layer)
    if cls in ("DenseLayer", "ConvolutionLayer", "Convolution1DLayer"):
        k = draw(*([3, 4] if cls == "DenseLayer" else [2, 3, 2, 3] if "Convolution1D"
                   not in cls else [3, 2, 3]))
        return {"kernel": k, "bias": draw(k.shape[-1])}
    if cls == "SeparableConvolution2DLayer":
        return {"depthwise_kernel": draw(3, 3, 2, 2), "pointwise_kernel": draw(1, 1, 4, 4),
                "bias": draw(4)}
    if cls == "DepthwiseConvolution2DLayer":
        return {"depthwise_kernel": draw(3, 3, 2, 2), "bias": draw(4)}
    if cls == "BatchNormalizationLayer":
        return {"gamma": draw(3), "beta": draw(3), "moving_mean": draw(3),
                "moving_variance": np.abs(draw(3))}
    if cls == "EmbeddingSequenceLayer":
        return {"embeddings": draw(10, 4)}
    if type(inner).__name__ == "LSTMLayer" or cls == "BidirectionalWrapper":
        one = {"kernel": draw(3, 16), "recurrent_kernel": draw(4, 16), "bias": draw(16)}
        if cls == "BidirectionalWrapper":
            return {f"{d}_{k}": v for d in ("forward", "backward") for k, v in one.items()}
        return one
    if cls == "GRULayer":
        return {"kernel": draw(3, 12), "recurrent_kernel": draw(4, 12), "bias": draw(2, 12)}
    if type(inner).__name__ == "SimpleRnnLayer":
        return {"kernel": draw(2, 3), "recurrent_kernel": draw(3, 3), "bias": draw(3)}
    if cls == "ConvLSTM2DLayer":
        return {"kernel": draw(3, 3, 2, 8), "recurrent_kernel": draw(3, 3, 2, 8),
                "bias": draw(8)}
    if cls == "TimeDistributedWrapper":
        return {"kernel": draw(3, 3, 1, 2), "bias": draw(2)}
    if cls == "LayerNormalizationLayer":
        return {"gamma": draw(5), "beta": draw(5)}
    if cls == "SelfAttentionLayer":
        return {**{f"{p}_kernel": draw(6, 2, 3) for p in ("query", "key", "value")},
                **{f"{p}_bias": draw(2, 3) for p in ("query", "key", "value")},
                "attention_output_kernel": draw(2, 3, 6), "attention_output_bias": draw(6)}
    return {}


def _to_dict(layer):
    d = layer.to_dict()
    d.pop("fn", None)
    return d


@pytest.mark.parametrize("class_name", list(MAPPED))
def test_every_mapped_class_matches_the_reference(class_name):
    cfg = MAPPED[class_name]
    jlayer, jfn = jkl.map_keras_layer(class_name, dict(cfg))
    layer, fn = pkl.map_keras_layer(class_name, dict(cfg))
    if jlayer is None:
        assert layer is None
        return
    assert type(layer).__name__ == type(jlayer).__name__
    assert _to_dict(layer) == _to_dict(jlayer)
    raw = _raw_weights(jlayer, len(class_name))
    (jp, js), (p, s) = jfn(dict(raw)), fn(dict(raw))
    if "W" in jp and class_name in ("SeparableConv2D", "DepthwiseConv2D"):
        # Keras' [kh, kw, C, M] kernel as the grouped layer's [kh, kw, 1, C*M]
        # (ROADMAP C10; the reference keeps Keras' shape)
        jp = {**jp, "W": np.asarray(jp["W"]).reshape(3, 3, 1, -1)}
    for mine, theirs in ((p, jp), (s, js)):
        assert set(mine) == set(theirs)
        for k in mine:
            np.testing.assert_array_equal(np.asarray(mine[k]), np.asarray(theirs[k]))


def test_cross_attention_mapping_matches_the_reference():
    cfg = _cfg(num_heads=2, key_dim=3, value_dim=4)
    (jlayer, jfn), (layer, fn) = jkl.map_keras_mha_cross(dict(cfg)), pkl.map_keras_mha_cross(dict(cfg))
    assert _to_dict(layer) == _to_dict(jlayer)
    rng = np.random.default_rng(3)
    raw = {"query_kernel": rng.normal(size=(6, 2, 3)), "key_kernel": rng.normal(size=(5, 2, 3)),
           "value_kernel": rng.normal(size=(5, 2, 4)), "query_bias": rng.normal(size=(2, 3)),
           "attention_output_kernel": rng.normal(size=(2, 4, 6))}
    (jp, _), (p, _) = jfn(dict(raw)), fn(dict(raw))
    assert set(p) == set(jp)
    for k in p:
        np.testing.assert_array_equal(p[k], np.asarray(jp[k]))


def test_the_maps_of_activations_and_losses_are_the_reference_s():
    assert pkl.ACTIVATIONS == jkl.ACTIVATIONS and pkl.LOSSES == jkl.LOSSES
    for name in list(jkl.ACTIVATIONS) + [None, "RELU"]:
        assert pkl.map_activation(name) == jkl.map_activation(name)
    # Keras' "gelu" is the exact erf form, as the reference maps it
    assert pkl.map_activation("gelu") == "gelu"


# --------------------------------------------------- what both refuse
_RS = {"class_name": "Reshape", "config": {"name": "rs", "target_shape": [2, -1]}}
REFUSED_LAYERS = {
    "unknown layer": ("Conv3D", _cfg(filters=2)),
    "activation": ("Dense", _cfg(units=2, activation="mish")),
    "unregistered lambda": ("Lambda", {"name": "mystery"}),
    "constraint": ("Dense", _cfg(units=2, kernel_constraint={"class_name": "Fancy",
                                                             "config": {}})),
    "convlstm channels_first": ("ConvLSTM2D", _cfg(filters=2, kernel_size=[3, 3],
                                                   data_format="channels_first")),
    "bidirectional merge None": ("Bidirectional", _cfg(layer=_LSTM, merge_mode=None)),
    "bidirectional merge": ("Bidirectional", _cfg(layer=_LSTM, merge_mode="max")),
    "layer norm axis": ("LayerNormalization", _cfg(axis=[1])),
    "mha value_dim": ("MultiHeadAttention", _cfg(num_heads=2, key_dim=3, value_dim=4)),
    "mha output_shape": ("MultiHeadAttention", _cfg(num_heads=2, key_dim=3,
                                                    output_shape=[5])),
}


@pytest.mark.parametrize("case", list(REFUSED_LAYERS))
def test_every_refused_layer_is_refused_as_by_the_reference(case):
    class_name, cfg = REFUSED_LAYERS[case]
    with pytest.raises(jkl.UnsupportedKerasConfigurationException) as want:
        jkl.map_keras_layer(class_name, dict(cfg))
    with pytest.raises(pkl.UnsupportedKerasConfigurationException) as got:
        pkl.map_keras_layer(class_name, dict(cfg))
    assert str(got.value) == str(want.value)


def _seq(*layers):
    return {"class_name": "Sequential", "config": {"name": "s", "layers": list(layers)}}


_IN = {"class_name": "InputLayer", "config": {"name": "in", "batch_shape": [None, 4, 4, 3]}}
REFUSED_MODELS = {
    "reshape wildcard": (_seq(_IN, _RS, {"class_name": "Dense",
                                         "config": _cfg(units=2)}), None),
    "reshape last": (_seq(_IN, {"class_name": "Reshape",
                                "config": {"name": "rs", "target_shape": [48]}}), None),
    "mixed data formats": (_seq(_IN, {"class_name": "Conv2D", "config": _cfg(
        filters=2, kernel_size=[1, 1], data_format="channels_first")},
        {"class_name": "MaxPooling2D", "config": {"name": "p", "data_format": "channels_last"}}),
        None),
    "cross mha output_shape": ({"class_name": "Functional", "config": {
        "name": "f", "input_layers": [["q", 0, 0], ["v", 0, 0]], "output_layers": [["x", 0, 0]],
        "layers": [
            {"class_name": "InputLayer", "name": "q",
             "config": {"name": "q", "batch_shape": [None, 3, 4]}, "inbound_nodes": []},
            {"class_name": "InputLayer", "name": "v",
             "config": {"name": "v", "batch_shape": [None, 5, 4]}, "inbound_nodes": []},
            {"class_name": "MultiHeadAttention", "name": "x",
             "config": _cfg(num_heads=1, key_dim=4, output_shape=[4]),
             "inbound_nodes": [[["q", 0, 0, {}], ["v", 0, 0, {}]]]}]}}, None),
}


@pytest.mark.parametrize("case", list(REFUSED_MODELS))
def test_every_refused_model_is_refused_as_by_the_reference(case):
    model_json, training = REFUSED_MODELS[case]
    with pytest.raises(ValueError) as want:
        jk.KerasModelImport.import_keras_model_from_json(model_json, training)
    with pytest.raises(ValueError) as got:
        pk.KerasModelImport.import_keras_model_from_json(model_json, training)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


# ------------------------------------------ the card's committed fixtures
@pytest.mark.parametrize("name", ["bert_base", "imdb_bilstm", "sequential_cnn"])
def test_committed_fixtures_import_to_the_reference_s_configuration(name):
    with open(os.path.join(FIXTURES, f"{name}.json")) as f:
        fixture = json.load(f)
    want = jk.KerasModelImport.import_keras_model_from_json(
        fixture["model_config"], fixture["training_config"])
    got = pk.KerasModelImport.import_keras_model_from_json(
        fixture["model_config"], fixture["training_config"])
    assert type(got).__name__ == type(want).__name__
    assert got.conf.to_json() == want.conf.to_json()
    assert got.layer_names == want.layer_names
