"""The zoo's remaining ported-layer models in the port against the JAX package.

``AlexNet``, ``VGG16``, ``VGG19``, ``GoogLeNet`` (with
``inception_module``), ``TextGenerationLSTM``, ``TransformerEncoder``
(with ``transformer_encoder_block``), ``VisionTransformer``,
``SimpleCNN`` and ``Darknet19`` (with ``darknet_block``), at the
published sizes from the configuration only (no network is
initialized): the parameter count and the layer or vertex names, in
order, equal the JAX package's ``conf()``; the configuration JSON reads
both ways. Then the CNNs: a reduced twin of AlexNet, VGG16, GoogLeNet,
SimpleCNN and Darknet19 (the sizes of the JAX package's
``tests/test_zoo.py``; SimpleCNN at 32x32, as its pretrained-weights test
builds it) gives the
reference's ``output`` within 1e-5 from the same weights (carried by
``load_reference_params``), and after 3 ``fit`` steps of the model's own
updater (Nesterovs, AlexNet with l2; SimpleCNN's AdaDelta) each parameter
lies within 2e-5 x its
tensor's largest entry of the reference's, with the dropout on, both
packages drawing the same masks (``tests/torch_putin.py``). VGG19 is
checked on its configuration only, as the JAX test does. The sequence
models' twins are in ``tests/test_torch_zoo_encoders.py``, which uses
this file's helpers.

The CNNs' steps run in float64 in both packages (under
``jax.enable_x64``): their f32 steps at these sizes are ill-conditioned,
as ResNet-50's is. A max pool's window whose two largest inputs lie
within f32 rounding of each other sends the gradient to either, and the
layers before it then take other gradients. In GoogLeNet's 4c max pool
two windows flip between the port's f32 forward and its f64 one, and the
port's f32 weight gradients of the layers before it lie up to 7.7e-3 of
their largest entry from the f64 ones (their biases, which sum over the
positions, within 1e-6); after 3 f32 steps VGG16's and AlexNet's biases
lie up to 4.3e-3 of their largest entry from the f64 steps. The port's
f32 convolutions on the CPU (oneDNN) differ from f64 by ~1e-6 relative,
the JAX package's by ~1e-7, so the port flips such near-ties more often
there; in f64 the two packages agree to 1e-15. Darknet19 runs at the
JAX test's 64x64: at 32x32 its last five blocks see 1x1 maps, each
BatchNorm then normalizes two values a channel, and even in f64 the two
packages' scores part from 1e-10 to 0.3 relative within 3 steps.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.nn.conf.graph_conf import ComputationGraphConfiguration as JGraphConf
from deeplearning4j_tpu.nn.conf.network import MultiLayerConfiguration as JMLConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.zoo import models as J
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn.conf.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import SelfAttentionLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.convert import export_params, load_reference_params
from deeplearning4j_tpu_torch.zoo import models as P
from torch_putin import PutIn

# the key bias (bqkv's K columns) has an analytically zero gradient
# (softmax ignores a constant added to every score of a row): both
# packages compute rounding noise there, which Adam scales into steps, so
# that slice is held by its gradient (below KEY_BIAS_GRAD on both sides),
# not by its steps, as tests/test_torch_graph_serde.py holds it
OUT_TOL, STEP_TOL, KEY_BIAS_GRAD = 1e-5, 2e-5, 1e-7
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731

VIT_B16 = dict(image_size=224, patch_size=16, n_layers=12, d_model=768,
               n_heads=12, d_ff=3072)
PUBLISHED = {"AlexNet": {}, "VGG16": {}, "VGG19": {}, "GoogLeNet": {},
             "TextGenerationLSTM": {}, "TransformerEncoder": {},
             "VisionTransformer": VIT_B16, "SimpleCNN": {}, "Darknet19": {}}
ENC = dict(num_labels=2, n_layers=2, d_model=16, n_heads=2, d_ff=32,
           vocab_size=50, max_length=12, seed=7)
REDUCED = {
    "AlexNet": dict(num_labels=7, input_shape=(3, 112, 112)),
    "VGG16": dict(num_labels=4, input_shape=(3, 64, 64)),
    "GoogLeNet": dict(num_labels=4, input_shape=(3, 64, 64)),
    "TextGenerationLSTM": dict(num_labels=12, max_length=10),
    "TransformerEncoder": ENC,
    "VisionTransformer": dict(num_labels=2, image_size=16, patch_size=4,
                              n_layers=2, d_model=32, n_heads=4, d_ff=64, seed=7),
    "SimpleCNN": dict(num_labels=5, input_shape=(3, 32, 32)),
    "Darknet19": dict(num_labels=6, input_shape=(3, 64, 64)),
}
CNNS = ["AlexNet", "VGG16", "GoogLeNet", "SimpleCNN", "Darknet19"]
# the models whose training forward draws dropout masks
DROPOUT = {"AlexNet", "VGG16", "GoogLeNet", "SimpleCNN"}
# the models whose step twins run in float64 (see the module docstring)
F64_STEPS = set(CNNS)


@pytest.fixture(autouse=True)
def _clean_seams():
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()
    yield
    jhelpers.clear_all_helpers()
    thelpers.clear_all_helpers()


def _names(conf):
    if hasattr(conf, "vertices"):
        return list(conf.topo_order)
    return [type(layer).__name__ for layer in conf.layers]


# ------------------------------------------------- published configurations
@pytest.mark.parametrize("name", list(PUBLISHED))
def test_published_configuration_matches_the_reference(name):
    jconf = getattr(J, name)(**PUBLISHED[name]).conf()
    conf = getattr(P, name)(**PUBLISHED[name]).conf()
    assert conf.num_params() == jconf.num_params()
    assert _names(conf) == _names(jconf)
    if hasattr(conf, "vertices"):
        assert [conf.vertices[n].inputs for n in conf.topo_order] == \
            [jconf.vertices[n].inputs for n in jconf.topo_order]
        assert [type(conf.vertices[n].obj).__name__ for n in conf.topo_order] == \
            [type(jconf.vertices[n].obj).__name__ for n in jconf.topo_order]


@pytest.mark.parametrize("name", list(PUBLISHED))
def test_published_configuration_json_reads_both_ways(name):
    jconf = getattr(J, name)(**PUBLISHED[name]).conf()
    conf = getattr(P, name)(**PUBLISHED[name]).conf()
    graph = hasattr(conf, "vertices")
    p_cls, j_cls = ((ComputationGraphConfiguration, JGraphConf) if graph
                    else (MultiLayerConfiguration, JMLConf))
    from_ref = p_cls.from_json(jconf.to_json())
    from_port = j_cls.from_json(conf.to_json())
    assert from_ref.num_params() == from_port.num_params() == jconf.num_params()
    assert _names(from_ref) == _names(jconf) and _names(from_port) == _names(conf)
    assert from_ref.to_dict() == conf.to_dict()


def test_published_models_keep_the_reference_defaults():
    enc = P.TransformerEncoder()
    assert (enc.n_layers, enc.d_model, enc.n_heads, enc.d_ff, enc.vocab_size,
            enc.max_length, enc.num_labels) == (12, 768, 12, 3072, 30522, 128, 2)
    g = enc.conf().global_conf
    assert type(g.updater).__name__ == "Adam" and g.updater.learning_rate == 1e-4
    alex = P.AlexNet().conf().global_conf
    assert alex.l2 == 5e-4 and alex.weight_init == "distribution"
    assert (alex.distribution.kind, alex.distribution.mean, alex.distribution.std) == (
        "normal", 0.0, 0.005)
    assert type(alex.updater).__name__ == "Nesterovs" and alex.updater.momentum == 0.9
    tg = P.TextGenerationLSTM().conf()
    assert type(tg.global_conf.updater).__name__ == "RmsProp"
    assert (tg.global_conf.gradient_normalization,
            tg.global_conf.gradient_normalization_threshold) == (
        "clip_elementwise_absolute_value", 10.0)
    assert [layer.n_out for layer in tg.layers[:2]] == [256, 256]
    assert P.VisionTransformer(**VIT_B16).num_patches == 196
    for name in ("SimpleCNN", "Darknet19"):
        mine, ref = getattr(P, name)(), getattr(J, name)()
        assert (mine.num_labels, mine.seed, mine.input_shape) == \
            (ref.num_labels, ref.seed, ref.input_shape)
    simple = P.SimpleCNN().conf()
    assert type(simple.global_conf.updater).__name__ == "AdaDelta"
    assert type(simple.layers[-1]).__name__ == "LossLayer"
    dark = P.Darknet19().conf()
    assert type(dark.global_conf.updater).__name__ == "Nesterovs"
    assert (dark.global_conf.updater.learning_rate, dark.global_conf.updater.momentum) \
        == (1e-3, 0.9)
    # the reference's "leakyrelu" (alpha 0.01), not DarknetHelper's 0.1
    assert dark.vertices["activation_1"].obj.activation == "leakyrelu"
    for shape in ((3, 224, 224), (3, 448, 448)):
        mine, ref = P.Darknet19(input_shape=shape), J.Darknet19(input_shape=shape)
        for kind in ("imagenet", "cifar10"):
            assert mine.pretrained_url(kind) == ref.pretrained_url(kind)
            assert mine.pretrained_checksum(kind) == ref.pretrained_checksum(kind)


# ------------------------------------------------------------- reduced twins
def _data(name, batch=2):
    rng = np.random.default_rng(3)
    kw = REDUCED[name]
    labels = kw["num_labels"]
    if name == "TextGenerationLSTM":
        x = rng.random((batch, kw["max_length"], labels)).astype(np.float32)
        y = np.eye(labels, dtype=np.float32)[rng.integers(0, labels, (batch, kw["max_length"]))]
        return x, y
    if name == "TransformerEncoder":
        x = rng.integers(0, kw["vocab_size"], (batch, kw["max_length"])).astype(np.float32)
    elif name == "VisionTransformer":
        x = rng.normal(size=(batch, kw["image_size"], kw["image_size"], 3)).astype(np.float32)
    else:
        c, h, w = kw["input_shape"]
        x = rng.random((batch, h, w, c)).astype(np.float32)
    return x, np.eye(labels, dtype=np.float32)[rng.integers(0, labels, batch)]


def _jax_init(name, conf=None):
    """The JAX network of model ``name`` (or of ``conf``), initialized
    with its normal and uniform draws taken from numpy (seeded):
    ``jax.random`` compiles a draw for every new shape, which is most of
    the cost of a reference init of these models on the CPU, and any
    weights serve for parity."""
    rng = np.random.default_rng(11)

    def normal(key, shape=(), dtype=np.float32):
        return jnp.asarray(rng.standard_normal(tuple(shape)), dtype)

    def uniform(key, shape=(), dtype=np.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(rng.uniform(minval, maxval, tuple(shape)), dtype)

    if conf is None:
        conf = getattr(J, name)(**REDUCED[name]).conf()
    with mock.patch.object(jax.random, "normal", normal), \
            mock.patch.object(jax.random, "uniform", uniform):
        return (JGraph if hasattr(conf, "vertices") else JMLN)(conf).init()


@functools.lru_cache(maxsize=None)
def _reference_weights(name):
    return to_np(_jax_init(name).params)


def _twins(name, dtype="float32"):
    """The JAX network and the port's, from the same weights, in ``dtype``
    (call under ``jax.enable_x64`` for "float64")."""
    jnet = _jax_init(name)
    cast = lambda a: jnp.asarray(np.asarray(a, dtype))  # noqa: E731
    jnet.params = jax.tree_util.tree_map(cast, _reference_weights(name))
    jnet.updater_states = jax.tree_util.tree_map(cast, jnet.updater_states)
    jnet.conf.global_conf.dtype = dtype
    conf = getattr(P, name)(**REDUCED[name]).conf()
    conf.global_conf.dtype = dtype
    net_cls = ComputationGraph if hasattr(conf, "vertices") else MultiLayerNetwork
    net = load_reference_params(net_cls(conf, device="cpu").init(),
                                _reference_weights(name))
    return jnet, net


def _keyed(tree):
    return tree if isinstance(tree, dict) else dict(enumerate(tree))


def _key_bias(net):
    """``{vertex: mask of bqkv's K entries}`` of the self-attention layers
    (head-major [H, 3, Dh] columns: K is part 1)."""
    out = {}
    for vd in getattr(net.conf, "layer_vertices", lambda: [])():
        if isinstance(vd.obj, SelfAttentionLayer):
            m = np.zeros((vd.obj.n_heads, 3, vd.obj._dh()), bool)
            m[:, 1] = True
            out[vd.name] = m.reshape(-1)
    return out


@pytest.mark.parametrize("name", CNNS)
def test_reduced_twin_output_matches_the_reference(name):
    check_output(name)


def check_output(name):
    jnet, net = _twins(name)
    x, _ = _data(name)
    want = np.asarray(jnet.output(x))
    got = net.output(x)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OUT_TOL)
    np.testing.assert_allclose(got.numpy().sum(-1), 1.0, atol=1e-4)


@pytest.mark.parametrize("name", CNNS)
def test_reduced_twin_three_steps_match_the_reference(name, monkeypatch):
    check_three_steps(name, monkeypatch)


def check_three_steps(name, monkeypatch):
    dtype = "float64" if name in F64_STEPS else "float32"
    with jax.enable_x64(dtype == "float64"):
        jnet, net = _twins(name, dtype)
        putin = PutIn(monkeypatch, seed=5) if name in DROPOUT else None
        x, y = _data(name)
        key_bias = _key_bias(net)
        if key_bias:
            grads, _ = net.compute_gradient_and_score(x, y)
            jgrads, _ = jnet.compute_gradient_and_score(x, y)
            for v, m in key_bias.items():
                for g in (grads[v]["bqkv"].numpy(), np.asarray(jgrads[v]["bqkv"])):
                    assert np.abs(g[m]).max() < KEY_BIAS_GRAD, v
        for _ in range(3):
            jnet.fit(x, y)
            net.fit(x, y)
            np.testing.assert_allclose(net.score_, float(jnet.score_), rtol=STEP_TOL)
        ref = _keyed(to_np(jnet.params))
    if putin is not None:  # the dropout stayed on, the same masks both ways
        assert putin.drawn and putin.port_calls == 3 * len(putin.drawn)
    start = _keyed(_reference_weights(name))
    moved = 0
    for key, named in _keyed(export_params(net)).items():
        for n, got in named.items():
            want, first = ref[key][n], start[key][n]
            assert got.dtype == want.dtype == np.dtype(dtype)
            if n == "bqkv" and key in key_bias:
                got, want, first = (a[~key_bias[key]] for a in (got, want, first))
            moved += not np.array_equal(want, first)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=STEP_TOL * max(np.abs(want).max(), 1e-30),
                                       err_msg=f"{name} {key}/{n}")
    assert moved


def test_vgg19_configuration_only():
    jconf = J.VGG19(num_labels=4, input_shape=(3, 64, 64)).conf()
    conf = P.VGG19(num_labels=4, input_shape=(3, 64, 64)).conf()
    assert conf.num_params() == jconf.num_params() > 0
    assert len(conf.layers) == 24
