"""The zoo's last two models in the port against the JAX package.

``InceptionResNetV1`` (with ``inception_resnet_block_a`` / ``_b`` / ``_c``)
and ``FaceNetNN4Small2``, at their published sizes from the configuration
only: the parameter count, the vertex names, inputs and types, in order,
equal the JAX package's ``conf()``, and the configuration JSON reads both
ways. FaceNet at the JAX package's ``tests/test_zoo.py`` size (4 labels,
3x64x64), in f64 from the same weights, gives the reference's ``output``
within 1e-5, and after 3 ``fit`` steps of its Adam(0.1) each parameter and
BatchNorm statistic lies within 2e-5 x its tensor's largest entry of the
reference's (f64: the CNN zoo's f32 steps are ill-conditioned, ROADMAP
§C). Each Inception-ResNet block type runs in a small graph (the block
over a 3x3 map of its 256, 896 or 1792 channels, average pooling, a
softmax output), f64, ``output`` and 3 Adam steps held the same way. The
whole InceptionResNetV1 is held on its configuration: the reference's
forward of it on the CPU costs more than this suite's budget allows.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.layers import base as jbase
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import GlobalPoolingLayer as JPool
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.zoo import helpers as JH
from deeplearning4j_tpu.zoo import models as J
from deeplearning4j_tpu_torch.nn.conf import InputType
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.graph_conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import GlobalPoolingLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    export_states,
    load_reference_params,
)
from deeplearning4j_tpu_torch.zoo import helpers as PH
from deeplearning4j_tpu_torch.zoo import models as P
from test_torch_zoo_models import OUT_TOL, STEP_TOL, _jax_init, _keyed, _names, to_np

from deeplearning4j_tpu.nn.conf.graph_conf import ComputationGraphConfiguration as JGraphConf

MODELS = ["InceptionResNetV1", "FaceNetNN4Small2"]
FACENET = dict(num_labels=4, input_shape=(3, 64, 64))
# each block over a 3x3 map of the channels its residual adds to
BLOCKS = {"a": 256, "b": 896, "c": 1792}


@pytest.mark.parametrize("name", MODELS)
def test_published_configuration_matches_the_reference(name):
    jconf, conf = getattr(J, name)().conf(), getattr(P, name)().conf()
    assert conf.num_params() == jconf.num_params()
    assert _names(conf) == _names(jconf)
    assert [conf.vertices[n].inputs for n in conf.topo_order] == \
        [jconf.vertices[n].inputs for n in jconf.topo_order]
    assert [type(conf.vertices[n].obj).__name__ for n in conf.topo_order] == \
        [type(jconf.vertices[n].obj).__name__ for n in jconf.topo_order]
    g = conf.global_conf
    assert (type(g.updater).__name__, g.updater.learning_rate) == (
        type(jconf.global_conf.updater).__name__, jconf.global_conf.updater.learning_rate)


@pytest.mark.parametrize("name", MODELS)
def test_published_configuration_json_reads_both_ways(name):
    jconf, conf = getattr(J, name)().conf(), getattr(P, name)().conf()
    from_ref = ComputationGraphConfiguration.from_json(jconf.to_json())
    from_port = JGraphConf.from_json(conf.to_json())
    assert from_ref.num_params() == from_port.num_params() == jconf.num_params()
    assert from_ref.to_dict() == conf.to_dict()
    mine, ref = getattr(P, name)(), getattr(J, name)()
    assert (mine.num_labels, mine.seed, mine.input_shape, mine.embedding_size) == \
        (ref.num_labels, ref.seed, ref.input_shape, ref.embedding_size)


def _block_conf(nnc, it, pool, out, adam, helpers, block, seed=5):
    c = BLOCKS[block]
    g = (nnc.builder().seed(seed).activation("relu").weight_init("relu")
         .updater(adam(1e-3)).graph_builder().add_inputs("in")
         .set_input_types(it.convolutional(3, 3, c)))
    x = getattr(helpers, f"inception_resnet_block_{block}")(g, f"blk-{block}", "in", 0.1)
    g.add_layer("pool", pool(pooling_type="avg"), x)
    g.add_layer("out", out(n_out=3, activation="softmax", loss="mcxent"), "pool")
    return g.set_outputs("out").build()


def _jax_net(conf):
    """The JAX network of ``conf`` with its initial arrays made by numpy
    (weights He-normal from a seed): ``jax.random`` and ``jnp``'s
    constructors compile a program for every new shape and dtype, most of a
    reference init's cost here."""
    rng = np.random.default_rng(11)

    def made(fn):
        return lambda shape, *a, dtype=np.float32, **k: jnp.asarray(
            fn(shape, *a, **k), dtype)

    def weight(key, shape, scheme, fan_in, fan_out, dtype=np.float32, **k):
        return jnp.asarray(rng.normal(0.0, np.sqrt(2.0 / fan_in), tuple(shape)), dtype)

    with mock.patch.multiple(
            jnp, zeros=made(np.zeros), ones=made(np.ones), full=made(np.full),
            zeros_like=lambda a, dtype=None: jnp.asarray(np.zeros(np.shape(a)),
                                                         dtype or a.dtype)), \
            mock.patch.object(jbase, "init_weight", weight):
        return _jax_init(None, conf)


def _twins(jconf, conf, dtype):
    """The JAX network and the port's, the same weights, in ``dtype``
    (under ``jax.enable_x64`` for float64)."""
    jnet = _jax_net(jconf)
    cast = lambda a: np.asarray(a, dtype)  # noqa: E731
    weights = jax.tree_util.tree_map(cast, to_np(jnet.params))
    jnet.params = jax.tree_util.tree_map(jax.numpy.asarray, weights)
    jnet.updater_states = jax.tree_util.tree_map(
        lambda a: jax.numpy.asarray(np.asarray(a, dtype)), jnet.updater_states)
    jnet.conf.global_conf.dtype = dtype
    conf.global_conf.dtype = dtype
    net = load_reference_params(ComputationGraph(conf, device="cpu").init(), weights)
    return jnet, net


def _three_steps(jnet, net, x, y):
    for _ in range(3):
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.score_, float(jnet.score_), rtol=STEP_TOL)
    moved = 0
    for mine, theirs, dtype in ((export_params(net), to_np(jnet.params), np.float64),
                                (export_states(net), to_np(jnet.states), np.float32)):
        ref = _keyed(theirs)
        for key, named in _keyed(mine).items():
            for n, got in named.items():
                want = ref[key][n]
                # BatchNorm's running statistics stay f32 in both packages
                assert got.dtype == want.dtype == dtype
                moved += 1
                np.testing.assert_allclose(
                    got, want, rtol=0, atol=STEP_TOL * max(np.abs(want).max(), 1e-30),
                    err_msg=f"{key}/{n}")
    assert moved


def _images(shape, batch, labels, seed):
    rng = np.random.default_rng(seed)
    h, w, c = shape
    return (rng.random((batch, h, w, c)).astype(np.float32),
            np.eye(labels, dtype=np.float32)[rng.integers(0, labels, batch)])


def test_facenet_output_and_three_steps_match_the_reference_in_f64():
    with jax.enable_x64(True):
        jnet, net = _twins(J.FaceNetNN4Small2(**FACENET).conf(),
                           P.FaceNetNN4Small2(**FACENET).conf(), "float64")
        x, y = _images((64, 64, 3), 2, 4, 4)
        want = np.asarray(jnet.output(x))
        got = net.output(x).numpy()
        assert got.shape == want.shape == (2, 4)
        np.testing.assert_allclose(got, want, rtol=0, atol=OUT_TOL)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-12)
        _three_steps(jnet, net, x, y)


@pytest.mark.parametrize("block", list(BLOCKS))
def test_inception_resnet_block_matches_the_reference_in_f64(block):
    with jax.enable_x64(True):
        jconf = _block_conf(JNNC, JIT, JPool, JOut, JAdam, JH, block)
        conf = _block_conf(NeuralNetConfiguration, InputType, GlobalPoolingLayer,
                           OutputLayer, Adam, PH, block)
        assert _names(conf) == _names(jconf) and conf.num_params() == jconf.num_params()
        jnet, net = _twins(jconf, conf, "float64")
        x, y = _images((3, 3, BLOCKS[block]), 2, 3, 5)
        np.testing.assert_allclose(net.output(x).numpy(), np.asarray(jnet.output(x)),
                                   rtol=0, atol=1e-12)
        _three_steps(jnet, net, x, y)
