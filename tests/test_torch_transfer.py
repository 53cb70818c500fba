"""Transfer learning, the zoo's ``ZooModel`` base and its labels in the
port against the JAX package.

- every ``TransferLearning.Builder`` / ``GraphBuilder`` /
  ``TransferLearningHelper`` case of the reference's
  ``tests/test_transfer_and_earlystopping.py``, on the port, each with
  the reference's result: the same configuration (layer types, widths,
  frozen wrappers), retained tensors equal to the source's (copies: the
  source stays as it was through fine-tuning), and, with the re-initialised
  tensors carried across from the reference, 2 fit steps (Adam, or the
  fine-tune's Sgd) within 1e-5 x each tensor's largest entry; frozen
  tensors unchanged bit for bit;
- ``FineTuneConfiguration``'s global and per-layer overrides;
- ``ZooModel.init_pretrained``: a ``file://`` fetch into the cache, a
  cache hit, a bad Adler32 or SHA-256 (the fetched artifact deleted, a
  user's file kept), an interrupted fetch, the DL4J ModelSerializer
  fixture, the reference's own zip format; ``ModelSelector``, the models'
  ``meta_data`` and pretrained registries;
- the labels: VOC, COCO, an ImageNet JSON, ``decode_predictions``.
"""

import hashlib
import json
import os
import shutil
import zlib

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import InputType as JIT
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import ConvolutionLayer as JConv
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.layers import SubsamplingLayer as JPool
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import transferlearning as JTL
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.util import model_serializer as jms
from deeplearning4j_tpu.zoo import labels as jlabels
from deeplearning4j_tpu.zoo import models as jmodels
from deeplearning4j_tpu.zoo import zoo_model as jzoo
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import cuda_kernels as ck
from deeplearning4j_tpu_torch.nn import helpers as thelpers
from deeplearning4j_tpu_torch.nn import transferlearning as PTL
from deeplearning4j_tpu_torch.nn import updaters as PU
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer,
    DenseLayer,
    FrozenLayer,
    OutputLayer,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import model_serializer as pms
from deeplearning4j_tpu_torch.util.convert import export_params, load_reference_params
from deeplearning4j_tpu_torch.zoo import labels as plabels
from deeplearning4j_tpu_torch.zoo import models as pmodels
from deeplearning4j_tpu_torch.zoo import zoo_model as pzoo

TOL = 1e-5
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
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


def _data(n=32, d=8, k=3, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, d).astype(np.float32)
    yi = rng.randint(0, k, n)
    x[np.arange(n), yi] += 2.0
    return x, np.eye(k, dtype=np.float32)[yi]


def _mlp(pkg, seed=7):
    j = pkg == "jax"
    nnc, it, dense, out, adam = ((JNNC, JIT, JDense, JOut, JU.Adam) if j else
                                 (NeuralNetConfiguration, InputType, DenseLayer,
                                  OutputLayer, PU.Adam))
    return (nnc.builder().seed(seed).updater(adam(0.01)).list()
            .layer(dense(n_out=16, activation="relu"))
            .layer(dense(n_out=12, activation="relu"))
            .layer(out(n_out=3))
            .set_input_type(it.feed_forward(8)).build())


def _graph(pkg):
    j = pkg == "jax"
    nnc, it, dense, out, adam = ((JNNC, JIT, JDense, JOut, JU.Adam) if j else
                                 (NeuralNetConfiguration, InputType, DenseLayer,
                                  OutputLayer, PU.Adam))
    return (nnc.builder().seed(5).updater(adam(0.01)).graph_builder()
            .add_inputs("in")
            .add_layer("d0", dense(n_out=16, activation="relu"), "in")
            .add_layer("d1", dense(n_out=12, activation="relu"), "d0")
            .add_layer("out", out(n_out=3), "d1")
            .set_outputs("out")
            .set_input_types(it.feed_forward(8))
            .build())


def _sources(graph=False):
    """The source network in both packages, with the same weights."""
    if graph:
        jnet = JGraph(_graph("jax")).init()
        tnet = ComputationGraph(_graph("port"), device="cpu").init()
    else:
        jnet = JMLN(_mlp("jax")).init()
        tnet = MultiLayerNetwork(_mlp("port"), device="cpu").init()
    return jnet, load_reference_params(tnet, to_np(jnet.params))


def _layers(net):
    if isinstance(net, (JGraph, ComputationGraph)):
        return {n: v.obj for n, v in net.conf.vertices.items() if v.is_layer}
    return dict(enumerate(net.conf.layers))


def _describe(layer):
    inner = layer.layer if hasattr(layer, "layer") and layer.layer is not None else layer
    return (type(layer).__name__, type(inner).__name__, getattr(inner, "n_in", None),
            getattr(inner, "n_out", None), type(inner.updater).__name__,
            getattr(inner.updater, "learning_rate", None))


def _transfer(jnet, tnet, build, fused=False, steps=2, seed=0, classes=3):
    """``build(pkg, net)`` applied to both sources; checks the new
    configurations agree, the retained tensors equal the source's, then
    fits both ``steps`` times from the reference's re-initialised weights
    and compares. Returns (new reference net, new port net, retained keys)."""
    before = {k: {n: t.clone() for n, t in v.items()} for k, v in tnet.params.items()}
    jn, tn = build(JTL, jnet), build(PTL, tnet)
    jl, tl = _layers(jn), _layers(tn)
    assert {k: _describe(v) for k, v in jl.items()} == {
        k: _describe(v) for k, v in tl.items()}
    src = export_params(tnet)
    src = dict(enumerate(src)) if isinstance(src, list) else src
    retained = [k for k in tn.params if k in src and all(
        np.array_equal(tn.params[k][n].numpy(), src[k][n]) for n in tn.params[k])
        and tn.params[k]]
    for k in retained:  # copies, not aliases
        for n, t in tn.params[k].items():
            assert t.data_ptr() != tnet.params[k][n].data_ptr()
    load_reference_params(tn, to_np(jn.params))
    if fused:
        thelpers.set_helper("updater", ck.FusedUpdaterHelper())
    x, y = _data(seed=seed, k=classes)
    frozen = {k: {n: t.clone() for n, t in tn.params[k].items()}
              for k, layer in tl.items() if isinstance(layer, FrozenLayer)}
    for _ in range(steps):
        jn.fit(x, y)
        tn.fit(x, y)
    np.testing.assert_allclose(tn.score_, float(jn.score_), rtol=TOL, atol=TOL)
    _assert_tree(export_params(tn), to_np(jn.params), "param")
    for k, named in frozen.items():
        for n, t in named.items():
            assert torch.equal(tn.params[k][n], t), (k, n)
    for k, v in before.items():  # the source is untouched
        for n, t in v.items():
            assert torch.equal(tnet.params[k][n], t), (k, n)
    return jn, tn, retained


def _updater(pkg, name, lr):
    return getattr(JU if pkg is JTL else PU, name)(lr)


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused"])
def test_freeze_keeps_params_fixed(fused):
    jnet, tnet = _sources()
    _, tn, retained = _transfer(jnet, tnet, lambda tl, net: (
        tl.TransferLearning.Builder(net)
        .fine_tune_configuration(tl.FineTuneConfiguration(
            updater=_updater(tl, "Sgd", 0.5)))
        .set_feature_extractor(0).build()), fused=fused)
    assert isinstance(tn.layers[0], FrozenLayer) and retained == [0, 1, 2]


def test_params_copied_from_source():
    jnet, tnet = _sources()
    _, tn, retained = _transfer(jnet, tnet, lambda tl, net: (
        tl.TransferLearning.Builder(net).set_feature_extractor(0).build()))
    assert retained == [0, 1, 2]


def test_nout_replace_reinitializes_consumer():
    jnet, tnet = _sources()
    _, tn, retained = _transfer(jnet, tnet, lambda tl, net: (
        tl.TransferLearning.Builder(net).n_out_replace(1, 20, weight_init="xavier")
        .build()))
    assert tn.layers[1].n_out == 20 and tuple(tn.params[1]["W"].shape) == (16, 20)
    assert tuple(tn.params[2]["W"].shape) == (20, 3) and retained == [0]


@pytest.mark.parametrize("fused", [False, True], ids=["stock", "fused"])
def test_remove_and_add_output_layer(fused):
    jnet, tnet = _sources()

    def build(tl, net):
        out = JOut if tl is JTL else OutputLayer
        return (tl.TransferLearning.Builder(net).remove_output_layer()
                .add_layer(out(n_out=5, activation="softmax")).build())
    jn, tn = build(JTL, jnet), build(PTL, tnet)
    load_reference_params(tn, to_np(jn.params))
    x, _ = _data()
    _assert_tree(tn.output(x).numpy(), np.asarray(jn.output(x)), "output")
    assert tuple(tn.output(x).shape) == (32, 5)


def test_fine_tune_configuration_overrides():
    jnet, tnet = _sources()
    ftc = dict(l2=1e-3, dropout=0.9, seed=99, weight_init="relu",
               gradient_normalization="clipelementwiseabsolutevalue",
               gradient_normalization_threshold=0.5)
    jn = (JTL.TransferLearning.Builder(jnet).fine_tune_configuration(
        JTL.FineTuneConfiguration(updater=JU.Sgd(0.123), **ftc)).set_feature_extractor(0)
        .build())
    tn = (PTL.TransferLearning.Builder(tnet).fine_tune_configuration(
        PTL.FineTuneConfiguration(updater=PU.Sgd(0.123), **ftc)).set_feature_extractor(0)
        .build())
    assert type(tn.conf.global_conf.updater).__name__ == "Sgd"
    assert tn.conf.to_dict() == jn.conf.to_dict()
    g = PTL.FineTuneConfiguration(updater="adam", bias_updater=PU.Sgd(0.2)).apply_to(
        tnet.conf.global_conf)
    assert isinstance(g.updater, PU.Adam) and g.bias_updater == PU.Sgd(0.2)
    assert tnet.conf.global_conf.bias_updater is None  # a copy was changed


def test_fine_tune_step_matches_reference_with_regularization():
    jnet, tnet = _sources()
    _transfer(jnet, tnet, lambda tl, net: (
        tl.TransferLearning.Builder(net)
        .fine_tune_configuration(tl.FineTuneConfiguration(
            updater=_updater(tl, "Adam", 0.05), l2=1e-2, seed=3))
        .set_feature_extractor(0).build()), fused=True, steps=3)


def test_helper_featurize():
    jnet, tnet = _sources()
    x, y = _data()
    jh = JTL.TransferLearningHelper(jnet, frozen_till=0)
    th = PTL.TransferLearningHelper(tnet, frozen_till=0)
    jf, tf = jh.featurize(JDataSet(x, y)), th.featurize(DataSet(x, y))
    assert tuple(tf.features.shape) == (32, 16)
    _assert_tree(tf.features.numpy(), np.asarray(jf.features), "features")
    before = tnet.output(x).clone()
    load_reference_params(th.unfrozen_mln, to_np(jh.unfrozen_mln.params))
    thelpers.set_helper("updater", ck.FusedUpdaterHelper())
    jh.fit_featurized(jf, epochs=2)
    th.fit_featurized(tf, epochs=2)
    _assert_tree(export_params(th.unfrozen_mln), to_np(jh.unfrozen_mln.params), "head")
    _assert_tree(th.output_from_featurized(tf.features).numpy(),
                 np.asarray(jh.output_from_featurized(jf.features)), "output")
    assert torch.equal(before, tnet.output(x))  # the trunk is untouched


def test_helper_featurize_cnn_flatten():
    def conf(pkg):
        j = pkg == "jax"
        nnc, it, conv, pool, dense, out, adam = (
            (JNNC, JIT, JConv, JPool, JDense, JOut, JU.Adam) if j else
            (NeuralNetConfiguration, InputType, ConvolutionLayer, SubsamplingLayer,
             DenseLayer, OutputLayer, PU.Adam))
        return (nnc.builder().seed(1).updater(adam(0.01)).list()
                .layer(conv(n_out=4, kernel_size=(3, 3), activation="relu"))
                .layer(pool())
                .layer(dense(n_out=10, activation="relu"))
                .layer(out(n_out=3))
                .set_input_type(it.convolutional(12, 12, 1)).build())
    jnet = JMLN(conf("jax")).init()
    tnet = load_reference_params(MultiLayerNetwork(conf("port"), device="cpu").init(),
                                 to_np(jnet.params))
    x = np.random.RandomState(0).rand(8, 12, 12, 1).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[np.random.RandomState(1).randint(0, 3, 8)]
    jh = JTL.TransferLearningHelper(jnet, frozen_till=1)
    th = PTL.TransferLearningHelper(tnet, frozen_till=1)
    jf, tf = jh.featurize(JDataSet(x, y)), th.featurize(DataSet(x, y))
    assert tf.features.ndim == 2  # flattened for the dense head
    _assert_tree(tf.features.numpy(), np.asarray(jf.features), "features")
    load_reference_params(th.unfrozen_mln, to_np(jh.unfrozen_mln.params))
    jh.fit_featurized(jf)
    th.fit_featurized(tf)
    _assert_tree(export_params(th.unfrozen_mln), to_np(jh.unfrozen_mln.params), "head")
    with pytest.raises(ValueError, match="trainable"):
        PTL.TransferLearningHelper(tnet, frozen_till=3)


def test_graph_freeze_ancestors():
    jnet, tnet = _sources(graph=True)
    _, tn, retained = _transfer(jnet, tnet, lambda tl, net: (
        tl.TransferLearning.GraphBuilder(net).set_feature_extractor("d1").build()),
        fused=True)
    v = tn.conf.vertices
    assert isinstance(v["d0"].obj, FrozenLayer) and isinstance(v["d1"].obj, FrozenLayer)
    assert not isinstance(v["out"].obj, FrozenLayer)
    assert sorted(retained) == ["d0", "d1", "out"]


def test_graph_replace_output():
    jnet, tnet = _sources(graph=True)

    def build(tl, net):
        out = JOut if tl is JTL else OutputLayer
        return (tl.TransferLearning.GraphBuilder(net).remove_vertex("out")
                .add_layer("newout", out(n_out=7), "d1").set_outputs("newout").build())
    _, tn, retained = _transfer(jnet, tnet, build, classes=7)
    x, _ = _data()
    assert tuple(tn.output(x).shape) == (32, 7)
    assert sorted(retained) == ["d0", "d1"]


def test_graph_remove_vertex_keeping_connections_and_nout_replace():
    jnet, tnet = _sources(graph=True)
    _, tn, retained = _transfer(jnet, tnet, lambda tl, net: (
        tl.TransferLearning.GraphBuilder(net).n_out_replace("d1", 24).build()))
    assert tuple(tn.params["d1"]["W"].shape) == (16, 24)
    assert tuple(tn.params["out"]["W"].shape) == (24, 3) and retained == ["d0"]
    # remove_vertex without its connections keeps the consumers: the
    # configuration then names a vertex that is gone, in both packages
    for tl, net in ((JTL, jnet), (PTL, tnet)):
        b = tl.TransferLearning.GraphBuilder(net).remove_vertex("d1",
                                                                remove_connections=False)
        with pytest.raises(Exception):
            b.build()
    kept = PTL.TransferLearning.GraphBuilder(tnet).remove_vertex("d0")._removed
    assert kept == JTL.TransferLearning.GraphBuilder(jnet).remove_vertex("d0")._removed


def test_builders_refuse_uninitialized_networks():
    with pytest.raises(ValueError, match="initialized"):
        PTL.TransferLearning.Builder(MultiLayerNetwork(_mlp("port"), device="cpu"))
    with pytest.raises(ValueError, match="initialized"):
        PTL.TransferLearning.GraphBuilder(ComputationGraph(_graph("port"), device="cpu"))


# ------------------------------------------------------------- the zoo
def test_model_selector_and_meta_data_match_reference():
    # every zoo model of the reference is ported and selectable by name
    assert set(pzoo.ModelSelector.available()) == set(jzoo.ModelSelector.available())
    for name in ("InceptionResNetV1", "FaceNetNN4Small2"):
        m = pzoo.ModelSelector.select(name.lower(), num_labels=5, seed=3)
        assert type(m).__name__ == name and (m.num_labels, m.seed) == (5, 3)
    with pytest.raises(KeyError, match="Unknown zoo model"):
        pzoo.ModelSelector.select("nope")
    m = pzoo.ModelSelector.select("LeNet", num_labels=4, seed=9)
    assert isinstance(m, pmodels.LeNet) and (m.num_labels, m.seed) == (4, 9)
    for name in pzoo.ModelSelector.available():
        mine, ref = pzoo.ModelSelector.select(name), jzoo.ModelSelector.select(name)
        assert isinstance(mine, pzoo.ZooModel)
        assert mine.meta_data() == pzoo.ModelMetaData(*dataclass_tuple(ref.meta_data()))
        assert mine.meta_data().use_mds == ref.meta_data().use_mds
        for kind in ("imagenet", "mnist", "cifar10", "vggface"):
            assert mine.pretrained_url(kind) == ref.pretrained_url(kind), (name, kind)
            assert mine.pretrained_checksum(kind) == ref.pretrained_checksum(kind)
        assert mine._artifact_name("imagenet") == ref._artifact_name("imagenet")
    p448 = pmodels.Darknet19(input_shape=(3, 448, 448))
    assert p448._artifact_name("imagenet") == jmodels.Darknet19(
        input_shape=(3, 448, 448))._artifact_name("imagenet")


def dataclass_tuple(meta):
    return (meta.input_shape, meta.n_outputs, meta.network_type)


def _lenet(seed=123):
    return pmodels.LeNet(num_labels=3, seed=seed, input_shape=(1, 12, 12))


def _stage(tmp_path, monkeypatch, name, src=None, net=None):
    zoo = tmp_path / "zoo"
    zoo.mkdir(exist_ok=True)
    monkeypatch.setenv("DL4J_TPU_ZOO_DIR", str(zoo))
    dst = zoo / name
    if src is not None:
        shutil.copyfile(src, dst)
    else:
        pms.write_model(net, str(dst))
    return dst


def _x(n=2):
    return np.random.default_rng(0).normal(size=(n, 12, 12, 1)).astype(np.float32)


def test_dl4j_zip_and_checksums_through_the_zoo_path(tmp_path, monkeypatch):
    staged = _stage(tmp_path, monkeypatch, "lenet_mnist.zip",
                    src=os.path.join(FIXTURES, "dl4j_checkpoint_convnet.zip"))
    net = pmodels.LeNet(num_labels=3).init_pretrained("mnist", device="cpu")
    exp = np.load(os.path.join(FIXTURES, "dl4j_checkpoint_convnet_expected.npz"))
    np.testing.assert_allclose(net.output(exp["x"]).numpy(), exp["out"], rtol=1e-5,
                               atol=1e-6)
    good = zlib.adler32(staged.read_bytes())
    assert pmodels.LeNet(num_labels=3).init_pretrained(
        "mnist", expected_checksum=good, device="cpu").params is not None
    with pytest.raises(ValueError, match="failed checksum"):
        pmodels.LeNet(num_labels=3).init_pretrained("mnist", expected_checksum=good + 1,
                                                    device="cpu")
    assert staged.exists()  # a user's file is never deleted
    monkeypatch.setattr(pmodels.LeNet, "PRETRAINED_CHECKSUMS", {"mnist": good})
    assert pmodels.LeNet(num_labels=3).init_pretrained("mnist", device="cpu").params


def test_own_zip_and_missing(tmp_path, monkeypatch):
    src = _lenet().init(device="cpu")
    _stage(tmp_path, monkeypatch, "lenet_cifar10.zip", net=src)
    net = _lenet().init_pretrained("cifar10", device="cpu")
    assert torch.equal(net.output(_x()), src.output(_x()))
    jnet = jms.restore_model(str(tmp_path / "zoo" / "lenet_cifar10.zip"))
    _assert_tree(net.output(_x()).numpy(), np.asarray(jnet.output(_x())), "reference")
    with pytest.raises(FileNotFoundError, match="No pretrained weights"):
        pmodels.LeNet().init_pretrained("vggface", device="cpu")


def _origin(tmp_path, monkeypatch):
    origin = tmp_path / "origin"
    origin.mkdir()
    ref = _lenet().init(device="cpu")
    blob = origin / "weights.zip"
    pms.write_model(ref, str(blob))
    cache = tmp_path / "cache"
    monkeypatch.setenv("DL4J_TPU_ZOO_DIR", str(cache))
    monkeypatch.setattr(pmodels.LeNet, "PRETRAINED_URLS", {"cifar10": blob.as_uri()})
    return blob, zlib.adler32(blob.read_bytes()), cache, ref


def test_file_url_fetch_cache_and_bad_checksum(tmp_path, monkeypatch):
    blob, good, cache, ref = _origin(tmp_path, monkeypatch)
    slot = cache / "lenet_cifar10.zip"
    monkeypatch.setattr(pmodels.LeNet, "PRETRAINED_CHECKSUMS", {"cifar10": good + 1})
    with pytest.raises(ValueError, match="corrupt download was deleted"):
        _lenet().init_pretrained("cifar10", device="cpu")
    assert not slot.exists()  # the fetched artifact was deleted
    monkeypatch.setattr(pmodels.LeNet, "PRETRAINED_CHECKSUMS", {"cifar10": good})
    net = _lenet().init_pretrained("cifar10", device="cpu")
    assert slot.exists() and (cache / "lenet_cifar10.zip.src").exists()
    assert not (cache / "lenet_cifar10.zip.part").exists()
    assert torch.equal(net.output(_x()), ref.output(_x()))
    os.remove(blob)  # a cache hit needs no transport
    assert torch.equal(_lenet().init_pretrained("cifar10", device="cpu").output(_x()),
                       ref.output(_x()))
    slot.write_bytes(slot.read_bytes() + b"bitrot")  # a fetched cache rots
    with pytest.raises(ValueError, match="delete the file"):
        _lenet().init_pretrained("cifar10", device="cpu")
    assert slot.exists()


def test_sha256_and_user_files(tmp_path, monkeypatch):
    blob, good, cache, _ = _origin(tmp_path, monkeypatch)
    digest = hashlib.sha256(blob.read_bytes()).hexdigest()
    monkeypatch.setattr(pmodels.LeNet, "PRETRAINED_CHECKSUMS", {"cifar10": good})
    monkeypatch.setattr(pmodels.LeNet, "PRETRAINED_SHA256", {"cifar10": digest.upper()})
    assert _lenet().init_pretrained("cifar10", device="cpu").params is not None
    shutil.rmtree(cache)
    monkeypatch.setattr(pmodels.LeNet, "PRETRAINED_SHA256", {"cifar10": "0" * 64})
    with pytest.raises(ValueError, match="SHA-256"):
        _lenet().init_pretrained("cifar10", device="cpu")
    assert not (cache / "lenet_cifar10.zip").exists()
    # a user's own weights in the slot: the registry's checksums do not apply
    own = _lenet(seed=777).init(device="cpu")
    pms.write_model(own, str(cache / "lenet_cifar10.zip"))
    net = _lenet().init_pretrained("cifar10", device="cpu")
    assert torch.equal(net.output(_x()), own.output(_x()))


def test_interrupted_fetch_leaves_no_artifact(tmp_path, monkeypatch):
    blob, _, cache, _ = _origin(tmp_path, monkeypatch)

    def explode(src, dst):
        dst.write(b"partial")
        raise OSError("link dropped")
    monkeypatch.setattr(shutil, "copyfileobj", explode)
    with pytest.raises(OSError, match="link dropped"):
        _lenet().init_pretrained("cifar10", device="cpu")
    for suffix in ("", ".part", ".src"):
        assert not (cache / f"lenet_cifar10.zip{suffix}").exists()


# ------------------------------------------------------------ labels
def test_labels_match_reference(tmp_path, monkeypatch):
    assert plabels.VOC_CLASSES == jlabels.VOC_CLASSES
    assert plabels.COCO_CLASSES == jlabels.COCO_CLASSES
    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.ones(20), size=4).astype(np.float32)
    probs[1, 7] = 5.0
    for top in (1, 5):
        for arg in (probs, torch.from_numpy(probs)):
            got = plabels.VOCLabels().decode_predictions(arg, top=top)
            want = jlabels.VOCLabels().decode_predictions(probs, top=top)
            assert [[(c.number, c.label, c.probability) for c in r] for r in got] == [
                [(c.number, c.label, c.probability) for c in r] for r in want]
    assert repr(got[0][0]) == repr(want[0][0])
    one = plabels.COCOLabels().decode_predictions(np.eye(80)[3], top=2)
    assert one[0][0].label == jlabels.COCOLabels().get_label(3) and len(one) == 1
    with pytest.raises(ValueError, match="label"):
        plabels.VOCLabels().decode_predictions(np.ones((2, 80)) / 80)
    idx = {str(i): [f"n{i:08d}", f"class_{i}"] for i in range(1000)}
    idx["0"] = ["n01440764", "tench"]
    (tmp_path / "imagenet_class_index.json").write_text(json.dumps(idx))
    labels = plabels.ImageNetLabels(str(tmp_path / "imagenet_class_index.json"))
    assert len(labels) == 1000 and labels.get_label(0) == "tench"
    monkeypatch.setenv("DL4J_TPU_ZOO_DIR", str(tmp_path))
    assert plabels.ImageNetLabels().get_label(999) == "class_999"
    monkeypatch.setenv("DL4J_TPU_ZOO_DIR", str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError, match="label table"):
        plabels.ImageNetLabels()
