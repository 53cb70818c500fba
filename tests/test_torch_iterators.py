"""The port's iterators, prefetch and normalizers against the JAX
package's, on the same numpy data.

- every iterator of ``datasets/iterators.py`` yields the reference's
  batches (equal arrays);
- ``AsyncDataSetIterator`` yields its base's batches, raises a producer's
  error in the consumer and retires its producer when the consumer stops
  early; ``wrap_for_prefetch`` keeps the reference's refusals; on the CPU
  ``device_put_batch`` only makes tensors;
- ``fit`` with the default prefetch equals ``fit`` with
  ``prefetch_depth=0`` (both networks, equal parameters and bytes);
- every normalizer's fit, transform and revert within 1e-6 of the
  reference's, its JSON equal and read in both directions; a model zip
  with a normalizer loads in each package from the other's.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import iterators as JI
from deeplearning4j_tpu.datasets import normalizers as JN
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import ListDataSetIterator as JList
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMulti
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.datasets import iterators as PI
from deeplearning4j_tpu_torch.datasets import normalizers as PN
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.util import model_serializer as pser
from deeplearning4j_tpu_torch.util.convert import export_params, load_reference_params
from deeplearning4j_tpu_torch.zoo.models import TransformerLM, lm_labels

TOL = 1e-6


def _data(n=10, seed=0, masks=False):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n, 3)).astype(np.float32)
    l = rng.standard_normal((n, 2)).astype(np.float32)
    if not masks:
        return f, l, None, None
    return f, l, (rng.random(n) > 0.3).astype(np.float32), np.ones(n, np.float32)


def _arrays(ds):
    if hasattr(ds, "features_masks"):
        return [np.asarray(a) for a in ds.features + ds.labels]
    return [None if a is None else np.asarray(a)
            for a in (ds.features, ds.labels, ds.features_mask, ds.labels_mask)]


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(_arrays(g), _arrays(w)):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


def _pair(make):
    """The reference's iterator and the port's, made by ``make(I, D, L)``
    from each package's iterators module, DataSet and ListDataSetIterator."""
    return make(JI, JDataSet, JList), make(PI, DataSet, ListDataSetIterator)


ITERATORS = {
    "multiple_epochs": lambda I, D, L: I.MultipleEpochsIterator(
        L(D(*_data()), 4, shuffle=True, seed=2), 3),
    "early_termination": lambda I, D, L: I.EarlyTerminationDataSetIterator(
        L(D(*_data()), 3), 2),
    "sampling": lambda I, D, L: I.SamplingDataSetIterator(D(*_data()), 4, 5, seed=3),
    "iterator_dataset": lambda I, D, L: I.IteratorDataSetIterator(
        L(D(*_data(masks=True)), 3), 5),
    "indarray": lambda I, D, L: I.INDArrayDataSetIterator(
        list(zip(*_data()[:2])), 4),
    "existing_list": lambda I, D, L: I.ExistingDataSetIterator(
        list(L(D(*_data()), 3)), total=2),
    "existing_factory": lambda I, D, L: I.ExistingDataSetIterator(
        lambda: iter(L(D(*_data()), 4))),
    "view": lambda I, D, L: I.ViewIterator(D(*_data(masks=True)), 4),
    "joint_stop": lambda I, D, L: I.JointParallelDataSetIterator(
        L(D(*_data()), 3), L(D(*_data(n=4, seed=1)), 2)),
    "joint_drain": lambda I, D, L: I.JointParallelDataSetIterator(
        L(D(*_data()), 3), L(D(*_data(n=4, seed=1)), 2), stop_on_first_exhausted=False),
    "doubles": lambda I, D, L: I.DoublesDataSetIterator(
        [([1.0, 2.0], [0.0, 1.0]), ([3.0, 4.0], [1.0, 0.0])], 1),
    "floats": lambda I, D, L: I.FloatsDataSetIterator(
        [([1.0, 2.0], [0.0, 1.0]), ([3.0, 4.0], [1.0, 0.0])], 2),
    "reconstruction": lambda I, D, L: I.ReconstructionDataSetIterator(
        L(D(*_data(masks=True)), 4)),
    "shield": lambda I, D, L: I.AsyncShieldDataSetIterator(L(D(*_data()), 4)),
    "early_termination_multi": lambda I, D, L: I.EarlyTerminationMultiDataSetIterator(
        L(D(*_data()), 2), 3),
}


@pytest.mark.parametrize("name", list(ITERATORS))
def test_iterator_yields_the_reference_batches(name):
    j, t = _pair(ITERATORS[name])
    for _ in range(2):  # a second pass after reset
        if hasattr(j, "reset"):
            j.reset()
            t.reset()
        _same_batches(t, j)


def test_splitter_parts_match_the_reference():
    j, t = _pair(lambda I, D, L: I.DataSetIteratorSplitter(
        L(D(*_data(n=20)), 2, shuffle=True, seed=4), 8, 0.75))
    _same_batches(t.train, j.train)
    _same_batches(t.test, j.test)
    t.train.reset()
    _same_batches(t.train, j.train)


def test_file_split_reads_npz_files_as_the_reference(tmp_path):
    for i in range(3):
        f, l, fm, lm = _data(n=4, seed=i, masks=i == 1)
        extra = {} if fm is None else {"features_mask": fm, "labels_mask": lm}
        np.savez(tmp_path / f"part{i}.npz", features=f, labels=l, **extra)
    seen = []

    class Cb(PI.DataSetCallback):
        def call(self, ds):
            seen.append(ds.num_examples())

    _same_batches(PI.FileSplitDataSetIterator(str(tmp_path), callback=Cb()),
                  JI.FileSplitDataSetIterator(str(tmp_path)))
    assert seen == [4, 4, 4]


def _mds(n, seed):
    f, l, _, _ = _data(n, seed)
    return f, l


def test_multidataset_iterators_match_the_reference():
    items = [(_mds(3, s), _mds(3, s + 10)) for s in range(3)]
    j = JI.IteratorMultiDataSetIterator([JMulti([a[0], b[0]], [a[1]]) for a, b in items], 5)
    t = PI.IteratorMultiDataSetIterator([MultiDataSet([a[0], b[0]], [a[1]])
                                         for a, b in items], 5)
    _same_batches(t, j)
    single = [_mds(4, s) for s in range(2)]
    jw = JI.MultiDataSetWrapperIterator([JMulti([f], [l]) for f, l in single])
    tw = PI.MultiDataSetWrapperIterator([MultiDataSet([f], [l]) for f, l in single])
    _same_batches(tw, jw)
    with pytest.raises(ValueError, match="single-input"):
        list(PI.MultiDataSetWrapperIterator([MultiDataSet([single[0][0]] * 2,
                                                          [single[0][1]])]))


def test_pre_processors_match_the_reference():
    f, l, _, _ = _data(n=12)
    jn = JN.NormalizerMinMaxScaler().fit(JDataSet(f, l))
    tn = PN.NormalizerMinMaxScaler().fit(DataSet(f, l))
    want = JI.CombinedPreProcessor(JI.DummyPreProcessor(), jn).preprocess(JDataSet(f, l))
    got = PI.CombinedPreProcessor(PI.DummyPreProcessor(), tn).preprocess(DataSet(f, l))
    np.testing.assert_allclose(got.features, want.features, rtol=TOL, atol=TOL)
    assert PI.DummyPreProcessor().preprocess(DataSet(f, l)) is None


# ------------------------------------------------------------- prefetch
def test_async_iterator_yields_its_base_and_retires_its_producer():
    base = ListDataSetIterator(DataSet(*_data(n=9)), 2, shuffle=True, seed=5)
    seen = []
    a = PI.AsyncDataSetIterator(base, queue_size=1,
                                device_put=lambda ds: seen.append(1) or ds)
    before = threading.active_count()
    _same_batches(a, JList(JDataSet(*_data(n=9)), 2, shuffle=True, seed=5))
    assert len(seen) == 5 and threading.active_count() == before
    it = iter(PI.AsyncDataSetIterator(ListDataSetIterator(DataSet(*_data(n=40)), 1)))
    next(it)
    it.close()  # the consumer stops early: the producer is stopped and joined
    assert threading.active_count() == before


def test_async_iterator_raises_the_producers_error_in_the_consumer():
    def broken():
        yield DataSet(*_data(n=2))
        raise RuntimeError("the source broke")

    class Source:
        def __iter__(self):
            return broken()

    got = []
    with pytest.raises(RuntimeError, match="the source broke"):
        for ds in PI.AsyncDataSetIterator(Source()):
            got.append(ds)
    assert len(got) == 1

    def bad_put(ds):
        raise ValueError("cannot pin")

    with pytest.raises(ValueError, match="cannot pin"):
        list(PI.AsyncDataSetIterator(ListDataSetIterator(DataSet(*_data()), 4),
                                     device_put=bad_put))


def test_wrap_for_prefetch_keeps_the_reference_refusals():
    it = ListDataSetIterator(DataSet(*_data()), 4)
    for depth in (0, -1):
        assert PI.wrap_for_prefetch(it, depth, "cpu") is it
        assert JI.wrap_for_prefetch(it, depth) is it
    one = [DataSet(*_data())]
    assert PI.wrap_for_prefetch(one, None, "cpu") is one
    shield = PI.AsyncShieldDataSetIterator(it)
    assert PI.wrap_for_prefetch(shield, None, "cpu") is shield
    already = PI.AsyncDataSetIterator(it, 5)
    assert PI.wrap_for_prefetch(already, 3, "cpu") is already
    w = PI.wrap_for_prefetch(it, None, "cpu")
    assert isinstance(w, PI.AsyncDataSetIterator) and w.queue_size == 2
    assert PI.wrap_for_prefetch(it, 4, "cpu").queue_size == 4
    two = [DataSet(*_data()), DataSet(*_data(seed=1))]
    assert isinstance(PI.wrap_for_prefetch(two, None, "cpu"), PI.AsyncDataSetIterator)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PI.wrap_for_prefetch(it, None)


def test_device_put_on_the_cpu_only_makes_tensors():
    f, l, fm, lm = _data(masks=True)
    ds = DataSet(f, l, fm, lm)
    out = PI.device_put_batch(ds, "cpu")
    assert out is not ds and ds.features is f  # the caller's batch is kept
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu"
               for a in (out.features, out.labels, out.features_mask, out.labels_mask))
    np.testing.assert_array_equal(out.features.numpy(), f)
    assert PI.finish_device_put(out) is out and not hasattr(out, "device_copy")
    mds = PI.device_put_batch(MultiDataSet([f, f], [l], [fm, None], None), "cpu")
    assert isinstance(mds.features[1], torch.Tensor) and mds.features_masks[1] is None
    callback_ds = DataSet(f, l)
    PI.DefaultCallback("cpu").call(callback_ds)
    assert isinstance(callback_ds.features, torch.Tensor)


def _mln_conf():
    return (NeuralNetConfiguration.builder().seed(4).updater(Adam(1e-2)).dropout(0.8)
            .list().layer(DenseLayer(n_out=6, activation="tanh"))
            .layer(OutputLayer(n_out=2)).set_input_type(InputType.feed_forward(3))
            .build())


def test_fit_with_prefetch_equals_fit_without():
    f, l, _, _ = _data(n=20)
    nets = {}
    for depth in (None, 0):
        net = MultiLayerNetwork(_mln_conf(), device="cpu").init()
        net.fit(ListDataSetIterator(DataSet(f, l), 4, shuffle=True, seed=1), epochs=2,
                prefetch_depth=depth)
        nets[depth] = net
    assert nets[None].iteration == nets[0].iteration == 10
    assert nets[None].transfer_bytes == nets[0].transfer_bytes == 2 * (f.nbytes + l.nbytes)
    for i, named in enumerate(export_params(nets[0])):
        for n, w in named.items():
            np.testing.assert_array_equal(export_params(nets[None])[i][n], w)


def test_graph_fit_with_prefetch_equals_fit_without():
    small = dict(vocab_size=20, max_length=8, n_layers=1, d_model=8, n_heads=2,
                 d_ff=16, attn_dropout=0.2)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 20, (6, 8)).astype(np.float32)
    data = DataSet(ids, lm_labels(ids, 20))
    nets = {}
    for depth in (None, 0):
        net = TransformerLM(**small).init(device="cpu")
        net.fit(ListDataSetIterator(data, 2), epochs=2, prefetch_depth=depth)
        nets[depth] = net
    assert nets[None].iteration == nets[0].iteration == 6
    for v, named in export_params(nets[0]).items():
        for n, w in named.items():
            np.testing.assert_array_equal(export_params(nets[None])[v][n], w)


# ---------------------------------------------------------- normalizers
NORMALIZERS = {
    "standardize": lambda N: N.NormalizerStandardize(),
    "standardize_labels": lambda N: _fit_label(N.NormalizerStandardize()),
    "minmax": lambda N: N.NormalizerMinMaxScaler(-1.0, 2.0),
    "minmax_labels": lambda N: _fit_label(N.NormalizerMinMaxScaler()),
    "image": lambda N: N.ImagePreProcessingScaler(0.0, 1.0, 255.0),
    "vgg16": lambda N: N.VGG16ImagePreProcessor(),
}


def _fit_label(n):
    n.fit_label = True
    return n


def _images(seed=0):
    rng = np.random.default_rng(seed)
    f = (rng.random((6, 4, 4, 3)) * 255).astype(np.float32)
    return f, rng.standard_normal((6, 4, 4, 2)).astype(np.float32)


@pytest.mark.parametrize("name", list(NORMALIZERS))
def test_normalizer_matches_the_reference_and_reads_both_ways(name):
    f, l = _images()
    jn, tn = NORMALIZERS[name](JN), NORMALIZERS[name](PN)
    jn.fit(JList(JDataSet(f, l), 2))  # streamed over batches
    tn.fit(ListDataSetIterator(DataSet(f, l), 2))
    assert tn.to_dict() == jn.to_dict()
    g, gl = _images(1)
    for op in ("transform", "revert", "pre_process"):
        want = getattr(jn, op)(JDataSet(g, gl))
        got = getattr(tn, op)(DataSet(g, gl))
        np.testing.assert_allclose(got.features, want.features, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got.labels, want.labels, rtol=TOL, atol=TOL)
    back = tn.revert(tn.transform(DataSet(g, gl)))
    np.testing.assert_allclose(back.features, g, rtol=1e-4, atol=1e-3)
    assert PN.Normalizer.from_json(jn.to_json()).to_dict() == jn.to_dict()
    assert JN.Normalizer.from_json(tn.to_json()).to_dict() == jn.to_dict()


@pytest.mark.parametrize("kind", ["standardize", "minmax"])
@pytest.mark.parametrize("fit_label", [False, True])
def test_multi_normalizer_matches_the_reference(kind, fit_label):
    f, l = _images()
    g = f[..., :2] * 0.5
    jm, tm = JN.MultiNormalizer(kind), PN.MultiNormalizer(kind)
    jm.fit_label = tm.fit_label = fit_label
    jm.fit([JMulti([f, g], [l])])
    tm.fit([MultiDataSet([f, g], [l])])
    assert tm.to_dict() == jm.to_dict()
    for op in ("transform", "revert"):
        want = getattr(jm, op)(JMulti([f, g], [l]))
        got = getattr(tm, op)(MultiDataSet([f, g], [l]))
        for a, b in zip(got.features + got.labels, want.features + want.labels):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    assert PN.MultiNormalizer.from_dict(jm.to_dict()).to_dict() == jm.to_dict()
    assert JN.MultiNormalizer.from_dict(tm.to_dict()).to_dict() == jm.to_dict()
    with pytest.raises(ValueError, match="fit the MultiNormalizer"):
        PN.MultiNormalizer().transform(MultiDataSet([f], [l]))


def test_normalizing_iterator_matches_the_reference():
    f, l = _images()
    jn = JN.NormalizerStandardize().fit(JDataSet(f, l))
    tn = PN.NormalizerStandardize().fit(DataSet(f, l))
    _same_batches(PN.NormalizingIterator(ListDataSetIterator(DataSet(f, l), 4), tn),
                  JN.NormalizingIterator(JList(JDataSet(f, l), 4), jn))
    with pytest.raises(ValueError, match="nothing to fit"):
        PN.NormalizerStandardize().fit([])


def _zip_conf(pkg):
    from deeplearning4j_tpu.nn.conf import InputType as JIT
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
    from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
    j = pkg == "jax"
    b, dense, out, it = ((JNNC.builder(), JDense, JOut, JIT) if j else
                         (NeuralNetConfiguration.builder(), DenseLayer, OutputLayer,
                          InputType))
    return (b.seed(2).list().layer(dense(n_out=4)).layer(out(n_out=2))
            .set_input_type(it.feed_forward(3)).build())


def test_model_zip_carries_a_normalizer_both_ways(tmp_path):
    f, l, _, _ = _data()
    jnorm = JN.NormalizerStandardize().fit(JDataSet(f, l))
    tnorm = PN.NormalizerStandardize().fit(DataSet(f, l))
    jnet = JaxMLN(_zip_conf("jax")).init()
    tnet = load_reference_params(MultiLayerNetwork(_zip_conf("port"), device="cpu").init(),
                                 jax.tree_util.tree_map(np.asarray, jnet.params))
    port_zip, jax_zip = str(tmp_path / "port.zip"), str(tmp_path / "jax.zip")
    pser.write_model(tnet, port_zip, normalizer=tnorm)
    jser.write_model(jnet, jax_zip, normalizer=jnorm)
    assert jser.restore_normalizer(port_zip).to_dict() == jnorm.to_dict()
    assert pser.restore_normalizer(jax_zip).to_dict() == jnorm.to_dict()
    np.testing.assert_allclose(
        MultiLayerNetwork.load(jax_zip, device="cpu").output(f).numpy(),
        np.asarray(jser.restore_multi_layer_network(port_zip).output(f)), rtol=1e-5,
        atol=1e-6)
    plain = str(tmp_path / "plain.zip")
    tnet.save(plain)
    assert pser.restore_normalizer(plain) is None
    mm = PN.NormalizerMinMaxScaler().fit(DataSet(f, l))
    pser.add_normalizer_to_model(plain, mm)
    assert jser.restore_normalizer(plain).to_dict() == mm.to_dict()
    assert pser.validate_model_zip(plain) == []


class _Copying:
    """A pre-processor whose only face returns a new DataSet (no metadata)."""

    def __init__(self, ds_cls):
        self.ds_cls = ds_cls

    def transform(self, ds):
        return self.ds_cls(np.asarray(ds.features) * 2.0, ds.labels)


@pytest.mark.parametrize("face", ["mutating", "returning"])
def test_example_meta_data_is_kept_and_carried_as_the_reference(face):
    """C15: ``DataSet`` takes ``example_meta_data`` and a pre-processor
    keeps it, whether it mutates the DataSet or returns a copy."""
    from deeplearning4j_tpu.datasets.dataset import apply_preprocessor as japply
    from deeplearning4j_tpu_torch.datasets.dataset import apply_preprocessor as tapply

    f, l, _, _ = _data(n=4)
    meta = [f"records.csv:{i}" for i in range(4)]
    out = {}
    for name, D, N, apply in (("port", DataSet, PN, tapply), ("ref", JDataSet, JN, japply)):
        ds = D(f, l, example_meta_data=list(meta))
        assert ds.get_example_meta_data() == meta
        assert D(f, l).get_example_meta_data() is None
        pre = (N.NormalizerStandardize().fit(D(f, l)) if face == "mutating"
               else _Copying(D))
        got = apply(pre, ds)
        out[name] = (got.get_example_meta_data(), np.asarray(got.features))
    assert out["port"][0] == out["ref"][0] == meta
    np.testing.assert_allclose(out["port"][1], out["ref"][1], rtol=TOL, atol=TOL)
