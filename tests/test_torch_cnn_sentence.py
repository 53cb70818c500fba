"""The port's ``nlp/cnn_sentence.py`` and DL4J's CNN sentence classifier
against the JAX package on the CPU.

The providers hand out the reference's sentences in the reference's
order; ``CnnSentenceDataSetIterator`` over word vectors carried from a
reference Word2Vec gives the reference's ``DataSet``s bit for bit for every
feature format and unknown-word option (and ``load_single_sentence`` its
features), and reads the table again after training changed it. A
narrowed Kim-2014 classifier (``CnnSentenceClassificationExample``'s
graph: three "same" convolutions over the full word width, a merge, a
global max pool with dropout 0.5, a softmax head; vectors of 16, length
12, 4 maps) takes one Adam step from carried weights and lands within
1e-5 of the reference's ``ComputationGraph``; the put-in draws
(``tests/torch_putin.py``) show that neither package draws a mask for the
pool's dropout.
"""

import functools
import random

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import nlp as R
from deeplearning4j_tpu_torch import nlp as P
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.util.convert import (
    export_params,
    load_reference_lookup_table,
    load_reference_params,
)
from torch_putin import PutIn

STEP_TOL = 1e-5  # × each tensor's largest entry
WORDS = [f"w{i}" for i in range(30)]


def _corpus(n=60, seed=1):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=rng.integers(4, 10))) for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _reference_vectors():
    return R.Word2Vec(layer_size=16, window_size=3, min_word_frequency=1, epochs=1,
                      seed=5).fit(_corpus())


def _port_vectors():
    ref = _reference_vectors()
    port = P.Word2Vec(layer_size=16, window_size=3, min_word_frequency=1, epochs=1,
                      seed=5, device="cpu")
    port.build_vocab(_corpus())
    t = ref.lookup_table
    return load_reference_lookup_table(port, np.asarray(t.syn0), None, np.asarray(t.syn1neg))


SENTENCES = ["w1 w2 w3 w4 w5", "w2 zz w7", "qq rr", "w9 w9 w1 w3 w4 w5 w6 w7 w8 w0 w11 w12",
             "w3", "w4 w5 w6 w7 unknown w8"]
LABELS = ["pos", "neg", "neg", "pos", "pos", "neg"]


def _iterators(**kw):
    its = []
    for pkg, vectors in ((P, _port_vectors()), (R, _reference_vectors())):
        provider = pkg.CollectionLabeledSentenceProvider(SENTENCES, LABELS, rng=None)
        its.append(pkg.CnnSentenceDataSetIterator(provider, vectors, minibatch_size=4, **kw))
    return its


def _same_batches(got_it, want_it):
    got, want = list(got_it), list(want_it)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert type(g) is DataSet
        for name in ("features", "labels", "features_mask", "labels_mask"):
            a, b = getattr(g, name), getattr(w, name)
            assert (a is None) == (b is None), name
            if b is not None:
                assert a.dtype == b.dtype and a.shape == b.shape, name
                np.testing.assert_array_equal(a, b)
    return got


@pytest.mark.parametrize("normalized", [True, False], ids=["normalized", "raw"])
@pytest.mark.parametrize("unknown", ["remove", "use_unknown"])
@pytest.mark.parametrize("along_height", [True, False], ids=["height", "width"])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batches_equal_the_reference(fmt, along_height, unknown, normalized):
    kw = dict(feature_format=fmt, sentences_along_height=along_height,
              unknown_word_handling=unknown, use_normalized_word_vectors=normalized,
              max_sentence_length=8)
    if unknown == "use_unknown":
        kw["unknown_vector"] = np.linspace(-1, 1, 16, dtype=np.float32)
    port, ref = _iterators(**kw)
    batches = _same_batches(port, ref)
    assert any(b.features_mask is not None for b in batches)
    assert port.get_labels() == ref.get_labels()
    assert port.get_label_class_map() == ref.get_label_class_map()
    assert port.input_columns() == ref.input_columns() == 16
    for sentence in ("w1 w2 zz w3", "w5"):
        np.testing.assert_array_equal(port.load_single_sentence(sentence),
                                      ref.load_single_sentence(sentence))
    for it in (port, ref):
        with pytest.raises(ValueError):
            it.load_single_sentence("zz qq") if unknown == "remove" else it.load_single_sentence("")


def test_iterator_reads_the_table_again_after_training():
    port, _ = _iterators(feature_format="NHWC")
    vectors = port.word_vectors
    before = port.next().features.copy()
    table = vectors.lookup_table
    reads = []
    orig = table.host_vectors
    table.host_vectors = lambda: reads.append(1) or orig()
    port.reset()
    port.next()
    assert reads == []  # every word of the batch came from the iterator's copy
    vectors.fit(_corpus()[:5])  # training changes the table
    port.reset()
    after = port.next().features
    assert len(reads) >= 1
    assert not np.array_equal(before, after)
    provider = P.CollectionLabeledSentenceProvider(SENTENCES, LABELS, rng=None)
    fresh = P.CnnSentenceDataSetIterator(provider, vectors, minibatch_size=4,
                                         feature_format="NHWC")
    np.testing.assert_array_equal(fresh.next().features, after)


class _FakeVectors:
    """A word-vector source without a lookup table (the reference's test
    double): every word is looked up each time."""

    _table = {"the": [2.0, 0.0, 0.0], "cat": [0.0, 2.0, 0.0], "sat": [0.0, 0.0, 2.0],
              "dog": [2.0, 2.0, 0.0]}

    class vocab:  # noqa: N801 - mimics .vocab.words()
        @staticmethod
        def words():
            return list(_FakeVectors._table)

    def get_word_vector(self, w):
        v = self._table.get(w)
        return None if v is None else np.asarray(v, np.float32)

    def has_word(self, w):
        return w in self._table


def test_batches_over_a_vector_source_without_a_table():
    its = [pkg.CnnSentenceDataSetIterator(
        pkg.CollectionLabeledSentenceProvider(["the cat sat", "the dog", "zzz"],
                                              ["pos", "neg", "pos"], rng=None),
        _FakeVectors(), minibatch_size=2) for pkg in (P, R)]
    _same_batches(*its)


PROVIDERS = {
    "collection": lambda pkg, tmp: pkg.CollectionLabeledSentenceProvider(
        SENTENCES, LABELS, rng=random.Random(3)),
    "files": lambda pkg, tmp: pkg.FileLabeledSentenceProvider(
        {"pos": [str(tmp / "p0.txt"), str(tmp / "p1.txt")], "neg": [str(tmp / "n0.txt")]},
        rng=random.Random(4)),
    "converter": lambda pkg, tmp: pkg.LabelAwareConverter(
        pkg.sentence.LabelAwareIterator([("doc one", ["a"]), ("doc two", ["b"]),
                                         ("doc three", ["a"])])),
}


@pytest.mark.parametrize("name", list(PROVIDERS))
def test_providers_hand_out_the_reference_s_sentences(name, tmp_path):
    for f, text in (("p0.txt", "the cat"), ("p1.txt", "a dog"), ("n0.txt", "the end")):
        (tmp_path / f).write_text(text)
    out = []
    for pkg in (P, R):
        p = PROVIDERS[name](pkg, tmp_path)
        seen = []
        for _ in range(2):
            while p.has_next():
                seen.append(p.next_sentence())
            p.reset()
        out.append((seen, p.all_labels(), p.num_label_classes(), p.total_num_sentences()))
    assert out[0] == out[1]
    with pytest.raises(ValueError):
        P.CollectionLabeledSentenceProvider(["a"], ["x", "y"])


# ------------------------------------------------------ the Kim-2014 network

def kim_conf(pkg, width=16, length=12, maps=4):
    """DL4J's ``CnnSentenceClassificationExample`` graph at ``width``-wide
    vectors, ``length`` words and ``maps`` feature maps a kernel height."""
    conf_mod = __import__(f"{pkg}.nn.conf", fromlist=["x"])
    layers = __import__(f"{pkg}.nn.layers", fromlist=["x"])
    vertices = __import__(f"{pkg}.nn.vertices", fromlist=["x"])
    updaters = __import__(f"{pkg}.nn.updaters", fromlist=["x"])
    g = (conf_mod.NeuralNetConfiguration.builder().seed(12345)
         .weight_init("relu").activation("leakyrelu")
         .updater(updaters.Adam(0.01)).l2(1e-4)
         .graph_builder().add_inputs("input")
         .set_input_types(conf_mod.InputType.convolutional(length, width, 1)))
    for k in (3, 4, 5):
        g.add_layer(f"cnn{k}", layers.ConvolutionLayer(
            n_out=maps, kernel_size=(k, width), stride=(1, width),
            convolution_mode="same", activation="leakyrelu"), "input")
    g.add_vertex("merge", vertices.MergeVertex(), "cnn3", "cnn4", "cnn5")
    g.add_layer("globalPool", layers.GlobalPoolingLayer(pooling_type="max", dropout=0.5),
                "merge")
    g.add_layer("out", layers.OutputLayer(n_out=2, activation="softmax", loss="mcxent"),
                "globalPool")
    return g.set_outputs("out").build()


def test_kim_cnn_step_from_carried_weights_matches_the_reference(monkeypatch):
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as PGraph
    from deeplearning4j_tpu_torch.nn.layers.conv import same_pads

    rng = np.random.default_rng(7)
    x = rng.normal(size=(6, 12, 16, 1)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 6)]
    jnet = JGraph(kim_conf("deeplearning4j_tpu")).init()
    pnet = load_reference_params(
        PGraph(kim_conf("deeplearning4j_tpu_torch"), device="cpu").init(),
        jax.tree_util.tree_map(np.asarray, jnet.params))
    # the same graph: SAME pads the height (1, 1), (1, 2), (2, 2) and leaves
    # a width of 1; the merge joins 3 × 4 maps on the channel axis
    assert [same_pads(12, k, 1) for k in (3, 4, 5)] == [(1, 1), (1, 2), (2, 2)]
    assert same_pads(16, 16, 16) == (0, 0)
    acts = pnet.feed_forward(x)
    assert tuple(acts["cnn4"].shape) == (6, 12, 1, 4)
    assert tuple(acts["merge"].shape) == (6, 12, 1, 12)
    want = np.asarray(jnet.output(x))
    np.testing.assert_allclose(pnet.output(x).numpy(), want, rtol=0, atol=1e-6)
    putin = PutIn(monkeypatch, seed=11)
    jnet.fit(x, y)
    pnet.fit(x, y)
    # the reference's GlobalPoolingLayer never applies its dropout (its
    # forward has no ``_dropout``): neither package draws (ROADMAP §C)
    assert putin.port_calls == len(putin.drawn) == 0
    got = export_params(pnet)
    for v, named in jax.tree_util.tree_map(np.asarray, jnet.params).items():
        for n, w in named.items():
            err = np.abs(got[v][n] - w).max()
            assert err <= STEP_TOL * np.abs(w).max(), (v, n, err)
    assert abs(float(pnet.score_) - float(jnet.score_)) <= 1e-5 * abs(float(jnet.score_))
