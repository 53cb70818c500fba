"""The port's embedding models against the JAX package's on the CPU.

Word2Vec (SkipGram and CBOW, each with negative sampling, hierarchical
softmax and both), ParagraphVectors (DBOW, DM, DM on hierarchical softmax)
with ``infer_vector``, and GloVe train on the same ~50 seeded sentences at
layer size 16 for 2 epochs in both packages; every table lies within
1e-5 × its largest entry of the reference's (both draw from the same numpy
generator; the sums run in another order). One reference run a
configuration is shared by its cases. Also: the vocabulary with its
Huffman codes and points, the queries on a carried table, the host copies
a query hands out (unchanged by later training), the table bit for bit
unchanged after ``infer_vector``, the file corpus scan (native and its
fallback) and the serializer's files byte for byte, read both ways.
"""

import functools

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nlp as R
from deeplearning4j_tpu import native as r_native
from deeplearning4j_tpu_torch import native as p_native
from deeplearning4j_tpu_torch import nlp as P
from deeplearning4j_tpu_torch.util.convert import load_reference_lookup_table
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5  # × the table's largest entry

WORDS = [f"w{i}" for i in range(40)]


def _corpus(n=50, seed=0):
    rng = np.random.default_rng(seed)
    p = np.arange(40, 0, -1, dtype=np.float64)
    return [" ".join(rng.choice(WORDS, size=rng.integers(3, 12), p=p / p.sum()))
            for _ in range(n)]


CORPUS = _corpus()

# name -> (the class both packages name, its keyword arguments)
CONFIGS = {
    "skipgram_ns": ("Word2Vec", dict(algorithm="skipgram", negative_sample=5)),
    "skipgram_hs": ("Word2Vec", dict(algorithm="skipgram", negative_sample=0,
                                     use_hierarchic_softmax=True)),
    "skipgram_hs_ns": ("Word2Vec", dict(algorithm="skipgram", negative_sample=3,
                                        use_hierarchic_softmax=True)),
    "cbow_ns": ("Word2Vec", dict(algorithm="cbow", negative_sample=5)),
    "cbow_hs": ("Word2Vec", dict(algorithm="cbow", negative_sample=0,
                                 use_hierarchic_softmax=True)),
    "cbow_hs_ns": ("Word2Vec", dict(algorithm="cbow", negative_sample=3,
                                    use_hierarchic_softmax=True)),
    "dbow": ("ParagraphVectors", dict(sequence_algorithm="dbow")),
    "dm": ("ParagraphVectors", dict(sequence_algorithm="dm")),
    "dm_hs": ("ParagraphVectors", dict(sequence_algorithm="dm", negative_sample=0)),
    "glove": ("Glove", dict(window=3, batch_size=64)),
}
COMMON = {"Word2Vec": dict(layer_size=16, window_size=3, min_word_frequency=1,
                           epochs=2, seed=3),
          "ParagraphVectors": dict(layer_size=16, window_size=3, min_word_frequency=1,
                                   epochs=2, seed=3),
          "Glove": dict(layer_size=16, epochs=2, seed=3)}


def _kw(name):
    cls, kw = CONFIGS[name]
    return cls, {**COMMON[cls], **kw}


@functools.lru_cache(maxsize=None)
def _reference(name):
    cls, kw = _kw(name)
    return getattr(R, cls)(**kw).fit(CORPUS)


def _port(name):
    cls, kw = _kw(name)
    return getattr(P, cls)(**kw, device="cpu").fit(CORPUS)


@functools.lru_cache(maxsize=None)
def _fitted_port(name):
    """One port fit a configuration, shared by the cases that only read it."""
    return _port(name)


def _tables(table):
    """The table's syn0, syn1 and syn1neg that exist, as numpy."""
    out = {}
    for n in ("syn0", "syn1", "syn1neg"):
        t = getattr(table, n)
        if t is not None:
            out[n] = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return out


def _close(got, want, what):
    assert set(got) == set(want), what
    for n, w in want.items():
        assert got[n].shape == w.shape, (what, n)
        err = np.abs(got[n] - w).max()
        assert err <= TOL * np.abs(w).max(), (what, n, err)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tables_match_the_reference(name):
    ref, port = _reference(name), _fitted_port(name)
    assert port.vocab.words() == ref.vocab.words()
    _close(_tables(port.lookup_table), _tables(ref.lookup_table), name)
    assert port.lookup_table.syn0.dtype == torch.float32


@pytest.mark.parametrize("name", ["dbow", "dm", "dm_hs"])
def test_infer_vector_matches_and_leaves_the_table_bit_for_bit(name):
    ref, port = _reference(name), _fitted_port(name)
    before = {n: t.clone() for n, t in
              ((n, getattr(port.lookup_table, n)) for n in ("syn0", "syn1", "syn1neg"))
              if t is not None}
    for text in (CORPUS[3], "w1 w2 w3 w0 w5", "unknown words only"):
        want = ref.infer_vector(text, steps=5)
        got = port.infer_vector(text, steps=5)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.abs(got - want).max() <= TOL * max(np.abs(want).max(), 1e-30)
    for n, t in before.items():
        assert torch.equal(getattr(port.lookup_table, n), t), n
        assert getattr(port.lookup_table, n).shape == t.shape
    assert port.lookup_table.syn0.shape[0] == port.vocab.num_words()


@pytest.mark.parametrize("name", ["skipgram_hs_ns", "dm"])
def test_vocabulary_and_huffman_match(name):
    ref, port = _reference(name), _fitted_port(name)
    def rows(m):
        return [(vw.word, vw.index, vw.frequency, vw.code, vw.points, vw.is_label)
                for vw in m.vocab.vocab_words()]
    assert rows(port) == rows(ref)
    assert port.vocab.total_word_occurrences == ref.vocab.total_word_occurrences
    if name == "dm":
        assert port.labels == ref.labels


def _carried(name="skipgram_hs_ns"):
    """A port model with the reference's vocabulary and its trained tables
    carried in."""
    ref = _reference(name)
    cls, kw = _kw(name)
    port = getattr(P, cls)(**kw, device="cpu")
    port.build_vocab(CORPUS)
    t = ref.lookup_table
    load_reference_lookup_table(
        port, np.asarray(t.syn0), None if t.syn1 is None else np.asarray(t.syn1),
        None if t.syn1neg is None else np.asarray(t.syn1neg))
    return ref, port


@pytest.mark.parametrize("query", ["similarity", "words_nearest", "words_nearest_vec",
                                   "words_nearest_sum", "get_word_vector"])
def test_queries_on_a_carried_table_give_the_reference_s_answers(query):
    ref, port = _carried()
    calls = {
        "similarity": lambda m: [m.similarity(a, b) for a in ("w0", "w3", "w9")
                                 for b in ("w1", "w7", "nope")],
        "words_nearest": lambda m: [m.words_nearest(w, top_n=5) for w in ("w0", "w2", "nope")],
        "words_nearest_vec": lambda m: m.words_nearest(np.linspace(-1, 1, 16), top_n=7,
                                                       exclude=["w4"]),
        "words_nearest_sum": lambda m: m.words_nearest_sum(["w0", "w1"], ["w2"], top_n=6),
        "get_word_vector": lambda m: [m.get_word_vector(w) for w in ("w0", "w5", "nope")],
    }
    got, want = calls[query](port), calls[query](ref)
    if query == "get_word_vector":
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                np.testing.assert_array_equal(g, np.asarray(w))
    elif query == "similarity":
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    else:
        assert got == want


def test_carry_checks_names_and_shapes():
    ref, port = _carried()
    t = ref.lookup_table
    syn0 = np.asarray(t.syn0)
    with pytest.raises(ValueError, match="syn1neg"):
        load_reference_lookup_table(port, syn0, np.asarray(t.syn1), None)
    with pytest.raises(ValueError, match="shape"):
        load_reference_lookup_table(port, syn0[:-1], np.asarray(t.syn1),
                                    np.asarray(t.syn1neg))
    # nothing was copied by a refused carry
    np.testing.assert_array_equal(port.lookup_table.syn0.numpy(), syn0)


def test_returned_vectors_are_copies_unchanged_by_more_training():
    port = _port("skipgram_ns")
    v = port.get_word_vector("w0")
    held = v.copy()
    everything = port.lookup_table.all_vectors()
    port.fit(CORPUS[:10])  # more training on the same tables
    assert not np.array_equal(port.get_word_vector("w0"), held)
    np.testing.assert_array_equal(v, held)
    assert not np.array_equal(everything, port.lookup_table.all_vectors())
    # a returned row written by its caller leaves the table alone
    v[:] = 0.0
    assert not np.array_equal(port.get_word_vector("w0"), v)


def _write_corpus(path):
    with open(path, "w", encoding="utf-8") as f:
        for line in CORPUS:
            f.write(line + "\n")
        f.write("Straße café w1 w1\n")  # non-ASCII tokens, byte-level split


@pytest.mark.parametrize("native", [True, False], ids=["native", "fallback"])
def test_fit_file_scan_and_training_match_the_reference(tmp_path, monkeypatch, native):
    path = str(tmp_path / "corpus.txt")
    _write_corpus(path)
    if not native:
        for mod in (r_native, p_native):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_build_failed", True)
    else:
        assert p_native.native_available() and r_native.native_available()
    _, kw = _kw("skipgram_ns")
    ref = R.Word2Vec(**kw).fit_file(path, n_threads=2)
    port = P.Word2Vec(**kw, device="cpu").fit_file(path, n_threads=2)
    assert [(vw.word, vw.frequency, vw.code) for vw in port.vocab.vocab_words()] == \
        [(vw.word, vw.frequency, vw.code) for vw in ref.vocab.vocab_words()]
    assert "Straße" in port.vocab.words()
    _close(_tables(port.lookup_table), _tables(ref.lookup_table), "fit_file")
    counts = P.vocab.scan_corpus_file(path, n_threads=3, to_lower=True)
    assert counts == R.vocab.scan_corpus_file(path, n_threads=3, to_lower=True)


FORMATS = {
    "text": ("write_word_vectors", "load_txt_vectors", "vec.txt"),
    "binary": ("write_binary_model", "read_binary_model", "vec.bin"),
    "binary_gz": ("write_binary_model", "read_binary_model", "vec.bin.gz"),
    "zip": ("write_word2vec_model", "read_word2vec_model", "model.zip"),
}


def _zip_members(path):
    import zipfile

    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def _file_bytes(path, fmt):
    if fmt == "zip":
        return _zip_members(path)
    if fmt == "binary_gz":
        import gzip

        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_serializer_files_byte_for_byte_read_both_ways(tmp_path, fmt):
    ref, port = _carried()
    write, read, name = FORMATS[fmt]
    rp, pp = str(tmp_path / f"ref_{name}"), str(tmp_path / f"port_{name}")
    getattr(R.WordVectorSerializer, write)(ref, rp)
    getattr(P.WordVectorSerializer, write)(port, pp)
    assert _file_bytes(pp, fmt) == _file_bytes(rp, fmt)
    # the port reads the reference's file, the reference the port's
    back_p = getattr(P.WordVectorSerializer, read)(rp, device="cpu")
    back_r = getattr(R.WordVectorSerializer, read)(pp)
    assert back_p.vocab.words() == back_r.vocab.words() == ref.vocab.words()
    _close(_tables(back_p.lookup_table), _tables(back_r.lookup_table), fmt)
    np.testing.assert_array_equal(back_p.lookup_table.syn0.numpy(),
                                  np.asarray(back_r.lookup_table.syn0))
    assert back_p.lookup_table.syn0.device.type == "cpu"
    static = P.WordVectorSerializer.load_static_model(rp, device="cpu")
    np.testing.assert_array_equal(static.lookup_table.syn0.numpy(),
                                  back_p.lookup_table.syn0.numpy())
    if fmt == "zip":
        for n in ("syn1", "syn1neg"):
            np.testing.assert_array_equal(getattr(back_p.lookup_table, n).numpy(),
                                          np.asarray(getattr(ref.lookup_table, n)))
        assert [vw.points for vw in back_p.vocab.vocab_words()] == \
            [vw.points for vw in ref.vocab.vocab_words()]


def test_glove_f64_twin_stays_near_the_f32_run():
    _, kw = _kw("glove")
    f32 = P.Glove(**kw, device="cpu").fit(CORPUS).lookup_table.syn0
    f64 = P.Glove(**kw, device="cpu", dtype=torch.float64).fit(CORPUS).lookup_table.syn0
    assert f64.dtype == torch.float64
    assert (f32.double() - f64).abs().max() <= 1e-5 * f64.abs().max()


def test_table_to_f64_keeps_the_draws():
    _, kw = _kw("skipgram_ns")
    m = P.Word2Vec(**kw, device="cpu")
    m.build_vocab(CORPUS)
    syn0 = m.lookup_table.syn0.clone()
    m.lookup_table.to(dtype=torch.float64)
    assert m.lookup_table.syn0.dtype == m.lookup_table.syn1neg.dtype == torch.float64
    assert torch.equal(m.lookup_table.syn0, syn0.double())
    m.fit(CORPUS)
    ref = _reference("skipgram_ns").lookup_table
    assert np.abs(m.lookup_table.syn0.numpy() - np.asarray(ref.syn0)).max() <= \
        1e-5 * np.abs(np.asarray(ref.syn0)).max()
