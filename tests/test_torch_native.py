"""The port's ``native/`` (a copy of the JAX package's jax-free C++
components and their numpy fallbacks) against the reference on the CPU.

The threshold codec's messages, decodes, extractions and counts, the
prefetching loader's batches (in memory, shuffled, IDX files) and the
corpus scan equal the reference's, each on the native library and on its
fallback. The port's library builds from its own ``native/src`` into its
gitignored build directory.
"""

import os

import numpy as np
import pytest

from deeplearning4j_tpu import native as R
from deeplearning4j_tpu.nlp import vocab as r_vocab
from deeplearning4j_tpu_torch import native as P
from deeplearning4j_tpu_torch.nlp import vocab as p_vocab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=["native", "fallback"])
def path(request, monkeypatch):
    """Runs a test on both packages' native libraries, then on both
    fallbacks."""
    if request.param == "native":
        assert R.native_available() and P.native_available()
    else:
        for mod in (R, P):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_build_failed", True)
    return request.param


def test_library_builds_into_the_port_s_ignored_build_directory():
    assert P.native_available()
    built = P._compile()
    build = os.path.join(REPO, "deeplearning4j_tpu_torch", "build")
    assert os.path.commonpath([built, build]) == build
    assert os.path.isfile(built)
    assert P._SRC_DIR == os.path.join(REPO, "deeplearning4j_tpu_torch", "native", "src")
    assert sorted(os.listdir(P._SRC_DIR)) == sorted(
        f for f in os.listdir(R._SRC_DIR) if f.endswith(".cpp"))
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "deeplearning4j_tpu_torch/build/" in f.read().split()


CODEC_CASES = {
    "encode": lambda m, r: m.encode_threshold(r, 1.5e-3),
    "encode_capacity": lambda m, r: m.encode_threshold(r, 1e-4, capacity=16),
    "decode": lambda m, r: m.decode_threshold(m.encode_threshold(r, 2e-3), 2e-3, len(r)),
    "decode_in_place": lambda m, r: m.decode_threshold(
        np.array([1, -3, 999, -1000], np.int32), 0.5, 8, out=np.ones(8, np.float32)),
    "extract": lambda m, r: m.extract_threshold(r.copy(), 2e-3, m.encode_threshold(r, 2e-3)),
    "count": lambda m, r: m.count_threshold(r, 2e-3, n_threads=3),
}


@pytest.mark.parametrize("case", list(CODEC_CASES))
def test_codec_matches_the_reference(path, case, rng):
    r = rng.normal(0, 2e-3, size=4096).astype(np.float32)
    got, want = CODEC_CASES[case](P, r), CODEC_CASES[case](R, r)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


def test_decode_refuses_a_copying_out():
    for m in (R, P):
        with pytest.raises(ValueError):
            m.decode_threshold(np.array([1], np.int32), 0.5, 2,
                               out=np.zeros(4, np.float32)[::2])


def _batches(it):
    return [(ds.features.copy(), ds.labels.copy()) for ds in it]


def _same(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        assert gx.dtype == wx.dtype and gx.shape == wx.shape


LOADER_CASES = {
    "ordered": dict(batch_size=16),
    "drop_last": dict(batch_size=16, drop_last=True),
    "images": dict(batch_size=32, feature_shape=(5, 4, 1)),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_batches_match_the_reference(path, case, rng):
    x = rng.normal(size=(100, 20)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 100)]
    kw = LOADER_CASES[case]
    got = P.NativeDataSetIterator(x, y, **kw)
    want = R.NativeDataSetIterator(x, y, **kw)
    _same(_batches(got), _batches(want))
    assert type(next(iter(got))).__module__ == "deeplearning4j_tpu_torch.datasets.dataset"
    assert got.num_examples() == 100


def test_loader_shuffles_as_the_reference_within_a_path(path, rng):
    """Shuffled epochs: the native loader's order is its C++ generator's,
    the fallback's numpy's; each equals the reference's on the same path."""
    x = np.arange(64, dtype=np.float32).reshape(64, 1)
    y = np.zeros((64, 1), np.float32)
    its = [m.NativeDataSetIterator(x, y, batch_size=10, shuffle=True, seed=9)
           for m in (P, R)]
    for _ in range(2):
        _same(_batches(its[0]), _batches(its[1]))
        for it in its:
            it.reset()


def test_idx_loader_matches_the_reference(path, tmp_path, rng):
    n, rows, cols = 30, 4, 4
    images = rng.integers(0, 256, size=(n, rows, cols), dtype=np.uint8)
    labels = rng.integers(0, 3, size=n, dtype=np.uint8)
    ip, lp = tmp_path / "images.idx", tmp_path / "labels.idx"
    ip.write_bytes(np.array([0x803, n, rows, cols], ">u4").tobytes() + images.tobytes())
    lp.write_bytes(np.array([0x801, n], ">u4").tobytes() + labels.tobytes())
    kw = dict(images_path=str(ip), labels_path=str(lp), n_classes=3, batch_size=8)
    _same(_batches(P.NativeDataSetIterator(**kw)), _batches(R.NativeDataSetIterator(**kw)))


SCAN_TEXT = {
    "mixed": lambda rng: (" ".join(rng.choice(
        ["alpha", "beta", "Gamma", "delta-x", "ALPHA", "beta", "émile"], 800))
        + "\nTab\tsep\r\nmore  spaces").encode("utf-8"),
    "invalid_utf8": lambda rng: b"\xff \xfe \xff word",
}


@pytest.mark.parametrize("text", list(SCAN_TEXT))
@pytest.mark.parametrize("to_lower", [False, True])
def test_corpus_scan_matches_the_reference(path, tmp_path, rng, text, to_lower):
    p = tmp_path / "corpus.txt"
    p.write_bytes(SCAN_TEXT[text](rng))
    got = p_vocab.scan_corpus_file(str(p), n_threads=3, to_lower=to_lower)
    want = r_vocab.scan_corpus_file(str(p), n_threads=3, to_lower=to_lower)
    assert list(got.items()) == list(want.items())
    cache_p = p_vocab.VocabConstructor(2).build_vocab_from_file(str(p), to_lower=to_lower)
    cache_r = r_vocab.VocabConstructor(2).build_vocab_from_file(str(p), to_lower=to_lower)
    assert [(w.word, w.frequency, w.code, w.points) for w in cache_p.vocab_words()] == \
        [(w.word, w.frequency, w.code, w.points) for w in cache_r.vocab_words()]


def test_missing_file_raises_as_the_reference(tmp_path):
    for vocab in (p_vocab, r_vocab):
        with pytest.raises(OSError):
            vocab.scan_corpus_file(str(tmp_path / "nope.txt"))
