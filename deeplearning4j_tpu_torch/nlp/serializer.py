"""Word-vector serialization.

Parity with `models/embeddings/loader/WordVectorSerializer.java:92`: the
word2vec C text format (`writeWordVectors` / `loadTxtVectors`) and a full
zip model format (vocab with frequencies + Huffman structure + syn0/syn1)
mirroring `writeWord2VecModel`/`readWord2Vec`.

Counterpart of the JAX package's ``nlp/serializer.py``: the same files,
byte for byte (a zip's members; its container records when it was
written). The writers read the table to the host; the readers take
``device=`` (None means the card, and raises without one; ``"cpu"``
reads onto the CPU).
"""

from __future__ import annotations

import base64
import json
import os
import zipfile
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabWord
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec


def _escape(word: str) -> str:
    """Words with whitespace/colons get DL4J's "B64:" wrapping
    (WordVectorSerializer's ReadHelper convention) so the text format stays
    space-delimited and lossless."""
    if any(c in word for c in " \t:"):
        return "B64:" + base64.b64encode(word.encode("utf-8")).decode("ascii")
    return word


def _unescape(word: str) -> str:
    if word.startswith("B64:"):
        return base64.b64decode(word[4:]).decode("utf-8")
    return word


class WordVectorSerializer:
    # ------------------------------------------------------- text format

    @staticmethod
    def write_word_vectors(model: SequenceVectors, path: str) -> None:
        """word2vec C text format: header 'vocab dim', then 'word v1 ...'."""
        mat = model.lookup_table.all_vectors()
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(f"{mat.shape[0]} {mat.shape[1]}\n")
            for i in range(mat.shape[0]):
                word = _escape(model.vocab.word_at_index(i))
                # each entry widened to a Python float once: the text
                # f"{v:.6f}" gives an f32 scalar
                vec = " ".join(map("{:.6f}".format, mat[i].tolist()))
                fh.write(f"{word} {vec}\n")

    @staticmethod
    def load_txt_vectors(path: str, device=None) -> SequenceVectors:
        with open(path, "r", encoding="utf-8") as fh:
            first = fh.readline().split()
            has_header = len(first) == 2 and all(t.isdigit() for t in first)
            rows = []
            words = []
            if not has_header:
                words.append(_unescape(first[0]))
                rows.append([float(v) for v in first[1:]])
            for line in fh:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < 2:
                    continue
                words.append(_unescape(parts[0]))
                rows.append([float(v) for v in parts[1:]])
        mat = np.asarray(rows, np.float32)
        cache = VocabCache()
        for w in words:
            cache.add_token(VocabWord(w))
        # preserve file order, not frequency order
        cache._by_index = [cache.word_for(w) for w in words]
        for i, vw in enumerate(cache._by_index):
            vw.index = i
        model = SequenceVectors(layer_size=mat.shape[1], device=device)
        model.vocab = cache
        model.lookup_table = InMemoryLookupTable(cache, mat.shape[1],
                                                 init_syn0=False, device=device)
        model.lookup_table.syn0 = mat
        return model

    # ----------------------------------------- Google word2vec binary format

    @staticmethod
    def write_binary_model(model: SequenceVectors, path: str,
                           compress: Optional[bool] = None) -> None:
        """Write the Google word2vec C binary format (the original
        ``word2vec.c`` layout, the de-facto pretrained-embedding
        interchange): ASCII header ``"<words> <size>\\n"``, then per word
        ``word + b' '`` followed by ``size`` packed little-endian float32s
        and a newline. ``compress`` (default: from a ``.gz`` suffix) gzips
        the stream, the GoogleNews-vectors distribution style."""
        import gzip as _gzip

        if compress is None:
            compress = path.endswith(".gz")
        mat = np.asarray(model.lookup_table.all_vectors(), np.float32)
        opener = _gzip.open if compress else open
        with opener(path, "wb") as fh:
            fh.write(f"{mat.shape[0]} {mat.shape[1]}\n".encode("utf-8"))
            for i in range(mat.shape[0]):
                word = model.vocab.word_at_index(i)
                fh.write(word.encode("utf-8") + b" ")
                fh.write(mat[i].astype("<f4").tobytes())
                fh.write(b"\n")

    @staticmethod
    def read_binary_model(path: str, linebreaks: Optional[bool] = None,
                          normalize: bool = False, device=None) -> SequenceVectors:
        """Read a Google word2vec C binary file
        (``WordVectorSerializer.readBinaryModel``,
        ``WordVectorSerializer.java:165``): header words/size as ASCII,
        each word terminated by a space (``readString:282`` stops at space
        or newline), then packed little-endian float32s (``getFloat:265``).

        ``linebreaks=None`` auto-detects the per-word trailing newline
        variant (the C tool writes one; some exporters don't — the
        reference makes the caller choose, ``loadGoogleModel:117``).
        ``normalize=True`` unit-normalizes each vector on load, matching
        the reference's ``Transforms.unitVec`` path."""
        import gzip as _gzip

        with open(path, "rb") as probe:
            magic = probe.read(2)
        opener = _gzip.open if magic == b"\x1f\x8b" else open
        with opener(path, "rb") as fh:
            data = fh.read()

        def token(pos):
            end = pos
            while data[end] not in (0x20, 0x0A):
                end += 1
            return data[pos:end], end + 1

        head, pos = token(0)
        n_words = int(head)
        head, pos = token(pos)
        size = int(head)
        words, rows = [], np.empty((n_words, size), np.float32)
        for i in range(n_words):
            # skip the previous row's newline (linebreaks variant); words
            # themselves can't start with \n
            if linebreaks is not False and pos < len(data) \
                    and data[pos] == 0x0A:
                pos += 1
            raw, pos = token(pos)
            words.append(raw.decode("utf-8"))
            rows[i] = np.frombuffer(data, "<f4", count=size, offset=pos)
            pos += 4 * size
            if linebreaks is True:
                pos += 1
        if normalize:
            norms = np.linalg.norm(rows, axis=1, keepdims=True)
            rows = rows / np.maximum(norms, 1e-12)
        cache = VocabCache()
        for w in words:
            cache.add_token(VocabWord(w))
        cache._by_index = [cache.word_for(w) for w in words]
        for i, vw in enumerate(cache._by_index):
            vw.index = i
        model = SequenceVectors(layer_size=size, device=device)
        model.vocab = cache
        model.lookup_table = InMemoryLookupTable(cache, size, init_syn0=False,
                                                 device=device)
        model.lookup_table.syn0 = rows
        return model

    @staticmethod
    def load_static_model(path: str, device=None) -> SequenceVectors:
        """``WordVectorSerializer.loadStaticModel:2481``: inference-only
        word vectors from ANY supported artifact — tries this framework's
        zip model, then the C text format, then the Google binary format
        (the reference's exact fallback order: dl4j zip → csv → binary).
        The device is settled before any format is tried."""
        device = resolve_device(device)
        try:
            return WordVectorSerializer.read_word2vec_model(path, device)
        except (zipfile.BadZipFile, KeyError, OSError):
            pass
        try:
            return WordVectorSerializer.load_txt_vectors(path, device)
        except (UnicodeDecodeError, ValueError, IndexError):
            pass
        try:
            return WordVectorSerializer.read_binary_model(path, device=device)
        except Exception as e:
            raise ValueError(
                f"Unable to guess input file format for {path!r} (tried "
                "zip model, text vectors, Google binary)") from e

    # -------------------------------------------------------- zip format

    @staticmethod
    def write_word2vec_model(model: SequenceVectors, path: str) -> None:
        """Zip with config + vocab (freq/huffman) + syn0/syn1neg npy."""
        meta = {
            "layer_size": model.layer_size,
            "window": model.window,
            "negative": model.negative,
            "use_hs": model.use_hs,
            "learning_rate": model.learning_rate,
            "min_word_frequency": model.min_word_frequency,
        }
        vocab = [{
            "word": vw.word, "frequency": vw.frequency,
            "code": vw.code, "points": vw.points, "is_label": vw.is_label,
        } for vw in model.vocab.vocab_words()]
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("config.json", json.dumps(meta))
            zf.writestr("vocab.json", json.dumps(vocab))
            import io
            for name, arr in [("syn0", model.lookup_table.syn0),
                              ("syn1", model.lookup_table.syn1),
                              ("syn1neg", model.lookup_table.syn1neg)]:
                if arr is None:
                    continue
                buf = io.BytesIO()
                np.save(buf, arr.detach().cpu().numpy())
                zf.writestr(f"{name}.npy", buf.getvalue())

    @staticmethod
    def read_word2vec_model(path: str, device=None) -> Word2Vec:
        with zipfile.ZipFile(path, "r") as zf:
            meta = json.loads(zf.read("config.json"))
            vocab_entries = json.loads(zf.read("vocab.json"))
            arrays = {}
            import io
            for name in ("syn0", "syn1", "syn1neg"):
                try:
                    arrays[name] = np.load(io.BytesIO(zf.read(f"{name}.npy")))
                except KeyError:
                    arrays[name] = None
        cache = VocabCache()
        for e in vocab_entries:
            vw = VocabWord(e["word"], e["frequency"], e.get("is_label", False))
            vw.code = e["code"]
            vw.points = e["points"]
            cache.add_token(vw)
        cache._by_index = [cache.word_for(e["word"]) for e in vocab_entries]
        for i, vw in enumerate(cache._by_index):
            vw.index = i
        model = Word2Vec(
            layer_size=meta["layer_size"], window_size=meta["window"],
            negative_sample=meta["negative"],
            use_hierarchic_softmax=meta["use_hs"],
            learning_rate=meta["learning_rate"],
            min_word_frequency=meta["min_word_frequency"], device=device)
        model.vocab = cache
        table = model.lookup_table = InMemoryLookupTable(
            cache, meta["layer_size"], use_hs=meta["use_hs"],
            negative=meta["negative"], init_syn0=False, device=device)
        # float32 tables, as the reference's jnp.asarray makes them
        table.syn0 = arrays["syn0"]
        if arrays["syn1"] is not None:
            table.syn1 = table._tensor(arrays["syn1"])
        if arrays["syn1neg"] is not None:
            table.syn1neg = table._tensor(arrays["syn1neg"])
        return model
