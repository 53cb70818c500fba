"""Sentence-classification CNN data pipeline.

Parity with the reference's ``iterator/CnnSentenceDataSetIterator.java``
and ``iterator/provider/`` (CollectionLabeledSentenceProvider,
FileLabeledSentenceProvider, LabelAwareConverter): sentences are encoded
as stacked word vectors — features ``[mb, 1, maxLen, wordVectorSize]``
(``sentences_along_height=True``, the default) or
``[mb, 1, wordVectorSize, maxLen]`` — with one-hot 2d labels and a
``[mb, maxLen]`` feature mask when lengths differ, ready for a Conv2D +
GlobalPooling classifier (Kim-2014 style).

Counterpart of the JAX package's ``nlp/cnn_sentence.py``: the same
providers and batches (numpy, the reference's values). A word's
(normalized) vector is computed as the reference computes it and kept
until the word vectors' table changes (its ``version``), so a batch reads
the table on the host once (:meth:`InMemoryLookupTable.host_vectors`)
rather than once a token from the device.
"""

from __future__ import annotations

import os
import random as _random
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_DEFAULT_RNG = object()  # sentinel: "shuffle with a fresh per-instance rng"

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet

__all__ = [
    "LabeledSentenceProvider",
    "CollectionLabeledSentenceProvider",
    "FileLabeledSentenceProvider",
    "LabelAwareConverter",
    "CnnSentenceDataSetIterator",
]


class LabeledSentenceProvider:
    """Source of (sentence, label) pairs (``LabeledSentenceProvider.java``)."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_sentence(self) -> Tuple[str, str]:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def total_num_sentences(self) -> int:
        raise NotImplementedError

    def all_labels(self) -> List[str]:
        """Distinct labels, sorted alphabetically."""
        raise NotImplementedError

    def num_label_classes(self) -> int:
        return len(self.all_labels())


class CollectionLabeledSentenceProvider(LabeledSentenceProvider):
    """In-memory sentences + labels, optionally shuffled
    (``CollectionLabeledSentenceProvider.java``)."""

    def __init__(self, sentences: Sequence[str], labels: Sequence[str],
                 rng=_DEFAULT_RNG):
        if len(sentences) != len(labels):
            raise ValueError(
                f"Sentence size ({len(sentences)}) must match label size ({len(labels)})")
        self._sentences = list(sentences)
        self._labels = list(labels)
        self._rng = _random.Random() if rng is _DEFAULT_RNG else rng
        self._all_labels = sorted(set(labels))
        self._order = list(range(len(sentences)))
        self._cursor = 0
        self.reset()

    def reset(self) -> None:
        self._cursor = 0
        if self._rng is not None:
            self._rng.shuffle(self._order)

    def has_next(self) -> bool:
        return self._cursor < len(self._sentences)

    def next_sentence(self) -> Tuple[str, str]:
        i = self._order[self._cursor]
        self._cursor += 1
        return self._sentences[i], self._labels[i]

    def total_num_sentences(self) -> int:
        return len(self._sentences)

    def all_labels(self) -> List[str]:
        return list(self._all_labels)


class FileLabeledSentenceProvider(LabeledSentenceProvider):
    """One sentence/document per file, label -> list-of-files mapping
    (``FileLabeledSentenceProvider.java``)."""

    def __init__(self, files_by_label: Dict[str, Sequence[str]],
                 rng=_DEFAULT_RNG):
        self._all_labels = sorted(files_by_label.keys())
        label_to_idx = {l: i for i, l in enumerate(self._all_labels)}
        self._paths: List[str] = []
        self._label_idx: List[int] = []
        for label, paths in files_by_label.items():
            for p in paths:
                self._paths.append(os.fspath(p))
                self._label_idx.append(label_to_idx[label])
        self._rng = _random.Random() if rng is _DEFAULT_RNG else rng
        self._order = list(range(len(self._paths)))
        self._cursor = 0
        self.reset()

    def reset(self) -> None:
        self._cursor = 0
        if self._rng is not None:
            self._rng.shuffle(self._order)

    def has_next(self) -> bool:
        return self._cursor < len(self._paths)

    def next_sentence(self) -> Tuple[str, str]:
        i = self._order[self._cursor]
        self._cursor += 1
        with open(self._paths[i], "r", encoding="utf-8", errors="replace") as fh:
            return fh.read(), self._all_labels[self._label_idx[i]]

    def total_num_sentences(self) -> int:
        return len(self._paths)

    def all_labels(self) -> List[str]:
        return list(self._all_labels)


class LabelAwareConverter(LabeledSentenceProvider):
    """Adapts a LabelAwareIterator (LabelledDocument stream) to the
    provider interface (``LabelAwareConverter.java``)."""

    def __init__(self, iterator, labels: Optional[Sequence[str]] = None):
        self._docs = [(d.content, d.labels[0]) for d in iterator]
        if labels is None:
            labels = sorted({l for _, l in self._docs})
        self._all_labels = sorted(labels)
        self._cursor = 0

    def reset(self) -> None:
        self._cursor = 0

    def has_next(self) -> bool:
        return self._cursor < len(self._docs)

    def next_sentence(self) -> Tuple[str, str]:
        pair = self._docs[self._cursor]
        self._cursor += 1
        return pair

    def total_num_sentences(self) -> int:
        return len(self._docs)

    def all_labels(self) -> List[str]:
        return list(self._all_labels)


_UNKNOWN_SENTINEL = object()


class CnnSentenceDataSetIterator:
    """Word-vector-encoded sentence batches for CNN classifiers
    (``CnnSentenceDataSetIterator.java``).

    ``unknown_word_handling``: ``"remove"`` drops out-of-vocab tokens,
    ``"use_unknown"`` substitutes ``unknown_vector`` (zeros by default).
    Labels are one-hot against the provider's alphabetically sorted label
    list (``getLabels``/``getLabelClassMap`` parity). A feature mask
    ``[mb, max_len]`` is attached only when batch lengths differ.

    ``feature_format``: ``"NCHW"`` (reference layout, the default) or
    ``"NHWC"`` — this framework's conv layers take NHWC, so pass
    ``"NHWC"`` to feed a Conv2D+GlobalPooling classifier directly.
    """

    def __init__(self, sentence_provider: LabeledSentenceProvider,
                 word_vectors, tokenizer_factory=None,
                 unknown_word_handling: str = "remove",
                 use_normalized_word_vectors: bool = True,
                 minibatch_size: int = 32,
                 max_sentence_length: int = -1,
                 sentences_along_height: bool = True,
                 data_set_pre_processor=None,
                 unknown_vector: Optional[np.ndarray] = None,
                 feature_format: str = "NCHW"):
        if unknown_word_handling not in ("remove", "use_unknown"):
            raise ValueError("unknown_word_handling must be 'remove' or 'use_unknown'")
        if feature_format not in ("NCHW", "NHWC"):
            raise ValueError("feature_format must be 'NCHW' or 'NHWC'")
        self.provider = sentence_provider
        self.word_vectors = word_vectors
        self.tokenizer_factory = tokenizer_factory
        self.unknown_word_handling = unknown_word_handling
        self.use_normalized = use_normalized_word_vectors
        self.minibatch_size = minibatch_size
        self.max_sentence_length = max_sentence_length
        self.sentences_along_height = sentences_along_height
        self.pre_processor = data_set_pre_processor
        self.feature_format = feature_format

        probe = self._raw_vector_any()
        self.word_vector_size = int(probe.shape[0])
        if unknown_vector is None:
            unknown_vector = np.zeros(self.word_vector_size, np.float32)
        self.unknown_vector = np.asarray(unknown_vector, np.float32)

        labels = self.provider.all_labels()
        self.num_classes = len(labels)
        self._label_class_map = {l: i for i, l in enumerate(sorted(labels))}
        self._preloaded: Optional[Tuple[List[object], str]] = None
        self._cursor = 0
        # each looked-up word's feature vector, while the table is unchanged
        self._vectors: Dict[str, np.ndarray] = {}
        self._vectors_of: Optional[Tuple[object, int]] = None

    @classmethod
    def builder(cls) -> "CnnSentenceDataSetIterator._Builder":
        return cls._Builder()

    class _Builder:
        def __init__(self):
            self._kw = {}

        def sentence_provider(self, p): self._kw["sentence_provider"] = p; return self
        def word_vectors(self, wv): self._kw["word_vectors"] = wv; return self
        def tokenizer_factory(self, tf): self._kw["tokenizer_factory"] = tf; return self
        def unknown_word_handling(self, h): self._kw["unknown_word_handling"] = h; return self
        def use_normalized_word_vectors(self, b): self._kw["use_normalized_word_vectors"] = b; return self
        def minibatch_size(self, n): self._kw["minibatch_size"] = n; return self
        def max_sentence_length(self, n): self._kw["max_sentence_length"] = n; return self
        def sentences_along_height(self, b): self._kw["sentences_along_height"] = b; return self
        def data_set_pre_processor(self, p): self._kw["data_set_pre_processor"] = p; return self
        def unknown_vector(self, v): self._kw["unknown_vector"] = v; return self
        def feature_format(self, f): self._kw["feature_format"] = f; return self
        def build(self) -> "CnnSentenceDataSetIterator":
            return CnnSentenceDataSetIterator(**self._kw)

    # -- word vector access ------------------------------------------------
    def _raw_vector_any(self) -> np.ndarray:
        wv = self.word_vectors
        vocab = getattr(wv, "vocab", None)
        words = None
        if vocab is not None and hasattr(vocab, "words"):
            words = list(vocab.words())
        if not words:
            raise ValueError("word_vectors has an empty vocabulary")
        return np.asarray(self._lookup(words[0]), np.float32).reshape(-1)

    def _lookup(self, word: str) -> Optional[np.ndarray]:
        wv = self.word_vectors
        if hasattr(wv, "get_word_vector"):
            return wv.get_word_vector(word)
        return wv.vector(word)

    def _has_word(self, word: str) -> bool:
        wv = self.word_vectors
        if hasattr(wv, "has_word"):
            return wv.has_word(word)
        return self._lookup(word) is not None

    def _get_vector(self, token) -> np.ndarray:
        if token is _UNKNOWN_SENTINEL:
            return self.unknown_vector
        table = getattr(self.word_vectors, "lookup_table", None)
        version = getattr(table, "version", None)
        if version is None:  # no table to watch: look the word up each time
            return self._word_vector(token)
        if self._vectors_of is None or self._vectors_of[0] is not table \
                or self._vectors_of[1] != version:
            self._vectors, self._vectors_of = {}, (table, version)
        v = self._vectors.get(token)
        if v is None:
            v = self._vectors[token] = self._word_vector(token)
        return v

    def _word_vector(self, token) -> np.ndarray:
        v = np.asarray(self._lookup(token), np.float32).reshape(-1)
        if self.use_normalized:
            n = float(np.linalg.norm(v))
            if n > 0:
                v = v / n
        return v

    def _tokenize(self, sentence: str) -> List[object]:
        if self.tokenizer_factory is not None:
            tokens = self.tokenizer_factory.create(sentence).get_tokens()
        else:
            tokens = sentence.split()
        out: List[object] = []
        for tok in tokens:
            if not self._has_word(tok):
                if self.unknown_word_handling == "remove":
                    continue
                out.append(_UNKNOWN_SENTINEL)
            else:
                out.append(tok)
        return out

    # -- iterator protocol -------------------------------------------------
    def get_labels(self) -> List[str]:
        out = [""] * self.num_classes
        for label, idx in self._label_class_map.items():
            out[idx] = label
        return out

    def get_label_class_map(self) -> Dict[str, int]:
        return dict(self._label_class_map)

    def input_columns(self) -> int:
        return self.word_vector_size

    def total_examples(self) -> int:
        return self.provider.total_num_sentences()

    def reset(self) -> None:
        self.provider.reset()
        self._preloaded = None
        self._cursor = 0

    def _preload(self) -> None:
        while self._preloaded is None and self.provider.has_next():
            sentence, label = self.provider.next_sentence()
            tokens = self._tokenize(sentence)
            if tokens:
                self._preloaded = (tokens, label)

    def has_next(self) -> bool:
        self._preload()
        return self._preloaded is not None

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next()

    def next(self, num: Optional[int] = None) -> DataSet:
        if not self.has_next():
            raise StopIteration("No next element")
        num = num or self.minibatch_size

        batch: List[Tuple[List[object], str]] = []
        max_len, min_len = -1, 1 << 30
        if self._preloaded is not None:
            batch.append(self._preloaded)
            max_len = max(max_len, len(self._preloaded[0]))
            min_len = min(min_len, len(self._preloaded[0]))
            self._preloaded = None
        while len(batch) < num and self.provider.has_next():
            sentence, label = self.provider.next_sentence()
            tokens = self._tokenize(sentence)
            if tokens:
                max_len = max(max_len, len(tokens))
                min_len = min(min_len, len(tokens))
                batch.append((tokens, label))

        if self.max_sentence_length > 0:
            max_len = min(max_len, self.max_sentence_length)

        mb = len(batch)
        labels = np.zeros((mb, self.num_classes), np.float32)
        for i, (_, label) in enumerate(batch):
            if label not in self._label_class_map:
                raise ValueError(
                    f'Got label "{label}" that is not present in list of '
                    "LabeledSentenceProvider labels")
            labels[i, self._label_class_map[label]] = 1.0

        if self.sentences_along_height:
            features = np.zeros((mb, 1, max_len, self.word_vector_size), np.float32)
        else:
            features = np.zeros((mb, 1, self.word_vector_size, max_len), np.float32)
        for i, (tokens, _) in enumerate(batch):
            rows = np.stack([self._get_vector(tok) for tok in tokens[:max_len]])
            if self.sentences_along_height:
                features[i, 0, :len(rows), :] = rows
            else:
                features[i, 0, :, :len(rows)] = rows.T
        if self.feature_format == "NHWC":
            features = np.transpose(features, (0, 2, 3, 1))

        features_mask = None
        if min_len != max_len:
            features_mask = np.zeros((mb, max_len), np.float32)
            for i, (tokens, _) in enumerate(batch):
                features_mask[i, : min(len(tokens), max_len)] = 1.0

        ds = DataSet(features, labels, features_mask, None)
        if self.pre_processor is not None:
            self.pre_processor(ds)
        self._cursor += mb
        return ds

    def load_single_sentence(self, sentence: str) -> np.ndarray:
        """Features for one sentence, mb=1 (``loadSingleSentence``)."""
        tokens = self._tokenize(sentence)
        if not tokens:
            raise ValueError(
                "Cannot convert sentence: no tokens (all words unknown?)")
        if self.max_sentence_length > 0:
            tokens = tokens[: self.max_sentence_length]
        n = len(tokens)
        if self.sentences_along_height:
            out = np.zeros((1, 1, n, self.word_vector_size), np.float32)
            for j, tok in enumerate(tokens):
                out[0, 0, j, :] = self._get_vector(tok)
        else:
            out = np.zeros((1, 1, self.word_vector_size, n), np.float32)
            for j, tok in enumerate(tokens):
                out[0, 0, :, j] = self._get_vector(tok)
        if self.feature_format == "NHWC":
            out = np.transpose(out, (0, 2, 3, 1))
        return out
