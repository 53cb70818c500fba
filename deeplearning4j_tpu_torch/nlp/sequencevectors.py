"""Generic sequence-embedding trainer.

Counterpart of the JAX package's ``nlp/sequencevectors.py``: the same
orchestration on the port's torch steps, with ``device=`` (None means the
card, and raises without one; ``"cpu"`` runs on the CPU). Parity with
`models/sequencevectors/SequenceVectors.java` (1,245 LoC; `fit():192`,
`buildVocab():108`): orchestrates vocab construction, the elements learning
algorithm, and the epoch loop with word2vec's linear learning-rate decay.
The reference's AsyncSequencer producer thread + hogwild consumers (`:288`)
are replaced by deterministic host-side batch generation feeding one torch
step a sentence (see :mod:`learning`).

Query surface parity (`wordVectors()` side of WordVectorsImpl):
``similarity``, ``words_nearest``, ``get_word_vector``.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nlp.learning import (
    CBOW,
    ElementsLearningAlgorithm,
    SkipGram,
    make_keep_prob,
)
from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabConstructor


class SequenceVectors:
    """Trains embeddings over generic element sequences.

    Subclasses (Word2Vec, ParagraphVectors, DeepWalk's vectors) provide the
    sequence source; anything yielding lists of string tokens works.
    """

    def __init__(self, layer_size: int = 100, window: int = 5,
                 negative: int = 5, use_hierarchic_softmax: bool = False,
                 learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4,
                 min_word_frequency: int = 1, sample: float = 0.0,
                 epochs: int = 1, iterations: int = 1, seed: int = 12345,
                 elements_algorithm: Optional[ElementsLearningAlgorithm] = None,
                 device=None):
        self.device = resolve_device(device)
        self.layer_size = layer_size
        self.window = window
        self.negative = negative
        # word2vec convention: with no negative sampling, hierarchical
        # softmax is the only objective left — force it on
        self.use_hs = use_hierarchic_softmax or negative <= 0
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.min_word_frequency = min_word_frequency
        self.sample = sample
        self.epochs = epochs
        self.iterations = iterations
        self.seed = seed
        self.elements_algorithm = elements_algorithm
        self.vocab: Optional[VocabCache] = None
        self.lookup_table: Optional[InMemoryLookupTable] = None

    # -------------------------------------------------------------- vocab

    def build_vocab(self, sequences: Iterable[Sequence[str]]) -> VocabCache:
        """Corpus scan → VocabCache (SequenceVectors.buildVocab():108)."""
        constructor = VocabConstructor(min_word_frequency=self.min_word_frequency)
        self._set_vocab(constructor.build_vocab(sequences))
        return self.vocab

    def build_vocab_from_file(self, path: str, *, n_threads: int = 4,
                              to_lower: bool = False) -> VocabCache:
        """File-corpus fast path: the native multithreaded scan counts the
        whole file outside the GIL (whitespace tokenization — matching
        ``DefaultTokenizerFactory``), then the standard cutoff/Huffman/
        lookup pipeline runs."""
        constructor = VocabConstructor(min_word_frequency=self.min_word_frequency)
        self._set_vocab(constructor.build_vocab_from_file(
            path, n_threads=n_threads, to_lower=to_lower))
        return self.vocab

    def _set_vocab(self, vocab: VocabCache) -> None:
        self.vocab = vocab
        self.lookup_table = InMemoryLookupTable(
            self.vocab, self.layer_size, seed=self.seed,
            use_hs=self.use_hs, negative=self.negative, device=self.device)

    def _plain_whitespace_tokenization(self) -> bool:
        """The native scan's byte-level whitespace tokenization only matches
        an unconfigured DefaultTokenizerFactory (no pre-processor)."""
        from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
        tf = getattr(self, "tokenizer_factory", None)
        return tf is None or (type(tf) is DefaultTokenizerFactory
                              and tf._pre is None)

    def fit_file(self, path: str, *, n_threads: int = 4,
                 to_lower: bool = False) -> "SequenceVectors":
        """Train from a text file (one sentence per line).

        ``to_lower`` defaults to False — the plain DefaultTokenizerFactory
        that fit() would apply does NOT lowercase, and the two entry points
        must build the same vocabulary from the same text. Opt into
        lowercasing explicitly (ASCII-only, matching the native scan).

        With plain whitespace tokenization, vocabulary counting uses the
        native multithreaded scan and the training pass tokenizes the SAME
        way (byte-level ASCII whitespace/lowercasing), so every vocab word
        is trainable. A configured tokenizer_factory/pre-processor instead
        routes every line through that tokenizer for both vocab and
        training — identical results to the in-memory path, without the
        native counting fast path. Note the training pass materializes the
        encoded sequences in memory (as fit() always does — epochs iterate
        over them); the native scan only removes the counting pass.
        """
        if not self._plain_whitespace_tokenization():
            tf = self.tokenizer_factory  # type: ignore[attr-defined]
            with open(path, encoding="utf-8", errors="replace") as f:
                seqs = [toks for line in f
                        if (toks := tf.create(line).get_tokens())]
            return self.fit(seqs)

        if self.vocab is None:
            self.build_vocab_from_file(path, n_threads=n_threads,
                                       to_lower=to_lower)

        def lines():
            # byte-level split/lower: EXACTLY the scan's tokenization, so
            # vocab keys and training tokens can never diverge (Unicode
            # case/whitespace handled identically)
            with open(path, "rb") as f:
                for raw in f:
                    if to_lower:
                        raw = raw.lower()
                    toks = [t.decode("utf-8", errors="replace")
                            for t in raw.split()]
                    if toks:
                        yield toks

        return self.fit(lines())

    # ------------------------------------------------------------ training

    def _make_algorithm(self) -> ElementsLearningAlgorithm:
        algo = self.elements_algorithm or SkipGram()
        algo.configure(self.lookup_table, self.window, self.negative,
                       self.seed)
        return algo

    def _encode(self, seq: Sequence[str]) -> np.ndarray:
        idx = [self.vocab.index_of(w) for w in seq]
        return np.array([i for i in idx if i >= 0], np.int64)

    def fit(self, sequences: Iterable[Sequence[str]]) -> "SequenceVectors":
        seqs: List[Sequence[str]] = list(sequences)
        if self.vocab is None:
            self.build_vocab(seqs)
        algo = self._make_algorithm()
        keep = make_keep_prob(self.vocab, self.sample)
        encoded = [self._encode(s) for s in seqs]
        total_words = sum(len(s) for s in encoded) * self.epochs * self.iterations
        seen = 0
        for _epoch in range(self.epochs):
            for seq in encoded:
                if len(seq) < 1:
                    continue
                for _it in range(self.iterations):
                    frac = seen / max(total_words, 1)
                    lr = max(self.learning_rate * (1.0 - frac),
                             self.min_learning_rate)
                    algo.train_sequence(seq, lr, keep)
                    seen += len(seq)
        return self

    # -------------------------------------------------------------- query

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        return self.lookup_table.vector(word)

    def has_word(self, word: str) -> bool:
        return self.vocab is not None and self.vocab.contains_word(word)

    def similarity(self, w1: str, w2: str) -> float:
        v1, v2 = self.get_word_vector(w1), self.get_word_vector(w2)
        if v1 is None or v2 is None:
            return float("nan")
        denom = np.linalg.norm(v1) * np.linalg.norm(v2)
        if denom == 0:
            return 0.0
        return float(np.dot(v1, v2) / denom)

    def words_nearest(self, word_or_vec, top_n: int = 10,
                      exclude: Sequence[str] = ()) -> List[str]:
        if isinstance(word_or_vec, str):
            vec = self.get_word_vector(word_or_vec)
            exclude = list(exclude) + [word_or_vec]
            if vec is None:
                return []
        else:
            vec = np.asarray(word_or_vec)
        # the host copy the table keeps until training changes it
        mat = self.lookup_table.host_vectors()
        norms = np.linalg.norm(mat, axis=1) * (np.linalg.norm(vec) or 1.0)
        sims = mat @ vec / np.where(norms == 0, 1.0, norms)
        order = np.argsort(-sims)
        out = []
        excluded = set(exclude)
        for idx in order:
            w = self.vocab.word_at_index(int(idx))
            if w in excluded:
                continue
            out.append(w)
            if len(out) >= top_n:
                break
        return out

    def words_nearest_sum(self, positive: Sequence[str],
                          negative: Sequence[str], top_n: int = 10) -> List[str]:
        """Analogy query: argmax cos(v, sum(pos) - sum(neg))."""
        vec = np.zeros(self.layer_size, np.float32)
        for w in positive:
            v = self.get_word_vector(w)
            if v is not None:
                vec += v
        for w in negative:
            v = self.get_word_vector(w)
            if v is not None:
                vec -= v
        return self.words_nearest(vec, top_n,
                                  exclude=list(positive) + list(negative))
