"""Word2Vec.

Counterpart of the JAX package's ``nlp/word2vec.py`` on the port's
:class:`SequenceVectors` (``device=``; the builder's ``device``). Parity
with `models/word2vec/Word2Vec.java` (633 LoC): a SequenceVectors
specialisation whose input is sentences via a SentenceIterator +
TokenizerFactory, with the familiar builder surface (layerSize, windowSize,
negativeSample, minWordFrequency, …).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Union

from deeplearning4j_tpu_torch.nlp.learning import CBOW, SkipGram
from deeplearning4j_tpu_torch.nlp.sentence import SentenceIterator
from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)


class Word2Vec(SequenceVectors):
    def __init__(self, layer_size: int = 100, window_size: int = 5,
                 negative_sample: int = 5,
                 use_hierarchic_softmax: bool = False,
                 learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4,
                 min_word_frequency: int = 5, sampling: float = 0.0,
                 epochs: int = 1, iterations: int = 1, seed: int = 12345,
                 algorithm: str = "skipgram",
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 sentence_iterator: Optional[SentenceIterator] = None,
                 device=None):
        algo = CBOW() if algorithm.lower() == "cbow" else SkipGram()
        super().__init__(
            layer_size=layer_size, window=window_size,
            negative=negative_sample,
            use_hierarchic_softmax=use_hierarchic_softmax,
            learning_rate=learning_rate, min_learning_rate=min_learning_rate,
            min_word_frequency=min_word_frequency, sample=sampling,
            epochs=epochs, iterations=iterations, seed=seed,
            elements_algorithm=algo, device=device)
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.sentence_iterator = sentence_iterator

    class Builder:
        """Fluent builder (Word2Vec.Builder parity)."""

        def __init__(self):
            self._kw = {}

        def layer_size(self, n): self._kw["layer_size"] = n; return self
        def window_size(self, n): self._kw["window_size"] = n; return self
        def negative_sample(self, n): self._kw["negative_sample"] = n; return self
        def use_hierarchic_softmax(self, b): self._kw["use_hierarchic_softmax"] = b; return self
        def learning_rate(self, v): self._kw["learning_rate"] = v; return self
        def min_learning_rate(self, v): self._kw["min_learning_rate"] = v; return self
        def min_word_frequency(self, n): self._kw["min_word_frequency"] = n; return self
        def sampling(self, v): self._kw["sampling"] = v; return self
        def epochs(self, n): self._kw["epochs"] = n; return self
        def iterations(self, n): self._kw["iterations"] = n; return self
        def seed(self, n): self._kw["seed"] = n; return self
        def elements_learning_algorithm(self, name):
            self._kw["algorithm"] = name; return self
        def tokenizer_factory(self, tf): self._kw["tokenizer_factory"] = tf; return self
        def iterate(self, it): self._kw["sentence_iterator"] = it; return self
        def device(self, d): self._kw["device"] = d; return self

        def build(self) -> "Word2Vec":
            return Word2Vec(**self._kw)

    @classmethod
    def builder(cls) -> "Word2Vec.Builder":
        return cls.Builder()

    # ------------------------------------------------------------ training

    def _tokenize_corpus(
            self, sentences: Optional[Iterable[Union[str, Sequence[str]]]]
    ) -> List[List[str]]:
        src: Iterable = sentences if sentences is not None else self.sentence_iterator
        if src is None:
            raise ValueError("no sentences: pass them to fit() or set "
                             "sentence_iterator")
        out = []
        for s in src:
            if isinstance(s, str):
                out.append(self.tokenizer_factory.create(s).get_tokens())
            else:
                out.append(list(s))
        return out

    def fit(self, sentences: Optional[Iterable[Union[str, Sequence[str]]]] = None
            ) -> "Word2Vec":
        return super().fit(self._tokenize_corpus(sentences))

    def build_vocab(self, sentences=None):
        return super().build_vocab(self._tokenize_corpus(sentences))
