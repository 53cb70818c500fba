"""Bag-of-words / TF-IDF vectorizers.

Parity with `bagofwords/vectorizer/` (BagOfWordsVectorizer,
TfidfVectorizer): text corpus → count or tf-idf feature matrices usable as
DataSet features.

The port's copy of the JAX package's jax-free ``nlp/vectorizer.py``: the
same bag-of-words and TF-IDF vectors (numpy).
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, VocabConstructor


class BaseTextVectorizer:
    def __init__(self, min_word_frequency: int = 1,
                 tokenizer_factory: Optional[TokenizerFactory] = None):
        self.min_word_frequency = min_word_frequency
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.vocab: Optional[VocabCache] = None

    def _tokenize(self, docs: Iterable[Union[str, Sequence[str]]]
                  ) -> List[List[str]]:
        out = []
        for d in docs:
            if isinstance(d, str):
                out.append(self.tokenizer_factory.create(d).get_tokens())
            else:
                out.append(list(d))
        return out

    def fit(self, docs: Iterable[Union[str, Sequence[str]]]):
        corpus = self._tokenize(docs)
        self.vocab = VocabConstructor(
            min_word_frequency=self.min_word_frequency).build_vocab(corpus)
        self._post_fit(corpus)
        return self

    def _post_fit(self, corpus: List[List[str]]) -> None:
        pass

    def _counts(self, tokens: List[str]) -> np.ndarray:
        vec = np.zeros(self.vocab.num_words(), np.float32)
        for t in tokens:
            idx = self.vocab.index_of(t)
            if idx >= 0:
                vec[idx] += 1.0
        return vec

    def transform(self, docs: Iterable[Union[str, Sequence[str]]]
                  ) -> np.ndarray:
        corpus = self._tokenize(docs)
        return np.stack([self._transform_one(t) for t in corpus])

    def fit_transform(self, docs) -> np.ndarray:
        docs = list(docs)
        self.fit(docs)
        return self.transform(docs)

    def _transform_one(self, tokens: List[str]) -> np.ndarray:
        raise NotImplementedError


class BagOfWordsVectorizer(BaseTextVectorizer):
    """Raw term counts (BagOfWordsVectorizer.java)."""

    def _transform_one(self, tokens: List[str]) -> np.ndarray:
        return self._counts(tokens)


class TfidfVectorizer(BaseTextVectorizer):
    """tf·idf with idf = log(N / df) (TfidfVectorizer.java semantics)."""

    def _post_fit(self, corpus: List[List[str]]) -> None:
        n_docs = len(corpus)
        df = np.zeros(self.vocab.num_words(), np.float64)
        for tokens in corpus:
            seen = {self.vocab.index_of(t) for t in tokens}
            for idx in seen:
                if idx >= 0:
                    df[idx] += 1
        with np.errstate(divide="ignore"):
            self.idf = np.where(df > 0, np.log(n_docs / np.maximum(df, 1)), 0.0)

    def tfidf_word(self, word: str, doc_tokens: List[str]) -> float:
        idx = self.vocab.index_of(word)
        if idx < 0:
            return 0.0
        tf = doc_tokens.count(word) / max(len(doc_tokens), 1)
        return float(tf * self.idf[idx])

    def _transform_one(self, tokens: List[str]) -> np.ndarray:
        counts = self._counts(tokens)
        tf = counts / max(len(tokens), 1)
        return (tf * self.idf).astype(np.float32)
