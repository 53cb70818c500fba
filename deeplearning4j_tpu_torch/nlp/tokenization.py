"""Tokenizer SPI.

Parity with the reference's `text/tokenization/` package: a
`TokenizerFactory` creates a `Tokenizer` per sentence; an optional
`TokenPreProcess` normalises each token
(`tokenization/tokenizer/preprocessor/CommonPreprocessor.java` lowercases and
strips punctuation). Language packs (kuromoji/ansj/UIMA, SURVEY.md §2 "NLP
language packs") plug in by implementing ``TokenizerFactory``.

The port's copy of the JAX package's jax-free ``nlp/tokenization.py``: the
same tokenizers and pre-processors.
"""

from __future__ import annotations

import re
from typing import Callable, Iterator, List, Optional


class TokenPreProcess:
    """Normalises one token; return "" to drop it."""

    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits (CommonPreprocessor.java)."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token).lower()


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token: str) -> str:
        return token.lower()


class Tokenizer:
    """Iterator over the tokens of one sentence."""

    def __init__(self, tokens: List[str],
                 pre_processor: Optional[TokenPreProcess] = None):
        self._tokens = tokens
        self._pre = pre_processor

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        self._pre = pre

    def get_tokens(self) -> List[str]:
        if self._pre is None:
            return list(self._tokens)
        out = []
        for t in self._tokens:
            t = self._pre.pre_process(t)
            if t:
                out.append(t)
        return out

    def count_tokens(self) -> int:
        return len(self.get_tokens())

    def __iter__(self) -> Iterator[str]:
        return iter(self.get_tokens())


class TokenizerFactory:
    def create(self, sentence: str) -> Tokenizer:
        raise NotImplementedError

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        self._pre = pre


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace tokenizer (DefaultTokenizerFactory.java)."""

    def __init__(self, pre_processor: Optional[TokenPreProcess] = None):
        self._pre = pre_processor

    def create(self, sentence: str) -> Tokenizer:
        return Tokenizer(sentence.split(), self._pre)


def DefaultTokenizer(sentence: str) -> Tokenizer:
    return DefaultTokenizerFactory().create(sentence)


class NGramTokenizerFactory(TokenizerFactory):
    """Emits word n-grams joined by spaces (NGramTokenizerFactory.java)."""

    def __init__(self, min_n: int = 1, max_n: int = 2,
                 pre_processor: Optional[TokenPreProcess] = None):
        self.min_n = min_n
        self.max_n = max_n
        self._pre = pre_processor

    def create(self, sentence: str) -> Tokenizer:
        words = Tokenizer(sentence.split(), self._pre).get_tokens()
        grams: List[str] = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(words) - n + 1):
                grams.append(" ".join(words[i:i + n]))
        return Tokenizer(grams)
