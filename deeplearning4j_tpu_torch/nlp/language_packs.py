"""Language-pack tokenizer factories: Chinese, Japanese, Korean, UIMA-style.

Capability parity with the reference's language modules
(`deeplearning4j-nlp-chinese` — ansj segmenter, `deeplearning4j-nlp-japanese`
— bundled kuromoji, `deeplearning4j-nlp-korean`, `deeplearning4j-nlp-uima`
— `UimaTokenizerFactory.java` sentence/token pipeline). The reference vendors
JVM morphological analysers (~20k LoC); here each language gets a compact,
dependency-free segmenter with the same SPI (:class:`TokenizerFactory`) and
an optional user dictionary for the dictionary-driven languages:

- Chinese: forward-maximum-matching over a user dictionary when given,
  falling back to single-character (hanzi) tokens — the standard baseline
  ansj degrades to without its bundled dictionary.
- Japanese: script-transition segmentation (kanji/hiragana/katakana/latin
  runs), splitting where the writing system changes — the shape kuromoji's
  lattice produces for dictionary-less text, plus maximum-matching when a
  user dictionary is supplied.
- Korean: whitespace eojeol splitting with optional particle (josa)
  stripping.
- UIMA: regex sentence segmentation + per-sentence tokenization, mirroring
  the SentenceAnnotator→TokenizerAnnotator pipeline.

The port's copy of the JAX package's jax-free ``nlp/language_packs.py``: the
same language packs.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Iterable, List, Optional, Sequence, Set

from deeplearning4j_tpu_torch.nlp.tokenization import (
    TokenPreProcess,
    Tokenizer,
    TokenizerFactory,
)


def _max_match(text: str, dictionary: Set[str], max_len: int) -> List[str]:
    """Forward maximum matching: greedily take the longest dictionary word."""
    out, i, n = [], 0, len(text)
    while i < n:
        match = None
        for L in range(min(max_len, n - i), 1, -1):
            cand = text[i:i + L]
            if cand in dictionary:
                match = cand
                break
        if match is None:
            match = text[i]
        out.append(match)
        i += len(match)
    return out


def _char_class(ch: str) -> str:
    o = ord(ch)
    if 0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF:
        return "han"
    if 0x3040 <= o <= 0x309F:
        return "hiragana"
    if 0x30A0 <= o <= 0x30FF or o == 0x30FC:  # incl. long-vowel mark
        return "katakana"
    if 0xAC00 <= o <= 0xD7AF:
        return "hangul"
    if ch.isspace():
        return "space"
    if unicodedata.category(ch).startswith("P"):
        return "punct"
    if ch.isdigit():
        return "digit"
    return "latin"


def _split_scripts(sentence: str) -> List[str]:
    """Runs of identical character class; space/punct runs are dropped."""
    out: List[str] = []
    cur, cur_cls = "", None
    for ch in sentence:
        cls = _char_class(ch)
        if cls != cur_cls and cur:
            if cur_cls not in ("space", "punct"):
                out.append(cur)
            cur = ""
        cur += ch
        cur_cls = cls
    if cur and cur_cls not in ("space", "punct"):
        out.append(cur)
    return out


class ChineseTokenizerFactory(TokenizerFactory):
    """Chinese segmentation (`deeplearning4j-nlp-chinese` ansj role).

    ``dictionary`` accepts either a word list (forward maximum matching —
    ansj's min-mode shape) or a
    :class:`~deeplearning4j_tpu_torch.nlp.dictionary_tokenizer.MorphologicalDictionary`
    (cost-lattice Viterbi — ansj's n-gram CRF shape; measured against the
    greedy baseline in ``tests/test_dictionary_tokenizer.py::
    TestChineseSegmentationAccuracy``: viterbi 1.000 vs greedy 0.967 span
    F1 on the tagged fixture corpus)."""

    def __init__(self, dictionary: Optional[Iterable[str]] = None,
                 pre_processor: Optional[TokenPreProcess] = None):
        from deeplearning4j_tpu_torch.nlp.dictionary_tokenizer import (
            MorphologicalDictionary)
        self._pre = pre_processor
        self._lattice = (dictionary
                         if isinstance(dictionary, MorphologicalDictionary)
                         else None)
        self._dict: Set[str] = (set() if self._lattice is not None
                                else set(dictionary or ()))
        self._max_len = max((len(w) for w in self._dict), default=1)

    def create(self, sentence: str) -> Tokenizer:
        from deeplearning4j_tpu_torch.nlp.dictionary_tokenizer import (
            viterbi_segment)
        tokens: List[str] = []
        for run in _split_scripts(sentence):
            if _char_class(run[0]) == "han":
                if self._lattice is not None:
                    tokens.extend(e.surface for e in
                                  viterbi_segment(run, self._lattice))
                elif self._dict:
                    tokens.extend(_max_match(run, self._dict, self._max_len))
                else:
                    tokens.extend(run)  # per-hanzi fallback
            else:
                tokens.append(run)
        return Tokenizer(tokens, self._pre)


class JapaneseTokenizerFactory(TokenizerFactory):
    """Japanese segmentation (`deeplearning4j-nlp-japanese` kuromoji role).

    ``use_base_form`` is accepted for API parity with the kuromoji factory's
    baseform mode; without a morphological dictionary surface forms are
    returned either way.
    """

    def __init__(self, dictionary: Optional[Iterable[str]] = None,
                 use_base_form: bool = False,
                 pre_processor: Optional[TokenPreProcess] = None):
        self._pre = pre_processor
        self.use_base_form = use_base_form
        self._dict: Set[str] = set(dictionary or ())
        self._max_len = max((len(w) for w in self._dict), default=1)

    def create(self, sentence: str) -> Tokenizer:
        tokens: List[str] = []
        for run in _split_scripts(sentence):
            cls = _char_class(run[0])
            if cls in ("han", "hiragana") and self._dict:
                tokens.extend(_max_match(run, self._dict, self._max_len))
            else:
                tokens.append(run)
        return Tokenizer(tokens, self._pre)


# common single-character josa + a few frequent two-character particles
_KOREAN_JOSA = ("은", "는", "이", "가", "을", "를", "에", "의", "도", "로",
                "과", "와", "만", "께", "에서", "에게", "으로", "까지", "부터",
                "하고", "이다", "입니다")


class KoreanTokenizerFactory(TokenizerFactory):
    """Korean eojeol tokenizer (`deeplearning4j-nlp-korean` role): whitespace
    splitting with optional particle stripping."""

    def __init__(self, strip_josa: bool = False,
                 pre_processor: Optional[TokenPreProcess] = None):
        self._pre = pre_processor
        self.strip_josa = strip_josa
        self._josa = sorted(_KOREAN_JOSA, key=len, reverse=True)

    def create(self, sentence: str) -> Tokenizer:
        tokens: List[str] = []
        for run in _split_scripts(sentence):
            if self.strip_josa and _char_class(run[0]) == "hangul" and len(run) > 1:
                for josa in self._josa:
                    if run.endswith(josa) and len(run) > len(josa):
                        run = run[:-len(josa)]
                        break
            tokens.append(run)
        return Tokenizer(tokens, self._pre)


_SENTENCE_RE = re.compile(r"(?<=[.!?。！？])\s+")


class UimaTokenizerFactory(TokenizerFactory):
    """Sentence-annotating tokenizer (`deeplearning4j-nlp-uima/.../UimaTokenizerFactory.java`):
    segments into sentences first, then tokenizes each — the UIMA
    SentenceAnnotator → TokenizerAnnotator pipeline as plain functions."""

    def __init__(self, base_factory: Optional[TokenizerFactory] = None,
                 pre_processor: Optional[TokenPreProcess] = None):
        from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
        self._pre = pre_processor
        self.base = base_factory or DefaultTokenizerFactory()

    @staticmethod
    def segment_sentences(text: str) -> List[str]:
        return [s for s in _SENTENCE_RE.split(text.strip()) if s]

    def create(self, text: str) -> Tokenizer:
        tokens: List[str] = []
        for sent in self.segment_sentences(text):
            tokens.extend(self.base.create(sent).get_tokens())
        return Tokenizer(tokens, self._pre)
