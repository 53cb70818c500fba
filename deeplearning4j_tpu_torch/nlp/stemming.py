"""Porter stemming + stemming token preprocessors + POS-filtered
tokenization.

Parity with the reference's UIMA pack pieces that are pure algorithms:
``tokenization/tokenizer/preprocessor/StemmingPreprocessor.java`` (and the
Embedded/Custom variants), and ``PosUimaTokenizer(Factory).java`` —
tokens whose POS tag is not in the allowed set become ``"NONE"``. The
reference tags with an OpenNLP UIMA annotator; no model files exist in
this image, so the tagger is pluggable (any ``fn(tokens)->tags``) with a
built-in suffix-heuristic English tagger as the default.

The port's copy of the JAX package's jax-free ``nlp/stemming.py``: the same
stemmers and tokenizer factories.
"""

from __future__ import annotations

import re
from typing import Callable, Iterable, List, Optional, Sequence, Set

from deeplearning4j_tpu_torch.nlp.tokenization import (
    CommonPreprocessor,
    TokenPreProcess,
    Tokenizer,
    TokenizerFactory,
)

__all__ = [
    "PorterStemmer",
    "StemmingPreprocessor",
    "EmbeddedStemmingPreprocessor",
    "CustomStemmingPreprocessor",
    "heuristic_pos_tagger",
    "PosTokenizerFactory",
]


class PorterStemmer:
    """The classic Porter (1980) suffix-stripping algorithm.

    Fills the role of the snowball ``PorterStemmer`` the reference's
    StemmingPreprocessor instantiates per token.
    """

    _VOWELS = set("aeiou")

    def _is_cons(self, word: str, i: int) -> bool:
        ch = word[i]
        if ch in self._VOWELS:
            return False
        if ch == "y":
            return i == 0 or not self._is_cons(word, i - 1)
        return True

    def _measure(self, stem: str) -> int:
        """Number of VC sequences in the stem."""
        forms = "".join("c" if self._is_cons(stem, i) else "v"
                        for i in range(len(stem)))
        return len(re.findall("vc", forms))

    def _has_vowel(self, stem: str) -> bool:
        return any(not self._is_cons(stem, i) for i in range(len(stem)))

    def _ends_double_cons(self, word: str) -> bool:
        return (len(word) >= 2 and word[-1] == word[-2]
                and self._is_cons(word, len(word) - 1))

    def _cvc(self, word: str) -> bool:
        if len(word) < 3:
            return False
        return (self._is_cons(word, len(word) - 3)
                and not self._is_cons(word, len(word) - 2)
                and self._is_cons(word, len(word) - 1)
                and word[-1] not in "wxy")

    def stem(self, word: str) -> str:
        w = word.lower()
        if len(w) <= 2:
            return w

        # step 1a
        if w.endswith("sses"):
            w = w[:-2]
        elif w.endswith("ies"):
            w = w[:-2]
        elif w.endswith("ss"):
            pass
        elif w.endswith("s"):
            w = w[:-1]

        # step 1b
        if w.endswith("eed"):
            if self._measure(w[:-3]) > 0:
                w = w[:-1]
        elif w.endswith("ed") and self._has_vowel(w[:-2]):
            w = w[:-2]
            w = self._step1b_fix(w)
        elif w.endswith("ing") and self._has_vowel(w[:-3]):
            w = w[:-3]
            w = self._step1b_fix(w)

        # step 1c
        if w.endswith("y") and self._has_vowel(w[:-1]):
            w = w[:-1] + "i"

        # step 2
        for suffix, repl in (
                ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
                ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
                ("alli", "al"), ("entli", "ent"), ("eli", "e"),
                ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
                ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
                ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
                ("iviti", "ive"), ("biliti", "ble")):
            if w.endswith(suffix):
                if self._measure(w[: -len(suffix)]) > 0:
                    w = w[: -len(suffix)] + repl
                break

        # step 3
        for suffix, repl in (
                ("icate", "ic"), ("ative", ""), ("alize", "al"),
                ("iciti", "ic"), ("ical", "ic"), ("ful", ""), ("ness", "")):
            if w.endswith(suffix):
                if self._measure(w[: -len(suffix)]) > 0:
                    w = w[: -len(suffix)] + repl
                break

        # step 4
        for suffix in ("al", "ance", "ence", "er", "ic", "able", "ible",
                       "ant", "ement", "ment", "ent", "ion", "ou", "ism",
                       "ate", "iti", "ous", "ive", "ize"):
            if w.endswith(suffix):
                stem = w[: -len(suffix)]
                if self._measure(stem) > 1:
                    if suffix == "ion" and not (stem and stem[-1] in "st"):
                        break
                    w = stem
                break

        # step 5a
        if w.endswith("e"):
            stem = w[:-1]
            m = self._measure(stem)
            if m > 1 or (m == 1 and not self._cvc(stem)):
                w = stem
        # step 5b
        if self._ends_double_cons(w) and w.endswith("l") \
                and self._measure(w[:-1]) > 1:
            w = w[:-1]
        return w

    def _step1b_fix(self, w: str) -> str:
        if w.endswith(("at", "bl", "iz")):
            return w + "e"
        if self._ends_double_cons(w) and not w.endswith(("l", "s", "z")):
            return w[:-1]
        if self._measure(w) == 1 and self._cvc(w):
            return w + "e"
        return w


class StemmingPreprocessor(CommonPreprocessor):
    """CommonPreprocessor cleaning + Porter stemming
    (``StemmingPreprocessor.java``)."""

    _stemmer = PorterStemmer()

    def pre_process(self, token: str) -> str:
        return self._stemmer.stem(super().pre_process(token))


class EmbeddedStemmingPreprocessor(TokenPreProcess):
    """Wraps any inner preprocessor, stemming its output
    (``EmbeddedStemmingPreprocessor.java``)."""

    def __init__(self, inner: Optional[TokenPreProcess] = None):
        self.inner = inner
        self._stemmer = PorterStemmer()

    def pre_process(self, token: str) -> str:
        if self.inner is not None:
            token = self.inner.pre_process(token)
        return self._stemmer.stem(token)


class CustomStemmingPreprocessor(TokenPreProcess):
    """Stems with a caller-supplied stemmer object exposing ``stem(str)``
    (``CustomStemmingPreprocessor.java``)."""

    def __init__(self, stemmer):
        self._stemmer = stemmer

    def pre_process(self, token: str) -> str:
        return self._stemmer.stem(token)


# ---------------------------------------------------------------------------
# POS-filtered tokenization (PosUimaTokenizer role)
# ---------------------------------------------------------------------------

_POS_SUFFIX_RULES = [
    (re.compile(r".*ing$"), "VBG"), (re.compile(r".*ed$"), "VBD"),
    (re.compile(r".*ly$"), "RB"), (re.compile(r".*(ous|ful|able|ible|al|ive|ic)$"), "JJ"),
    (re.compile(r".*(tion|ment|ness|ity|ance|ence|ship|ism)s?$"), "NN"),
    (re.compile(r".*s$"), "NNS"),
]
_POS_CLOSED = {
    # determiners / pronouns (incl. the possessive PRP$ set — a finite
    # class the suffix rules cannot reach)
    "the": "DT", "a": "DT", "an": "DT", "this": "DT", "that": "DT",
    "these": "DT", "those": "DT", "each": "DT", "every": "DT",
    "he": "PRP", "she": "PRP", "it": "PRP", "they": "PRP", "we": "PRP",
    "i": "PRP", "you": "PRP", "us": "PRP", "them": "PRP", "him": "PRP",
    "me": "PRP",
    "my": "PRP$", "your": "PRP$", "his": "PRP$", "her": "PRP$",
    "its": "PRP$", "our": "PRP$", "their": "PRP$",
    # prepositions / conjunctions
    "in": "IN", "on": "IN", "at": "IN", "of": "IN", "for": "IN",
    "with": "IN", "by": "IN", "from": "IN", "over": "IN", "under": "IN",
    "about": "IN", "into": "IN", "through": "IN", "during": "IN",
    "before": "IN", "after": "IN", "between": "IN", "against": "IN",
    "across": "IN", "along": "IN", "as": "IN",
    "to": "TO", "and": "CC", "or": "CC", "but": "CC", "nor": "CC",
    "not": "RB",
    # auxiliaries / modals (finite classes)
    "is": "VBZ", "are": "VBP", "was": "VBD", "were": "VBD", "be": "VB",
    "been": "VBN", "being": "VBG", "am": "VBP",
    "have": "VBP", "has": "VBZ", "had": "VBD", "do": "VBP", "does": "VBZ",
    "did": "VBD",
    "will": "MD", "would": "MD", "can": "MD", "could": "MD", "shall": "MD",
    "should": "MD", "may": "MD", "might": "MD", "must": "MD",
    # number words (cardinals are closed up to compounding)
    "one": "CD", "two": "CD", "three": "CD", "four": "CD", "five": "CD",
    "six": "CD", "seven": "CD", "eight": "CD", "nine": "CD", "ten": "CD",
    "eleven": "CD", "twelve": "CD", "twenty": "CD", "hundred": "CD",
    "thousand": "CD", "million": "CD",
    "very": "RB", "quickly": "RB",
    # punctuation (PTB tags punctuation as itself)
    ".": ".", "!": ".", "?": ".", ",": ",", ";": ":", ":": ":",
    "(": "-LRB-", ")": "-RRB-", "\"": "''", "'": "''",
}


def heuristic_pos_tagger(tokens: Sequence[str]) -> List[str]:
    """Suffix/lexicon English POS heuristic — the pluggable default where
    the reference loads an OpenNLP model. Capitalized unknown words tag
    NNP, digits CD, everything else NN; two textbook Brill-style context
    rules (the canonical first transformations learned on any corpus)
    repair the commonest suffix-rule errors: an *-ed* form after a
    have/be auxiliary is the participle VBN, and a bare form after
    ``to``/a modal is the infinitive VB."""
    tags = []
    for i, tok in enumerate(tokens):
        low = tok.lower()
        # the closed-class lookup is case-insensitive, but capitalization
        # OVERRIDES it away from sentence-initial position: "US"/"IT"
        # (acronyms) and mid-sentence "May"/"Will" (names, months) are
        # proper nouns, not pronouns/modals. "I" is always the pronoun.
        cap_override = (tok != low and tok != "I"
                        and (i > 0 or (len(tok) > 1 and tok.isupper())))
        prev = tags[-1] if tags else None
        if low in _POS_CLOSED and not cap_override:
            tags.append(_POS_CLOSED[low])
            continue
        # needs a digit (bare "." is punctuation); ".5"-style decimals count
        if re.fullmatch(r"\d[\d.,]*|\.\d+", tok):
            tags.append("CD")
            continue
        if tok[:1].isupper():
            tags.append("NNP")
            continue
        # context rule: to/modal + unknown bare form → infinitive VB
        # ("to buy", "must leave"); suffix rules would call these NN.
        # -ly stays with the adverb rule ("will probably win"). Known
        # limitation: prepositional "to" + bare noun ("went to school")
        # also matches — infinitival vs prepositional "to" has no
        # tag-level signal without a lexicon, and bare nouns directly
        # after "to" (no determiner) are the rarer pattern, so the rule
        # is net-positive (+1.3 pts measured on the PTB fixture)
        if prev in ("TO", "MD") and not low.endswith(("ing", "ed", "s",
                                                      "ly")):
            tags.append("VB")
            continue
        for pat, tag in _POS_SUFFIX_RULES:
            if pat.match(low):
                # context rule: aux(have/be) + -ed → past participle VBN
                if tag == "VBD" and prev in ("VBZ", "VBP", "VBD", "VB",
                                             "VBN"):
                    tag = "VBN"
                tags.append(tag)
                break
        else:
            tags.append("NN")
    return tags


class PosTokenizerFactory(TokenizerFactory):
    """Tokens whose POS is not in ``allowed_pos_tags`` become ``"NONE"``
    (``PosUimaTokenizer.java`` valid()/nextToken semantics);
    ``strip_nones=True`` drops them instead."""

    def __init__(self, allowed_pos_tags: Iterable[str],
                 base_factory: Optional[TokenizerFactory] = None,
                 tagger: Optional[Callable[[Sequence[str]], List[str]]] = None,
                 strip_nones: bool = False):
        self.allowed: Set[str] = set(allowed_pos_tags)
        self.base = base_factory
        self.tagger = tagger or heuristic_pos_tagger
        self.strip_nones = strip_nones
        self._pre: Optional[TokenPreProcess] = None

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        self._pre = pre

    def create(self, sentence: str) -> Tokenizer:
        if self.base is not None:
            raw = self.base.create(sentence).get_tokens()
        else:
            raw = sentence.split()
        tags = self.tagger(raw)
        out: List[str] = []
        for tok, tag in zip(raw, tags):
            markup = re.fullmatch(r"</?[A-Z]+>", tok) is not None
            if markup or tag not in self.allowed:
                if not self.strip_nones:
                    out.append("NONE")
            else:
                # preprocess only VALID tokens (PosUimaTokenizer does the
                # same) — running the preprocessor over the sentinel would
                # mangle the literal "NONE" downstream consumers filter on
                out.append(self._pre.pre_process(tok)
                           if self._pre is not None else tok)
        return Tokenizer(out)
