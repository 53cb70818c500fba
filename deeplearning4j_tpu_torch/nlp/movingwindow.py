"""Sliding context windows over tokenized text.

Parity with the reference's ``text/movingwindow/`` package
(``Windows.java`` window generation, ``Window.java`` the window unit,
``WindowConverter.java`` window -> example array, and
``ContextLabelRetriever.java`` inline ``<LABEL> ... </LABEL>`` extraction).
Used for window-based training examples (e.g. NER-style classification
over word contexts).

The port's copy of the JAX package's jax-free ``nlp/movingwindow.py``: the
same windows and contexts.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Window",
    "windows",
    "window_for_word_in_position",
    "as_example_array",
    "as_example_matrix",
    "string_with_labels",
]

_BEGIN_LABEL = re.compile(r"<([A-Za-z]+|\d+)>$")
_END_LABEL = re.compile(r"</([A-Za-z]+|\d+)>$")


class Window:
    """A context window around a focus word (``Window.java``).

    ``words`` has odd length; the median element is the focus. Inline
    ``<LABEL>`` / ``</LABEL>`` markers in the left/right context set
    ``label`` and the begin/end flags, as in the reference.
    """

    def __init__(self, words: Sequence[str], window_size: int,
                 begin: int, end: int):
        if not words:
            raise ValueError("Words must be non-empty")
        self.words = list(words)
        self.window_size = window_size
        self.begin = begin
        self.end = end
        self.label = "NONE"
        self.begin_label = False
        self.end_label = False
        self.median = int(math.floor(len(self.words) / 2))
        self._init_context()

    def _init_context(self) -> None:
        context = self.words[: self.median] + self.words[self.median + 1:]
        for s in context:
            if _BEGIN_LABEL.match(s):
                self.label = re.sub(r"[<>/]", "", s)
                self.begin_label = True
            elif _END_LABEL.match(s):
                self.end_label = True
                self.label = re.sub(r"[<>/]", "", s)

    def focus_word(self) -> str:
        return self.words[self.median]

    def as_tokens(self) -> str:
        return " ".join(self.words)

    def __repr__(self) -> str:
        return f"Window({self.as_tokens()!r}, label={self.label!r})"


def window_for_word_in_position(window_size: int, word_pos: int,
                                sentence: Sequence[str]) -> Window:
    """One window centred at ``word_pos``, padded with <s> / </s>
    (``Windows.java`` windowForWordInPosition)."""
    context = int(math.floor((window_size - 1) / 2))
    words: List[str] = []
    for i in range(word_pos - context, word_pos + context + 1):
        if i < 0:
            words.append("<s>")
        elif i >= len(sentence):
            words.append("</s>")
        else:
            words.append(sentence[i])
    return Window(words, window_size, max(0, word_pos - context),
                  min(len(sentence), word_pos + context + 1))


def windows(text_or_tokens, window_size: int = 5,
            tokenizer_factory=None) -> List[Window]:
    """All windows over a sentence (``Windows.java`` windows overloads).

    Accepts a raw string (whitespace-split, or via ``tokenizer_factory``)
    or a pre-tokenized list.
    """
    if isinstance(text_or_tokens, str):
        if tokenizer_factory is not None:
            tokens = tokenizer_factory.create(text_or_tokens).get_tokens()
        else:
            tokens = text_or_tokens.split()
    else:
        tokens = list(text_or_tokens)
    if not tokens:
        raise ValueError("No tokens found for windows")
    return [window_for_word_in_position(window_size, i, tokens)
            for i in range(len(tokens))]


def _vector_for(word_vectors, word: str, normalize: bool) -> Optional[np.ndarray]:
    getter = getattr(word_vectors, "vector", None)
    if getter is None:
        getter = getattr(word_vectors, "get_word_vector_matrix")
    v = getter(word)
    if v is None:
        return None
    v = np.asarray(v, dtype=np.float32).reshape(-1)
    if normalize:
        n = float(np.linalg.norm(v))
        if n > 0:
            v = v / n
    return v


def as_example_array(window: Window, word_vectors,
                     normalize: bool = False) -> np.ndarray:
    """Concatenated word vectors for a window
    (``WindowConverter.java`` asExampleArray). Missing words raise."""
    vecs = []
    for w in window.words:
        v = _vector_for(word_vectors, w, normalize)
        if v is None:
            raise ValueError(f"Word {w!r} has no vector")
        vecs.append(v)
    return np.concatenate(vecs)


def as_example_matrix(window: Window, word_vectors) -> np.ndarray:
    """Like :func:`as_example_array` but unknown words map to zeros
    (``WindowConverter.java`` asExampleMatrix)."""
    dim = None
    vecs: List[Optional[np.ndarray]] = []
    for w in window.words:
        v = _vector_for(word_vectors, w, False)
        vecs.append(v)
        if v is not None:
            dim = v.shape[0]
    if dim is None:
        raise ValueError("No known words in window")
    return np.concatenate([v if v is not None else np.zeros(dim, np.float32)
                           for v in vecs])


def string_with_labels(sentence: str, tokenizer_factory=None
                       ) -> Tuple[str, Dict[Tuple[int, int], str]]:
    """Strip inline ``<LABEL> ... </LABEL>`` spans from a sentence
    (``ContextLabelRetriever.java`` stringWithLabels).

    Returns ``(stripped_sentence, {(begin_token, end_token): label})``
    where the span indexes token positions in the stripped sentence.
    """
    if tokenizer_factory is not None:
        tokens = tokenizer_factory.create(sentence).get_tokens()
    else:
        tokens = sentence.split()

    segments: List[Tuple[str, List[str]]] = []
    curr: List[str] = []
    curr_label: Optional[str] = None
    for tok in tokens:
        if _BEGIN_LABEL.match(tok):
            if curr_label is not None:
                raise ValueError("Nested begin label before previous closed")
            if curr:
                segments.append(("NONE", curr))
                curr = []
            curr_label = re.sub(r"[<>/]", "", tok)
        elif _END_LABEL.match(tok):
            end = re.sub(r"[<>/]", "", tok)
            if curr_label is None:
                raise ValueError("Found an ending label with no matching begin label")
            if curr_label != end:
                raise ValueError(f"Begin/end label mismatch: {curr_label} vs {end}")
            segments.append((curr_label, curr))
            curr = []
            curr_label = None
        else:
            curr.append(tok)
    if curr_label is not None:
        raise ValueError(f"Unclosed label {curr_label}")
    if curr:
        segments.append(("NONE", curr))

    out_tokens: List[str] = []
    spans: Dict[Tuple[int, int], str] = {}
    for label, seg in segments:
        start = len(out_tokens)
        out_tokens.extend(seg)
        if label != "NONE" and seg:
            spans[(start, len(out_tokens))] = label
    return " ".join(out_tokens), spans
