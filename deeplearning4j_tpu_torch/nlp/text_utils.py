"""Text preparation utilities.

Parity targets (reference, deeplearning4j-nlp):
- ``text/inputsanitation/InputHomogenization.java`` — character-level text
  normalization (digits -> 'd', lowercasing, punctuation stripping, NFD).
- ``text/stopwords/StopWords.java`` — canonical English stop-word list.
- ``text/invertedindex/InvertedIndex.java`` — document/word posting index
  SPI (the reference ships the interface; the LuceneInvertedIndex impl
  lived outside this snapshot). Here: an in-memory implementation with the
  same query surface.

The port's copy of the JAX package's jax-free ``nlp/text_utils.py``: the
same stop words, homogenization and inverted index.
"""

from __future__ import annotations

import re
import threading
import unicodedata
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

__all__ = [
    "InputHomogenization",
    "StopWords",
    "InvertedIndex",
    "InMemoryInvertedIndex",
]

# A standard English stop-word list (function words + contractions), the
# role of the reference's bundled stopwords.txt resource.
_ENGLISH_STOP_WORDS = """
a about above after again against all am an and any are aren't as at be
because been before being below between both but by can't cannot could
couldn't did didn't do does doesn't doing don't down during each few for
from further had hadn't has hasn't have haven't having he he'd he'll he's
her here here's hers herself him himself his how how's i i'd i'll i'm i've
if in into is isn't it it's its itself let's me more most mustn't my myself
no nor not of off on once only or other ought our ours ourselves out over
own same shan't she she'd she'll she's should shouldn't so some such than
that that's the their theirs them themselves then there there's these they
they'd they'll they're they've this those through to too under until up
very was wasn't we we'd we'll we're we've were weren't what what's when
when's where where's which while who who's whom why why's with won't would
wouldn't you you'd you'll you're you've your yours yourself yourselves
""".split()


class StopWords:
    """English stop-word list (``StopWords.java`` getStopWords)."""

    _words: Optional[List[str]] = None

    @classmethod
    def get_stop_words(cls) -> List[str]:
        if cls._words is None:
            cls._words = list(_ENGLISH_STOP_WORDS)
        return cls._words


class InputHomogenization:
    """Normalizes raw text (``InputHomogenization.java:41`` transform()).

    - digits become ``d``
    - uppercase lowered unless ``preserve_case``
    - characters in ``ignore_characters_containing`` pass through untouched
    - NFD-normalized, then common punctuation stripped, runs of ``!``
      collapsed to one
    """

    _STRIP = '.,"\'()“”…|/\\[]‘’'

    def __init__(self, input_text: str, preserve_case: bool = False,
                 ignore_characters_containing: Optional[Sequence[str]] = None):
        self.input = input_text
        self.preserve_case = preserve_case
        self.ignore = set(ignore_characters_containing or ())

    def transform(self) -> str:
        out = []
        for ch in self.input:
            if ch in self.ignore:
                out.append(ch)
            elif ch.isdigit():
                out.append("d")
            elif ch.isupper() and not self.preserve_case:
                out.append(ch.lower())
            else:
                out.append(ch)
        s = unicodedata.normalize("NFD", "".join(out))
        # ignored characters survive the punctuation strip too
        s = s.translate({ord(c): None for c in self._STRIP
                         if c not in self.ignore})
        if "!" not in self.ignore:
            s = re.sub(r"!+", "!", s)
        return s


class InvertedIndex:
    """Word -> posting-list index SPI (``InvertedIndex.java``).

    The reference interface speaks VocabWord objects; here words are plain
    strings and documents are integer ids.
    """

    def document(self, index: int) -> List[str]:
        raise NotImplementedError

    def documents(self, word: str) -> List[int]:
        raise NotImplementedError

    def num_documents(self) -> int:
        raise NotImplementedError

    def words(self) -> Set[str]:
        raise NotImplementedError

    def add_word_to_doc(self, doc: int, word: str) -> None:
        raise NotImplementedError

    def add_words_to_doc(self, doc: int, words: Iterable[str]) -> None:
        for w in words:
            self.add_word_to_doc(doc, w)

    def finish(self) -> None:
        """Flush / seal the index (no-op for the in-memory impl)."""

    def total_words(self) -> int:
        raise NotImplementedError


class InMemoryInvertedIndex(InvertedIndex):
    """Thread-safe in-memory inverted index."""

    def __init__(self):
        self._docs: Dict[int, List[str]] = {}
        self._postings: Dict[str, List[int]] = {}
        self._total = 0
        self._lock = threading.Lock()

    def document(self, index: int) -> List[str]:
        return list(self._docs.get(index, []))

    def documents(self, word: str) -> List[int]:
        return list(self._postings.get(word, []))

    def num_documents(self) -> int:
        return len(self._docs)

    def words(self) -> Set[str]:
        return set(self._postings.keys())

    def add_word_to_doc(self, doc: int, word: str) -> None:
        with self._lock:
            self._docs.setdefault(doc, []).append(word)
            posting = self._postings.setdefault(word, [])
            if not posting or posting[-1] != doc:
                posting.append(doc)
            self._total += 1

    def total_words(self) -> int:
        return self._total

    def batch_iter(self, batch_size: int) -> Iterable[List[List[str]]]:
        """Yield documents in batches (the reference's batchDocs role)."""
        batch: List[List[str]] = []
        for idx in sorted(self._docs):
            batch.append(self._docs[idx])
            if len(batch) == batch_size:
                yield batch
                batch = []
        if batch:
            yield batch

    def each_doc(self, fn: Callable[[List[str]], None]) -> None:
        for idx in sorted(self._docs):
            fn(self._docs[idx])
