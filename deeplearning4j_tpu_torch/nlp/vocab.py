"""Vocabulary construction + Huffman coding.

Parity with `models/word2vec/wordstore/VocabConstructor.java:31` (parallel
corpus scan, frequency cutoffs) and `models/embeddings/loader/` Huffman tree
construction: each vocab word gets a binary `code` and the list of inner-node
`points` used by hierarchical softmax.

The port's copy of the JAX package's jax-free ``nlp/vocab.py``: the same
vocabulary, Huffman codes and points; the file scan runs on the port's
``native``.
"""

from __future__ import annotations

import heapq
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence


class VocabWord:
    """One vocabulary element (VocabWord.java): word, frequency, Huffman
    code/points, unigram-table sampling weight."""

    __slots__ = ("word", "frequency", "index", "code", "points", "is_label",
                 "is_special")

    def __init__(self, word: str, frequency: float = 1.0,
                 is_label: bool = False, is_special: bool = False):
        self.word = word
        self.frequency = frequency
        self.index = -1
        self.code: List[int] = []
        self.points: List[int] = []
        self.is_label = is_label
        self.is_special = is_special

    def increment(self, by: float = 1.0) -> None:
        self.frequency += by

    def __repr__(self) -> str:
        return f"VocabWord({self.word!r}, f={self.frequency})"


class VocabCache:
    """In-memory vocab store (AbstractCache.java parity): word↔index maps,
    frequencies, total token count."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []
        self.total_word_occurrences = 0.0

    def add_token(self, vw: VocabWord) -> None:
        if vw.word in self._words:
            self._words[vw.word].increment(vw.frequency)
        else:
            self._words[vw.word] = vw
        self.total_word_occurrences += vw.frequency

    def contains_word(self, word: str) -> bool:
        return word in self._words

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def word_frequency(self, word: str) -> float:
        vw = self._words.get(word)
        return vw.frequency if vw else 0.0

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return vw.index if vw else -1

    def word_at_index(self, index: int) -> Optional[str]:
        if 0 <= index < len(self._by_index):
            return self._by_index[index].word
        return None

    def element_at_index(self, index: int) -> VocabWord:
        return self._by_index[index]

    def num_words(self) -> int:
        return len(self._by_index)

    def words(self) -> List[str]:
        return [vw.word for vw in self._by_index]

    def vocab_words(self) -> List[VocabWord]:
        return list(self._by_index)

    def truncate(self, min_frequency: float) -> None:
        """Drop words below the cutoff, keeping labels and special tokens
        (VocabConstructor pins special tokens through the cutoff)."""
        kept = {w: vw for w, vw in self._words.items()
                if vw.frequency >= min_frequency or vw.is_label
                or vw.is_special}
        self._words = kept
        self._by_index = []

    def update_indices(self) -> None:
        """Assign indices by descending frequency (word2vec convention)."""
        self._by_index = sorted(self._words.values(),
                                key=lambda vw: (-vw.frequency, vw.word))
        for i, vw in enumerate(self._by_index):
            vw.index = i

    def __len__(self) -> int:
        return len(self._by_index)


def build_huffman(cache: VocabCache) -> None:
    """Assign Huffman ``code`` / ``points`` to every word in the cache.

    Mirrors word2vec's tree build (reference `Huffman.java`): leaves are
    vocab words weighted by frequency; each word's code is its path of
    left/right choices, points are the inner-node ids along the path
    (usable as rows of syn1).
    """
    n = cache.num_words()
    if n == 0:
        return
    # heap of (freq, tiebreak, node_id); leaves are 0..n-1, inner n..2n-2
    heap = [(cache.element_at_index(i).frequency, i, i) for i in range(n)]
    heapq.heapify(heap)
    parent = {}
    binary = {}
    next_id = n
    while len(heap) > 1:
        f1, _, n1 = heapq.heappop(heap)
        f2, _, n2 = heapq.heappop(heap)
        parent[n1] = next_id
        parent[n2] = next_id
        binary[n1] = 0
        binary[n2] = 1
        heapq.heappush(heap, (f1 + f2, next_id, next_id))
        next_id += 1
    root = heap[0][2]
    for i in range(n):
        code: List[int] = []
        points: List[int] = []
        node = i
        while node != root:
            code.append(binary[node])
            node = parent[node]
            # inner node id relative to n (syn1 row); root included
            points.append(node - n)
        vw = cache.element_at_index(i)
        vw.code = list(reversed(code))
        vw.points = list(reversed(points))


def scan_corpus_file(path: str, *, n_threads: int = 4,
                     to_lower: bool = False) -> Dict[str, int]:
    """Word frequencies over a text file, split on ASCII whitespace.

    ``to_lower`` defaults to False, matching ``build_vocab_from_file`` /
    ``fit_file`` (the plain DefaultTokenizerFactory behavior) so counting
    directly and training with defaults key the vocabulary identically.

    The reference's parallel corpus scan (``VocabConstructor.java:31``) as a
    native component: C++ worker threads count per-chunk outside the GIL
    (``native/src/corpus_scan.cpp``), merged and returned in (count desc,
    word asc) order. Falls back to a single-pass Python count with the SAME
    tokenization (``bytes.split()`` = ASCII whitespace, ASCII lowercasing)
    when the native library is unavailable.
    """
    import ctypes

    from deeplearning4j_tpu_torch import native as _n

    def _merge(pairs):
        # distinct byte tokens can decode (errors='replace') to the same
        # string — SUM collisions rather than keep the last one
        out: Dict[str, int] = {}
        for w, c in pairs:
            out[w] = out.get(w, 0) + int(c)
        return out

    lib = _n._load()  # prototypes declared in native._load()
    if lib is not None and hasattr(lib, "corpus_scan_file"):
        out = (ctypes.c_longlong * 3)()
        h = lib.corpus_scan_file(path.encode(), int(n_threads),
                                 1 if to_lower else 0, out)
        if h:  # nullptr = IO failure -> fall through to the Python path
            try:
                n_unique, _total, nbytes = out[0], out[1], out[2]
                words_buf = ctypes.create_string_buffer(int(nbytes))
                counts = (ctypes.c_longlong * int(n_unique))()
                lib.corpus_scan_fill(h, words_buf, counts)
                words = words_buf.raw[:int(nbytes)].decode(
                    "utf-8", errors="replace").split("\n")
                return _merge(zip(words, counts))
            finally:
                lib.corpus_scan_free(h)

    with open(path, "rb") as f:
        data = f.read()
    if to_lower:
        data = data.lower()
    counts = Counter(data.split())
    items = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    return _merge((w.decode("utf-8", errors="replace"), c)
                  for w, c in items)


class VocabConstructor:
    """Builds a VocabCache from token sequences (VocabConstructor.java:31)."""

    def __init__(self, min_word_frequency: int = 1,
                 special_tokens: Sequence[str] = ()):
        self.min_word_frequency = min_word_frequency
        self.special_tokens = list(special_tokens)

    def build_vocab_from_file(self, path: str, *, n_threads: int = 4,
                              to_lower: bool = False) -> "VocabCache":
        """Fast path for file corpora: the native multithreaded scan feeds
        the same cutoff/Huffman pipeline as :meth:`build_vocab`."""
        counts = scan_corpus_file(path, n_threads=n_threads,
                                  to_lower=to_lower)
        total = sum(counts.values())
        cache = VocabCache()
        for tok in self.special_tokens:
            cache.add_token(VocabWord(tok,
                                      frequency=max(counts.get(tok, 1), 1),
                                      is_special=True))
            counts.pop(tok, None)
        for word, c in counts.items():
            cache.add_token(VocabWord(word, frequency=c))
        cache.truncate(self.min_word_frequency)
        cache.update_indices()
        cache.total_word_occurrences = float(total)
        build_huffman(cache)
        return cache

    def build_vocab(self, sequences: Iterable[Sequence[str]],
                    labels: Iterable[Sequence[str]] = ()) -> VocabCache:
        counts: Counter = Counter()
        total = 0
        for seq in sequences:
            counts.update(seq)
            total += len(seq)
        cache = VocabCache()
        for tok in self.special_tokens:
            cache.add_token(VocabWord(tok, frequency=max(counts.get(tok, 1), 1),
                                      is_special=True))
            counts.pop(tok, None)
        for word, c in counts.items():
            cache.add_token(VocabWord(word, frequency=c))
        for label_set in labels:
            for lab in label_set:
                existing = cache.word_for(lab)
                if existing is None:
                    cache.add_token(VocabWord(lab, frequency=1, is_label=True))
                else:
                    # label collides with a corpus word: pin it so the
                    # document keeps a trainable label row past the cutoff
                    existing.is_label = True
        cache.truncate(self.min_word_frequency)
        cache.update_indices()
        cache.total_word_occurrences = float(total)
        build_huffman(cache)
        return cache
