"""Sentence / document iterators.

Parity with `text/sentenceiterator/` (BasicLineIterator, Collection-,
File-, Line-, StreamLine-, Aggregating-, MutipleEpochs-, Prefetching-,
Synchronized- variants plus SentencePreProcessor) and
`text/documentiterator/` (DocumentIterator, FileDocumentIterator,
LabelsSource, Basic/File/FilenamesLabelAwareIterator — the labelled
document sources used by ParagraphVectors).

The port's copy of the JAX package's jax-free ``nlp/sentence.py``: the same
sentence, document and label-aware iterators.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

SentencePreProcessor = Callable[[str], str]


class SentenceIterator:
    """Streams sentences; reset() restarts from the beginning.

    An optional pre-processor (``SentencePreProcessor.java``) is applied
    inside ``next_sentence`` itself, as the reference iterators do — both
    the iteration protocol and explicit has_next()/next_sentence() loops
    see processed text.
    """

    _pre_processor: Optional[SentencePreProcessor] = None

    def next_sentence(self) -> Optional[str]:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def set_pre_processor(self, fn: Optional[SentencePreProcessor]) -> None:
        self._pre_processor = fn

    def get_pre_processor(self) -> Optional[SentencePreProcessor]:
        return self._pre_processor

    def _apply_pre(self, s: Optional[str]) -> Optional[str]:
        if s is not None and self._pre_processor is not None:
            return self._pre_processor(s)
        return s

    def __iter__(self) -> Iterator[str]:
        self.reset()
        while self.has_next():
            s = self.next_sentence()
            if s is not None:
                yield s


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Sequence[str]):
        self._sentences = list(sentences)
        self._pos = 0

    def next_sentence(self) -> Optional[str]:
        if self._pos >= len(self._sentences):
            return None
        s = self._sentences[self._pos]
        self._pos += 1
        return self._apply_pre(s)

    def has_next(self) -> bool:
        return self._pos < len(self._sentences)

    def reset(self) -> None:
        self._pos = 0


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a text file (BasicLineIterator.java)."""

    def __init__(self, path: str):
        self._path = path
        self._fh = None
        self._next: Optional[str] = None
        self.reset()

    def _advance(self) -> None:
        line = self._fh.readline()
        self._next = line.rstrip("\n") if line else None

    def next_sentence(self) -> Optional[str]:
        s = self._next
        self._advance()
        return self._apply_pre(s)

    def has_next(self) -> bool:
        return self._next is not None

    def reset(self) -> None:
        if self._fh:
            self._fh.close()
        self._fh = open(self._path, "r", encoding="utf-8")
        self._advance()


class FileSentenceIterator(SentenceIterator):
    """All lines of all files under a directory."""

    def __init__(self, root: str):
        self._root = root
        self.reset()

    def _paths(self) -> List[str]:
        if os.path.isfile(self._root):
            return [self._root]
        out = []
        for base, dirs, files in os.walk(self._root):
            dirs.sort()  # deterministic traversal order across platforms
            for f in sorted(files):
                out.append(os.path.join(base, f))
        return out

    def reset(self) -> None:
        # stream file-by-file, line-by-line — never materialize the corpus
        if getattr(self, "_fh", None) is not None:
            self._fh.close()
        self._file_queue: List[str] = self._paths()
        self._fh = None
        self._next: Optional[str] = None
        self._advance()

    def _advance(self) -> None:
        while True:
            if self._fh is not None:
                line = self._fh.readline()
                if line:
                    self._next = line.rstrip("\n")
                    return
                self._fh.close()
                self._fh = None
            if not self._file_queue:
                self._next = None
                return
            self._fh = open(self._file_queue.pop(0), "r", encoding="utf-8")

    def next_sentence(self) -> Optional[str]:
        s = self._next
        if s is not None:
            self._advance()
        return self._apply_pre(s)

    def has_next(self) -> bool:
        return self._next is not None


class LabelledDocument:
    """A document with labels (ParagraphVectors input unit)."""

    def __init__(self, content: str, labels: Sequence[str]):
        self.content = content
        self.labels = list(labels)


class LabelAwareIterator:
    """Streams LabelledDocuments (LabelAwareSentenceIterator parity)."""

    def __init__(self, docs: Iterable[Tuple[str, Sequence[str]]]):
        self._docs = [LabelledDocument(c, l) for c, l in docs]

    def __iter__(self) -> Iterator[LabelledDocument]:
        return iter(self._docs)


class LineSentenceIterator(BasicLineIterator):
    """One sentence per line of a single file (``LineSentenceIterator.java``;
    same contract as BasicLineIterator, kept as its own name for parity)."""


class StreamLineIterator(SentenceIterator):
    """Adapts a document stream to sentences line-by-line
    (``StreamLineIterator.java``).

    ``source`` is a DocumentIterator, a file-like object, or any iterable
    of document strings.
    """

    def __init__(self, source):
        # one-shot sources (generators, non-seekable streams) are
        # snapshotted here so reset() can restart them
        if isinstance(source, DocumentIterator):
            self._source: Optional[DocumentIterator] = source
            self._docs: List[str] = []
        else:
            self._source = None
            if hasattr(source, "read"):
                self._docs = [source.read()]
            else:
                self._docs = list(source)
        self.reset()

    def reset(self) -> None:
        if self._source is not None:
            self._source.reset()
            self._docs = list(self._source)
        self._lines: List[str] = []
        for doc in self._docs:
            self._lines.extend(doc.splitlines())
        self._pos = 0

    def next_sentence(self) -> Optional[str]:
        if self._pos >= len(self._lines):
            return None
        s = self._lines[self._pos]
        self._pos += 1
        return self._apply_pre(s)

    def has_next(self) -> bool:
        return self._pos < len(self._lines)


class AggregatingSentenceIterator(SentenceIterator):
    """Chains several backing sentence iterators
    (``AggregatingSentenceIterator.java``; the reference exposes a
    Builder.addSentenceIterator — pass the list here)."""

    def __init__(self, iterators: Sequence[SentenceIterator]):
        self._iterators = list(iterators)
        self.reset()

    @classmethod
    def builder(cls) -> "AggregatingSentenceIterator._Builder":
        return cls._Builder()

    class _Builder:
        def __init__(self):
            self._its: List[SentenceIterator] = []
            self._pre: Optional[SentencePreProcessor] = None

        def add_sentence_iterator(self, it: SentenceIterator) -> "AggregatingSentenceIterator._Builder":
            self._its.append(it)
            return self

        def add_sentence_pre_processor(self, fn: SentencePreProcessor) -> "AggregatingSentenceIterator._Builder":
            self._pre = fn
            return self

        def build(self) -> "AggregatingSentenceIterator":
            out = AggregatingSentenceIterator(self._its)
            out.set_pre_processor(self._pre)
            return out

    def reset(self) -> None:
        for it in self._iterators:
            it.reset()
        self._idx = 0

    def has_next(self) -> bool:
        while self._idx < len(self._iterators):
            if self._iterators[self._idx].has_next():
                return True
            self._idx += 1
        return False

    def next_sentence(self) -> Optional[str]:
        if not self.has_next():
            return None
        return self._apply_pre(self._iterators[self._idx].next_sentence())


class MutipleEpochsSentenceIterator(SentenceIterator):
    """Repeats the underlying iterator for N epochs
    (``MutipleEpochsSentenceIterator.java`` — reference spelling kept)."""

    def __init__(self, iterator: SentenceIterator, num_epochs: int):
        if num_epochs < 1:
            raise ValueError("num_epochs must be >= 1")
        self._it = iterator
        self._num_epochs = num_epochs
        self.reset()

    def reset(self) -> None:
        self._it.reset()
        self._epoch = 0

    def has_next(self) -> bool:
        if self._it.has_next():
            return True
        if self._epoch + 1 < self._num_epochs:
            self._epoch += 1
            self._it.reset()
            return self._it.has_next()
        return False

    def next_sentence(self) -> Optional[str]:
        if not self.has_next():
            return None
        return self._apply_pre(self._it.next_sentence())


class PrefetchingSentenceIterator(SentenceIterator):
    """Background-thread prefetch of an underlying iterator
    (``PrefetchingSentenceIterator.java``; the AsyncDataSetIterator idea
    applied to text)."""

    _END = object()

    def __init__(self, iterator: SentenceIterator, fetch_size: int = 10_000):
        self._it = iterator
        self._fetch_size = max(1, fetch_size)
        self._thread: Optional[threading.Thread] = None
        self.reset()

    @classmethod
    def builder(cls) -> "PrefetchingSentenceIterator._Builder":
        return cls._Builder()

    class _Builder:
        def __init__(self):
            self._it: Optional[SentenceIterator] = None
            self._size = 10_000
            self._pre: Optional[SentencePreProcessor] = None

        def set_sentence_iterator(self, it: SentenceIterator) -> "PrefetchingSentenceIterator._Builder":
            self._it = it
            return self

        def set_fetch_size(self, n: int) -> "PrefetchingSentenceIterator._Builder":
            self._size = n
            return self

        def set_sentence_pre_processor(self, fn: SentencePreProcessor) -> "PrefetchingSentenceIterator._Builder":
            self._pre = fn
            return self

        def build(self) -> "PrefetchingSentenceIterator":
            out = PrefetchingSentenceIterator(self._it, self._size)
            out.set_pre_processor(self._pre)
            return out

    def _producer(self, q: "queue.Queue", gen_id: int) -> None:
        # the underlying iterator is touched only under _it_lock so a
        # stale producer can't race reset()'s _it.reset(); the finally
        # guarantees _END even if the source raises mid-stream (a hung
        # consumer would otherwise block forever on q.get())
        try:
            while True:
                with self._it_lock:
                    if gen_id != self._gen:
                        return
                    if not self._it.has_next():
                        return
                    s = self._it.next_sentence()
                while True:
                    try:
                        q.put(s, timeout=0.1)
                        break
                    except queue.Full:
                        if gen_id != self._gen:  # orphaned by reset()
                            return
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer side
            self._error = e
        finally:
            while gen_id == self._gen:  # orphaned generations just drop _END
                try:
                    q.put(self._END, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def reset(self) -> None:
        if not hasattr(self, "_it_lock"):
            self._it_lock = threading.Lock()
            self._gen = 0
        self._gen += 1  # orphans any in-flight producer
        old = getattr(self, "_thread", None)
        if old is not None and old.is_alive():
            old.join(timeout=2.0)
        with self._it_lock:
            self._it.reset()
        self._queue: "queue.Queue" = queue.Queue(maxsize=self._fetch_size)
        self._peeked: Optional[object] = None
        self._done = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._producer, args=(self._queue, self._gen), daemon=True)
        self._thread.start()

    def _peek(self):
        if self._done:
            return None
        if self._peeked is None:
            item = self._queue.get()
            if item is self._END:
                self._done = True
                if self._error is not None:  # source raised mid-stream
                    raise self._error
                return None
            self._peeked = item
        return self._peeked

    def has_next(self) -> bool:
        return self._peek() is not None

    def next_sentence(self) -> Optional[str]:
        s = self._peek()
        self._peeked = None
        return self._apply_pre(s) if s is not None else None


class SynchronizedSentenceIterator(SentenceIterator):
    """Lock-guarded wrapper making any iterator safe for concurrent
    consumers (``SynchronizedSentenceIterator.java``)."""

    def __init__(self, iterator: SentenceIterator):
        self._it = iterator
        self._lock = threading.RLock()

    def reset(self) -> None:
        with self._lock:
            self._it.reset()

    def has_next(self) -> bool:
        with self._lock:
            return self._it.has_next()

    def next_sentence(self) -> Optional[str]:
        with self._lock:
            if not self._it.has_next():
                return None
            return self._apply_pre(self._it.next_sentence())


# ---------------------------------------------------------------------------
# Document iterators (text/documentiterator/)
# ---------------------------------------------------------------------------


class DocumentIterator:
    """Streams whole documents (``DocumentIterator.java``)."""

    def next_document(self) -> str:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self) -> Iterator[str]:
        self.reset()
        while self.has_next():
            yield self.next_document()


class FileDocumentIterator(DocumentIterator):
    """Each file under ``root`` is one document
    (``FileDocumentIterator.java``)."""

    def __init__(self, root: str):
        self._root = root
        self.reset()

    def _paths(self) -> List[str]:
        if os.path.isfile(self._root):
            return [self._root]
        out = []
        for base, dirs, files in os.walk(self._root):
            dirs.sort()  # deterministic traversal order across platforms
            for f in sorted(files):
                out.append(os.path.join(base, f))
        return out

    def reset(self) -> None:
        self._queue = self._paths()

    def has_next(self) -> bool:
        return bool(self._queue)

    def next_document(self) -> str:
        path = self._queue.pop(0)
        with open(path, "r", encoding="utf-8", errors="replace") as fh:
            return fh.read()


class LabelsSource:
    """Generates or stores document labels (``LabelsSource.java``).

    Template mode (``LabelsSource("DOC_%d")`` or a prefix without ``%d``)
    hands out ``next_label()`` sequentially; list mode serves a fixed
    label list. ``store_label`` collects unique labels either way.
    """

    def __init__(self, template_or_labels=None):
        self._counter = 0
        self._template: Optional[str] = None
        self._labels: Optional[List[str]] = None
        self._uniq: set = set()
        # fixed at construction: store_label must not flip a template
        # source into list mode (next_label would then serve stored
        # labels and run off the end of the list)
        self._list_mode = False
        if isinstance(template_or_labels, str):
            self._template = template_or_labels
        elif template_or_labels is not None:
            self._labels = list(template_or_labels)
            self._uniq.update(self._labels)
            self._list_mode = True

    def _format(self, value: int) -> str:
        if self._template and "%d" in self._template:
            return self._template % value
        return f"{self._template or 'DOC_'}{value}"

    def next_label(self) -> str:
        if self._list_mode:
            label = self._labels[self._counter]
            self._counter += 1
            return label
        label = self._format(self._counter)
        self._counter += 1
        return label

    def store_label(self, label: str) -> None:
        if self._labels is None:
            self._labels = []
        if label not in self._uniq:
            self._uniq.add(label)
            self._labels.append(label)

    def index_of(self, label: str) -> int:
        return (self._labels or []).index(label)

    def size(self) -> int:
        return len(self.get_labels())

    def get_labels(self) -> List[str]:
        if self._labels:
            return list(self._labels)
        return [self._format(i) for i in range(self._counter)]

    def reset(self) -> None:
        self._counter = 0


class BasicLabelAwareIterator(LabelAwareIterator):
    """Wraps a sentence/document source, auto-generating one label per
    document from a LabelsSource template
    (``BasicLabelAwareIterator.java``)."""

    def __init__(self, source, labels_source: Optional[LabelsSource] = None):
        self.labels_source = labels_source or LabelsSource("doc_%d")
        docs: List[LabelledDocument] = []
        if isinstance(source, SentenceIterator) or isinstance(source, DocumentIterator):
            contents: Iterable[str] = source
        else:
            contents = source
        for content in contents:
            # template mode reconstructs get_labels() from the counter, so
            # no store_label here (SentenceIteratorConverter behavior)
            label = self.labels_source.next_label()
            docs.append(LabelledDocument(content, [label]))
        self._docs = docs


class FileLabelAwareIterator(LabelAwareIterator):
    """Documents from label-named subfolders: ``root/<label>/<file>``
    (``FileLabelAwareIterator.java``; addSourceFolder semantics)."""

    def __init__(self, roots: Sequence[str]):
        if isinstance(roots, str):
            roots = [roots]
        docs: List[LabelledDocument] = []
        self.labels_source = LabelsSource([])
        for root in roots:
            for label in sorted(os.listdir(root)):
                sub = os.path.join(root, label)
                if not os.path.isdir(sub):
                    continue
                for fname in sorted(os.listdir(sub)):
                    path = os.path.join(sub, fname)
                    if not os.path.isfile(path):
                        continue
                    with open(path, "r", encoding="utf-8", errors="replace") as fh:
                        docs.append(LabelledDocument(fh.read(), [label]))
                    self.labels_source.store_label(label)
        self._docs = docs

    @classmethod
    def builder(cls) -> "FileLabelAwareIterator._Builder":
        return cls._Builder()

    class _Builder:
        def __init__(self):
            self._roots: List[str] = []

        def add_source_folder(self, path: str) -> "FileLabelAwareIterator._Builder":
            self._roots.append(path)
            return self

        def build(self) -> "FileLabelAwareIterator":
            return FileLabelAwareIterator(self._roots)


class FilenamesLabelAwareIterator(LabelAwareIterator):
    """Each file is a document whose label is its filename
    (``FilenamesLabelAwareIterator.java``)."""

    def __init__(self, roots: Sequence[str], absolute_path_as_label: bool = False):
        if isinstance(roots, str):
            roots = [roots]
        docs: List[LabelledDocument] = []
        self.labels_source = LabelsSource([])
        for root in roots:
            for base, dirs, files in os.walk(root):
                dirs.sort()  # deterministic label order
                for fname in sorted(files):
                    path = os.path.join(base, fname)
                    label = path if absolute_path_as_label else fname
                    with open(path, "r", encoding="utf-8", errors="replace") as fh:
                        docs.append(LabelledDocument(fh.read(), [label]))
                    self.labels_source.store_label(label)
        self._docs = docs
