"""Record readers and the record → DataSet bridge.

The reference consumes records through the external DataVec library and
bridges them in ``deeplearning4j-core/.../datasets/datavec/``
(`RecordReaderDataSetIterator.java:86`, `SequenceRecordReaderDataSetIterator.java`,
`RecordReaderMultiDataSetIterator.java`). This module provides both sides
natively: a small RecordReader SPI (CSV / line / collection / sequence
readers) and the iterators that assemble batched, padded, masked ``DataSet`` /
``MultiDataSet`` objects ready for jitted training (fixed shapes per batch;
variable-length sequences become padding + mask, never ragged arrays).

The port's copy of the JAX package's ``datasets/records.py``, on the
port's ``DataSet``: the same arrays and metadata (PIL is imported only
when an image is decoded).
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import os
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, DataSetIterator, MultiDataSet

Record = List  # a record is a list of values (DataVec "Writable"s)


@dataclasses.dataclass(frozen=True)
class RecordMetaData:
    """Provenance of one record (DataVec ``RecordMetaDataLine`` /
    ``RecordMetaDataIndex``): where it came from, so an evaluation error can
    be traced back to — and the original record reloaded from — its source.
    """

    index: int                      # position within the reader
    uri: Optional[str] = None       # source file, when file-backed
    reader_class: str = ""

    def get_location(self) -> str:
        base = self.uri or "<memory>"
        return f"{base}:{self.index}"


# --------------------------------------------------------------------------
# record readers
# --------------------------------------------------------------------------
class RecordReader:
    """SPI: iterate records (lists of values). Mirrors DataVec's RecordReader
    as used by the bridge iterators, including the metadata face
    (``nextRecord()`` → Record-with-meta, ``loadFromMetaData``)."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_record(self) -> Record:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    # ------------------------------------------------------------- metadata
    def _meta_uri(self) -> Optional[str]:
        paths = getattr(self, "_paths", None)
        return paths[0] if paths else None

    def next_record_with_meta(self):
        """(record, RecordMetaData) — DataVec ``RecordReader.nextRecord()``.
        The index is the reader-global record position (multi-file readers
        concatenate; the uri is the first source path)."""
        idx = int(getattr(self, "_pos", -1))
        return self.next_record(), RecordMetaData(
            index=idx, uri=self._meta_uri(), reader_class=type(self).__name__)

    def _record_at(self, index: int) -> Record:
        raise NotImplementedError(
            f"{type(self).__name__} does not support loadFromMetaData")

    def load_from_meta_data(self, metas) -> List[Record]:
        """Reload the original records for the given metadata
        (DataVec ``RecordReader.loadFromMetaData``) — the error-drilldown
        path: Evaluation.get_prediction_errors() → back to source records."""
        if isinstance(metas, RecordMetaData):
            metas = [metas]
        return [self._record_at(m.index) for m in metas]

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_record()


class CollectionRecordReader(RecordReader):
    """Records from an in-memory collection."""

    def __init__(self, records: Sequence[Record]):
        self._records = [list(r) for r in records]
        self.reset()

    def reset(self):
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._records)

    def next_record(self):
        r = self._records[self._pos]
        self._pos += 1
        return list(r)

    def _record_at(self, index):
        return list(self._records[index])


class LineRecordReader(RecordReader):
    """One record per line: ``[line]``. Files are read once at construction;
    ``reset()`` only rewinds."""

    def __init__(self, path: Union[str, Sequence[str]]):
        self._paths = _expand_paths(path)
        self._lines: List[str] = []
        for p in self._paths:
            with open(p, "r", encoding="utf-8") as f:
                self._lines.extend(ln.rstrip("\n") for ln in f)
        self.reset()

    def reset(self):
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._lines)

    def next_record(self):
        r = [self._lines[self._pos]]
        self._pos += 1
        return r

    def _record_at(self, index):
        return [self._lines[index]]


class CSVRecordReader(RecordReader):
    """Delimited text records; numeric fields are parsed to float."""

    def __init__(self, path: Union[str, Sequence[str]], skip_lines: int = 0,
                 delimiter: str = ","):
        self._paths = _expand_paths(path)
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        # parse once; reset() only rewinds (multi-epoch training would
        # otherwise re-read + re-parse the whole corpus every epoch)
        self._records: List[Record] = []
        for p in self._paths:
            with open(p, "r", encoding="utf-8") as f:
                for i, line in enumerate(f):
                    if i < self.skip_lines:
                        continue
                    line = line.strip()
                    if line:
                        self._records.append(
                            [_parse_field(v) for v in line.split(self.delimiter)])
        self.reset()

    def reset(self):
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._records)

    def next_record(self):
        r = self._records[self._pos]
        self._pos += 1
        return list(r)

    def _record_at(self, index):
        return list(self._records[index])


class ImageRecordReader(RecordReader):
    """Image directory reader (DataVec's ``ImageRecordReader`` role — the
    external dependency the reference's datavec bridge consumes; not in the
    reference snapshot itself). Walks a directory tree, decodes each image
    to a ``[height, width, channels]`` float32 array (0-255, PIL-backed,
    bilinear resize), and labels from the PARENT DIRECTORY name
    (ParentPathLabelGenerator semantics: one subdirectory per class,
    label indices assigned in sorted directory order).

    Records are ``[image_array, label_index]`` — feed to
    :class:`RecordReaderDataSetIterator` with ``label_index=1`` and
    ``num_possible_labels=len(reader.labels)``; scale with
    :class:`~deeplearning4j_tpu_torch.datasets.normalizers.ImagePreProcessingScaler`.
    """

    EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif")

    def __init__(self, height: int, width: int, channels: int = 3,
                 path: Optional[str] = None):
        self.height = int(height)
        self.width = int(width)
        self.channels = int(channels)
        self._files: List[Tuple[str, int]] = []
        self.labels: List[str] = []
        self._pos = 0
        if path is not None:
            self.initialize(path)

    def initialize(self, path: str) -> "ImageRecordReader":
        """Collect (file, label) pairs from ``path/<label>/<image>``; files
        directly under ``path`` get label 0 with a single '' class."""
        entries = []
        for root, _dirs, files in os.walk(path):
            for f in sorted(files):
                if f.lower().endswith(self.EXTENSIONS):
                    rel = os.path.relpath(root, path)
                    # ParentPathLabelGenerator: the file's IMMEDIATE parent
                    # directory names the class (root/a/b/x.png -> "b")
                    label = "" if rel == "." else os.path.basename(root)
                    entries.append((os.path.join(root, f), label))
        self.labels = sorted({lab for _, lab in entries})
        idx = {lab: i for i, lab in enumerate(self.labels)}
        entries.sort(key=lambda e: (e[1], e[0]))
        self._files = [(p, idx[lab]) for p, lab in entries]
        self.reset()
        return self

    def reset(self):
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._files)

    def _decode(self, path: str) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as im:
            im = im.convert("L" if self.channels == 1 else "RGB")
            im = im.resize((self.width, self.height), Image.BILINEAR)
            arr = np.asarray(im, np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr

    def next_record(self):
        path, label = self._files[self._pos]
        self._pos += 1
        return [self._decode(path), label]

    def next_record_with_meta(self):
        idx = self._pos
        path, _ = self._files[idx]
        rec = self.next_record()
        return rec, RecordMetaData(index=idx, uri=path,
                                   reader_class=type(self).__name__)

    def _record_at(self, index):
        path, label = self._files[index]
        return [self._decode(path), label]


class SequenceRecordReader:
    """SPI: iterate sequences (lists of records), with the same metadata
    face as RecordReader (``SequenceRecordReader.nextSequence()`` /
    ``loadSequenceFromMetaData``)."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_sequence(self) -> List[Record]:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def _meta_uri(self) -> Optional[str]:
        paths = getattr(self, "_paths", None)
        return paths[0] if paths else None

    def next_sequence_with_meta(self):
        idx = int(getattr(self, "_pos", -1))
        return self.next_sequence(), RecordMetaData(
            index=idx, uri=self._meta_uri(),
            reader_class=type(self).__name__)

    def _sequence_at(self, index: int) -> List[Record]:
        raise NotImplementedError(
            f"{type(self).__name__} does not support loadSequenceFromMetaData")

    def load_sequence_from_meta_data(self, metas):
        if isinstance(metas, RecordMetaData):
            metas = [metas]
        return [self._sequence_at(m.index) for m in metas]

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_sequence()


class CollectionSequenceRecordReader(SequenceRecordReader):
    def __init__(self, sequences: Sequence[Sequence[Record]]):
        self._seqs = [[list(r) for r in s] for s in sequences]
        self.reset()

    def reset(self):
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._seqs)

    def next_sequence(self):
        s = self._seqs[self._pos]
        self._pos += 1
        return [list(r) for r in s]

    def _sequence_at(self, index):
        return [list(r) for r in self._seqs[index]]


class CSVSequenceRecordReader(SequenceRecordReader):
    """One sequence per file (DataVec CSVSequenceRecordReader): each line of a
    file is one time step."""

    def __init__(self, path: Union[str, Sequence[str]], skip_lines: int = 0,
                 delimiter: str = ","):
        self._paths = _expand_paths(path)
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self.reset()

    def reset(self):
        self._pos = 0

    def has_next(self):
        return self._pos < len(self._paths)

    def next_sequence(self):
        seq = self._sequence_at(self._pos)
        self._pos += 1
        return seq

    def next_sequence_with_meta(self):
        idx = self._pos
        return self.next_sequence(), RecordMetaData(
            index=idx, uri=self._paths[idx],
            reader_class=type(self).__name__)

    def _sequence_at(self, index):
        seq = []
        with open(self._paths[index], "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                if i < self.skip_lines:
                    continue
                line = line.strip()
                if line:
                    seq.append([_parse_field(v)
                                for v in line.split(self.delimiter)])
        return seq


def _expand_paths(path: Union[str, Sequence[str]]) -> List[str]:
    if isinstance(path, (list, tuple)):
        return [str(p) for p in path]
    path = str(path)
    if os.path.isdir(path):
        return sorted(os.path.join(path, f) for f in os.listdir(path)
                      if os.path.isfile(os.path.join(path, f)))
    if any(c in path for c in "*?["):
        return sorted(_glob.glob(path))
    return [path]


def _parse_field(v: str):
    v = v.strip()
    try:
        return float(v)
    except ValueError:
        return v


# --------------------------------------------------------------------------
# record → DataSet bridge
# --------------------------------------------------------------------------
class RecordReaderDataSetIterator(DataSetIterator):
    """Batches records into DataSets (`RecordReaderDataSetIterator.java:86`).

    - classification: ``label_index`` holds an integer class, one-hot encoded
      to ``num_possible_labels`` outputs;
    - regression: label columns ``label_index..label_index_to`` inclusive
      (``.regression(from, to)`` builder in the reference);
    - ``label_index < 0``: features-only DataSets (labels == features, the
      autoencoder convention).
    """

    def __init__(self, record_reader: RecordReader, batch_size: int,
                 label_index: int = -1, num_possible_labels: int = -1,
                 label_index_to: int = -1, regression: bool = False,
                 max_num_batches: int = -1, preprocessor=None,
                 collect_meta_data: bool = False):
        self.reader = record_reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.label_index_to = label_index_to if label_index_to >= 0 else label_index
        self.num_possible_labels = num_possible_labels
        self.regression = regression
        self.max_num_batches = max_num_batches
        self.preprocessor = preprocessor
        # setCollectMetaData(true) parity: emitted DataSets carry per-example
        # RecordMetaData, the source Evaluation's error drilldown reads
        self.collect_meta_data = collect_meta_data
        if regression and label_index >= 0 and num_possible_labels > 0:
            raise ValueError("regression=True is incompatible with "
                             "num_possible_labels (one-hot classification)")

    def reset(self):
        self.reader.reset()

    def _split(self, rec: Record):
        # tensor-valued records (ImageRecordReader: [array, label]) pass
        # the array through as the feature block (NDArrayWritable role)
        if rec and isinstance(rec[0], np.ndarray) and rec[0].ndim > 1:
            f = np.asarray(rec[0], np.float32)
            if self.label_index < 0:
                return f, f
            cls = int(float(rec[self.label_index]))
            if self.regression:
                return f, np.asarray([float(rec[i]) for i in
                                      range(self.label_index,
                                            self.label_index_to + 1)],
                                     np.float32)
            if not 0 <= cls < self.num_possible_labels:
                raise ValueError(
                    f"Label {cls} outside [0, {self.num_possible_labels})")
            l = np.zeros(self.num_possible_labels, np.float32)
            l[cls] = 1.0
            return f, l
        if self.label_index < 0:
            f = np.asarray([float(v) for v in rec], np.float32)
            return f, f
        lo, hi = self.label_index, self.label_index_to
        feats = [float(v) for i, v in enumerate(rec) if not lo <= i <= hi]
        f = np.asarray(feats, np.float32)
        if self.regression:
            l = np.asarray([float(rec[i]) for i in range(lo, hi + 1)], np.float32)
        else:
            cls = int(float(rec[self.label_index]))
            if not 0 <= cls < self.num_possible_labels:
                raise ValueError(
                    f"Label {cls} outside [0, {self.num_possible_labels})")
            l = np.zeros(self.num_possible_labels, np.float32)
            l[cls] = 1.0
        return f, l

    def __iter__(self):
        self.reset()
        batches = 0
        feats, labels, metas = [], [], []
        while self.reader.has_next():
            if self.collect_meta_data:
                rec, meta = self.reader.next_record_with_meta()
                metas.append(meta)
            else:
                rec = self.reader.next_record()
            f, l = self._split(rec)
            feats.append(f)
            labels.append(l)
            if len(feats) == self.batch_size:
                yield self._emit(feats, labels, metas)
                feats, labels, metas = [], [], []
                batches += 1
                if 0 < self.max_num_batches <= batches:
                    return
        if feats:
            yield self._emit(feats, labels, metas)

    def _emit(self, feats, labels, metas=()):
        ds = DataSet(np.stack(feats), np.stack(labels),
                     example_meta_data=list(metas) or None)
        if self.preprocessor is not None:
            from deeplearning4j_tpu_torch.datasets.dataset import apply_preprocessor
            ds = apply_preprocessor(self.preprocessor, ds)
        return ds

    def load_from_meta_data(self, metas) -> DataSet:
        """Rebuild a DataSet from recorded metadata
        (``RecordReaderDataSetIterator.loadFromMetaData``) — fetches the
        original records and re-applies the feature/label split."""
        if isinstance(metas, RecordMetaData):
            metas = [metas]
        recs = self.reader.load_from_meta_data(metas)
        feats, labels = zip(*(self._split(r) for r in recs))
        return self._emit(list(feats), list(labels), metas)


class AlignmentMode:
    """Sequence alignment for two-reader iteration
    (SequenceRecordReaderDataSetIterator.AlignmentMode)."""

    EQUAL_LENGTH = "equal_length"
    ALIGN_START = "align_start"
    ALIGN_END = "align_end"


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Sequence records → padded+masked [N, T, C] DataSets
    (`SequenceRecordReaderDataSetIterator.java`).

    One reader: label column inside each time-step record. Two readers:
    features and labels read separately, aligned per AlignmentMode (padding +
    masks make every batch rectangular — the jit-friendly encoding of ragged
    sequences).
    """

    def __init__(self, features_reader: SequenceRecordReader, batch_size: int,
                 num_possible_labels: int = -1, label_index: int = -1,
                 regression: bool = False,
                 labels_reader: Optional[SequenceRecordReader] = None,
                 alignment_mode: str = AlignmentMode.ALIGN_START,
                 collect_meta_data: bool = False):
        self.features_reader = features_reader
        self.labels_reader = labels_reader
        self.batch_size = batch_size
        self.num_possible_labels = num_possible_labels
        self.label_index = label_index
        self.regression = regression
        self.alignment_mode = alignment_mode
        self.collect_meta_data = collect_meta_data

    def reset(self):
        self.features_reader.reset()
        if self.labels_reader is not None:
            self.labels_reader.reset()

    def _one_hot(self, v) -> np.ndarray:
        cls = int(float(v))
        if not 0 <= cls < self.num_possible_labels:
            raise ValueError(f"Label {cls} outside [0, {self.num_possible_labels})")
        out = np.zeros(self.num_possible_labels, np.float32)
        out[cls] = 1.0
        return out

    def __iter__(self):
        self.reset()
        fs, ls, metas = [], [], []
        lab_iter = iter(self.labels_reader) if self.labels_reader is not None else None
        while self.features_reader.has_next():
            if self.collect_meta_data:
                seq, meta = self.features_reader.next_sequence_with_meta()
                metas.append(meta)
            else:
                seq = self.features_reader.next_sequence()
            if lab_iter is not None:
                try:
                    lseq = next(lab_iter)
                except StopIteration:
                    raise ValueError(
                        "labels reader exhausted before features reader: "
                        "sequence counts differ") from None
                f = np.asarray([[float(v) for v in r] for r in seq], np.float32)
                if self.regression:
                    l = np.asarray([[float(v) for v in r] for r in lseq], np.float32)
                else:
                    l = np.stack([self._one_hot(r[0]) for r in lseq])
            else:
                idx = self.label_index
                f = np.asarray([[float(v) for i, v in enumerate(r) if i != idx]
                                for r in seq], np.float32)
                if self.regression:
                    l = np.asarray([[float(r[idx])] for r in seq], np.float32)
                else:
                    l = np.stack([self._one_hot(r[idx]) for r in seq])
            fs.append(f)
            ls.append(l)
            if len(fs) == self.batch_size:
                yield self._emit(fs, ls, metas)
                fs, ls, metas = [], [], []
        if fs:
            yield self._emit(fs, ls, metas)

    def _emit(self, fs, ls, metas=()):
        n = len(fs)
        tf = max(f.shape[0] for f in fs)
        tl = max(l.shape[0] for l in ls)
        t = max(tf, tl)
        fdim, ldim = fs[0].shape[1], ls[0].shape[1]
        x = np.zeros((n, t, fdim), np.float32)
        y = np.zeros((n, t, ldim), np.float32)
        fm = np.zeros((n, t), np.float32)
        lm = np.zeros((n, t), np.float32)
        for i, (f, l) in enumerate(zip(fs, ls)):
            if self.alignment_mode == AlignmentMode.ALIGN_END:
                fo, lo = t - f.shape[0], t - l.shape[0]
            else:
                if (self.alignment_mode == AlignmentMode.EQUAL_LENGTH
                        and f.shape[0] != l.shape[0]):
                    raise ValueError(
                        f"EQUAL_LENGTH alignment but lengths differ: "
                        f"{f.shape[0]} vs {l.shape[0]}")
                fo, lo = 0, 0
            x[i, fo:fo + f.shape[0]] = f
            fm[i, fo:fo + f.shape[0]] = 1.0
            y[i, lo:lo + l.shape[0]] = l
            lm[i, lo:lo + l.shape[0]] = 1.0
        all_f = bool(np.all(fm == 1.0))
        all_l = bool(np.all(lm == 1.0))
        return DataSet(x, y, None if all_f else fm, None if all_l else lm,
                       example_meta_data=list(metas) or None)


class RecordReaderMultiDataSetIterator:
    """Multiple named readers → MultiDataSet (builder-style API of
    `RecordReaderMultiDataSetIterator.java`): declare which column ranges of
    which reader become which input/output arrays."""

    class Builder:
        def __init__(self, batch_size: int):
            self.batch_size = batch_size
            self._readers = {}
            self._inputs = []   # (reader_name, col_from, col_to)
            self._outputs = []  # (reader_name, col_from, col_to, one_hot_n)

        def add_reader(self, name: str, reader: RecordReader) -> "RecordReaderMultiDataSetIterator.Builder":
            self._readers[name] = reader
            return self

        def add_input(self, name: str, col_from: int = 0,
                      col_to: int = -1) -> "RecordReaderMultiDataSetIterator.Builder":
            self._inputs.append((name, col_from, col_to))
            return self

        def add_output(self, name: str, col_from: int = 0,
                       col_to: int = -1) -> "RecordReaderMultiDataSetIterator.Builder":
            self._outputs.append((name, col_from, col_to, -1))
            return self

        def add_output_one_hot(self, name: str, column: int,
                               num_classes: int) -> "RecordReaderMultiDataSetIterator.Builder":
            self._outputs.append((name, column, column, num_classes))
            return self

        def build(self) -> "RecordReaderMultiDataSetIterator":
            return RecordReaderMultiDataSetIterator(self)

    def __init__(self, builder: "RecordReaderMultiDataSetIterator.Builder"):
        self._b = builder
        for name, *_ in builder._inputs + [o[:3] for o in builder._outputs]:
            if name not in builder._readers:
                raise ValueError(f"No reader named {name!r}")

    def reset(self):
        for r in self._b._readers.values():
            r.reset()

    def __iter__(self):
        self.reset()
        b = self._b
        names = list(b._readers)
        iters = {n: iter(b._readers[n]) for n in names}
        while True:
            rows = {n: [] for n in names}
            exhausted = False
            for _ in range(b.batch_size):
                # one record from EVERY reader per row (all-or-nothing, so
                # readers can never go out of alignment mid-batch)
                rec_per = {}
                for n in names:
                    try:
                        rec_per[n] = next(iters[n])
                    except StopIteration:
                        exhausted = True
                        break
                if exhausted:
                    break
                for n in names:
                    rows[n].append(rec_per[n])
            if rows[names[0]]:
                yield self._emit(rows)
            if exhausted:
                return

    def _emit(self, rows) -> MultiDataSet:
        b = self._b

        def cols(rec, lo, hi):
            hi = len(rec) - 1 if hi < 0 else hi
            return [float(v) for v in rec[lo:hi + 1]]

        features = []
        for name, lo, hi in b._inputs:
            features.append(np.asarray([cols(r, lo, hi) for r in rows[name]],
                                       np.float32))
        labels = []
        for name, lo, hi, one_hot in b._outputs:
            if one_hot > 0:
                arr = np.zeros((len(rows[name]), one_hot), np.float32)
                for i, r in enumerate(rows[name]):
                    cls = int(float(r[lo]))
                    if not 0 <= cls < one_hot:
                        raise ValueError(f"Label {cls} outside [0, {one_hot})")
                    arr[i, cls] = 1.0
            else:
                arr = np.asarray([cols(r, lo, hi) for r in rows[name]], np.float32)
            labels.append(arr)
        return MultiDataSet(features, labels)
