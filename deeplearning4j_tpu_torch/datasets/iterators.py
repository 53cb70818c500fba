"""Iterator utilities: asynchronous prefetch and composition.

Counterpart of ``deeplearning4j_tpu/datasets/iterators.py``, every class of
it: ``AsyncDataSetIterator`` (a producer thread and a bounded queue; an
error in the producer is raised again in the consumer),
``MultipleEpochsIterator``, ``EarlyTerminationDataSetIterator``,
``SamplingDataSetIterator``, ``DataSetIteratorSplitter``,
``IteratorDataSetIterator``, ``INDArrayDataSetIterator``, the shields,
callbacks and pre-processors.

The device stage is :func:`device_put_batch`. On a CUDA device the
producer thread copies each array into pinned host memory and starts its
copy to the card on a copy stream of its own (``non_blocking``), then
records an event; the consumer (the training thread) makes its current
stream wait for that event and marks every tensor as used on that stream
(``record_stream``), so the caching allocator cannot hand the memory out
again while the copy or the step still uses it. Batch N+1 thus crosses
to the card while the card runs batch N. Nothing falls back: a batch that
cannot be pinned, or a copy stream that cannot start, raises. On the CPU
the stage only turns arrays into tensors. :data:`COPY_STATS` counts the
batches that reached the consumer, those whose host memory was pinned
and those copied on a stream other than the default one.
"""

from __future__ import annotations

import copy
import glob
import os
import queue
import threading
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.datasets.dataset import (
    DataSet,
    DataSetIterator,
    MultiDataSet,
    apply_preprocessor,
)

#: batches handed to a consumer by :func:`finish_device_put`: all of them,
#: those whose host memory was pinned, those copied on a side stream
COPY_STATS = {"batches": 0, "pinned": 0, "side_stream": 0}

_copy_streams: dict = {}
_streams_lock = threading.Lock()


class DeviceCopy:
    """A batch's copy to the card: the pinned host tensors it was read
    from, the stream it ran on and the event recorded after it."""

    def __init__(self, device, stream, event, host):
        self.device = device
        self.stream = stream
        self.event = event
        self.host = host
        self.waited = False


def _map_arrays(ds, fn):
    """A shallow copy of a DataSet or MultiDataSet with ``fn`` applied to
    each of its arrays (features, labels and the masks that are set)."""
    out = copy.copy(ds)
    if isinstance(ds, MultiDataSet) or hasattr(ds, "features_masks"):
        out.features = [fn(f) for f in ds.features]
        out.labels = [fn(l) for l in ds.labels]
        if ds.features_masks is not None:
            out.features_masks = [None if m is None else fn(m)
                                  for m in ds.features_masks]
        if ds.labels_masks is not None:
            out.labels_masks = [None if m is None else fn(m)
                                for m in ds.labels_masks]
        return out
    out.features = fn(ds.features)
    out.labels = fn(ds.labels)
    if ds.features_mask is not None:
        out.features_mask = fn(ds.features_mask)
    if ds.labels_mask is not None:
        out.labels_mask = fn(ds.labels_mask)
    return out


def _tensors(ds) -> List[torch.Tensor]:
    if isinstance(ds, MultiDataSet) or hasattr(ds, "features_masks"):
        arrays = (ds.features + ds.labels + (ds.features_masks or [])
                  + (ds.labels_masks or []))
    else:
        arrays = [ds.features, ds.labels, ds.features_mask, ds.labels_mask]
    return [a for a in arrays if isinstance(a, torch.Tensor)]


def _copy_stream(device: torch.device):
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _streams_lock:
        if index not in _copy_streams:
            _copy_streams[index] = torch.cuda.Stream(device=index)
        return _copy_streams[index]


def _host_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


def device_put_batch(ds, device):
    """One DataSet/MultiDataSet with its arrays on ``device``: on the CPU
    as tensors; on a CUDA device pinned, then copied on the device's copy
    stream (see the module docstring), with the copy's
    :class:`DeviceCopy` in ``device_copy``. The consumer calls
    :func:`finish_device_put` before using the tensors."""
    device = torch.device(device)
    if device.type != "cuda":
        return _map_arrays(ds, _host_tensor)
    stream = _copy_stream(device)
    host: List[torch.Tensor] = []

    def put(a):
        t = _host_tensor(a)
        if t.is_cuda:
            return t
        if not t.is_pinned():
            t = t.pin_memory()  # raises when memory cannot be pinned
        host.append(t)
        return t.to(device, non_blocking=True)

    with torch.cuda.device(device), torch.cuda.stream(stream):
        out = _map_arrays(ds, put)
        event = torch.cuda.Event()
        event.record(stream)
    out.device_copy = DeviceCopy(device, stream, event, host)
    return out


def finish_device_put(ds):
    """Make a batch from :func:`device_put_batch` safe to use on the
    calling thread's current stream: that stream waits for the copy's
    event, and every tensor is recorded as used on it. Counts the batch
    in :data:`COPY_STATS`. A batch with no pending copy passes as it is."""
    dc = getattr(ds, "device_copy", None)
    if dc is None or dc.waited:
        return ds
    current = torch.cuda.current_stream(dc.device)
    current.wait_event(dc.event)
    for t in _tensors(ds):
        if t.is_cuda:
            t.record_stream(current)
    dc.waited = True
    COPY_STATS["batches"] += 1
    COPY_STATS["pinned"] += int(all(h.is_pinned() for h in dc.host))
    COPY_STATS["side_stream"] += int(
        dc.stream.cuda_stream != torch.cuda.default_stream(dc.device).cuda_stream)
    return ds


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch (``AsyncDataSetIterator.java``): a
    producer thread runs the base iterator and ``device_put`` into a queue
    of ``queue_size`` batches; the consumer finishes each batch's copy
    (:func:`finish_device_put`) before it yields it. An error in the
    producer is raised in the consumer; a consumer that stops early stops
    and joins the producer."""

    _END = object()

    def __init__(self, base, queue_size: int = 2,
                 device_put: Optional[Callable] = None):
        self.base = base
        self.queue_size = max(1, queue_size)
        self.device_put = device_put

    def reset(self) -> None:
        # plain lists and generators have no reset; fit re-iterates them
        if hasattr(self.base, "reset"):
            self.base.reset()

    def __iter__(self) -> Iterator[DataSet]:
        q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)
        err: List[BaseException] = []
        stop = threading.Event()

        def put_unless_stopped(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for ds in self.base:
                    if self.device_put is not None:
                        ds = self.device_put(ds)
                    if not put_unless_stopped(ds):
                        return
            except BaseException as e:  # raised again in the consumer
                err.append(e)
            finally:
                put_unless_stopped(self._END)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._END:
                    break
                yield finish_device_put(item)
        finally:
            stop.set()
            t.join()
        if err:
            raise err[0]


class AsyncMultiDataSetIterator(AsyncDataSetIterator):
    """The same prefetch for MultiDataSet streams."""


def wrap_for_prefetch(iterator, prefetch_depth, device=None):
    """A fit data source wrapped in asynchronous host-to-device prefetch
    (``prefetch_depth`` queue slots, default 2; its batches put on
    ``device``, ``cuda`` unless the caller passes ``"cpu"``, by
    :func:`device_put_batch`). Returned unchanged, as the reference does, when the
    depth is <= 0, when it is a list of at most one batch, when it already
    is an :class:`AsyncDataSetIterator`, or when it opts out with
    ``async_supported = False`` (:class:`AsyncShieldDataSetIterator`)."""
    depth = 2 if prefetch_depth is None else int(prefetch_depth)
    if depth <= 0:
        return iterator
    if isinstance(iterator, AsyncDataSetIterator):
        return iterator  # the caller chose its own prefetch
    if not getattr(iterator, "async_supported", True):
        return iterator
    if isinstance(iterator, (list, tuple)) and len(iterator) <= 1:
        return iterator  # nothing to overlap with
    dev = resolve_device(device)
    return AsyncDataSetIterator(iterator, queue_size=depth,
                                device_put=lambda ds: device_put_batch(ds, dev))


class MultipleEpochsIterator(DataSetIterator):
    """Replays the base iterator N times as one pass."""

    def __init__(self, base, n_epochs: int):
        self.base = base
        self.n_epochs = n_epochs

    def reset(self) -> None:
        self.base.reset()

    def __iter__(self) -> Iterator[DataSet]:
        for e in range(self.n_epochs):
            if e > 0:
                self.base.reset()
            yield from self.base


class EarlyTerminationDataSetIterator(DataSetIterator):
    """Caps the number of minibatches a pass."""

    def __init__(self, base, max_minibatches: int):
        if max_minibatches <= 0:
            raise ValueError("max_minibatches must be > 0")
        self.base = base
        self.max_minibatches = max_minibatches

    def reset(self) -> None:
        self.base.reset()

    def __iter__(self) -> Iterator[DataSet]:
        for i, ds in enumerate(self.base):
            if i >= self.max_minibatches:
                break
            yield ds


class SamplingDataSetIterator(DataSetIterator):
    """Random with-replacement sampling of a DataSet."""

    def __init__(self, data: DataSet, batch_size: int, total_batches: int,
                 seed: int = 0):
        self.data = data
        self.batch_size = batch_size
        self.total_batches = total_batches
        self.seed = seed
        self._epoch = 0

    def reset(self) -> None:
        self._epoch += 1

    def __iter__(self) -> Iterator[DataSet]:
        rng = np.random.default_rng(self.seed + self._epoch)
        f = np.asarray(self.data.features)
        l = np.asarray(self.data.labels)
        n = f.shape[0]
        for _ in range(self.total_batches):
            idx = rng.integers(0, n, size=self.batch_size)
            yield DataSet(f[idx], l[idx])


class DataSetIteratorSplitter:
    """Splits one iterator's stream into train and test parts: the first
    ``ratio`` of ``total_batches`` train, the rest test. The window is
    read from ONE pass of the base and shared by both parts, so a
    shuffling base cannot leak test batches into train across resets."""

    def __init__(self, base, total_batches: int, ratio: float):
        self.base = base
        self.total_batches = total_batches
        self.n_train = int(total_batches * ratio)
        self._window: Optional[List[DataSet]] = None

    def _batches(self) -> List[DataSet]:
        if self._window is None:
            w: List[DataSet] = []
            for i, ds in enumerate(self.base):
                if i >= self.total_batches:
                    break
                w.append(ds)
            self._window = w
        return self._window

    @property
    def train(self) -> DataSetIterator:
        return _SplitPart(self, 0, self.n_train)

    @property
    def test(self) -> DataSetIterator:
        return _SplitPart(self, self.n_train, self.total_batches)


class _SplitPart(DataSetIterator):
    def __init__(self, splitter: DataSetIteratorSplitter, start: int, end: int):
        self.splitter = splitter
        self.start, self.end = start, end

    def reset(self) -> None:
        pass  # replays the shared window

    def __iter__(self) -> Iterator[DataSet]:
        yield from self.splitter._batches()[self.start:self.end]


class IteratorDataSetIterator(DataSetIterator):
    """Re-batches a stream of small DataSets into ``batch_size`` examples."""

    def __init__(self, base, batch_size: int):
        self.base = base
        self.batch_size = batch_size

    def reset(self) -> None:
        self.base.reset()

    def __iter__(self) -> Iterator[DataSet]:
        buf: List[DataSet] = []
        count = 0
        for ds in self.base:
            buf.append(ds)
            count += ds.num_examples()
            if count >= self.batch_size:
                yield DataSet.merge(buf)
                buf, count = [], 0
        if buf:
            yield DataSet.merge(buf)


class INDArrayDataSetIterator(DataSetIterator):
    """Iterates (features, labels) array pairs in batches."""

    def __init__(self, pairs: Sequence, batch_size: int):
        self.pairs = list(pairs)
        self.batch_size = batch_size

    def reset(self) -> None:
        pass

    def __iter__(self) -> Iterator[DataSet]:
        buf_f, buf_l, count = [], [], 0
        for f, l in self.pairs:
            f = np.atleast_2d(np.asarray(f))
            l = np.atleast_2d(np.asarray(l))
            buf_f.append(f)
            buf_l.append(l)
            count += f.shape[0]
            if count >= self.batch_size:
                yield DataSet(np.concatenate(buf_f), np.concatenate(buf_l))
                buf_f, buf_l, count = [], [], 0
        if buf_f:
            yield DataSet(np.concatenate(buf_f), np.concatenate(buf_l))


class ExistingDataSetIterator(DataSetIterator):
    """The DataSetIterator surface over a list of DataSets or a factory of
    iterables, with an optional cap of ``total`` batches."""

    def __init__(self, iterable, total: Optional[int] = None):
        self._factory = iterable if callable(iterable) else None
        self._items = None if callable(iterable) else list(iterable)
        self.total = total

    def reset(self) -> None:
        pass

    def __iter__(self) -> Iterator[DataSet]:
        source = self._factory() if self._factory is not None else self._items
        for i, ds in enumerate(source):
            if self.total is not None and i >= self.total:
                return
            yield ds


class ViewIterator(DataSetIterator):
    """Batched views of one DataSet, in order."""

    def __init__(self, data: DataSet, batch_size: int):
        self.data = data
        self.batch_size = batch_size

    def reset(self) -> None:
        pass

    def __iter__(self) -> Iterator[DataSet]:
        n = self.data.num_examples()
        f = np.asarray(self.data.features)
        l = np.asarray(self.data.labels)
        fm = None if self.data.features_mask is None else np.asarray(self.data.features_mask)
        lm = None if self.data.labels_mask is None else np.asarray(self.data.labels_mask)
        for s in range(0, n, self.batch_size):
            e = s + self.batch_size
            yield DataSet(f[s:e], l[s:e],
                          None if fm is None else fm[s:e],
                          None if lm is None else lm[s:e])


class FileSplitDataSetIterator(DataSetIterator):
    """DataSets read from the ``.npz`` files of a directory (features,
    labels and the masks they hold), with an optional callback for each."""

    def __init__(self, directory: str, pattern: str = "*.npz",
                 callback=None):
        self.files = sorted(glob.glob(os.path.join(directory, pattern)))
        self.callback = callback

    def reset(self) -> None:
        pass

    def __iter__(self) -> Iterator[DataSet]:
        for path in self.files:
            z = np.load(path)
            ds = DataSet(z["features"], z["labels"],
                         z["features_mask"] if "features_mask" in z else None,
                         z["labels_mask"] if "labels_mask" in z else None)
            if self.callback is not None:
                self.callback.call(ds)
            yield ds


class DataSetCallback:
    """A hook run on each DataSet."""

    def call(self, ds: DataSet) -> None:  # pragma: no cover - interface
        pass


class DefaultCallback(DataSetCallback):
    """Moves each DataSet's arrays (masks included) onto ``device``
    (``cuda`` unless the caller passes ``"cpu"``), in place, through
    :func:`device_put_batch`; the copy is finished on the calling
    thread's current stream."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def call(self, ds: DataSet) -> None:
        moved = finish_device_put(device_put_batch(ds, self.device))
        ds.features, ds.labels = moved.features, moved.labels
        ds.features_mask, ds.labels_mask = moved.features_mask, moved.labels_mask


class AsyncShieldDataSetIterator(DataSetIterator):
    """A pass-through that refuses asynchronous prefetch
    (``async_supported = False``)."""

    async_supported = False

    def __init__(self, base):
        self.base = base

    def reset(self) -> None:
        self.base.reset()

    def __iter__(self) -> Iterator[DataSet]:
        return iter(self.base)


class AsyncShieldMultiDataSetIterator(AsyncShieldDataSetIterator):
    """MultiDataSet variant."""


class EarlyTerminationMultiDataSetIterator(EarlyTerminationDataSetIterator):
    """MultiDataSet variant: the same truncation."""


class JointParallelDataSetIterator(DataSetIterator):
    """Interleaves several iterators round-robin; stops at the first one
    exhausted, or drains the others."""

    def __init__(self, *iterators, stop_on_first_exhausted: bool = True):
        self.iterators = list(iterators)
        self.stop_on_first_exhausted = stop_on_first_exhausted

    def reset(self) -> None:
        for it in self.iterators:
            it.reset()

    def __iter__(self) -> Iterator[DataSet]:
        its = [iter(i) for i in self.iterators]
        active = [True] * len(its)
        while any(active):
            for k, it in enumerate(its):
                if not active[k]:
                    continue
                try:
                    yield next(it)
                except StopIteration:
                    active[k] = False
                    if self.stop_on_first_exhausted:
                        return


class DoublesDataSetIterator(INDArrayDataSetIterator):
    """(features, labels) pairs of float sequences, as float64 arrays."""

    def __init__(self, pairs: Sequence, batch_size: int):
        super().__init__([(np.asarray(f, np.float64), np.asarray(l, np.float64))
                          for f, l in pairs], batch_size)


class FloatsDataSetIterator(INDArrayDataSetIterator):
    """(features, labels) pairs of float sequences, as float32 arrays."""

    def __init__(self, pairs: Sequence, batch_size: int):
        super().__init__([(np.asarray(f, np.float32), np.asarray(l, np.float32))
                          for f, l in pairs], batch_size)


class ReconstructionDataSetIterator(DataSetIterator):
    """Labels are the features (the autoencoder's wrapper)."""

    def __init__(self, base):
        self.base = base

    def reset(self) -> None:
        if hasattr(self.base, "reset"):
            self.base.reset()

    def __iter__(self) -> Iterator[DataSet]:
        for ds in self.base:
            yield DataSet(ds.features, ds.features, ds.features_mask,
                          ds.features_mask)


class IteratorMultiDataSetIterator:
    """Re-batches a stream of MultiDataSets into ``batch_size`` examples."""

    def __init__(self, source, batch_size: int):
        self._items = list(source)
        self.batch_size = batch_size

    def reset(self) -> None:
        pass

    def __iter__(self):
        buf, count = [], 0
        for mds in self._items:
            buf.append(mds)
            count += int(np.asarray(mds.features[0]).shape[0])
            if count >= self.batch_size:
                yield _merge_mds(buf)
                buf, count = [], 0
        if buf:
            yield _merge_mds(buf)


def _merge_mds(items):
    n_f = len(items[0].features)
    n_l = len(items[0].labels)
    feats = [np.concatenate([np.asarray(m.features[i]) for m in items])
             for i in range(n_f)]
    labels = [np.concatenate([np.asarray(m.labels[i]) for m in items])
              for i in range(n_l)]
    return MultiDataSet(feats, labels)


class MultiDataSetWrapperIterator(DataSetIterator):
    """A single-input, single-output MultiDataSet iterator seen as a
    DataSetIterator."""

    def __init__(self, base):
        self.base = base

    def reset(self) -> None:
        if hasattr(self.base, "reset"):
            self.base.reset()

    def __iter__(self) -> Iterator[DataSet]:
        for mds in self.base:
            if len(mds.features) != 1 or len(mds.labels) != 1:
                raise ValueError(
                    "MultiDataSetWrapperIterator requires single-input/"
                    f"single-output MultiDataSets (got {len(mds.features)} "
                    f"inputs, {len(mds.labels)} outputs)")
            fm = (None if mds.features_masks is None
                  else mds.features_masks[0])
            lm = None if mds.labels_masks is None else mds.labels_masks[0]
            yield DataSet(mds.features[0], mds.labels[0], fm, lm)


class DummyPreProcessor:
    """A pre-processor that does nothing."""

    def preprocess(self, ds) -> None:
        return None


class CombinedPreProcessor:
    """Pre-processors and normalizers applied in order, whichever face
    each has (a mutating ``preprocess`` or a returning ``transform``);
    returns the final DataSet."""

    def __init__(self, *preprocessors):
        self.preprocessors = list(preprocessors)

    def preprocess(self, ds):
        for p in self.preprocessors:
            ds = apply_preprocessor(p, ds)
        return ds
