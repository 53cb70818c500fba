"""Python face of the native prefetching loader.

A DataSetIterator whose batch assembly (shuffled gather, one-hot, [0,1]
normalization for IDX images) runs in C++ worker threads outside the GIL —
the AsyncDataSetIterator role with the heavy work off the training thread.
Falls back to numpy assembly when the native library is unavailable.

The port's copy of the JAX package's jax-free ``native/loader.py``:
``NativeDataSetIterator`` yields the port's ``DataSet``; the IDX parser of
the fallback is copied in.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, DataSetIterator


class NativeDataSetIterator(DataSetIterator):
    """Iterate DataSets assembled by the native loader.

    Construct with in-memory arrays (``features``/``labels``) or IDX files
    (``images_path``/``labels_path`` + ``n_classes`` — the MNIST container
    the reference's MnistDataFetcher parses).
    """

    def __init__(self, features=None, labels=None, *,
                 images_path: Optional[str] = None,
                 labels_path: Optional[str] = None,
                 n_classes: int = 10, batch_size: int = 32,
                 shuffle: bool = False, seed: int = 0, prefetch: int = 3,
                 n_threads: int = 2, drop_last: bool = False,
                 feature_shape: Optional[Tuple[int, ...]] = None):
        from deeplearning4j_tpu_torch import native as _n

        self.batch_size = int(batch_size)
        self._lib = _n._load()
        self._handle = None
        self._feature_shape = feature_shape
        if images_path is not None:
            if self._lib is not None:
                self._handle = self._lib.loader_create_idx(
                    images_path.encode(), labels_path.encode(), n_classes,
                    self.batch_size, int(shuffle), seed, prefetch, n_threads,
                    int(drop_last))
                if not self._handle:
                    raise ValueError(
                        f"Failed to parse IDX files: {images_path}, {labels_path}")
                self._n = self._lib.loader_num_examples(self._handle)
                self._x_elems = self._lib.loader_x_elems(self._handle)
                self._y_elems = self._lib.loader_y_elems(self._handle)
                if feature_shape is None:
                    side = int(round(self._x_elems ** 0.5))
                    if side * side == self._x_elems:
                        self._feature_shape = (side, side, 1)
                return
            # fallback: parse IDX in Python
            features, labels = _parse_idx(images_path, labels_path, n_classes)
        self._x = np.ascontiguousarray(
            np.asarray(features, np.float32).reshape(len(features), -1))
        self._y = np.ascontiguousarray(
            np.asarray(labels, np.float32).reshape(len(labels), -1))
        self._n = self._x.shape[0]
        self._x_elems = self._x.shape[1]
        self._y_elems = self._y.shape[1]
        if feature_shape is None and np.asarray(features).ndim > 2:
            self._feature_shape = tuple(np.asarray(features).shape[1:])
        if self._lib is not None:
            self._handle = self._lib.loader_create_mem(
                self._x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self._y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self._n, self._x_elems, self._y_elems, self.batch_size,
                int(shuffle), seed, prefetch, n_threads, int(drop_last))
        else:
            self._shuffle = shuffle
            self._seed = seed
            self._drop_last = drop_last
            self._epoch = 0

    # -- iteration -------------------------------------------------------
    def num_examples(self) -> int:
        return int(self._n)

    def reset(self) -> None:
        if self._handle is not None:
            self._lib.loader_reset(self._handle)
        else:
            self._epoch += 1

    def __iter__(self):
        if self._handle is not None:
            # re-arm the SAME epoch up front: every fresh iter() starts from
            # batch 0 with the same order (Python-fallback semantics) even
            # when an earlier iteration was abandoned mid-epoch and its
            # generator has not been finalized yet; reset() is what advances
            # the shuffle epoch
            self._lib.loader_rewind(self._handle)
            xbuf = np.empty((self.batch_size, self._x_elems), np.float32)
            ybuf = np.empty((self.batch_size, self._y_elems), np.float32)
            while True:
                got = self._lib.loader_next(
                    self._handle,
                    xbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    ybuf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
                if got == 0:
                    return
                yield self._emit(xbuf[:got].copy(), ybuf[:got].copy())
        else:
            order = np.arange(self._n)
            if self._shuffle:
                np.random.default_rng(self._seed + self._epoch).shuffle(order)
            end = (self._n - self._n % self.batch_size
                   if self._drop_last else self._n)
            for s in range(0, end, self.batch_size):
                sel = order[s:s + self.batch_size]
                yield self._emit(self._x[sel], self._y[sel])

    def _emit(self, x: np.ndarray, y: np.ndarray) -> DataSet:
        if self._feature_shape is not None:
            x = x.reshape((x.shape[0],) + tuple(self._feature_shape))
        return DataSet(x, y)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle is not None and self._lib is not None:
            self._lib.loader_destroy(handle)
            self._handle = None


def _read_idx(path) -> np.ndarray:
    """Parse an IDX file (optionally gzipped) — the MNIST/EMNIST format (a
    copy of the JAX package's ``datasets/fetchers.py`` parser)."""
    import gzip
    import struct

    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), np.uint8)
    return data.reshape(dims)


def _parse_idx(images_path: str, labels_path: str, n_classes: int):
    from pathlib import Path

    imgs = _read_idx(Path(images_path))
    if imgs.ndim != 3:
        raise ValueError(f"Expected rank-3 IDX image file, got {images_path}")
    lab = _read_idx(Path(labels_path))
    if lab.ndim != 1 or len(lab) != len(imgs):
        raise ValueError(f"Bad IDX label file {labels_path}")
    x = imgs.reshape(len(imgs), -1).astype(np.float32) / 255.0
    y = np.zeros((len(lab), n_classes), np.float32)
    y[np.arange(len(lab)), lab] = 1.0
    return x, y
