"""DataSet container and iterator SPI.

Counterpart of ``deeplearning4j_tpu/datasets/dataset.py`` (a copy: the
port imports nothing of the JAX package). ND4J's ``DataSet`` (features,
labels and optional masks) and the ``DataSetIterator`` every fit loop
consumes. Host-side data stays in numpy; a network moves each batch to
its device. The arrays may also be torch tensors already on the device
(``fit`` then copies nothing).
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np


class DataSet:
    """features/labels (+ optional masks), the unit a fit step consumes."""

    def __init__(self, features, labels, features_mask=None, labels_mask=None,
                 example_meta_data=None):
        self.features = features
        self.labels = labels
        self.features_mask = features_mask
        self.labels_mask = labels_mask
        # per-example provenance (RecordMetaData list), filled by record
        # iterators with collect_meta_data=True (DataSet.getExampleMetaData)
        self.example_meta_data = example_meta_data

    def get_example_meta_data(self):
        return self.example_meta_data

    def num_examples(self) -> int:
        return int(np.shape(self.features)[0])

    def split_test_and_train(self, n_train: int):
        f = np.asarray(self.features)
        l = np.asarray(self.labels)
        return (DataSet(f[:n_train], l[:n_train]),
                DataSet(f[n_train:], l[n_train:]))

    def shuffle(self, seed: Optional[int] = None) -> None:
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.num_examples())
        self.features = np.asarray(self.features)[idx]
        self.labels = np.asarray(self.labels)[idx]
        if self.features_mask is not None:
            self.features_mask = np.asarray(self.features_mask)[idx]
        if self.labels_mask is not None:
            self.labels_mask = np.asarray(self.labels_mask)[idx]

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        f = np.concatenate([np.asarray(d.features) for d in datasets])
        l = np.concatenate([np.asarray(d.labels) for d in datasets])

        def merge_masks(masks, arrays):
            # mixed mask presence: synthesize all-ones masks (all steps valid)
            if all(m is None for m in masks):
                return None
            out = []
            for m, a in zip(masks, arrays):
                if m is None:
                    a = np.asarray(a)
                    m = np.ones(a.shape[:2] if a.ndim >= 3 else a.shape[:1],
                                np.float32)
                out.append(np.asarray(m))
            return np.concatenate(out)

        fm = merge_masks([d.features_mask for d in datasets],
                         [d.features for d in datasets])
        lm = merge_masks([d.labels_mask for d in datasets],
                         [d.labels for d in datasets])
        return DataSet(f, l, fm, lm)


def apply_preprocessor(pre, ds):
    """A DataSet pre-processor or normalizer applied, whichever face it
    has: a mutating ``preprocess``/``pre_process`` or a returning
    ``transform``; a returned copy keeps ``example_meta_data``."""
    fn = (getattr(pre, "preprocess", None)
          or getattr(pre, "pre_process", None)
          or getattr(pre, "transform", None))
    out = fn(ds)
    if out is not None:
        if getattr(out, "example_meta_data", None) is None:
            out.example_meta_data = getattr(ds, "example_meta_data", None)
        ds = out
    return ds


class MultiDataSet:
    """Multiple features/labels arrays (ComputationGraph input/output sets)."""

    def __init__(self, features: Sequence, labels: Sequence,
                 features_masks: Optional[Sequence] = None,
                 labels_masks: Optional[Sequence] = None):
        self.features = list(features)
        self.labels = list(labels)
        self.features_masks = None if features_masks is None else list(features_masks)
        self.labels_masks = None if labels_masks is None else list(labels_masks)

    def num_examples(self) -> int:
        return int(np.shape(self.features[0])[0])


def batch_nbytes(ds) -> int:
    """Payload of one batch: features/labels/masks bytes, for both
    DataSet and MultiDataSet faces (numpy arrays and tensors alike)."""
    total = 0
    if isinstance(ds, MultiDataSet):
        groups = [ds.features, ds.labels, ds.features_masks or (),
                  ds.labels_masks or ()]
        arrays = [a for g in groups for a in g]
    else:
        arrays = [ds.features, ds.labels, ds.features_mask, ds.labels_mask]
    for a in arrays:
        if a is not None:
            total += int(getattr(a, "nbytes", 0))
    return total


class DataSetIterator:
    """Iterator SPI (reset + iteration). Subclasses yield DataSet batches."""

    def reset(self) -> None:  # pragma: no cover - interface
        pass

    def __iter__(self) -> Iterator[DataSet]:  # pragma: no cover - interface
        raise NotImplementedError


class ListDataSetIterator(DataSetIterator):
    """Batches a DataSet (or list of examples) — DL4J ListDataSetIterator."""

    def __init__(self, data: DataSet, batch_size: int = 32, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False):
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def reset(self) -> None:
        self._epoch += 1

    def __iter__(self) -> Iterator[DataSet]:
        n = self.data.num_examples()
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        f = np.asarray(self.data.features)
        l = np.asarray(self.data.labels)
        fm = None if self.data.features_mask is None else np.asarray(self.data.features_mask)
        lm = None if self.data.labels_mask is None else np.asarray(self.data.labels_mask)
        for s in range(0, n, self.batch_size):
            sel = idx[s:s + self.batch_size]
            if self.drop_last and len(sel) < self.batch_size:
                break
            yield DataSet(f[sel], l[sel],
                          None if fm is None else fm[sel],
                          None if lm is None else lm[sel])
