"""Data normalizers: fit, transform and revert.

Counterpart of ``deeplearning4j_tpu/datasets/normalizers.py`` (a copy, numpy
only: the port imports nothing of the JAX package). ND4J's
``DataNormalization`` family, which model zips carry
(``util/model_serializer.py``): NormalizerStandardize (zero mean, unit
variance), NormalizerMinMaxScaler, ImagePreProcessingScaler (pixels [0,255]
to [0,1]), the zoo's VGG16ImagePreProcessor (mean-RGB subtraction),
NormalizingIterator and MultiNormalizer. The JSON is the reference's, key
for key, so either package reads the other's.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet

NORMALIZER_REGISTRY = {}


def register_normalizer(cls):
    NORMALIZER_REGISTRY[cls.__name__] = cls
    return cls


class Normalizer:
    """fit(iterator|DataSet) → transform/revert in place (DataNormalization).

    ``fit_label`` mirrors DL4J's ``DataNormalization.fitLabel(boolean)``:
    when True, ``fit`` also collects label statistics and
    ``transform``/``revert`` apply them to ``ds.labels``.
    """

    fit_label: bool = False

    def fit(self, data) -> "Normalizer":
        raise NotImplementedError

    def transform(self, ds: DataSet) -> DataSet:
        raise NotImplementedError

    def revert(self, ds: DataSet) -> DataSet:
        raise NotImplementedError

    def pre_process(self, ds: DataSet) -> DataSet:  # DL4J alias
        return self.transform(ds)

    # -- serde ---------------------------------------------------------------
    def to_dict(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_dict(d: dict) -> "Normalizer":
        cls = NORMALIZER_REGISTRY[d["@normalizer"]]
        return cls._from_dict(d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_json(s: str) -> "Normalizer":
        return Normalizer.from_dict(json.loads(s))


def _iter_datasets(data):
    if isinstance(data, DataSet):
        yield data
    else:
        if hasattr(data, "reset"):
            data.reset()
        yield from data


class _MomentAcc:
    """Streaming per-feature mean/std over [*, n]-shaped batches."""

    def __init__(self):
        self.count, self.s, self.s2 = 0, None, None

    def add(self, a):
        f = np.asarray(a, np.float64)
        f2 = f.reshape(-1, f.shape[-1]) if f.ndim > 2 else f
        if self.s is None:
            self.s = f2.sum(0)
            self.s2 = (f2 ** 2).sum(0)
        else:
            self.s += f2.sum(0)
            self.s2 += (f2 ** 2).sum(0)
        self.count += f2.shape[0]

    def finish(self, what):
        if self.count == 0:
            raise ValueError(f"nothing to fit: no {what}")
        mean = (self.s / self.count).astype(np.float32)
        var = self.s2 / self.count - (self.s / self.count) ** 2
        std = np.sqrt(np.maximum(var, 1e-12)).astype(np.float32)
        return mean, std


class _ExtremaAcc:
    """Streaming per-feature min/max over [*, n]-shaped batches."""

    def __init__(self):
        self.lo, self.hi = None, None

    def add(self, a):
        f = np.asarray(a)
        f2 = f.reshape(-1, f.shape[-1]) if f.ndim > 2 else f
        mn, mx = f2.min(0), f2.max(0)
        self.lo = mn if self.lo is None else np.minimum(self.lo, mn)
        self.hi = mx if self.hi is None else np.maximum(self.hi, mx)

    def finish(self, what):
        if self.lo is None:
            raise ValueError(f"nothing to fit: no {what}")
        return self.lo.astype(np.float32), self.hi.astype(np.float32)


@register_normalizer
class NormalizerStandardize(Normalizer):
    """Per-feature zero-mean/unit-std (NormalizerStandardize)."""

    def __init__(self):
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None
        self.fit_label = False
        self.label_mean: Optional[np.ndarray] = None
        self.label_std: Optional[np.ndarray] = None

    def fit(self, data) -> "NormalizerStandardize":
        # single streaming pass: feature and (optional) label moments
        # accumulate together, O(batch) memory
        f_acc, l_acc = _MomentAcc(), _MomentAcc()
        for ds in _iter_datasets(data):
            f_acc.add(ds.features)
            if self.fit_label and ds.labels is not None:
                l_acc.add(ds.labels)
        self.mean, self.std = f_acc.finish("features")
        if self.fit_label:
            self.label_mean, self.label_std = l_acc.finish(
                "labels (fit_label=True but no batch carried labels)")
        return self

    def transform(self, ds: DataSet) -> DataSet:
        f = (np.asarray(ds.features) - self.mean) / self.std
        labels = ds.labels
        if self.fit_label and self.label_mean is not None and labels is not None:
            labels = ((np.asarray(labels) - self.label_mean)
                      / self.label_std).astype(np.float32)
        return DataSet(f.astype(np.float32), labels, ds.features_mask,
                       ds.labels_mask)

    def revert(self, ds: DataSet) -> DataSet:
        f = np.asarray(ds.features) * self.std + self.mean
        labels = ds.labels
        if self.fit_label and self.label_mean is not None and labels is not None:
            labels = (np.asarray(labels) * self.label_std
                      + self.label_mean).astype(np.float32)
        return DataSet(f.astype(np.float32), labels, ds.features_mask,
                       ds.labels_mask)

    def to_dict(self) -> dict:
        d = {"@normalizer": "NormalizerStandardize",
             "mean": self.mean.tolist(), "std": self.std.tolist()}
        if self.fit_label and self.label_mean is not None:
            d["label_mean"] = self.label_mean.tolist()
            d["label_std"] = self.label_std.tolist()
        return d

    @classmethod
    def _from_dict(cls, d):
        n = cls()
        n.mean = np.asarray(d["mean"], np.float32)
        n.std = np.asarray(d["std"], np.float32)
        if "label_mean" in d:
            n.fit_label = True
            n.label_mean = np.asarray(d["label_mean"], np.float32)
            n.label_std = np.asarray(d["label_std"], np.float32)
        return n


@register_normalizer
class NormalizerMinMaxScaler(Normalizer):
    """Scale features to [min_range, max_range] (NormalizerMinMaxScaler)."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range = min_range
        self.max_range = max_range
        self.data_min: Optional[np.ndarray] = None
        self.data_max: Optional[np.ndarray] = None
        self.fit_label = False
        self.label_min: Optional[np.ndarray] = None
        self.label_max: Optional[np.ndarray] = None

    def fit(self, data) -> "NormalizerMinMaxScaler":
        f_acc, l_acc = _ExtremaAcc(), _ExtremaAcc()
        for ds in _iter_datasets(data):
            f_acc.add(ds.features)
            if self.fit_label and ds.labels is not None:
                l_acc.add(ds.labels)
        self.data_min, self.data_max = f_acc.finish("features")
        if self.fit_label:
            self.label_min, self.label_max = l_acc.finish(
                "labels (fit_label=True but no batch carried labels)")
        return self

    def _scale(self, a, lo, hi):
        rng = np.maximum(hi - lo, 1e-12)
        out = (np.asarray(a) - lo) / rng
        return (out * (self.max_range - self.min_range)
                + self.min_range).astype(np.float32)

    def _unscale(self, a, lo, hi):
        rng = np.maximum(hi - lo, 1e-12)
        out = ((np.asarray(a) - self.min_range)
               / (self.max_range - self.min_range))
        return (out * rng + lo).astype(np.float32)

    def transform(self, ds: DataSet) -> DataSet:
        f = self._scale(ds.features, self.data_min, self.data_max)
        labels = ds.labels
        if self.fit_label and self.label_min is not None and labels is not None:
            labels = self._scale(labels, self.label_min, self.label_max)
        return DataSet(f, labels, ds.features_mask, ds.labels_mask)

    def revert(self, ds: DataSet) -> DataSet:
        f = self._unscale(ds.features, self.data_min, self.data_max)
        labels = ds.labels
        if self.fit_label and self.label_min is not None and labels is not None:
            labels = self._unscale(labels, self.label_min, self.label_max)
        return DataSet(f, labels, ds.features_mask, ds.labels_mask)

    def to_dict(self) -> dict:
        d = {"@normalizer": "NormalizerMinMaxScaler",
             "min_range": self.min_range, "max_range": self.max_range,
             "data_min": self.data_min.tolist(),
             "data_max": self.data_max.tolist()}
        if self.fit_label and self.label_min is not None:
            d["label_min"] = self.label_min.tolist()
            d["label_max"] = self.label_max.tolist()
        return d

    @classmethod
    def _from_dict(cls, d):
        n = cls(d["min_range"], d["max_range"])
        n.data_min = np.asarray(d["data_min"], np.float32)
        n.data_max = np.asarray(d["data_max"], np.float32)
        if "label_min" in d:
            n.fit_label = True
            n.label_min = np.asarray(d["label_min"], np.float32)
            n.label_max = np.asarray(d["label_max"], np.float32)
        return n


@register_normalizer
class ImagePreProcessingScaler(Normalizer):
    """Pixels [0, max_pixel] → [min, max] (ImagePreProcessingScaler)."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0,
                 max_pixel: float = 255.0):
        self.min_range = min_range
        self.max_range = max_range
        self.max_pixel = max_pixel

    def fit(self, data) -> "ImagePreProcessingScaler":
        return self  # stateless

    def transform(self, ds: DataSet) -> DataSet:
        f = np.asarray(ds.features) / self.max_pixel
        f = f * (self.max_range - self.min_range) + self.min_range
        return DataSet(f.astype(np.float32), ds.labels, ds.features_mask,
                       ds.labels_mask)

    def revert(self, ds: DataSet) -> DataSet:
        f = (np.asarray(ds.features) - self.min_range) / (self.max_range - self.min_range)
        return DataSet((f * self.max_pixel).astype(np.float32), ds.labels,
                       ds.features_mask, ds.labels_mask)

    def to_dict(self) -> dict:
        return {"@normalizer": "ImagePreProcessingScaler",
                "min_range": self.min_range, "max_range": self.max_range,
                "max_pixel": self.max_pixel}

    @classmethod
    def _from_dict(cls, d):
        return cls(d["min_range"], d["max_range"], d["max_pixel"])


@register_normalizer
class VGG16ImagePreProcessor(Normalizer):
    """Subtract ImageNet mean RGB (zoo VGG16ImagePreProcessor), NHWC."""

    MEAN_RGB = np.asarray([123.68, 116.779, 103.939], np.float32)

    def fit(self, data) -> "VGG16ImagePreProcessor":
        return self

    def transform(self, ds: DataSet) -> DataSet:
        f = np.asarray(ds.features) - self.MEAN_RGB
        return DataSet(f.astype(np.float32), ds.labels, ds.features_mask,
                       ds.labels_mask)

    def revert(self, ds: DataSet) -> DataSet:
        f = np.asarray(ds.features) + self.MEAN_RGB
        return DataSet(f.astype(np.float32), ds.labels, ds.features_mask,
                       ds.labels_mask)

    def to_dict(self) -> dict:
        return {"@normalizer": "VGG16ImagePreProcessor"}

    @classmethod
    def _from_dict(cls, d):
        return cls()


class NormalizingIterator:
    """Applies a fitted normalizer to every batch of a base iterator."""

    def __init__(self, base, normalizer: Normalizer):
        self.base = base
        self.normalizer = normalizer

    def reset(self):
        if hasattr(self.base, "reset"):
            self.base.reset()

    def __iter__(self):
        for ds in self.base:
            yield self.normalizer.transform(ds)


class MultiNormalizer:
    """Per-input normalization of MultiDataSets (reference:
    ``MultiNormalizerStandardize`` / ``MultiNormalizerMinMaxScaler`` in ND4J):
    one child normalizer per features array. Labels pass through unless
    ``fit_label`` is set (DL4J's ``fitLabel(true)``), in which case one
    label child per labels array is fitted and applied.

    ``kind`` selects the child type: "standardize" | "minmax".
    """

    def __init__(self, kind: str = "standardize", **kwargs):
        if kind not in ("standardize", "minmax"):
            raise ValueError(f"unknown MultiNormalizer kind {kind!r}")
        self.kind = kind
        self.kwargs = kwargs
        self.children = []
        self.fit_label = False
        self.label_children = []

    def _new_child(self):
        return (NormalizerStandardize() if self.kind == "standardize"
                else NormalizerMinMaxScaler(**self.kwargs))

    def fit(self, data) -> "MultiNormalizer":
        mds_list = [data] if isinstance(data, MultiDataSet) else list(data)
        n_inputs = len(mds_list[0].features)
        self.children = [self._new_child() for _ in range(n_inputs)]
        for i, child in enumerate(self.children):
            child.fit([DataSet(m.features[i],
                               m.labels[0] if m.labels else None)
                       for m in mds_list])
        if self.fit_label:
            labeled = [m for m in mds_list if m.labels]
            if not labeled:
                raise ValueError(
                    "nothing to fit: labels (fit_label=True but no "
                    "MultiDataSet carried labels)")
            n_outputs = len(labeled[0].labels)
            self.label_children = [self._new_child()
                                   for _ in range(n_outputs)]
            for o, child in enumerate(self.label_children):
                child.fit([DataSet(m.labels[o], None) for m in labeled])
        return self

    def transform(self, mds):
        if not self.children:
            raise ValueError("fit the MultiNormalizer first")
        labels = mds.labels[0] if mds.labels else None
        feats = [np.asarray(c.transform(DataSet(f, labels)).features)
                 for c, f in zip(self.children, mds.features)]
        out_labels = mds.labels
        if self.label_children and mds.labels:
            out_labels = [
                np.asarray(c.transform(DataSet(y, None)).features)
                for c, y in zip(self.label_children, mds.labels)]
        return MultiDataSet(feats, out_labels, mds.features_masks,
                            mds.labels_masks)

    pre_process = transform

    def revert(self, mds):
        labels = mds.labels[0] if mds.labels else None
        feats = [np.asarray(c.revert(DataSet(f, labels)).features)
                 for c, f in zip(self.children, mds.features)]
        out_labels = mds.labels
        if self.label_children and mds.labels:
            out_labels = [
                np.asarray(c.revert(DataSet(y, None)).features)
                for c, y in zip(self.label_children, mds.labels)]
        return MultiDataSet(feats, out_labels, mds.features_masks,
                            mds.labels_masks)

    def to_dict(self) -> dict:
        return {"@normalizer": "MultiNormalizer", "kind": self.kind,
                "kwargs": self.kwargs,
                "children": [c.to_dict() for c in self.children],
                "label_children": [c.to_dict()
                                   for c in self.label_children]}

    @staticmethod
    def from_dict(d: dict) -> "MultiNormalizer":
        m = MultiNormalizer(d["kind"], **d.get("kwargs", {}))
        m.children = [Normalizer.from_dict(c) for c in d.get("children", [])]
        m.label_children = [Normalizer.from_dict(c)
                            for c in d.get("label_children", [])]
        m.fit_label = bool(m.label_children)
        return m
