"""ND4J's ``NormalizerSerializer`` stream: ``normalizer.bin`` in DL4J model
zips.

The port's copy of ``deeplearning4j_tpu/modelimport/normalizer_serde.py``,
on the port's ``datasets/normalizers.py``. DL4J appends a fitted
normalizer to a model zip that has one (``ModelSerializer``
``addNormalizerToModel``, ``restoreNormalizerFromFile``). The stream (java
``DataOutputStream`` primitives, big-endian)::

    writeUTF("NORMALIZER")          # header magic
    writeInt(1)                     # header version
    writeUTF(type)                  # NormalizerType enum name
    [writeUTF(customClass)]         # only when type == CUSTOM

and then the strategy's payload:

``STANDARDIZE`` (NormalizerStandardize)::

    writeBoolean(fitLabel)
    Nd4j.write(mean); Nd4j.write(std)
    [Nd4j.write(labelMean); Nd4j.write(labelStd)]   # iff fitLabel

``MIN_MAX`` (NormalizerMinMaxScaler)::

    writeBoolean(fitLabel)
    writeDouble(targetMin); writeDouble(targetMax)
    Nd4j.write(min); Nd4j.write(max)
    [Nd4j.write(labelMin); Nd4j.write(labelMax)]    # iff fitLabel

``IMAGE_MIN_MAX`` (ImagePreProcessingScaler)::

    writeDouble(minRange); writeDouble(maxRange); writeDouble(maxPixelVal)

``IMAGE_VGG16`` (VGG16ImagePreProcessor): no payload.

``MULTI_STANDARDIZE`` / ``MULTI_MIN_MAX`` (MultiNormalizer*)::

    writeBoolean(fitLabel)
    writeInt(numInputs)
    writeInt(fitLabel ? numOutputs : -1)
    [writeDouble(targetMin); writeDouble(targetMax)]   # MULTI_MIN_MAX only
    per input:  Nd4j.write(stat_a); Nd4j.write(stat_b)  # mean/std or min/max
    per output (iff fitLabel): the same pair for labels

``MULTI_HYBRID`` and ``CUSTOM`` strategies raise: their payloads are
defined by classes that cannot be read here.
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO

import numpy as np

from deeplearning4j_tpu_torch.modelimport.nd4j_binary import (
    _read_utf, _write_utf, read_nd4j_array, write_nd4j_array)

HEADER_MAGIC = "NORMALIZER"
HEADER_VERSION = 1


class UnsupportedNormalizerException(ValueError):
    """Strategy exists in ND4J but cannot be represented here."""


# ---------------------------------------------------------------------------
# java DataOutputStream primitives on top of nd4j_binary's UTF helpers

def _read_bool(f: BinaryIO) -> bool:
    b = f.read(1)
    if len(b) < 1:
        raise ValueError("truncated normalizer stream: missing boolean")
    return b != b"\x00"


def _read_i32(f: BinaryIO) -> int:
    raw = f.read(4)
    if len(raw) < 4:
        raise ValueError("truncated normalizer stream: missing int")
    return struct.unpack(">i", raw)[0]


def _read_f64(f: BinaryIO) -> float:
    raw = f.read(8)
    if len(raw) < 8:
        raise ValueError("truncated normalizer stream: missing double")
    return struct.unpack(">d", raw)[0]


def _write_bool(f: BinaryIO, v: bool) -> None:
    f.write(b"\x01" if v else b"\x00")


def _write_i32(f: BinaryIO, v: int) -> None:
    f.write(struct.pack(">i", v))


def _write_f64(f: BinaryIO, v: float) -> None:
    f.write(struct.pack(">d", v))


def _read_vec(f: BinaryIO) -> np.ndarray:
    """ND4J stores normalizer stats as [1, n] row vectors; flatten."""
    return np.asarray(read_nd4j_array(f), np.float32).reshape(-1)


def _write_vec(f: BinaryIO, v: np.ndarray) -> None:
    write_nd4j_array(f, np.asarray(v, np.float32).reshape(1, -1), order="c")


# ---------------------------------------------------------------------------
# write

def write_normalizer(normalizer, f: BinaryIO) -> None:
    """``NormalizerSerializer.getDefault().write`` counterpart
    (``ModelSerializer.java:168`` call site)."""
    from deeplearning4j_tpu_torch.datasets import normalizers as N

    _write_utf(f, HEADER_MAGIC)
    _write_i32(f, HEADER_VERSION)

    if isinstance(normalizer, N.NormalizerStandardize):
        if normalizer.mean is None:
            raise UnsupportedNormalizerException(
                "cannot serialize an unfitted NormalizerStandardize")
        _write_utf(f, "STANDARDIZE")
        fit_label = bool(normalizer.fit_label
                         and normalizer.label_mean is not None)
        _write_bool(f, fit_label)
        _write_vec(f, normalizer.mean)
        _write_vec(f, normalizer.std)
        if fit_label:
            _write_vec(f, normalizer.label_mean)
            _write_vec(f, normalizer.label_std)
    elif isinstance(normalizer, N.NormalizerMinMaxScaler):
        if normalizer.data_min is None:
            raise UnsupportedNormalizerException(
                "cannot serialize an unfitted NormalizerMinMaxScaler")
        _write_utf(f, "MIN_MAX")
        fit_label = bool(normalizer.fit_label
                         and normalizer.label_min is not None)
        _write_bool(f, fit_label)
        _write_f64(f, normalizer.min_range)
        _write_f64(f, normalizer.max_range)
        _write_vec(f, normalizer.data_min)
        _write_vec(f, normalizer.data_max)
        if fit_label:
            _write_vec(f, normalizer.label_min)
            _write_vec(f, normalizer.label_max)
    elif isinstance(normalizer, N.ImagePreProcessingScaler):
        _write_utf(f, "IMAGE_MIN_MAX")
        _write_f64(f, normalizer.min_range)
        _write_f64(f, normalizer.max_range)
        _write_f64(f, normalizer.max_pixel)
    elif isinstance(normalizer, N.VGG16ImagePreProcessor):
        _write_utf(f, "IMAGE_VGG16")
    elif isinstance(normalizer, N.MultiNormalizer):
        _write_multi(f, normalizer)
    else:
        raise UnsupportedNormalizerException(
            f"no NormalizerSerializer strategy for "
            f"{type(normalizer).__name__} — DL4J would need a CUSTOM "
            "strategy class, which has no portable byte layout")


def _write_multi(f: BinaryIO, m) -> None:
    if not m.children:
        raise UnsupportedNormalizerException(
            "cannot serialize an unfitted MultiNormalizer")
    standardize = m.kind == "standardize"
    _write_utf(f, "MULTI_STANDARDIZE" if standardize else "MULTI_MIN_MAX")
    fit_label = bool(m.label_children)
    _write_bool(f, fit_label)
    _write_i32(f, len(m.children))
    _write_i32(f, len(m.label_children) if fit_label else -1)
    if not standardize:
        child0 = m.children[0]
        _write_f64(f, child0.min_range)
        _write_f64(f, child0.max_range)
    for c in m.children + m.label_children:
        if standardize:
            _write_vec(f, c.mean)
            _write_vec(f, c.std)
        else:
            _write_vec(f, c.data_min)
            _write_vec(f, c.data_max)


def normalizer_to_bytes(normalizer) -> bytes:
    buf = io.BytesIO()
    write_normalizer(normalizer, buf)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# read

def read_normalizer(f: BinaryIO):
    """``NormalizerSerializer.getDefault().restore`` counterpart
    (``ModelSerializer.java:715`` call site)."""
    from deeplearning4j_tpu_torch.datasets import normalizers as N

    magic = _read_utf(f)
    if magic != HEADER_MAGIC:
        raise ValueError(
            f"not a NormalizerSerializer stream (magic {magic!r}); "
            "pre-0.9 zips used raw Java object serialization "
            "(ModelSerializer.java:759 deprecated path), which is not "
            "portable")
    version = _read_i32(f)
    if version != HEADER_VERSION:
        raise ValueError(f"unsupported normalizer header version {version}")
    ntype = _read_utf(f)

    if ntype == "STANDARDIZE":
        n = N.NormalizerStandardize()
        fit_label = _read_bool(f)
        n.mean = _read_vec(f)
        n.std = _read_vec(f)
        if fit_label:
            n.fit_label = True
            n.label_mean = _read_vec(f)
            n.label_std = _read_vec(f)
        return n
    if ntype == "MIN_MAX":
        fit_label = _read_bool(f)
        n = N.NormalizerMinMaxScaler(_read_f64(f), _read_f64(f))
        n.data_min = _read_vec(f)
        n.data_max = _read_vec(f)
        if fit_label:
            n.fit_label = True
            n.label_min = _read_vec(f)
            n.label_max = _read_vec(f)
        return n
    if ntype == "IMAGE_MIN_MAX":
        return N.ImagePreProcessingScaler(
            _read_f64(f), _read_f64(f), _read_f64(f))
    if ntype == "IMAGE_VGG16":
        return N.VGG16ImagePreProcessor()
    if ntype in ("MULTI_STANDARDIZE", "MULTI_MIN_MAX"):
        return _read_multi(f, ntype)
    if ntype == "CUSTOM":
        cls_name = _read_utf(f)
        raise UnsupportedNormalizerException(
            f"normalizer.bin uses a CUSTOM serializer strategy "
            f"({cls_name}); its payload is defined by that class and "
            "cannot be interpreted here")
    if ntype == "MULTI_HYBRID":
        raise UnsupportedNormalizerException(
            "MULTI_HYBRID normalizers mix per-input strategies; only "
            "uniform MULTI_STANDARDIZE / MULTI_MIN_MAX are supported")
    raise ValueError(f"unknown NormalizerType {ntype!r}")


def _read_multi(f: BinaryIO, ntype: str):
    from deeplearning4j_tpu_torch.datasets import normalizers as N

    standardize = ntype == "MULTI_STANDARDIZE"
    fit_label = _read_bool(f)
    n_inputs = _read_i32(f)
    n_outputs = _read_i32(f)
    if n_inputs < 0 or n_inputs > 10_000:
        raise ValueError(f"implausible normalizer input count {n_inputs}")
    # n_outputs is a -1 sentinel when fitLabel is false, so the bound is
    # conditional; a corrupt fitLabel stream must fail fast here rather
    # than loop reading label children until a truncation error
    if fit_label and (n_outputs < 0 or n_outputs > 10_000):
        raise ValueError(f"implausible normalizer output count {n_outputs}")
    kwargs = {}
    if not standardize:
        kwargs = {"min_range": _read_f64(f), "max_range": _read_f64(f)}
    m = N.MultiNormalizer("standardize" if standardize else "minmax",
                          **kwargs)

    def read_child():
        c = m._new_child()
        a, b = _read_vec(f), _read_vec(f)
        if standardize:
            c.mean, c.std = a, b
        else:
            c.data_min, c.data_max = a, b
        return c

    m.children = [read_child() for _ in range(n_inputs)]
    if fit_label:
        m.fit_label = True
        m.label_children = [read_child() for _ in range(n_outputs)]
    return m


def normalizer_from_bytes(b: bytes):
    return read_normalizer(io.BytesIO(b))
