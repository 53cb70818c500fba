"""Wire format for arrays and DataSets.

Role of the reference's NDArray↔record conversion inside the Kafka/Camel
routes (`dl4j-streaming/.../streaming/conversion/`): a self-describing binary
frame — 4-byte big-endian JSON-header length, JSON header (dtype, shape,
fields), raw C-order array bytes concatenated.

A copy of the JAX package's ``streaming/codec.py``: for the same array the
frame is the reference's, byte for byte. numpy has no bfloat16 without
``ml_dtypes``, which the port does not need, so a bf16 answer reaches the
host widened to f32 and marked as a :class:`BFloat16Array`; its frame
says ``"dtype": "bfloat16"`` and carries the upper half of each f32 word
(2 bytes an entry, exact for values that came from bf16), as the
reference's bf16 numpy array writes it. A ``"bfloat16"`` frame decodes
to a :class:`BFloat16Array` of the same values in f32 (ROADMAP §C, C20).
"""

from __future__ import annotations

import json
import struct

import numpy as np

BFLOAT16 = "bfloat16"


class BFloat16Array(np.ndarray):
    """f32 values of a bf16 array, marked so the codec writes them as the
    2-byte bf16 frame. Slices and copies keep the mark; arithmetic
    (any ufunc) gives plain arrays, whose values need not be bf16."""

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        inputs = tuple(a.view(np.ndarray) if isinstance(a, BFloat16Array) else a
                       for a in inputs)
        if "out" in kwargs:
            kwargs["out"] = tuple(a.view(np.ndarray) if isinstance(a, BFloat16Array)
                                  else a for a in kwargs["out"])
        return getattr(ufunc, method)(*inputs, **kwargs)


def mark_bfloat16(a: np.ndarray) -> BFloat16Array:
    """``a`` (f32 holding bf16 values) marked for the bf16 frame."""
    if a.dtype != np.float32:
        raise ValueError(f"a bf16 answer widens to float32, got {a.dtype}")
    return a.view(BFloat16Array)


def serialize_array(arr) -> bytes:
    if isinstance(arr, BFloat16Array):
        wide = np.ascontiguousarray(arr.view(np.ndarray))
        a = (wide.view(np.uint32) >> 16).astype(np.uint16)
        dtype = BFLOAT16
    else:
        a = np.ascontiguousarray(np.asarray(arr))
        dtype = str(a.dtype)
    header = json.dumps({"dtype": dtype, "shape": list(a.shape)}).encode()
    # one copy of the array's bytes (the reference's ``tobytes`` and
    # concatenation make two): the same bytes on the wire
    return b"".join((struct.pack(">I", len(header)), header,
                     a.reshape(-1).view(np.uint8).data))


def deserialize_array(data: bytes) -> np.ndarray:
    hlen = struct.unpack(">I", data[:4])[0]
    header = json.loads(data[4:4 + hlen].decode())
    if header["dtype"] == BFLOAT16:
        bits = np.frombuffer(data[4 + hlen:], dtype=np.uint16)
        wide = (bits.astype(np.uint32) << 16).view(np.float32)
        return mark_bfloat16(wide.reshape(header["shape"]))
    a = np.frombuffer(data[4 + hlen:], dtype=np.dtype(header["dtype"]))
    return a.reshape(header["shape"]).copy()


def serialize_dataset(ds) -> bytes:
    parts = {"features": np.asarray(ds.features), "labels": np.asarray(ds.labels)}
    if ds.features_mask is not None:
        parts["features_mask"] = np.asarray(ds.features_mask)
    if ds.labels_mask is not None:
        parts["labels_mask"] = np.asarray(ds.labels_mask)
    blobs = {k: serialize_array(v) for k, v in parts.items()}
    header = json.dumps({k: len(v) for k, v in blobs.items()}).encode()
    return (struct.pack(">I", len(header)) + header
            + b"".join(blobs[k] for k in sorted(blobs)))


def deserialize_dataset(data: bytes):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    hlen = struct.unpack(">I", data[:4])[0]
    sizes = json.loads(data[4:4 + hlen].decode())
    arrays = {}
    off = 4 + hlen
    for k in sorted(sizes):
        arrays[k] = deserialize_array(data[off:off + sizes[k]])
        off += sizes[k]
    return DataSet(arrays["features"], arrays["labels"],
                   arrays.get("features_mask"), arrays.get("labels_mask"))
