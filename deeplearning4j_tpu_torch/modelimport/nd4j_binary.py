"""ND4J binary arrays: the reader and writer of ``coefficients.bin`` and
``updaterState.bin``.

The port's own copy of ``deeplearning4j_tpu/modelimport/nd4j_binary.py``
(numpy only; the port imports nothing of the JAX package). DL4J's
``ModelSerializer`` stores a network's one flattened parameter vector with
``Nd4j.write(params, dataOutputStream)`` and reads it back with
``Nd4j.read``. ``Nd4j.write`` emits two ``DataBuffer.write`` records back
to back, the shape-information buffer and then the data buffer; each
record is::

    writeUTF(allocationMode)   # java modified-UTF8: u16 BE length + bytes
                               # ("HEAP" | "DIRECT" | "JAVACPP" | ...)
    writeInt(length)           # element count, int32 BE
    writeUTF(dataTypeName)     # "INT" | "LONG" | "FLOAT" | "DOUBLE" | "HALF"
    <length elements, big-endian>

The shape-information buffer is ND4J's shapeInfo vector::

    [rank, shape_0..r-1, stride_0..r-1, offset, elementWiseStride, order]

with ``order`` the character code of the ordering (99 = 'c', 102 = 'f').
INT shape buffers are the 0.x layout; LONG is accepted for 1.0-era files.
The writer emits the 0.9.x layout (HEAP mode, INT shape buffer,
FLOAT/DOUBLE data), for fixtures and round trips.
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO

import numpy as np

_DTYPES_READ = {
    "FLOAT": (">f4", np.float32),
    "DOUBLE": (">f8", np.float64),
    "HALF": (">f2", np.float16),
    "INT": (">i4", np.int32),
    "LONG": (">i8", np.int64),
}


def _read_utf(f: BinaryIO) -> str:
    """java DataOutputStream.writeUTF counterpart (length-prefixed)."""
    raw = f.read(2)
    if len(raw) < 2:
        raise ValueError("truncated ND4J buffer: missing UTF length")
    (n,) = struct.unpack(">H", raw)
    data = f.read(n)
    if len(data) < n:
        raise ValueError("truncated ND4J buffer: short UTF payload")
    # java modified UTF-8 ~= utf-8 for the ASCII names used here
    return data.decode("utf-8")


def _write_utf(f: BinaryIO, s: str) -> None:
    b = s.encode("utf-8")
    f.write(struct.pack(">H", len(b)))
    f.write(b)


def _read_buffer(f: BinaryIO) -> np.ndarray:
    """One DataBuffer.write record → 1-d numpy array (native byte order)."""
    mode = _read_utf(f)
    if not mode.isupper():
        raise ValueError(f"bad ND4J allocation mode {mode!r} — not an "
                         "Nd4j.write stream?")
    raw = f.read(4)
    if len(raw) < 4:
        raise ValueError("truncated ND4J buffer: missing length")
    (length,) = struct.unpack(">i", raw)
    if length < 0:
        raise ValueError(f"bad ND4J buffer length {length}")
    dtype_name = _read_utf(f)
    if dtype_name not in _DTYPES_READ:
        raise ValueError(f"unsupported ND4J data type {dtype_name!r}")
    wire, out = _DTYPES_READ[dtype_name]
    nbytes = length * np.dtype(wire).itemsize
    data = f.read(nbytes)
    if len(data) < nbytes:
        raise ValueError(f"truncated ND4J buffer: wanted {nbytes} data bytes, "
                         f"got {len(data)}")
    return np.frombuffer(data, dtype=wire).astype(out, copy=False)


def _write_buffer(f: BinaryIO, arr: np.ndarray, dtype_name: str) -> None:
    wire, _ = _DTYPES_READ[dtype_name]
    _write_utf(f, "HEAP")
    f.write(struct.pack(">i", arr.size))
    _write_utf(f, dtype_name)
    f.write(np.ascontiguousarray(arr, dtype=wire).tobytes())


def read_nd4j_array(f: BinaryIO) -> np.ndarray:
    """``Nd4j.read``: shapeInfo buffer + data buffer → numpy array with the
    recorded shape and ordering applied."""
    shape_info = _read_buffer(f).astype(np.int64)
    if shape_info.size < 1:
        raise ValueError("empty ND4J shape-information buffer")
    rank = int(shape_info[0])
    if rank < 0 or shape_info.size < 2 * rank + 4:
        raise ValueError(
            f"bad ND4J shapeInfo: rank {rank}, {shape_info.size} elements")
    shape = tuple(int(s) for s in shape_info[1:1 + rank])
    order = chr(int(shape_info[2 * rank + 3])) or "c"
    data = _read_buffer(f)
    n = int(np.prod(shape)) if rank else data.size
    if data.size != n:
        raise ValueError(f"ND4J data buffer has {data.size} elements, "
                         f"shape {shape} wants {n}")
    return data.reshape(shape, order="F" if order == "f" else "C")


def read_nd4j_array_from_bytes(b: bytes) -> np.ndarray:
    return read_nd4j_array(io.BytesIO(b))


def write_nd4j_array(f: BinaryIO, arr: np.ndarray, order: str = "c") -> None:
    """``Nd4j.write`` counterpart (0.9.x layout) — fixture/round-trip use."""
    arr = np.asarray(arr)
    if arr.dtype == np.float64:
        dtype_name = "DOUBLE"
    elif arr.dtype == np.float16:
        dtype_name = "HALF"
    else:
        arr = arr.astype(np.float32, copy=False)
        dtype_name = "FLOAT"
    rank = arr.ndim
    shape = arr.shape
    # c-order strides in elements (ND4J convention); 'f' flips the build
    strides = [0] * rank
    acc = 1
    idx = range(rank - 1, -1, -1) if order == "c" else range(rank)
    for i in idx:
        strides[i] = acc
        acc *= shape[i]
    shape_info = np.array(
        [rank, *shape, *strides, 0, 1, ord(order)], dtype=np.int32)
    _write_buffer(f, shape_info, "INT")
    flat = arr.flatten(order="F" if order == "f" else "C")
    _write_buffer(f, flat, dtype_name)


def nd4j_array_to_bytes(arr: np.ndarray, order: str = "c") -> bytes:
    buf = io.BytesIO()
    write_nd4j_array(buf, arr, order)
    return buf.getvalue()
