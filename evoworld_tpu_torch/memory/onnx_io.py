"""ONNX initializer reader and writer without the `onnx` package (the port's
own copy of `evoworld_tpu/memory/onnx_io.py`, which is pure numpy).

ONNX files are protobuf; the weights live in `ModelProto.graph.initializer`
(repeated TensorProto). This module parses exactly that subset of the wire
format, enough to extract {name: ndarray} from `skyseg.onnx`-shaped files
(the upstream reprojection runs that file through onnxruntime), and writes
{name: float32 array} as a minimal valid ModelProto holding only those
initializers (for synthetic sky-segmentation weights).

Wire-format facts used (protobuf encoding spec):
  key = (field_number << 3) | wire_type
  wire types: 0 varint, 1 fixed64, 2 length-delimited, 5 fixed32
  ModelProto.graph = field 7;  GraphProto.initializer = field 5
  TensorProto: dims=1 (repeated int64), data_type=2, float_data=4 (packed),
               int64_data=7 (packed), name=8, raw_data=9, double_data=10
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

# TensorProto.DataType values we support.
_DTYPES = {
    1: np.float32,   # FLOAT
    6: np.int32,     # INT32
    7: np.int64,     # INT64
    10: np.float16,  # FLOAT16
    11: np.float64,  # DOUBLE
}


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long (corrupt protobuf)")


def _iter_fields(buf: memoryview) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over one message's fields."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            val = buf[pos:pos + length]
            pos += length
        elif wire == 5:
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: memoryview) -> Tuple[str, np.ndarray]:
    dims = []
    data_type = 1
    name = ""
    raw = None
    packed_float = b""
    packed_int64 = b""
    packed_double = b""
    for field, wire, val in _iter_fields(buf):
        if field == 1:                      # dims
            if wire == 0:
                dims.append(val)
            else:                           # packed repeated int64
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    dims.append(v)
        elif field == 2:
            data_type = val
        elif field == 4:
            packed_float += bytes(val) if wire == 2 else val
        elif field == 7:
            packed_int64 += bytes(val) if wire == 2 else val
        elif field == 8:
            name = bytes(val).decode("utf-8")
        elif field == 9:
            raw = bytes(val)
        elif field == 10:
            packed_double += bytes(val) if wire == 2 else val
    np_dtype = _DTYPES.get(data_type)
    if np_dtype is None:
        raise ValueError(f"unsupported TensorProto data_type {data_type} for {name!r}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif packed_float:
        arr = np.frombuffer(packed_float, dtype=np.float32)
    elif packed_double:
        arr = np.frombuffer(packed_double, dtype=np.float64)
    elif packed_int64:
        # int64_data is varint-packed, not fixed-width.
        vals = []
        pos = 0
        mv = memoryview(packed_int64)
        while pos < len(mv):
            v, pos = _read_varint(mv, pos)
            vals.append(np.int64(v))
        arr = np.asarray(vals, np.int64)
    else:
        arr = np.zeros(0, np_dtype)
    # No dims fields == rank-0 tensor (proto3 empty repeated field).
    return name, arr.reshape(dims)


def read_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """Extract {initializer_name: ndarray} from an ONNX file."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    out: Dict[str, np.ndarray] = {}
    for field, wire, val in _iter_fields(data):
        if field == 7 and wire == 2:        # ModelProto.graph
            for gfield, gwire, gval in _iter_fields(val):
                if gfield == 5 and gwire == 2:   # GraphProto.initializer
                    name, arr = _parse_tensor(gval)
                    out[name] = arr
    return out


# ---------------------------------------------------------------------------
# Writer: {name: array} as float32 initializers of a minimal valid ModelProto.
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int, payload: bytes) -> bytes:
    return _varint((num << 3) | wire) + payload


def write_onnx_initializers(path: str, tensors: Dict[str, np.ndarray]) -> None:
    graph = bytearray()
    for name, arr in tensors.items():
        # NOT ascontiguousarray: it promotes rank-0 arrays to shape (1,).
        arr = np.asarray(arr, np.float32, order="C")
        t = bytearray()
        for d in arr.shape:
            t += _field(1, 0, _varint(int(d)))
        t += _field(2, 0, _varint(1))                       # FLOAT
        nb = name.encode("utf-8")
        t += _field(8, 2, _varint(len(nb)) + nb)
        raw = arr.tobytes()
        t += _field(9, 2, _varint(len(raw)) + raw)
        graph += _field(5, 2, _varint(len(t)) + bytes(t))
    model = _field(7, 2, _varint(len(graph)) + bytes(graph))
    with open(path, "wb") as f:
        f.write(model)
