"""A frozen copy of the protobuf (ONNX) writer that the benchmark builds its
models with, so that the models do not change when the program's writer
does. It encodes the subset the program's ONNX parser reads: float and
int64 tensors, scalar and list attributes, value infos with static shapes.
It imports neither the program nor its JAX twin.
"""

from __future__ import annotations

import struct

import numpy as np


def _varint(x: int) -> bytes:
    out = bytearray()
    x &= (1 << 64) - 1
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _str_field(field: int, s: str) -> bytes:
    return _len_field(field, s.encode())


def _int_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def tensor(name: str, arr: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, raw_data=9, name=8."""
    arr = np.asarray(arr)
    if arr.dtype in (np.float64, np.float32):
        arr32 = arr.astype(np.float32)
        dtype_code, raw = 1, arr32.tobytes()
    elif arr.dtype == np.int64:
        dtype_code, raw = 7, arr.tobytes()
    elif arr.dtype == np.int32:
        dtype_code, raw = 6, arr.tobytes()
    elif arr.dtype == np.bool_:
        dtype_code, raw = 9, arr.astype(np.uint8).tobytes()
    else:
        raise TypeError(f"onnx_writer: unsupported dtype {arr.dtype}")
    out = b""
    for d in arr.shape:
        out += _int_field(1, int(d))
    out += _int_field(2, dtype_code)
    out += _str_field(8, name)
    out += _len_field(9, raw)
    return out


def _attr(name: str, val) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8,
    type=20 (FLOAT=1 INT=2 STRING=3 TENSOR=4 FLOATS=6 INTS=7)."""
    out = _str_field(1, name)
    if isinstance(val, bool):
        out += _int_field(3, int(val)) + _int_field(20, 2)
    elif isinstance(val, int):
        out += _int_field(3, val) + _int_field(20, 2)
    elif isinstance(val, float):
        out += _tag(2, 5) + struct.pack("<f", val) + _int_field(20, 1)
    elif isinstance(val, (str, bytes)):
        b = val.encode() if isinstance(val, str) else val
        out += _len_field(4, b) + _int_field(20, 3)
    elif isinstance(val, np.ndarray):
        out += _len_field(5, tensor("", val)) + _int_field(20, 4)
    elif isinstance(val, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in val):
            for v in val:
                out += _int_field(8, int(v))
            out += _int_field(20, 7)
        else:
            for v in val:
                out += _tag(7, 5) + struct.pack("<f", float(v))
            out += _int_field(20, 6)
    else:
        raise TypeError(f"onnx_writer: unsupported attr {name}={val!r}")
    return out


def node(op_type: str, inputs, outputs, name: str = "", **attrs) -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    out = b""
    for i in inputs:
        out += _str_field(1, i)
    for o in outputs:
        out += _str_field(2, o)
    out += _str_field(3, name or f"{op_type}_{id(attrs) & 0xFFFF}")
    out += _str_field(4, op_type)
    for k, v in attrs.items():
        out += _len_field(5, _attr(k, v))
    return out


def _value_info(name: str, shape, elem_type: int = 1) -> bytes:
    dims = b""
    for d in shape:
        dims += _len_field(1, _int_field(1, int(d)))          # dim{dim_value}
    ttype = _int_field(1, elem_type) + _len_field(2, dims)    # elem, shape
    return _str_field(1, name) + _len_field(2, _len_field(1, ttype))


def model(nodes: list[bytes], inputs: dict, outputs: dict,
          initializers: dict | None = None, opset: int = 14) -> bytes:
    """Serialize a ModelProto.

    nodes: list of `node(...)` payloads (in topological order).
    inputs/outputs: {name: shape}; initializers: {name: ndarray}.
    """
    g = b""
    for nd in nodes:
        g += _len_field(1, nd)
    g += _str_field(2, "g")
    for name, arr in (initializers or {}).items():
        g += _len_field(5, tensor(name, arr))
    for name, shape in inputs.items():
        g += _len_field(11, _value_info(name, shape))
    for name, shape in outputs.items():
        g += _len_field(12, _value_info(name, shape))
    m = _int_field(1, 8)                                      # ir_version
    m += _len_field(8, _int_field(2, opset))                  # opset_import
    m += _len_field(7, g)
    return m
