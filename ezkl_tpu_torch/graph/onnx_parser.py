"""Minimal ONNX model parser: raw protobuf wire-format decoding.

The reference parses ONNX via tract (`ezkl/src/graph/model.rs:
639-693`); this image has no `onnx` python package, so we decode the
protobuf wire format directly — ONNX's subset is small: varints, length-
delimited submessages, packed repeated numbers.

Port of `ezkl_tpu/graph/onnx_parser.py` (pure numpy, copied; imports rewired to the
port's modules).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np


def _read_varint(data: bytes, off: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7


def _fields(data: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    off = 0
    n = len(data)
    while off < n:
        key, off = _read_varint(data, off)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, off = _read_varint(data, off)
        elif wt == 1:
            v = data[off:off + 8]
            off += 8
        elif wt == 2:
            ln, off = _read_varint(data, off)
            v = data[off:off + ln]
            off += ln
        elif wt == 5:
            v = data[off:off + 4]
            off += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _packed_varints(v: bytes) -> list[int]:
    out, off = [], 0
    while off < len(v):
        x, off = _read_varint(v, off)
        out.append(x)
    return out


def _zigzag64(x: int) -> int:
    """Interpret varint as two's-complement int64."""
    return x - (1 << 64) if x >= (1 << 63) else x


@dataclasses.dataclass
class TensorInfo:
    name: str
    shape: list          # ints or str (symbolic dims like "batch_size")
    elem_type: int = 1


@dataclasses.dataclass
class OnnxNode:
    op_type: str
    name: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict


@dataclasses.dataclass
class OnnxGraph:
    nodes: list[OnnxNode]
    inputs: list[TensorInfo]
    outputs: list[TensorInfo]
    initializers: dict            # name -> np.ndarray
    value_info: dict


@dataclasses.dataclass
class OnnxModel:
    graph: OnnxGraph
    opset: int = 13
    producer: str = ""


# ONNX TensorProto.DataType
_DT = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
       6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
       12: np.uint32, 13: np.uint64}


def _parse_tensor(data: bytes) -> tuple[str, np.ndarray]:
    dims, dtype, raw, name = [], 1, None, ""
    float_data, int32_data, int64_data, double_data, uint64_data = [], [], [], [], []
    for f, wt, v in _fields(data):
        if f == 1:
            if wt == 0:
                dims.append(_zigzag64(v))
            else:
                dims.extend(_zigzag64(x) for x in _packed_varints(v))
        elif f == 2:
            dtype = v
        elif f == 4:
            if wt == 5:
                float_data.append(struct.unpack("<f", v)[0])
            else:
                float_data.extend(np.frombuffer(v, "<f4").tolist())
        elif f == 5:
            if wt == 0:
                int32_data.append(_zigzag64(v))
            else:
                int32_data.extend(_zigzag64(x) for x in _packed_varints(v))
        elif f == 7:
            if wt == 0:
                int64_data.append(_zigzag64(v))
            else:
                int64_data.extend(_zigzag64(x) for x in _packed_varints(v))
        elif f == 8:
            name = v.decode()
        elif f == 9:
            raw = v
        elif f == 11:
            if wt == 1:
                double_data.append(struct.unpack("<d", v)[0])
            else:
                double_data.extend(np.frombuffer(v, "<f8").tolist())
        elif f == 13:
            if wt == 0:
                uint64_data.append(v)
            else:
                uint64_data.extend(_packed_varints(v))
    np_dtype = _DT.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype).copy()
    elif float_data:
        arr = np.array(float_data, dtype=np.float32)
    elif int64_data:
        arr = np.array(int64_data, dtype=np.int64)
    elif int32_data:
        arr = np.array(int32_data, dtype=_DT.get(dtype, np.int32))
    elif double_data:
        arr = np.array(double_data, dtype=np.float64)
    elif uint64_data:
        arr = np.array(uint64_data, dtype=np.uint64)
    else:
        arr = np.zeros(0, dtype=np_dtype)
    shape = [int(d) for d in dims]
    return name, arr.reshape(shape) if shape else arr.reshape(())


def _parse_attr(data: bytes) -> tuple[str, object]:
    name, atype = "", 0
    val = None
    floats, ints, strings = [], [], []
    for f, wt, v in _fields(data):
        if f == 1:
            name = v.decode()
        elif f == 20:
            atype = v
        elif f == 2:
            val = struct.unpack("<f", v)[0] if atype in (0, 1) or val is None else val
            if atype == 1 or atype == 0:
                val = struct.unpack("<f", v)[0]
        elif f == 3:
            if atype in (0, 2) :
                val = _zigzag64(v)
        elif f == 4:
            val = v  # bytes
        elif f == 5:
            _, t = _parse_tensor(v)
            val = t
        elif f == 7:
            if wt == 5:
                floats.append(struct.unpack("<f", v)[0])
            else:
                floats.extend(np.frombuffer(v, "<f4").tolist())
        elif f == 8:
            if wt == 0:
                ints.append(_zigzag64(v))
            else:
                ints.extend(_zigzag64(x) for x in _packed_varints(v))
        elif f == 9:
            strings.append(v)
    if floats:
        val = floats
    elif ints:
        val = ints
    elif strings:
        val = strings if len(strings) > 1 else strings[0]
    return name, val


def _parse_value_info(data: bytes) -> TensorInfo:
    name, shape, elem = "", [], 1
    for f, wt, v in _fields(data):
        if f == 1:
            name = v.decode()
        elif f == 2:
            for f2, _, v2 in _fields(v):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in _fields(v2):
                        if f3 == 1:
                            elem = v3
                        elif f3 == 2:  # shape
                            for f4, _, v4 in _fields(v3):
                                if f4 == 1:  # dim
                                    dv = None
                                    for f5, _, v5 in _fields(v4):
                                        if f5 == 1:
                                            dv = _zigzag64(v5)
                                        elif f5 == 2:
                                            dv = v5.decode()
                                    shape.append(dv if dv is not None else 1)
    return TensorInfo(name=name, shape=shape, elem_type=elem)


def _parse_node(data: bytes) -> OnnxNode:
    inputs, outputs, attrs = [], [], {}
    op_type, name = "", ""
    for f, wt, v in _fields(data):
        if f == 1:
            inputs.append(v.decode())
        elif f == 2:
            outputs.append(v.decode())
        elif f == 3:
            name = v.decode()
        elif f == 4:
            op_type = v.decode()
        elif f == 5:
            an, av = _parse_attr(v)
            attrs[an] = av
    return OnnxNode(op_type=op_type, name=name, inputs=inputs,
                    outputs=outputs, attrs=attrs)


def _parse_graph(data: bytes) -> OnnxGraph:
    nodes, inputs, outputs = [], [], []
    initializers, value_info = {}, {}
    for f, wt, v in _fields(data):
        if f == 1:
            nodes.append(_parse_node(v))
        elif f == 5:
            nm, arr = _parse_tensor(v)
            initializers[nm] = arr
        elif f == 11:
            inputs.append(_parse_value_info(v))
        elif f == 12:
            outputs.append(_parse_value_info(v))
        elif f == 13:
            vi = _parse_value_info(v)
            value_info[vi.name] = vi
    # graph inputs exclude initializers (older exporters list them as inputs)
    inputs = [i for i in inputs if i.name not in initializers]
    return OnnxGraph(nodes=nodes, inputs=inputs, outputs=outputs,
                     initializers=initializers, value_info=value_info)


def load(path_or_bytes) -> OnnxModel:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    graph = None
    opset = 13
    producer = ""
    for f, wt, v in _fields(data):
        if f == 7:
            graph = _parse_graph(v)
        elif f == 2:
            producer = v.decode()
        elif f == 8:
            for f2, _, v2 in _fields(v):
                if f2 == 2:
                    opset = v2
    assert graph is not None, "no graph in ONNX model"
    return OnnxModel(graph=graph, opset=opset, producer=producer)
