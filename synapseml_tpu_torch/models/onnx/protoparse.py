"""Self-contained ONNX protobuf codec (no ``onnx`` package dependency).

The reference links ``onnx-protobuf`` and the ONNX Runtime JNI jar
(reference: build.sbt:420-421, deep-learning/.../ONNXUtils.scala:22-360).
This environment has neither the onnx wheel nor egress to fetch it, so we
read and write the ONNX ``ModelProto`` wire format directly: protobuf
encoding is a stable public format (tag = field_number << 3 | wire_type;
varint / 64-bit / length-delimited / 32-bit payloads), and the ONNX field
numbers are fixed by onnx.proto3.  Only the message subset needed for
graph execution is modelled.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

# -- ONNX TensorProto.DataType ------------------------------------------------
FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64 = 1, 2, 3, 4, 5, 6, 7
STRING, BOOL, FLOAT16, DOUBLE, UINT32, UINT64 = 8, 9, 10, 11, 12, 13
BFLOAT16 = 16

DTYPE_TO_NUMPY = {
    FLOAT: np.float32, UINT8: np.uint8, INT8: np.int8, UINT16: np.uint16,
    INT16: np.int16, INT32: np.int32, INT64: np.int64, BOOL: np.bool_,
    FLOAT16: np.float16, DOUBLE: np.float64, UINT32: np.uint32,
    UINT64: np.uint64,
}
NUMPY_TO_DTYPE = {np.dtype(v): k for k, v in DTYPE_TO_NUMPY.items()}


def numpy_to_elem_type(dtype) -> int:
    d = np.dtype(dtype)
    if str(d) == "bfloat16":
        return BFLOAT16
    try:
        return NUMPY_TO_DTYPE[d]
    except KeyError:
        raise TypeError(f"no ONNX elem_type for numpy dtype {d}") from None


# -- AttributeProto.AttributeType --------------------------------------------
A_FLOAT, A_INT, A_STRING, A_TENSOR, A_GRAPH = 1, 2, 3, 4, 5
A_FLOATS, A_INTS, A_STRINGS, A_TENSORS, A_GRAPHS = 6, 7, 8, 9, 10


# ============================================================================
# wire-format primitives
# ============================================================================

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
            raise ValueError("malformed varint")


def _to_signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value += 1 << 64
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _iter_fields(data: Union[bytes, memoryview]) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, payload) triples."""
    buf = memoryview(data)
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _packed_or_single_i64(wtype: int, val, out: List[int]) -> None:
    if wtype == 0:
        out.append(_to_signed64(val))
    else:  # packed
        buf = memoryview(val)
        pos = 0
        while pos < len(buf):
            v, pos = _read_varint(buf, pos)
            out.append(_to_signed64(v))


def _packed_or_single_f32(wtype: int, val, out: List[float]) -> None:
    if wtype == 5:
        out.append(struct.unpack("<f", val)[0])
    else:
        out.extend(np.frombuffer(bytes(val), dtype="<f4").tolist())


def _packed_or_single_f64(wtype: int, val, out: List[float]) -> None:
    if wtype == 1:
        out.append(struct.unpack("<d", val)[0])
    else:
        out.extend(np.frombuffer(bytes(val), dtype="<f8").tolist())


def _emit_tag(out: bytearray, fnum: int, wtype: int) -> None:
    _write_varint(out, (fnum << 3) | wtype)


def _emit_bytes(out: bytearray, fnum: int, payload: bytes) -> None:
    _emit_tag(out, fnum, 2)
    _write_varint(out, len(payload))
    out.extend(payload)


def _emit_str(out: bytearray, fnum: int, s: str) -> None:
    _emit_bytes(out, fnum, s.encode("utf-8"))


def _emit_varint_field(out: bytearray, fnum: int, value: int) -> None:
    _emit_tag(out, fnum, 0)
    _write_varint(out, value)


# ============================================================================
# message dataclasses (subset of onnx.proto3)
# ============================================================================

@dataclass
class TensorProto:
    name: str = ""
    dims: List[int] = field(default_factory=list)
    data_type: int = FLOAT
    raw_data: bytes = b""
    float_data: List[float] = field(default_factory=list)
    int32_data: List[int] = field(default_factory=list)
    int64_data: List[int] = field(default_factory=list)
    double_data: List[float] = field(default_factory=list)
    uint64_data: List[int] = field(default_factory=list)
    string_data: List[bytes] = field(default_factory=list)

    def to_numpy(self) -> np.ndarray:
        np_dtype = DTYPE_TO_NUMPY.get(self.data_type)
        if self.data_type == BFLOAT16:
            if self.raw_data:
                u16 = np.frombuffer(self.raw_data, dtype="<u2")
                return (u16.astype(np.uint32) << 16).view(np.float32).astype(
                    np.float32).reshape(self.dims)
            u16 = np.asarray(self.int32_data, dtype=np.uint32)
            return (u16 << 16).view(np.float32).reshape(self.dims)
        if np_dtype is None:
            raise TypeError(f"unsupported tensor data_type {self.data_type}")
        if self.raw_data:
            arr = np.frombuffer(self.raw_data, dtype=np.dtype(np_dtype).newbyteorder("<"))
            return arr.astype(np_dtype).reshape(self.dims)
        if self.data_type == FLOAT:
            arr = np.asarray(self.float_data, dtype=np.float32)
        elif self.data_type == DOUBLE:
            arr = np.asarray(self.double_data, dtype=np.float64)
        elif self.data_type == INT64:
            arr = np.asarray(self.int64_data, dtype=np.int64)
        elif self.data_type in (UINT64,):
            arr = np.asarray(self.uint64_data, dtype=np.uint64)
        elif self.data_type in (INT32, INT16, INT8, UINT16, UINT8, BOOL, FLOAT16):
            arr = np.asarray(self.int32_data)
            if self.data_type == FLOAT16:
                arr = arr.astype(np.uint16).view(np.float16)
            else:
                arr = arr.astype(np_dtype)
        else:
            raise TypeError(f"unsupported tensor data_type {self.data_type}")
        return arr.reshape(self.dims)

    @staticmethod
    def from_numpy(arr: np.ndarray, name: str = "") -> "TensorProto":
        arr = np.asarray(arr)  # NOT ascontiguousarray: it promotes 0-d to (1,)
        return TensorProto(name=name, dims=list(arr.shape),
                           data_type=numpy_to_elem_type(arr.dtype),
                           raw_data=arr.astype(
                               arr.dtype.newbyteorder("<")).tobytes())

    @staticmethod
    def parse(data) -> "TensorProto":
        t = TensorProto()
        for fnum, wtype, val in _iter_fields(data):
            if fnum == 1:
                _packed_or_single_i64(wtype, val, t.dims)
            elif fnum == 2:
                t.data_type = val
            elif fnum == 4:
                _packed_or_single_f32(wtype, val, t.float_data)
            elif fnum == 5:
                _packed_or_single_i64(wtype, val, t.int32_data)
            elif fnum == 6:
                t.string_data.append(bytes(val))
            elif fnum == 7:
                _packed_or_single_i64(wtype, val, t.int64_data)
            elif fnum == 8:
                t.name = bytes(val).decode("utf-8")
            elif fnum == 9:
                t.raw_data = bytes(val)
            elif fnum == 10:
                _packed_or_single_f64(wtype, val, t.double_data)
            elif fnum == 11:
                _packed_or_single_i64(wtype, val, t.uint64_data)
            elif fnum == 13:
                raise ValueError("external tensor data is not supported")
        return t

    def serialize(self) -> bytes:
        out = bytearray()
        for d in self.dims:
            _emit_varint_field(out, 1, d)
        _emit_varint_field(out, 2, self.data_type)
        if self.name:
            _emit_str(out, 8, self.name)
        if self.raw_data:
            _emit_bytes(out, 9, self.raw_data)
        return bytes(out)


@dataclass
class AttributeProto:
    name: str = ""
    type: int = 0
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: Optional[TensorProto] = None
    g: Optional["GraphProto"] = None
    floats: List[float] = field(default_factory=list)
    ints: List[int] = field(default_factory=list)
    strings: List[bytes] = field(default_factory=list)
    graphs: List["GraphProto"] = field(default_factory=list)

    def value(self) -> Any:
        if self.type == A_FLOAT:
            return self.f
        if self.type == A_INT:
            return self.i
        if self.type == A_STRING:
            return self.s.decode("utf-8")
        if self.type == A_TENSOR:
            return self.t.to_numpy()
        if self.type == A_GRAPH:
            return self.g
        if self.type == A_FLOATS:
            return list(self.floats)
        if self.type == A_INTS:
            return list(self.ints)
        if self.type == A_STRINGS:
            return [s.decode("utf-8") for s in self.strings]
        if self.type == A_GRAPHS:
            return list(self.graphs)
        raise ValueError(f"unsupported attribute type {self.type} for {self.name}")

    @staticmethod
    def parse(data) -> "AttributeProto":
        a = AttributeProto()
        for fnum, wtype, val in _iter_fields(data):
            if fnum == 1:
                a.name = bytes(val).decode("utf-8")
            elif fnum == 2:
                a.f = struct.unpack("<f", val)[0]
            elif fnum == 3:
                a.i = _to_signed64(val)
            elif fnum == 4:
                a.s = bytes(val)
            elif fnum == 5:
                a.t = TensorProto.parse(val)
            elif fnum == 6:
                a.g = GraphProto.parse(val)
            elif fnum == 7:
                _packed_or_single_f32(wtype, val, a.floats)
            elif fnum == 8:
                _packed_or_single_i64(wtype, val, a.ints)
            elif fnum == 9:
                a.strings.append(bytes(val))
            elif fnum == 11:
                a.graphs.append(GraphProto.parse(val))
            elif fnum == 20:
                a.type = val
        return a

    @staticmethod
    def make(name: str, value: Any) -> "AttributeProto":
        a = AttributeProto(name=name)
        if isinstance(value, bool):
            a.type, a.i = A_INT, int(value)
        elif isinstance(value, (int, np.integer)):
            a.type, a.i = A_INT, int(value)
        elif isinstance(value, (float, np.floating)):
            a.type, a.f = A_FLOAT, float(value)
        elif isinstance(value, str):
            a.type, a.s = A_STRING, value.encode("utf-8")
        elif isinstance(value, np.ndarray):
            a.type, a.t = A_TENSOR, TensorProto.from_numpy(value)
        elif isinstance(value, (list, tuple)):
            vals = list(value)
            if all(isinstance(v, (int, np.integer)) for v in vals):
                a.type, a.ints = A_INTS, [int(v) for v in vals]
            elif all(isinstance(v, str) for v in vals):
                a.type, a.strings = A_STRINGS, [v.encode("utf-8") for v in vals]
            else:
                a.type, a.floats = A_FLOATS, [float(v) for v in vals]
        else:
            raise TypeError(f"cannot encode attribute {name}={value!r}")
        return a

    def serialize(self) -> bytes:
        out = bytearray()
        _emit_str(out, 1, self.name)
        if self.type == A_FLOAT:
            _emit_tag(out, 2, 5)
            out.extend(struct.pack("<f", self.f))
        elif self.type == A_INT:
            _emit_varint_field(out, 3, self.i if self.i >= 0 else self.i + (1 << 64))
        elif self.type == A_STRING:
            _emit_bytes(out, 4, self.s)
        elif self.type == A_TENSOR:
            _emit_bytes(out, 5, self.t.serialize())
        elif self.type == A_FLOATS:
            for v in self.floats:
                _emit_tag(out, 7, 5)
                out.extend(struct.pack("<f", v))
        elif self.type == A_INTS:
            for v in self.ints:
                _emit_varint_field(out, 8, v if v >= 0 else v + (1 << 64))
        elif self.type == A_STRINGS:
            for s in self.strings:
                _emit_bytes(out, 9, s)
        else:
            raise TypeError(f"cannot serialize attribute type {self.type}")
        _emit_varint_field(out, 20, self.type)
        return bytes(out)


@dataclass
class NodeProto:
    op_type: str = ""
    name: str = ""
    domain: str = ""
    input: List[str] = field(default_factory=list)
    output: List[str] = field(default_factory=list)
    attribute: List[AttributeProto] = field(default_factory=list)

    def attrs(self) -> Dict[str, Any]:
        return {a.name: a.value() for a in self.attribute}

    @staticmethod
    def parse(data) -> "NodeProto":
        n = NodeProto()
        for fnum, wtype, val in _iter_fields(data):
            if fnum == 1:
                n.input.append(bytes(val).decode("utf-8"))
            elif fnum == 2:
                n.output.append(bytes(val).decode("utf-8"))
            elif fnum == 3:
                n.name = bytes(val).decode("utf-8")
            elif fnum == 4:
                n.op_type = bytes(val).decode("utf-8")
            elif fnum == 5:
                n.attribute.append(AttributeProto.parse(val))
            elif fnum == 7:
                n.domain = bytes(val).decode("utf-8")
        return n

    def serialize(self) -> bytes:
        out = bytearray()
        for s in self.input:
            _emit_str(out, 1, s)
        for s in self.output:
            _emit_str(out, 2, s)
        if self.name:
            _emit_str(out, 3, self.name)
        _emit_str(out, 4, self.op_type)
        for a in self.attribute:
            _emit_bytes(out, 5, a.serialize())
        if self.domain:
            _emit_str(out, 7, self.domain)
        return bytes(out)


@dataclass
class ValueInfoProto:
    name: str = ""
    elem_type: int = FLOAT
    #: ints for static dims, strings for symbolic dims, None when unknown
    shape: Optional[List[Union[int, str, None]]] = None

    @staticmethod
    def parse(data) -> "ValueInfoProto":
        v = ValueInfoProto()
        for fnum, _, val in _iter_fields(data):
            if fnum == 1:
                v.name = bytes(val).decode("utf-8")
            elif fnum == 2:
                v.elem_type, v.shape = _parse_type_proto(val)
        return v

    def serialize(self) -> bytes:
        out = bytearray()
        _emit_str(out, 1, self.name)
        _emit_bytes(out, 2, _serialize_type_proto(self.elem_type, self.shape))
        return bytes(out)


def _parse_type_proto(data) -> Tuple[int, Optional[List]]:
    elem_type, shape = FLOAT, None
    for fnum, _, val in _iter_fields(data):
        if fnum == 1:  # tensor_type
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    elem_type = v2
                elif f2 == 2:  # TensorShapeProto
                    shape = []
                    for f3, _, v3 in _iter_fields(v2):
                        if f3 == 1:  # Dimension
                            dim: Union[int, str, None] = None
                            for f4, _, v4 in _iter_fields(v3):
                                if f4 == 1:
                                    dim = _to_signed64(v4)
                                elif f4 == 2:
                                    dim = bytes(v4).decode("utf-8")
                            shape.append(dim)
    return elem_type, shape


def _serialize_type_proto(elem_type: int, shape: Optional[List]) -> bytes:
    tt = bytearray()
    _emit_varint_field(tt, 1, elem_type)
    if shape is not None:
        sh = bytearray()
        for dim in shape:
            d = bytearray()
            if isinstance(dim, (int, np.integer)):
                _emit_varint_field(d, 1, int(dim))
            elif isinstance(dim, str):
                _emit_str(d, 2, dim)
            _emit_bytes(sh, 1, bytes(d))
        _emit_bytes(tt, 2, bytes(sh))
    out = bytearray()
    _emit_bytes(out, 1, bytes(tt))
    return bytes(out)


@dataclass
class GraphProto:
    name: str = ""
    node: List[NodeProto] = field(default_factory=list)
    initializer: List[TensorProto] = field(default_factory=list)
    input: List[ValueInfoProto] = field(default_factory=list)
    output: List[ValueInfoProto] = field(default_factory=list)
    value_info: List[ValueInfoProto] = field(default_factory=list)

    @staticmethod
    def parse(data) -> "GraphProto":
        g = GraphProto()
        for fnum, _, val in _iter_fields(data):
            if fnum == 1:
                g.node.append(NodeProto.parse(val))
            elif fnum == 2:
                g.name = bytes(val).decode("utf-8")
            elif fnum == 5:
                g.initializer.append(TensorProto.parse(val))
            elif fnum == 11:
                g.input.append(ValueInfoProto.parse(val))
            elif fnum == 12:
                g.output.append(ValueInfoProto.parse(val))
            elif fnum == 13:
                g.value_info.append(ValueInfoProto.parse(val))
        return g

    def serialize(self) -> bytes:
        out = bytearray()
        for n in self.node:
            _emit_bytes(out, 1, n.serialize())
        if self.name:
            _emit_str(out, 2, self.name)
        for t in self.initializer:
            _emit_bytes(out, 5, t.serialize())
        for v in self.input:
            _emit_bytes(out, 11, v.serialize())
        for v in self.output:
            _emit_bytes(out, 12, v.serialize())
        for v in self.value_info:
            _emit_bytes(out, 13, v.serialize())
        return bytes(out)


@dataclass
class ModelProto:
    ir_version: int = 8
    producer_name: str = "synapseml_tpu"
    producer_version: str = "0.1"
    model_version: int = 0
    opset_version: int = 17
    domain: str = ""
    graph: Optional[GraphProto] = None

    @staticmethod
    def parse(data: bytes) -> "ModelProto":
        m = ModelProto()
        for fnum, _, val in _iter_fields(data):
            if fnum == 1:
                m.ir_version = _to_signed64(val)
            elif fnum == 2:
                m.producer_name = bytes(val).decode("utf-8")
            elif fnum == 3:
                m.producer_version = bytes(val).decode("utf-8")
            elif fnum == 5:
                m.model_version = _to_signed64(val)
            elif fnum == 7:
                m.graph = GraphProto.parse(val)
            elif fnum == 8:  # OperatorSetIdProto
                dom, ver = "", None
                for f2, _, v2 in _iter_fields(val):
                    if f2 == 1:
                        dom = bytes(v2).decode("utf-8")
                    elif f2 == 2:
                        ver = _to_signed64(v2)
                if ver is not None and dom in ("", "ai.onnx"):
                    m.opset_version = ver
        if m.graph is None:
            raise ValueError("ModelProto has no graph")
        return m

    def serialize(self) -> bytes:
        out = bytearray()
        _emit_varint_field(out, 1, self.ir_version)
        _emit_str(out, 2, self.producer_name)
        _emit_str(out, 3, self.producer_version)
        if self.model_version:
            _emit_varint_field(out, 5, self.model_version)
        _emit_bytes(out, 7, self.graph.serialize())
        ops = bytearray()
        _emit_str(ops, 1, self.domain)
        _emit_varint_field(ops, 2, self.opset_version)
        _emit_bytes(out, 8, bytes(ops))
        return bytes(out)


def load_model(source: Union[str, bytes]) -> ModelProto:
    """Parse an ONNX model from a file path or raw bytes."""
    if isinstance(source, str):
        with open(source, "rb") as f:
            source = f.read()
    return ModelProto.parse(source)
