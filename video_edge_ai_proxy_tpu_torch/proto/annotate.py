"""The ``AnnotateRequest`` message and its proto3 wire codec, without
``protobuf``.

The annotation queue carries the wire bytes of an ``AnnotateRequest``
(``proto/video_streaming.proto``): the engine writes them, gRPC
``Annotate`` writes what a client sent, and the uplink's batch handler
decodes them. The engine and the uplink use this codec, so they need no
``protobuf`` (only the server's wire imports it); ``encode`` writes the
bytes ``pb.AnnotateRequest.SerializeToString()`` writes for the same
fields:

- fields in field-number order; an implicit-presence scalar equal to its
  default (0, "", false) is not written, a double whose bits are not all
  zero is (so -0.0 and NaN are, as protobuf writes them);
- int32 and int64 as varints, a negative one sign-extended to 10 bytes;
  doubles as 8 little-endian bytes;
- the nested ``BoundingBox``, ``Location`` and ``Coordinate`` are written
  when set (None = unset), even when all their fields are defaults;
- ``mask`` (13) as one length-delimited message per element,
  ``object_signature`` (14) as one packed ``repeated double``.

``decode`` reads any valid encoding of the message: fields in any order,
unknown fields skipped, a scalar seen twice keeps the last value, a
nested message seen twice merges, field 14 packed or not.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5
_DOUBLE = struct.Struct("<d")
_MASK64 = (1 << 64) - 1


@dataclass
class BoundingBox:
    top: int = 0        # 1, int32
    left: int = 0       # 2, int32
    width: int = 0      # 3, int32
    height: int = 0     # 4, int32


@dataclass
class Location:
    lat: float = 0.0    # 1, double
    lon: float = 0.0    # 2, double


@dataclass
class Coordinate:
    x: float = 0.0      # 1, double
    y: float = 0.0      # 2, double
    z: float = 0.0      # 3, double


@dataclass
class AnnotateRequest:
    device_name: str = ""                                   # 1
    remote_stream_id: str = ""                              # 2
    type: str = ""                                          # 3
    start_timestamp: int = 0                                # 4, int64
    end_timestamp: int = 0                                  # 5, int64
    object_type: str = ""                                   # 6
    object_id: str = ""                                     # 7
    object_tracking_id: str = ""                            # 8
    confidence: float = 0.0                                 # 9, double
    object_bouding_box: Optional[BoundingBox] = None        # 10
    location: Optional[Location] = None                     # 11
    object_coordinate: Optional[Coordinate] = None          # 12
    mask: List[Coordinate] = field(default_factory=list)    # 13
    object_signature: List[float] = field(default_factory=list)  # 14, packed double
    ml_model: str = ""                                      # 15
    ml_model_version: str = ""                              # 16
    width: int = 0                                          # 17, int32
    height: int = 0                                         # 18, int32
    is_keyframe: bool = False                               # 19
    video_type: str = ""                                    # 20
    offset_timestamp: int = 0                               # 21, int64
    offset_duration: int = 0                                # 22, int64
    offset_frame_id: int = 0                                # 23, int64
    offset_packet_id: int = 0                               # 24, int64
    custom_meta_1: str = ""                                 # 25
    custom_meta_2: str = ""                                 # 26
    custom_meta_3: str = ""                                 # 27
    custom_meta_4: str = ""                                 # 28
    custom_meta_5: str = ""                                 # 29


# Per message: (field number, attribute, kind) in field-number order.
# Kinds: "str", "i32", "i64", "bool", "double", a message class (singular),
# ("repeated", class) and "packed_double".
_SCHEMA = {
    BoundingBox: ((1, "top", "i32"), (2, "left", "i32"), (3, "width", "i32"),
                  (4, "height", "i32")),
    Location: ((1, "lat", "double"), (2, "lon", "double")),
    Coordinate: ((1, "x", "double"), (2, "y", "double"), (3, "z", "double")),
    AnnotateRequest: (
        (1, "device_name", "str"), (2, "remote_stream_id", "str"), (3, "type", "str"),
        (4, "start_timestamp", "i64"), (5, "end_timestamp", "i64"),
        (6, "object_type", "str"), (7, "object_id", "str"),
        (8, "object_tracking_id", "str"), (9, "confidence", "double"),
        (10, "object_bouding_box", BoundingBox), (11, "location", Location),
        (12, "object_coordinate", Coordinate), (13, "mask", ("repeated", Coordinate)),
        (14, "object_signature", "packed_double"), (15, "ml_model", "str"),
        (16, "ml_model_version", "str"), (17, "width", "i32"), (18, "height", "i32"),
        (19, "is_keyframe", "bool"), (20, "video_type", "str"),
        (21, "offset_timestamp", "i64"), (22, "offset_duration", "i64"),
        (23, "offset_frame_id", "i64"), (24, "offset_packet_id", "i64"),
        (25, "custom_meta_1", "str"), (26, "custom_meta_2", "str"),
        (27, "custom_meta_3", "str"), (28, "custom_meta_4", "str"),
        (29, "custom_meta_5", "str"),
    ),
}


class DecodeError(ValueError):
    """Bytes that are not a valid encoding of the message."""


# -- encoding ----------------------------------------------------------------


def _varint(v: int) -> bytes:
    v &= _MASK64      # negatives: two's complement over 64 bits, 10 bytes
    out = bytearray()
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _tag(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _len_field(num: int, payload: bytes) -> bytes:
    return _tag(num, _LEN) + _varint(len(payload)) + payload


def _encode_msg(msg) -> bytes:
    parts = []
    for num, name, kind in _SCHEMA[type(msg)]:
        v = getattr(msg, name)
        if kind == "str":
            if v:
                parts.append(_len_field(num, v.encode("utf-8")))
        elif kind in ("i32", "i64"):
            if v:
                parts.append(_tag(num, _VARINT) + _varint(int(v)))
        elif kind == "bool":
            if v:
                parts.append(_tag(num, _VARINT) + b"\x01")
        elif kind == "double":
            raw = _DOUBLE.pack(float(v))
            if raw != b"\x00" * 8:
                parts.append(_tag(num, _I64) + raw)
        elif kind == "packed_double":
            if v:
                parts.append(_len_field(num, b"".join(_DOUBLE.pack(float(x)) for x in v)))
        elif isinstance(kind, tuple):
            for item in v:
                parts.append(_len_field(num, _encode_msg(item)))
        elif v is not None:
            parts.append(_len_field(num, _encode_msg(v)))
    return b"".join(parts)


def encode(req: AnnotateRequest) -> bytes:
    """The proto3 wire bytes of ``req``, as protobuf serializes them."""
    return _encode_msg(req)


# -- decoding ----------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & _MASK64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than 10 bytes")


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _skip(buf: bytes, pos: int, wire: int) -> int:
    if wire == _VARINT:
        return _read_varint(buf, pos)[1]
    if wire == _I64:
        end = pos + 8
    elif wire == _I32:
        end = pos + 4
    elif wire == _LEN:
        n, pos = _read_varint(buf, pos)
        end = pos + n
    else:
        raise DecodeError(f"unsupported wire type {wire}")
    if end > len(buf):
        raise DecodeError("truncated field")
    return end


def _decode_into(msg, buf: bytes) -> None:
    fields = {num: (name, kind) for num, name, kind in _SCHEMA[type(msg)]}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if num == 0:
            raise DecodeError("field number 0")
        spec = fields.get(num)
        if spec is None:
            pos = _skip(buf, pos, wire)
            continue
        name, kind = spec
        if wire == _LEN:
            n, pos = _read_varint(buf, pos)
            if pos + n > len(buf):
                raise DecodeError(f"truncated field {name}")
            payload, pos = buf[pos:pos + n], pos + n
            if kind == "str":
                try:
                    setattr(msg, name, payload.decode("utf-8"))
                except UnicodeDecodeError as exc:
                    raise DecodeError(f"field {name} is not UTF-8") from exc
            elif kind == "packed_double":
                if n % 8:
                    raise DecodeError(f"packed {name} of {n} bytes")
                getattr(msg, name).extend(v for (v,) in _DOUBLE.iter_unpack(payload))
            elif isinstance(kind, tuple):
                item = kind[1]()
                _decode_into(item, payload)
                getattr(msg, name).append(item)
            elif isinstance(kind, type):
                sub = getattr(msg, name)
                if sub is None:
                    sub = kind()
                    setattr(msg, name, sub)
                _decode_into(sub, payload)    # a repeated occurrence merges
            else:
                raise DecodeError(f"field {name}: wire type {wire}")
        elif wire == _VARINT and kind in ("i32", "i64", "bool"):
            v, pos = _read_varint(buf, pos)
            setattr(msg, name, bool(v) if kind == "bool"
                    else _signed(v, 32 if kind == "i32" else 64))
        elif wire == _I64 and kind in ("double", "packed_double"):
            if pos + 8 > len(buf):
                raise DecodeError(f"truncated field {name}")
            (v,) = _DOUBLE.unpack_from(buf, pos)
            pos += 8
            if kind == "double":
                setattr(msg, name, v)
            else:
                getattr(msg, name).append(v)    # an unpacked element
        else:
            raise DecodeError(f"field {name}: wire type {wire}")


def decode(raw: bytes) -> AnnotateRequest:
    """The ``AnnotateRequest`` of proto3 wire bytes; raises DecodeError on
    bytes that are not one."""
    req = AnnotateRequest()
    _decode_into(req, bytes(raw))
    return req

