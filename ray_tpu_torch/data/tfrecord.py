"""TFRecord framing + a minimal tf.train.Example codec (no TF needed).

Ref analog: python/ray/data/datasource/tfrecords_datasource.py — the
reference decodes via TensorFlow; this image has no TF, so both layers
are implemented against the public formats directly:

  - Record framing: [len u64le][masked crc32c(len) u32le][payload]
    [masked crc32c(payload) u32le] (tensorflow/core/lib/io/record
    format, public).
  - Payload: tf.train.Example protobuf — a Features message mapping
    feature names to BytesList/FloatList/Int64List. The wire format is
    standard protobuf (tag varints, length-delimited submessages), small
    enough to codec by hand.

CRC-32C uses the Castagnoli polynomial with TFRecord's mask rotation.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterable, List

# ---------------------------------------------------------------- crc32c

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ------------------------------------------------------------- record IO


def write_records(path: str, payloads: Iterable[bytes]):
    with open(path, "wb") as f:
        for data in payloads:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))


def read_records(path: str, *, verify: bool = True) -> List[bytes]:
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                break
            if len(header) < 8:
                raise ValueError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            if verify and (_masked_crc(header) != hcrc
                           or _masked_crc(data) != dcrc):
                raise ValueError(f"{path}: record crc mismatch")
            out.append(data)
    return out


# ------------------------------------------------- protobuf wire helpers


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _read_varint(buf: bytes, i: int):
    shift, val = 0, 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _ld(field: int, payload: bytes) -> bytes:  # length-delimited field
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


# --------------------------------------------------- tf.train.Example


def encode_example(features: Dict[str, Any]) -> bytes:
    """{name: bytes | str | [int] | [float] | int | float} -> Example
    wire bytes. Lists must be homogeneous."""
    feats = b""
    for name, value in features.items():
        if isinstance(value, bytes):
            value = [value]
        elif isinstance(value, str):
            value = [value.encode()]
        elif isinstance(value, (int, float)):
            value = [value]
        value = list(value)
        if value and isinstance(value[0], str):
            value = [v.encode() for v in value]
        if value and isinstance(value[0], bytes):
            # BytesList (field 1): repeated bytes value = 1
            payload = b"".join(_ld(1, v) for v in value)
            feature = _ld(1, payload)
        elif value and isinstance(value[0], float):
            # FloatList (field 2): packed repeated float value = 1
            packed = struct.pack(f"<{len(value)}f", *value)
            feature = _ld(2, _ld(1, packed))
        else:
            # Int64List (field 3): packed repeated int64 value = 1
            packed = b"".join(_varint(v & 0xFFFFFFFFFFFFFFFF)
                              for v in value)
            feature = _ld(3, _ld(1, packed))
        # Features.feature map entry: key (field 1, string) +
        # value (field 2, Feature)
        entry = _ld(1, name.encode()) + _ld(2, feature)
        feats += _ld(1, entry)
    return _ld(1, feats)  # Example.features (field 1)


def decode_example(data: bytes) -> Dict[str, Any]:
    """Example wire bytes -> {name: list} (bytes/float/int lists)."""
    out: Dict[str, Any] = {}
    # Example: field 1 = Features
    i = 0
    while i < len(data):
        tag, i = _read_varint(data, i)
        if tag >> 3 == 1 and tag & 7 == 2:
            ln, i = _read_varint(data, i)
            _decode_features(data[i:i + ln], out)
            i += ln
        else:
            i = _skip(data, i, tag)
    return out


def _decode_features(buf: bytes, out: Dict[str, Any]):
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        if tag >> 3 == 1 and tag & 7 == 2:  # map entry
            ln, i = _read_varint(buf, i)
            _decode_entry(buf[i:i + ln], out)
            i += ln
        else:
            i = _skip(buf, i, tag)


def _decode_entry(buf: bytes, out: Dict[str, Any]):
    key, value = "", None
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        ln, i = _read_varint(buf, i)
        if tag >> 3 == 1:
            key = buf[i:i + ln].decode()
        elif tag >> 3 == 2:
            value = _decode_feature(buf[i:i + ln])
        i += ln
    if key:
        out[key] = value


def _decode_feature(buf: bytes):
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        ln, i = _read_varint(buf, i)
        body = buf[i:i + ln]
        i += ln
        kind = tag >> 3
        if kind == 1:  # BytesList
            vals, j = [], 0
            while j < len(body):
                t, j = _read_varint(body, j)
                bl, j = _read_varint(body, j)
                vals.append(body[j:j + bl])
                j += bl
            return vals
        if kind == 2:  # FloatList (packed, field 1)
            j = 0
            vals = []
            while j < len(body):
                t, j = _read_varint(body, j)
                bl, j = _read_varint(body, j)
                vals.extend(struct.unpack(f"<{bl // 4}f",
                                          body[j:j + bl]))
                j += bl
            return vals
        if kind == 3:  # Int64List (packed varints, field 1)
            j = 0
            vals = []
            while j < len(body):
                t, j = _read_varint(body, j)
                bl, j = _read_varint(body, j)
                end = j + bl
                while j < end:
                    v, j = _read_varint(body, j)
                    if v >= 1 << 63:
                        v -= 1 << 64
                    vals.append(v)
            return vals
    return []


def _skip(buf: bytes, i: int, tag: int) -> int:
    wt = tag & 7
    if wt == 0:
        _, i = _read_varint(buf, i)
    elif wt == 2:
        ln, i = _read_varint(buf, i)
        i += ln
    elif wt == 5:
        i += 4
    elif wt == 1:
        i += 8
    else:
        raise ValueError(f"unsupported wire type {wt}")
    return i
