"""Pure-Python TFRecord + tf.train.Example codec (no TensorFlow).

A copy of the JAX package's ``data/tfrecord.py`` (the port imports
nothing from that package).  The reference's real-data path feeds
ImageNet **TFRecord** shards through tf_cnn_benchmarks' tf.data
pipeline; here the wire formats are implemented from scratch:

- TFRecord framing: ``uint64 length | uint32 masked_crc32c(length) |
  bytes data | uint32 masked_crc32c(data)`` per record.
- ``tf.train.Example``: a minimal protobuf wire-format codec for the
  three-field Feature oneof (bytes_list=1, float_list=2, int64_list=3)
  nested in Features' map<string, Feature>.

Both directions are provided.  The writer makes test shards and the
committed fixture; the pure-Python reader (~1 MB/s: its CRC32C loops over
every byte) serves the tests and is the reference the native scanner
(``native.tfrecord_scanner``) is held to.  The input pipeline reads
through the native scanner only.  Unlike the JAX copy, ``read_records``
raises ``IOError`` (not ``struct.error``) on a record cut inside its
CRC fields.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Iterable, Iterator

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven, with TFRecord's mask transform.
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78  # reflected Castagnoli polynomial
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's CRC mask: rotate right 15 and add a constant."""
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------


def write_records(path: Path | str, records: Iterable[bytes]) -> int:
    """Write records in TFRecord framing; returns the record count."""
    n = 0
    with open(path, "wb") as f:
        for rec in records:
            length = struct.pack("<Q", len(rec))
            f.write(length)
            f.write(struct.pack("<I", masked_crc32c(length)))
            f.write(rec)
            f.write(struct.pack("<I", masked_crc32c(rec)))
            n += 1
    return n


def _read_exactly(f, n: int, path) -> bytes:
    data = f.read(n)
    if len(data) < n:
        raise IOError(f"{path}: truncated record")
    return data


def read_records(
    path: Path | str, verify_crc: bool = False
) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) < 8:
                raise IOError(f"{path}: truncated length header")
            (length,) = struct.unpack("<Q", header)
            (len_crc,) = struct.unpack("<I", _read_exactly(f, 4, path))
            if verify_crc and masked_crc32c(header) != len_crc:
                raise IOError(f"{path}: length CRC mismatch")
            data = _read_exactly(f, length, path)
            (data_crc,) = struct.unpack("<I", _read_exactly(f, 4, path))
            if verify_crc and masked_crc32c(data) != data_crc:
                raise IOError(f"{path}: data CRC mismatch")
            yield data


def count_records(path: Path | str) -> int:
    """Count records by seeking over payloads (no CRC, no parse) — cheap
    enough to size an epoch (--num_epochs) from the actual shards."""
    import os

    n = 0
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos < size:
            header = f.read(8)
            if len(header) < 8:
                raise IOError(f"{path}: truncated length header")
            (length,) = struct.unpack("<Q", header)
            pos += 8 + 4 + length + 4
            f.seek(pos)
            n += 1
    if pos > size:
        raise IOError(f"{path}: truncated record")
    return n


# ---------------------------------------------------------------------------
# Minimal protobuf wire codec for tf.train.Example
# ---------------------------------------------------------------------------


def _write_varint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


def _len_delim(field: int, payload: bytes) -> bytes:
    out = bytearray()
    _write_varint(out, _tag(field, 2))
    _write_varint(out, len(payload))
    out += payload
    return bytes(out)


FeatureValue = list  # list[bytes] | list[float] | list[int]


def build_example(features: dict[str, FeatureValue]) -> bytes:
    """Encode a feature dict as a serialized tf.train.Example.

    Value type is inferred from the first element: bytes -> bytes_list,
    float -> float_list, int -> int64_list.
    """
    feats = bytearray()
    for name, values in features.items():
        if not isinstance(values, (list, tuple)):
            values = [values]
        if not values:
            raise ValueError(f"feature {name!r} is empty")
        v0 = values[0]
        inner = bytearray()
        if isinstance(v0, (bytes, str)):
            payload = bytearray()
            for v in values:
                vb = v.encode() if isinstance(v, str) else v
                payload += _len_delim(1, vb)
            inner += _len_delim(1, bytes(payload))      # Feature.bytes_list
        elif isinstance(v0, float):
            packed = bytearray()
            _write_varint(packed, _tag(1, 2))           # FloatList.value packed
            body = struct.pack(f"<{len(values)}f", *values)
            _write_varint(packed, len(body))
            packed += body
            inner += _len_delim(2, bytes(packed))       # Feature.float_list
        elif isinstance(v0, int):
            packed = bytearray()
            _write_varint(packed, _tag(1, 2))           # Int64List.value packed
            body = bytearray()
            for v in values:
                _write_varint(body, v & 0xFFFFFFFFFFFFFFFF)
            _write_varint(packed, len(body))
            packed += body
            inner += _len_delim(3, bytes(packed))       # Feature.int64_list
        else:
            raise TypeError(f"feature {name!r}: unsupported {type(v0)}")
        entry = _len_delim(1, name.encode()) + _len_delim(2, bytes(inner))
        feats += _len_delim(1, entry)                   # Features.feature map
    return _len_delim(1, bytes(feats))                  # Example.features


def _parse_packed_or_repeated(buf, want_wire, unpack_one):
    """Parse values that may be packed (len-delim) or repeated scalar."""
    values, pos = [], 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:  # packed
            ln, pos = _read_varint(buf, pos)
            end = pos + ln
            while pos < end:
                v, pos = unpack_one(buf, pos)
                values.append(v)
        else:
            v, pos = unpack_one(buf, pos)
            values.append(v)
    return values


def _unpack_varint(buf, pos):
    v, pos = _read_varint(buf, pos)
    if v >= 1 << 63:  # two's-complement int64
        v -= 1 << 64
    return v, pos


def _unpack_f32(buf, pos):
    return struct.unpack_from("<f", buf, pos)[0], pos + 4


def _split_fields(buf: bytes) -> Iterator[tuple[int, int, bytes | int]]:
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
            yield field, wire, v
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            yield field, wire, buf[pos : pos + 4]
            pos += 4
        elif wire == 1:
            yield field, wire, buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def parse_example(data: bytes) -> dict[str, FeatureValue]:
    """Decode a serialized tf.train.Example into {name: values}."""
    out: dict[str, FeatureValue] = {}
    for field, wire, features_buf in _split_fields(data):
        if field != 1 or wire != 2:
            continue
        for f2, w2, entry in _split_fields(features_buf):
            if f2 != 1 or w2 != 2:
                continue
            name, feature_buf = None, b""
            for f3, w3, v3 in _split_fields(entry):
                if f3 == 1:
                    name = v3.decode()
                elif f3 == 2:
                    feature_buf = v3
            if name is None:
                continue
            values: FeatureValue = []
            for f4, w4, v4 in _split_fields(feature_buf):
                if f4 == 1:    # bytes_list
                    for f5, w5, v5 in _split_fields(v4):
                        if f5 == 1:
                            values.append(v5)
                elif f4 == 2:  # float_list
                    values = _parse_packed_or_repeated(v4, 5, _unpack_f32)
                elif f4 == 3:  # int64_list
                    values = _parse_packed_or_repeated(v4, 0, _unpack_varint)
            out[name] = values
    return out
