"""Dependency-free TensorBoard scalar event writer: a copy of the JAX
package's ``utils/tensorboard.py``, so either package reads the other's
event files.

TensorBoard's on-disk format is simple enough to emit directly: an
``events.out.tfevents.*`` file is a sequence of TFRecords, each holding a
serialized ``tensorflow.Event`` protobuf. This module hand-encodes the two
layers (protobuf wire format + TFRecord framing with masked CRC32-C) with
no new dependency. TensorBoard's Scalars dashboard reads ``simple_value``
summaries from these files as they are.

Wire formats implemented:
- protobuf: varint (wire type 0), 64-bit double (type 1), length-delimited
  (type 2), 32-bit float (type 5). Messages used: ``Event{wall_time=1 double,
  step=2 int64, file_version=3 string, summary=5 Summary}``,
  ``Summary{value=1 repeated Value}``, ``Summary.Value{tag=1 string,
  simple_value=2 float}``.
- TFRecord: ``[len:8 LE][masked_crc32c(len):4][data][masked_crc32c(data):4]``
  where ``mask(c) = ((c >> 15 | c << 17) + 0xa282ead8) mod 2^32`` and the CRC
  is CRC32-C (Castagnoli), not zlib's CRC32.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Optional

# ---------------------------------------------------------------------------
# CRC32-C (Castagnoli, reflected, poly 0x1EDC6F41 -> reversed 0x82F63B78)
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf encoding
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _scalar_event(wall_time: float, step: int, tag: str, value: float) -> bytes:
    summary_value = _f_bytes(1, tag.encode("utf-8")) + _f_float(2, float(value))
    summary = _f_bytes(1, summary_value)
    return _f_double(1, wall_time) + _f_int64(2, int(step)) + _f_bytes(5, summary)


def _version_event(wall_time: float) -> bytes:
    return _f_double(1, wall_time) + _f_bytes(3, b"brain.Event:2")


def _tfrecord(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (
        header
        + struct.pack("<I", masked_crc32c(header))
        + data
        + struct.pack("<I", masked_crc32c(data))
    )


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


class TensorBoardWriter:
    """Append-only scalar writer producing TensorBoard-readable event files.

    Thread-safe (the trainer's async validation thread logs concurrently with
    the train loop). Each process/writer gets its own file — TensorBoard
    merges all ``events.out.tfevents.*`` files found under a logdir.
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname().split(".")[0] or "localhost"
        name = f"events.out.tfevents.{time.time():.6f}.{host}.{os.getpid()}{filename_suffix}"
        self.path = os.path.join(logdir, name)
        self._lock = threading.Lock()
        self._fh = open(self.path, "ab")
        self._write(_version_event(time.time()))

    def _write(self, event_bytes: bytes) -> None:
        self._fh.write(_tfrecord(event_bytes))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        with self._lock:
            if self._fh is None:
                return
            self._write(_scalar_event(wall_time or time.time(), step, tag, value))

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None


# ---------------------------------------------------------------------------
# Reader (for tests and offline inspection; TensorBoard itself is the
# intended consumer)
# ---------------------------------------------------------------------------


def read_scalars(path: str):
    """Parse an event file back into [(wall_time, step, tag, value)].

    Verifies the TFRecord CRCs — a corrupted file raises ValueError.
    """
    out = []
    with open(path, "rb") as fh:
        raw = fh.read()
    pos = 0
    while pos < len(raw):
        header = raw[pos : pos + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", raw[pos + 8 : pos + 12])
        if hcrc != masked_crc32c(header):
            raise ValueError(f"bad length crc at offset {pos}")
        data = raw[pos + 12 : pos + 12 + length]
        (dcrc,) = struct.unpack("<I", raw[pos + 12 + length : pos + 16 + length])
        if dcrc != masked_crc32c(data):
            raise ValueError(f"bad data crc at offset {pos}")
        pos += 16 + length
        evt = _decode_fields(data)
        wall = evt.get((1, 1), 0.0)
        step = evt.get((2, 0), 0)
        summary = evt.get((5, 2))
        if summary is None:
            continue
        for v in _decode_repeated(summary, 1):
            val = _decode_fields(v)
            tag = val.get((1, 2), b"").decode("utf-8")
            simple = val.get((2, 5))
            if simple is not None:
                out.append((wall, step, tag, simple))
    return out


def _decode_fields(data: bytes) -> dict:
    """One pass of proto decoding: {(field, wire_type): last value}."""
    out = {}
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = _read_varint(data, pos)
        elif wt == 1:
            (v,) = struct.unpack_from("<d", data, pos)
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(data, pos)
            v = data[pos : pos + ln]
            pos += ln
        elif wt == 5:
            (v,) = struct.unpack_from("<f", data, pos)
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        out[(field, wt)] = v
    return out


def _decode_repeated(data: bytes, want_field: int):
    """All length-delimited payloads of ``want_field`` in ``data``."""
    vals = []
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            _, pos = _read_varint(data, pos)
        elif wt == 1:
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(data, pos)
            if field == want_field:
                vals.append(data[pos : pos + ln])
            pos += ln
        elif wt == 5:
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
    return vals


def _read_varint(data: bytes, pos: int):
    result = shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
