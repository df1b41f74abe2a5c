"""Experiment-tracking sink: TensorBoard event files written without any
dependency (port of emloco_tpu/utils/tracking.py, byte for byte the same
records).

The scalar-summary subset of the format is small and stable:

  * TFRecord framing: u64 length, masked CRC32C(length), payload,
    masked CRC32C(payload)
  * payload = Event proto {wall_time(1,double), step(2,int64),
    file_version(3,string) | summary(5, Summary{ value(1, repeated
    Value{tag(1,string), simple_value(2,float)})})}

For the same (wall_time, step, scalars) the records equal the JAX package's
byte for byte, and each package's `read_scalars` reads the other's files.
Both the writer and a reader are here.
"""
from __future__ import annotations

import os
import struct
import time
from typing import Dict, Iterator, Tuple

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven — TFRecord integrity checksums
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf wire encoding
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _ld(field: int, payload: bytes) -> bytes:       # length-delimited
    return _key(field, 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int, body: bytes = b"") -> bytes:
    return (_key(1, 1) + struct.pack("<d", wall_time)
            + _key(2, 0) + _varint(step) + body)


def _scalar_summary(scalars: Dict[str, float]) -> bytes:
    vals = b""
    for tag, v in scalars.items():
        val = _ld(1, tag.encode()) + _key(2, 5) + struct.pack("<f", float(v))
        vals += _ld(1, val)
    return _ld(5, vals)


class TBWriter:
    """Append-only TensorBoard scalar writer.

    >>> w = TBWriter("output/run/tb")          # doctest: +SKIP
    >>> w.scalars(3, {"loss/total": 1.2, "reward/loc": 0.9})  # doctest: +SKIP
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{os.uname().nodename}{filename_suffix}")
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        # tensorboard requires the version record first
        self._record(_event(time.time(), 0,
                            _ld(3, b"brain.Event:2")))

    def _record(self, payload: bytes):
        hdr = struct.pack("<Q", len(payload))
        self._f.write(hdr + struct.pack("<I", _masked_crc(hdr)) + payload
                      + struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def scalars(self, step: int, values: Dict[str, float]):
        self._record(_event(time.time(), int(step),
                            _scalar_summary(values)))

    def close(self):
        self._f.close()


# ---------------------------------------------------------------------------
# reader (round-trip tests; also handy for post-hoc analysis)
# ---------------------------------------------------------------------------

def read_scalars(path: str) -> Iterator[Tuple[int, str, float]]:
    """Yield (step, tag, value) from a scalar event file, verifying CRCs."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        (ln,) = struct.unpack_from("<Q", data, off)
        hdr = data[off:off + 8]
        (hcrc,) = struct.unpack_from("<I", data, off + 8)
        if _masked_crc(hdr) != hcrc:
            raise ValueError(f"bad length crc at {off}")
        payload = data[off + 12:off + 12 + ln]
        (pcrc,) = struct.unpack_from("<I", data, off + 12 + ln)
        if _masked_crc(payload) != pcrc:
            raise ValueError(f"bad payload crc at {off}")
        off += 12 + ln + 4
        yield from _parse_event(payload)


def _read_varint(b: bytes, i: int):
    n = s = 0
    while True:
        c = b[i]
        i += 1
        n |= (c & 0x7F) << s
        if not c & 0x80:
            return n, i
        s += 7


def _fields(b: bytes) -> Iterator[Tuple[int, int, object]]:
    i = 0
    while i < len(b):
        k, i = _read_varint(b, i)
        field, wire = k >> 3, k & 7
        if wire == 0:
            v, i = _read_varint(b, i)
        elif wire == 1:
            v = b[i:i + 8]
            i += 8
        elif wire == 2:
            ln, i = _read_varint(b, i)
            v = b[i:i + ln]
            i += ln
        elif wire == 5:
            v = b[i:i + 4]
            i += 4
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, v


def _parse_event(payload: bytes) -> Iterator[Tuple[int, str, float]]:
    step = 0
    summaries = []
    for field, wire, v in _fields(payload):
        if field == 2 and wire == 0:
            step = v
        elif field == 5 and wire == 2:
            summaries.append(v)
    for s in summaries:
        for field, wire, val in _fields(s):
            if field != 1 or wire != 2:
                continue
            tag, num = None, None
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == 2:
                    tag = v2.decode()
                elif f2 == 2 and w2 == 5:
                    (num,) = struct.unpack("<f", v2)
            if tag is not None and num is not None:
                yield step, tag, num
