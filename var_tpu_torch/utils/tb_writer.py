"""Minimal TensorBoard event-file writer (port of
var_tpu/utils/tb_writer.py; no TensorFlow or tensorboard package).

Writes standard TFRecord-framed `Event` protobufs with scalar `Summary`
values, readable by any stock TensorBoard, byte for byte the files the
JAX package writes (tests/test_torch_tb_kvlogger.py).

Only the protobuf subset scalars need is encoded (hand-rolled — the
image ships no protobuf/tensorboard packages):

    Event  { double wall_time = 1; int64 step = 2;
             string file_version = 3; Summary summary = 5; }
    Summary{ repeated Value value = 1; }
    Value  { string tag = 1; float simple_value = 2; }

TFRecord framing per record: u64le length, u32le masked-crc32c(length),
payload, u32le masked-crc32c(payload); crc32c = Castagnoli.
"""
from __future__ import annotations

import os
import struct
import time
from typing import Dict, Optional

import numpy as np

# -- crc32c (Castagnoli, table-driven) ---------------------------------------

_POLY = 0x82F63B78


def _make_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_POLY if crc & 1 else 0)
        table[i] = crc
    return table


_TABLE = _make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    tab = _TABLE
    for b in data:
        crc = (crc >> 8) ^ int(tab[(crc ^ b) & 0xFF])
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- protobuf wire-format helpers (subset) -----------------------------------

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


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _field_double(num: int, v: float) -> bytes:
    return _varint(num << 3 | 1) + struct.pack("<d", v)


def _field_float(num: int, v: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", v)


def _field_varint(num: int, v: int) -> bytes:
    return _varint(num << 3 | 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def encode_event(wall_time: float, step: Optional[int] = None,
                 scalars: Optional[Dict[str, float]] = None,
                 file_version: Optional[str] = None) -> bytes:
    msg = _field_double(1, wall_time)
    if step is not None:
        msg += _field_varint(2, int(step))
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _field_bytes(1, _field_bytes(1, tag.encode())
                         + _field_float(2, float(val)))
            for tag, val in scalars.items())
        msg += _field_bytes(5, summary)
    return msg


def frame_record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc(header))
            + payload + struct.pack("<I", masked_crc(payload)))


class EventFileWriter:
    """Append-only scalar event writer; one file per instance."""

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{os.uname().nodename}{filename_suffix}")
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._f.write(frame_record(
            encode_event(time.time(), file_version="brain.Event:2")))
        self._f.flush()

    def add_scalars(self, step: int, scalars: Dict[str, float],
                    wall_time: Optional[float] = None):
        numeric = {k: float(v) for k, v in scalars.items()
                   if isinstance(v, (int, float, np.integer, np.floating))}
        if not numeric:
            return
        self._f.write(frame_record(encode_event(
            wall_time if wall_time is not None else time.time(),
            step=step, scalars=numeric)))
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.close()


# -- decoder (used by tests; also handy for inspection) ----------------------

def read_events(path: str):
    """Parse a scalar event file back into
    [(wall_time, step, {tag: value})]; validates both CRCs per record."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        (length,) = struct.unpack_from("<Q", data, i)
        header = data[i:i + 8]
        (hcrc,) = struct.unpack_from("<I", data, i + 8)
        assert masked_crc(header) == hcrc, "header crc mismatch"
        payload = data[i + 12:i + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, i + 12 + length)
        assert masked_crc(payload) == pcrc, "payload crc mismatch"
        i += 16 + length
        out.append(_decode_event(payload))
    return out


def _read_varint(buf: bytes, i: int):
    shift = v = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def _decode_event(buf: bytes):
    wall, step, scalars = 0.0, None, {}
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 1:
            (val,) = struct.unpack_from("<d", buf, i)
            i += 8
            if num == 1:
                wall = val
        elif wire == 0:
            val, i = _read_varint(buf, i)
            if num == 2:
                step = val
        elif wire == 5:
            i += 4
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            sub = buf[i:i + ln]
            i += ln
            if num == 5:  # summary
                j = 0
                while j < len(sub):
                    k2, j = _read_varint(sub, j)
                    if k2 >> 3 == 1 and k2 & 7 == 2:
                        vlen, j = _read_varint(sub, j)
                        scalars.update(_decode_value(sub[j:j + vlen]))
                        j += vlen
                    else:
                        raise ValueError("unexpected summary field")
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return wall, step, scalars


def _decode_value(buf: bytes):
    tag, val = None, None
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if num == 1 and wire == 2:
            ln, i = _read_varint(buf, i)
            tag = buf[i:i + ln].decode()
            i += ln
        elif num == 2 and wire == 5:
            (val,) = struct.unpack_from("<f", buf, i)
            i += 4
        else:
            raise ValueError("unexpected value field")
    return {tag: val} if tag is not None else {}
