"""Experiment writers: the JSONL metrics log and TensorBoard event files
(counterpart of dnsplatter_tpu/utils/writers.py).

`JsonlWriter` appends one json object per step; `TensorboardWriter` writes
standard tfevents files that stock TensorBoard reads. The record framing
(length + masked crc32c) and the Event/Summary protobuf messages are
encoded here (scalars only), with no tensorboard or tensorflow dependency,
so a file written by either package reads in the other.
"""

from __future__ import annotations

import json
import struct
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven — required by the tfevents framing
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf encoding (only what Event/Summary scalars need)
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    out = b""
    while True:
        bits = v & 0x7F
        v >>= 7
        if v:
            out += bytes([bits | 0x80])
        else:
            return out + bytes([bits])


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _event(step: Optional[int] = None,
           file_version: Optional[str] = None,
           scalars: Optional[Dict[str, float]] = None,
           wall_time: Optional[float] = None) -> bytes:
    msg = _pb_double(1, wall_time if wall_time is not None else time.time())
    if step is not None:
        msg += _pb_int64(2, step)
    if file_version is not None:
        msg += _pb_bytes(3, file_version.encode())
    if scalars:
        summary = b""
        for tag_name, val in scalars.items():
            value_msg = _pb_bytes(1, tag_name.encode()) + _pb_float(
                2, float(val)
            )
            summary += _pb_bytes(1, value_msg)
        msg += _pb_bytes(5, summary)
    return msg


class TensorboardWriter:
    """Append scalar events to a tfevents file under `log_dir`."""

    def __init__(self, log_dir: Path, run_name: str = ""):
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        host = run_name or "dnsplatter"
        self.path = log_dir / f"events.out.tfevents.{int(time.time())}.{host}"
        self._f = open(self.path, "ab")
        self._write_record(_event(file_version="brain.Event:2"))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))
        self._f.flush()

    def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        clean = {k: float(v) for k, v in scalars.items()
                 if isinstance(v, (int, float, np.floating, np.integer))}
        if clean:
            self._write_record(_event(step=step, scalars=clean))

    def close(self) -> None:
        self._f.close()


class JsonlWriter:
    """One json object per logged step (metrics.jsonl)."""

    def __init__(self, log_dir: Path, name: str = "metrics.jsonl"):
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        self.path = log_dir / name
        self._f = open(self.path, "a")

    def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        row = {"step": step}
        row.update({
            k: (float(v)
                if isinstance(v, (int, float, np.floating, np.integer))
                else v)
            for k, v in scalars.items()
        })
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_tfevents_scalars(path: Path):
    """Decode scalars back out of a tfevents file (tests / tooling)."""
    out = []
    data = Path(path).read_bytes()
    pos = 0
    while pos + 12 <= len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        payload = data[pos + 12: pos + 12 + length]
        assert struct.unpack_from("<I", data, pos + 8)[0] == _masked_crc(
            data[pos: pos + 8]
        ), "header crc mismatch"
        assert struct.unpack_from(
            "<I", data, pos + 12 + length
        )[0] == _masked_crc(payload), "payload crc mismatch"
        out.append(_decode_event(payload))
        pos += 12 + length + 4
    return out


def _read_varint(buf: bytes, pos: int):
    v = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


def _decode_event(buf: bytes):
    ev = {"scalars": {}}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 1:
            (val,) = struct.unpack_from("<d", buf, pos)
            pos += 8
            if field == 1:
                ev["wall_time"] = val
        elif wire == 0:
            val, pos = _read_varint(buf, pos)
            if field == 2:
                ev["step"] = val
        elif wire == 5:
            pos += 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            sub = buf[pos: pos + ln]
            pos += ln
            if field == 3:
                ev["file_version"] = sub.decode()
            elif field == 5:
                _decode_summary(sub, ev["scalars"])
    return ev


def _decode_summary(buf: bytes, out: Dict[str, float]) -> None:
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        if key >> 3 == 1 and key & 7 == 2:
            ln, pos = _read_varint(buf, pos)
            val_buf = buf[pos: pos + ln]
            pos += ln
            tag_name, value = None, None
            p2 = 0
            while p2 < len(val_buf):
                k2, p2 = _read_varint(val_buf, p2)
                if k2 >> 3 == 1 and k2 & 7 == 2:
                    ln2, p2 = _read_varint(val_buf, p2)
                    tag_name = val_buf[p2: p2 + ln2].decode()
                    p2 += ln2
                elif k2 >> 3 == 2 and k2 & 7 == 5:
                    (value,) = struct.unpack_from("<f", val_buf, p2)
                    p2 += 4
                else:
                    break
            if tag_name is not None and value is not None:
                out[tag_name] = value
        else:
            break
