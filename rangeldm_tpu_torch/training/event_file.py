"""TensorBoard event files written and read with the standard library.

An event file is a sequence of TFRecord records, each

    length (uint64, little-endian) | masked CRC32C of the length |
    payload | masked CRC32C of the payload

around a serialized `Event` protobuf. The first event carries
`file_version = "brain.Event:2"`; each scalar is an event with its
`wall_time`, `step` and a `Summary` of one `{tag, simple_value}`. This is
what tensorboardX's `SummaryWriter.add_scalar` writes, and TensorBoard
reads it; no tensorboard or protobuf package is needed to write or read it
here.

    w = EventFileWriter("<out_dir>/tb")
    w.add_scalar("loss", 0.5, step=1)
    w.close()
    read_scalars("<out_dir>/tb")    # [(1, "loss", 0.5)]
"""

from __future__ import annotations

import glob
import itertools
import os
import socket
import struct
import time
from typing import Iterator, List, Optional, Tuple

FILE_VERSION = "brain.Event:2"
_CASTAGNOLI = 0x82F63B78          # CRC-32C's polynomial, bit-reversed
_names = itertools.count()        # files this process opens, for their names


def _crc_table() -> List[int]:
    table = []
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = (crc >> 1) ^ (_CASTAGNOLI if crc & 1 else 0)
        table.append(crc)
    return table


_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli); crc32c(b"123456789") == 0xE3069283."""
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """The TFRecord mask of a record's CRC."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frame(payload: bytes) -> bytes:
    """One TFRecord record around `payload`."""
    length = struct.pack("<Q", len(payload))
    return (length + struct.pack("<I", masked_crc32c(length)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


def read_records(path: str) -> Iterator[bytes]:
    """The payloads of a TFRecord file; a bad CRC or a cut record raises."""
    with open(path, "rb") as f:
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) < 12:
                raise ValueError(f"{path}: record header cut short")
            length = head[:8]
            if struct.unpack("<I", head[8:])[0] != masked_crc32c(length):
                raise ValueError(f"{path}: bad length CRC")
            (n,) = struct.unpack("<Q", length)
            payload = f.read(n)
            tail = f.read(4)
            if len(payload) < n or len(tail) < 4:
                raise ValueError(f"{path}: record cut short")
            if struct.unpack("<I", tail)[0] != masked_crc32c(payload):
                raise ValueError(f"{path}: bad payload CRC")
            yield payload


# --- the protobuf wire format, as far as Event and Summary need it ---------

def _varint(v: int) -> bytes:
    v &= 0xFFFFFFFFFFFFFFFF           # int64 two's complement, as protobuf
    out = bytearray()
    while True:
        low = v & 0x7F
        v >>= 7
        if v:
            out.append(low | 0x80)
        else:
            out.append(low)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def encode_event(wall_time: float, step: Optional[int] = None,
                 file_version: Optional[str] = None,
                 scalar: Optional[Tuple[str, float]] = None) -> bytes:
    """An `Event`: wall_time (1, double), step (2, varint), file_version
    (3, string), summary (5) holding one value {tag (1), simple_value (2,
    float32)}."""
    out = _key(1, 1) + struct.pack("<d", wall_time)
    if step is not None:
        out += _key(2, 0) + _varint(int(step))
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if scalar is not None:
        tag, value = scalar
        val = (_bytes_field(1, tag.encode())
               + _key(2, 5) + struct.pack("<f", value))
        out += _bytes_field(5, _bytes_field(1, val))
    return out


def _fields(data: bytes) -> Iterator[Tuple[int, object]]:
    """(field, value) of a message: an int for varints, bytes for the
    other wire types."""
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(data, i)
        elif wire == 1:
            value, i = data[i:i + 8], i + 8
        elif wire == 2:
            n, i = _read_varint(data, i)
            value, i = data[i:i + n], i + n
        elif wire == 5:
            value, i = data[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, value


def _read_varint(data: bytes, i: int) -> Tuple[int, int]:
    shift = value = 0
    while True:
        byte = data[i]
        i += 1
        value |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return value, i


def decode_event(payload: bytes) -> dict:
    """wall_time, step, file_version and the summary's (tag, simple_value)
    pairs of an `Event`; fields this module does not write are skipped."""
    event = {"wall_time": 0.0, "step": 0, "file_version": None,
             "values": []}
    for field, value in _fields(payload):
        if field == 1:
            event["wall_time"] = struct.unpack("<d", value)[0]
        elif field == 2:
            step = value
            event["step"] = step - (1 << 64) if step >> 63 else step
        elif field == 3:
            event["file_version"] = value.decode()
        elif field == 5:
            for f, val in _fields(value):
                if f != 1:
                    continue
                tag, simple = None, None
                for vf, v in _fields(val):
                    if vf == 1:
                        tag = v.decode()
                    elif vf == 2:
                        simple = struct.unpack("<f", v)[0]
                event["values"].append((tag, simple))
    return event


def event_files(logdir: str) -> List[str]:
    """The event files of a directory in the order they were opened: by
    the time in their names, then by the writer's pid and count."""
    def key(path):
        parts = os.path.basename(path).split(".")
        return tuple(int(p) if p.isdigit() else -1
                     for p in (parts[3], parts[-2], parts[-1]))
    return sorted(glob.glob(os.path.join(logdir, "events.out.tfevents.*")),
                  key=key)


def read_scalars(logdir: str) -> List[Tuple[int, str, float]]:
    """(step, tag, value) of every scalar in a directory's event files, in
    the order written. Each file must open with the file-version event."""
    out = []
    for path in event_files(logdir):
        events = [decode_event(p) for p in read_records(path)]
        if not events or events[0]["file_version"] != FILE_VERSION:
            raise ValueError(f"{path} does not open with {FILE_VERSION}")
        out.extend((e["step"], tag, value) for e in events[1:]
                   for tag, value in e["values"])
    return out


class EventFileWriter:
    """Appends scalar events to a new file
    `<logdir>/events.out.tfevents.<time>.<host>.<pid>.<n>`; each
    `add_scalar` is flushed to the file before it returns."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(now):010d}."
            f"{socket.gethostname()}.{os.getpid()}.{next(_names)}")
        self._f = open(self.path, "wb")
        self._write(encode_event(now, file_version=FILE_VERSION))

    def _write(self, payload: bytes) -> None:
        self._f.write(frame(payload))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(encode_event(time.time(), step=step,
                                 scalar=(tag, float(value))))

    def close(self) -> None:
        self._f.close()         # flushes; a second close does nothing

    @property
    def closed(self) -> bool:
        return self._f.closed
