"""TensorBoard scalars written and read by the port itself: event files as
tensorboardX writes them, without the tensorboard, tensorboardX or
TensorFlow packages (the GPU machine has none of them).

An event file is TFRecord framing around ``Event`` protocol buffers: each
record is a little-endian u64 length, the masked CRC32C of those 8 bytes,
the data, and the masked CRC32C of the data. The first record is the
``file_version`` event ("brain.Event:2"); each scalar is one
``Event{wall_time, step, summary{value{tag, simple_value}}}`` with the
value as float32, tensorboardX's default scalar form. The protocol buffers
are encoded by hand, field by field, in field-number order and with proto3's
defaults left out, as protobuf serializes them, so the records are byte-equal
to tensorboardX's for the same wall time.

``SummaryWriter`` writes each record with one unbuffered write, so a record
is on disk when ``add_scalar`` returns, whatever ends the process after it
(a SIGKILL included); its file is closed by ``close()``, when the writer is
collected, or at exit. ``read_scalars`` reads a file or a directory back,
checking both CRCs of every record. ``tensorboard --logdir`` on any machine
that has TensorBoard reads the files.
"""

import os
import re
import socket
import struct
import time
import weakref
from pathlib import Path

import numpy as np

FILE_VERSION = "brain.Event:2"
_INVALID_TAG_CHARACTERS = re.compile(r"[^-/\w\.]")  # tensorboardX's _clean_tag


def _crc32c_table():
    table = []
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
        table.append(crc)
    return tuple(table)


_CRC32C_TABLE = _crc32c_table()


def crc32c(data):
    """The CRC32C (Castagnoli) of ``data``, from a 256-entry table."""
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC32C_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data):
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frame(data):
    """One TFRecord: length, its masked CRC, the data, the data's masked CRC."""
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data
            + struct.pack("<I", masked_crc32c(data)))


# ------------------------------------------------------------ protobuf wire

def _varint(n):
    n &= (1 << 64) - 1  # an int64 below 0 takes ten bytes, as protobuf writes it
    out = bytearray()
    while True:
        low = n & 0x7F
        n >>= 7
        if n:
            out.append(low | 0x80)
        else:
            out.append(low)
            return bytes(out)


def _key(field, wire_type):
    return _varint(field << 3 | wire_type)


def _length_delimited(field, payload):
    return _key(field, 2) + _varint(len(payload)) + payload


def _event(wall_time, step=0, file_version=None, summary=None):
    """Event: wall_time (1, double), step (2, int64), file_version (3) or
    summary (5), proto3's zero defaults omitted."""
    out = b""
    packed = struct.pack("<d", wall_time)
    if packed != bytes(8):  # a field is left out when its bits are all zero
        out += _key(1, 1) + packed
    if step:
        out += _key(2, 0) + _varint(step)
    if file_version is not None:
        out += _length_delimited(3, file_version.encode())
    if summary is not None:
        out += _length_delimited(5, summary)
    return out


def _scalar_summary(tag, value):
    """Summary{value: [Value{tag (1), simple_value (2, float32)}]}; the
    simple value is a member of a oneof, so a zero is written too."""
    entry = b""
    if tag:
        entry += _length_delimited(1, tag.encode())
    entry += _key(2, 5) + np.float32(value).tobytes()
    return _length_delimited(1, entry)


def clean_tag(tag):
    """The tag as tensorboardX writes it: characters outside ``-/\\w.``
    replaced by "_", leading slashes removed."""
    return _INVALID_TAG_CHARACTERS.sub("_", tag).lstrip("/")


# ------------------------------------------------------------------ writer

class SummaryWriter:
    """Scalars into ``<log_dir>/events.out.tfevents.<seconds>.<hostname>``
    (tensorboardX's name; ``.1``, ``.2``... appended where that file exists,
    as when a resumed run starts within the same second)."""

    def __init__(self, log_dir):
        self.log_dir = str(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        wall_time = time.time()
        base = os.path.join(self.log_dir, f"events.out.tfevents.{str(wall_time)[:10]}."
                                          f"{socket.gethostname()}")
        self.path, suffix = base, 0
        while True:
            try:
                self._file = open(self.path, "xb", buffering=0)
                break
            except FileExistsError:
                suffix += 1
                self.path = f"{base}.{suffix}"
        self._closer = weakref.finalize(self, self._file.close)
        self._write(_event(wall_time, file_version=FILE_VERSION))

    def _write(self, event):
        self._file.write(frame(event))

    def add_scalar(self, tag, value, step=None):
        """Write ``value`` (a number, a 0-d array or tensor) under ``tag`` at
        ``step``; on disk when this returns."""
        value = float(value.detach().squeeze() if hasattr(value, "detach")
                      else np.asarray(value).squeeze())
        self._write(_event(time.time(), int(step or 0),
                           summary=_scalar_summary(clean_tag(tag), value)))

    def flush(self):
        """Nothing is held back: each record is written as it comes."""

    def close(self):
        self._closer()


# ------------------------------------------------------------------ reader

def _records(data, name):
    at = 0
    while at < len(data):
        if len(data) - at < 12:
            raise ValueError(f"{name}: truncated record header at byte {at}")
        header = data[at:at + 8]
        (length,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[at + 8:at + 12])
        if crc != masked_crc32c(header):
            raise ValueError(f"{name}: corrupt record length at byte {at}")
        end = at + 12 + length
        if end + 4 > len(data):
            raise ValueError(f"{name}: truncated record at byte {at}")
        payload = data[at + 12:end]
        if struct.unpack("<I", data[end:end + 4])[0] != masked_crc32c(payload):
            raise ValueError(f"{name}: corrupt record data at byte {at}")
        yield payload
        at = end + 4


def _read_varint(data, at):
    out = shift = 0
    while True:
        if at >= len(data):
            raise ValueError("truncated varint")
        byte = data[at]
        out |= (byte & 0x7F) << shift
        at += 1
        if not byte & 0x80:
            return out, at
        shift += 7


def _fields(data):
    """(field, wire type, value) of a protocol buffer message: ints for
    varints, bytes for the rest."""
    at = 0
    while at < len(data):
        key, at = _read_varint(data, at)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, at = _read_varint(data, at)
        elif wire in (1, 5):
            size = 8 if wire == 1 else 4
            value, at = data[at:at + size], at + size
        elif wire == 2:
            size, at = _read_varint(data, at)
            value, at = data[at:at + size], at + size
        else:
            raise ValueError(f"unsupported wire type {wire}")
        if at > len(data):
            raise ValueError("truncated field")
        yield field, wire, value


def event_files(path):
    """The event files of a directory, in name order (oldest first), or the
    file itself."""
    path = Path(path)
    if path.is_dir():
        return sorted(p for p in path.iterdir() if "tfevents" in p.name and p.is_file())
    return [path]


def read_scalars(path):
    """{tag: [(step, value), ...]} of the scalar events in an event file, or
    in a directory's event files read oldest first. Raises ValueError on a
    record whose length or data fails its CRC."""
    out = {}
    for file in event_files(path):
        for record in _records(file.read_bytes(), str(file)):
            step, summary = 0, None
            for field, _, value in _fields(record):
                if field == 2:
                    step = value - (1 << 64) if value >= 1 << 63 else value
                elif field == 5:
                    summary = value
            if summary is None:
                continue
            for field, _, entry in _fields(summary):
                if field != 1:
                    continue
                tag, simple = "", None
                for f, wire, v in _fields(entry):
                    if f == 1:
                        tag = v.decode()
                    elif f == 2 and wire == 5:
                        simple = struct.unpack("<f", v)[0]
                if simple is not None:
                    out.setdefault(tag, []).append((step, simple))
    return out
