"""A msgpack decoder and encoder for simplesr_tpu's model files, in plain
Python.

They cover the subset that flax's ``msgpack_serialize`` writes for a model:
maps, arrays, str, bin, nil, bool, ints, floats, and ext type 1, flax's
ndarray, whose payload is itself msgpack of ``(shape, dtype name, raw
C-order bytes)``. Arrays decode to numpy, except bfloat16, which numpy
lacks: those decode to ``torch.bfloat16`` tensors. ``packb`` writes what
the msgpack package writes with ``use_bin_type=True`` and flax's ndarray
hook: the smallest encoding of each value, floats as doubles, maps in their
insertion order, numpy arrays and CPU tensors as flax's ndarray.
"""

import struct

import numpy as np
import torch

_EXT_NDARRAY = 1


def _ndarray(payload):
    shape, dtype_name, buffer = unpackb(payload, raw=True)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        return torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)


class _Reader:
    def __init__(self, data, raw):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def str(self, n):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        return _ndarray(payload)

    def read(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        lengths = {0: ">B", 1: ">H", 2: ">I"}
        if 0xC4 <= b <= 0xC6:
            return bytes(self.take(self.unpack(lengths[b - 0xC4])))
        if 0xC7 <= b <= 0xC9:
            return self.ext(self.unpack(lengths[b - 0xC7]))
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:
            return self.str(self.unpack(lengths[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(lengths[b - 0xDB]))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(lengths[b - 0xDD]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def unpackb(data, raw=False):
    """Decode one msgpack object from ``data``. ``raw`` leaves str as bytes."""
    reader = _Reader(data, raw)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("extra bytes after the msgpack object")
    return obj


def _header(small, fixed, n, tag):
    """The type header of a value of length ``n``: a fix type (``small``
    tag, at most ``fixed``) or tags 8/16/32 from ``tag``."""
    if small is not None and n <= fixed:
        return struct.pack(">B", small | n)
    for i, fmt in enumerate((">B", ">H", ">I")):
        if tag[i] is not None and n < 1 << (8 << i):
            return struct.pack(">B", tag[i]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack value of length {n} is too long")


def _pack_int(n):
    if 0 <= n <= 0x7F or -32 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    if n > 0:
        for tag, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < limit:
                return struct.pack(">B", tag) + struct.pack(fmt, n)
    else:
        for tag, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if n >= -limit:
                return struct.pack(">B", tag) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack")


def _ndarray_payload(x):
    """flax's ``_ndarray_to_bytes``: ``packb((shape, dtype name, bytes))``."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.device.type != "cpu":
            raise ValueError("packb takes CPU tensors")
        t = t.contiguous()
        name = str(t.dtype).removeprefix("torch.")
        raw = t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
        return packb((tuple(t.shape), name, raw))
    return packb((x.shape, x.dtype.name, x.tobytes("C")))


def _ext(code, payload):
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = (struct.pack(">B", fixed[n]) if n in fixed
            else _header(None, 0, n, (0xC7, 0xC8, 0xC9)))
    return head + struct.pack(">b", code) + payload


def packb(obj):
    """Encode ``obj`` as msgpack bytes."""
    if obj is None:
        return b"\xc0"
    if isinstance(obj, bool):
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, int):
        return _pack_int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        data = obj.encode("utf-8")
        return _header(0xA0, 31, len(data), (0xD9, 0xDA, 0xDB)) + data
    if isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        return _header(None, 0, len(data), (0xC4, 0xC5, 0xC6)) + data
    if isinstance(obj, (list, tuple)):
        return _header(0x90, 15, len(obj), (None, 0xDC, 0xDD)) + b"".join(map(packb, obj))
    if isinstance(obj, dict):
        return _header(0x80, 15, len(obj), (None, 0xDE, 0xDF)) + b"".join(
            packb(k) + packb(v) for k, v in obj.items())
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return _ext(_EXT_NDARRAY, _ndarray_payload(obj))
    raise TypeError(f"cannot msgpack {type(obj)}")
