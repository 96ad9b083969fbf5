"""A read-only HDF5 reader in the standard library and numpy, for the Keras
``.h5`` files that ``tools/import_keras.py`` converts (the port reads
msgpack the same way, ``train/_msgpack.py``, without the package).

It reads what h5py and Keras write by default, and with ``libver="latest"``:
  * superblock versions 0, 1, 2 and 3;
  * object headers version 1 and 2, with their continuation blocks;
  * groups as symbol tables (a version 1 B-tree of symbol-table nodes over a
    local heap) or as compact link messages;
  * the dataspace, datatype, data-layout and attribute messages;
  * contiguous and compact datasets of fixed-point and IEEE floating-point
    numbers (float16, float32, float64, integers of 1 to 8 bytes, either
    byte order);
  * fixed-length strings, and variable-length strings through the global
    heap, in datasets and attributes.
Chunked or filtered datasets, dense link or attribute storage (fractal heaps)
and shared messages raise ``ValueError`` naming what was met. Values come
out as h5py gives them: numeric arrays as numpy arrays in the stored byte
order, fixed-length strings as ``bytes`` (numpy ``S`` arrays),
variable-length strings as ``str`` in attributes and ``bytes`` in
datasets.

    with File("model.h5") as f:
        names = f["model_weights"].attrs["layer_names"]
        kernel = f["model_weights/conv2d/conv2d/kernel:0"][()]
"""

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"

# message types
_DATASPACE, _LINK_INFO, _DATATYPE, _LAYOUT = 0x01, 0x02, 0x03, 0x08
_LINK, _FILTERS, _ATTRIBUTE, _CONTINUATION = 0x06, 0x0B, 0x0C, 0x10
_SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x11, 0x15


class _Reader:
    """Little-endian fields of the file's bytes, bounds-checked."""

    def __init__(self, data):
        self.data = data
        self.offset_size = 8
        self.length_size = 8
        self.base = 0

    def bytes(self, at, n):
        if at < 0 or n < 0 or at + n > len(self.data):
            raise ValueError(f"HDF5: read of {n} bytes at {at} past the end of the file")
        return self.data[at:at + n]

    def uint(self, at, n):
        return int.from_bytes(self.bytes(at, n), "little")

    def offset(self, at):
        return self.uint(at, self.offset_size)

    def length(self, at):
        return self.uint(at, self.length_size)

    def address(self, at):
        """A file address, relative to the base address; None if undefined."""
        value = self.offset(at)
        if value == (1 << (8 * self.offset_size)) - 1:
            return None
        return self.base + value


# ------------------------------------------------------------ datatypes

class _Type:
    """A datatype message: ``kind`` is "number", "string" or "vlen-string";
    ``dtype`` the numpy dtype of one element as stored."""

    def __init__(self, kind, size, dtype=None):
        self.kind, self.size, self.dtype = kind, size, dtype


def _parse_type(r, at):
    head = r.bytes(at, 8)
    cls, version = head[0] & 0x0F, head[0] >> 4
    bits = head[1] | (head[2] << 8) | (head[3] << 16)
    size = int.from_bytes(head[4:8], "little")
    if version < 1:
        raise ValueError(f"HDF5: datatype message version {version}")
    if cls == 0:  # fixed-point
        order = ">" if bits & 1 else "<"
        kind = "i" if bits & 0x08 else "u"
        if size not in (1, 2, 4, 8):
            raise ValueError(f"HDF5: {size}-byte integers are not read")
        return _Type("number", size, np.dtype(f"{order}{kind}{size}"))
    if cls == 1:  # floating point
        order = ">" if bits & 1 else "<"
        if bits & 0x40 or size not in (2, 4, 8):
            raise ValueError(f"HDF5: a {size}-byte float of byte order bits {bits:#x} "
                             "is not read")
        return _Type("number", size, np.dtype(f"{order}f{size}"))
    if cls == 3:  # fixed-length string
        return _Type("string", size, np.dtype(f"S{size}"))
    if cls == 9:  # variable-length
        if bits & 0x0F != 1:
            raise ValueError("HDF5: variable-length sequences other than strings are not read")
        return _Type("vlen-string", size)
    raise ValueError(f"HDF5: datatype class {cls} is not read")


def _parse_space(r, at):
    """The dataspace's shape: () for a scalar, None for a null space."""
    version, rank, flags = r.bytes(at, 3)
    if version == 1:
        dims_at = at + 8
    elif version == 2:
        kind = r.uint(at + 3, 1)
        if kind == 2:
            return None
        dims_at = at + 4
    else:
        raise ValueError(f"HDF5: dataspace message version {version}")
    return tuple(r.length(dims_at + i * r.length_size) for i in range(rank))


# -------------------------------------------------------- object headers

def _messages(r, at):
    """(type, flags, body offset, body size) of every message of the object
    header at ``at``, continuation blocks followed."""
    out = []
    if r.bytes(at, 4) == b"OHDR":
        version, flags = r.bytes(at + 4, 2)
        if version != 2:
            raise ValueError(f"HDF5: object header version {version}")
        pos = at + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        size = r.uint(pos, width)
        pos += width
        blocks = [(pos, pos + size)]
        head = 6 if flags & 0x04 else 4
        while blocks:
            start, end = blocks.pop(0)
            while start + head <= end:
                kind = r.uint(start, 1)
                length = r.uint(start + 1, 2)
                mflags = r.uint(start + 3, 1)
                body = start + head
                if body + length > end:
                    raise ValueError("HDF5: an object header message overruns its block")
                out.append((kind, mflags, body, length))
                if kind == _CONTINUATION:
                    cont, cont_len = r.address(body), r.length(body + r.offset_size)
                    if r.bytes(cont, 4) != b"OCHK":
                        raise ValueError("HDF5: bad continuation block signature")
                    blocks.append((cont + 4, cont + cont_len - 4))
                start = body + length
        return out
    version = r.uint(at, 1)
    if version != 1:
        raise ValueError(f"HDF5: object header version {version}")
    count = r.uint(at + 2, 2)
    size = r.uint(at + 8, 4)
    blocks = [(at + 16, at + 16 + size)]
    while blocks and len(out) < count:
        start, end = blocks.pop(0)
        while start + 8 <= end and len(out) < count:
            kind = r.uint(start, 2)
            length = r.uint(start + 2, 2)
            mflags = r.uint(start + 4, 1)
            body = start + 8
            if body + length > end:
                raise ValueError("HDF5: an object header message overruns its block")
            out.append((kind, mflags, body, length))
            if kind == _CONTINUATION:
                blocks.append((r.address(body), r.address(body) + r.length(body + r.offset_size)))
            start = body + length
    return out


def _read_global_heap_object(r, collection, index):
    if r.bytes(collection, 4) != b"GCOL":
        raise ValueError("HDF5: bad global heap signature")
    size = r.length(collection + 8)
    pos, end = collection + 8 + r.length_size, collection + size
    while pos + 8 + r.length_size <= end:
        obj = r.uint(pos, 2)
        length = r.length(pos + 8)
        data_at = pos + 8 + r.length_size
        if obj == index:
            return r.bytes(data_at, length)
        if obj == 0:
            break
        pos = data_at + ((length + 7) & ~7)
    raise ValueError(f"HDF5: global heap object {index} not found")


def _decode(r, dtype, shape, raw, text=True):
    """Raw element bytes -> the value as h5py gives it: variable-length
    strings as ``str`` (``text``, attributes) or ``bytes`` (datasets)."""
    count = int(np.prod(shape)) if shape else 1
    if dtype.kind == "vlen-string":
        step = 4 + r.offset_size + 4
        values = []
        for i in range(count):
            at = i * step
            collection = int.from_bytes(raw[at + 4:at + 4 + r.offset_size], "little")
            index = int.from_bytes(raw[at + 4 + r.offset_size:at + step], "little")
            data = b"" if collection == 0 else _read_global_heap_object(
                r, r.base + collection, index)
            values.append(data.decode("utf-8") if text else data)
        if not shape:
            return values[0]
        return np.array(values, dtype=object).reshape(shape)
    need = count * dtype.size
    if len(raw) < need:
        raise ValueError(f"HDF5: {len(raw)} bytes of data for {count} elements of "
                         f"{dtype.size} bytes")
    arr = np.frombuffer(bytes(raw[:need]), dtype.dtype).reshape(shape).copy()
    return arr[()] if not shape else arr


def _parse_attribute(r, at):
    version = r.uint(at, 1)
    name_len, type_len, space_len = r.uint(at + 2, 2), r.uint(at + 4, 2), r.uint(at + 6, 2)
    if version == 1:
        pos = at + 8
        pad = lambda n: (n + 7) & ~7  # noqa: E731
    elif version in (2, 3):
        if r.uint(at + 1, 1) & 0x03:
            raise ValueError("HDF5: shared attribute datatypes are not read")
        pos = at + 8 + (1 if version == 3 else 0)
        pad = lambda n: n  # noqa: E731
    else:
        raise ValueError(f"HDF5: attribute message version {version}")
    name = r.bytes(pos, name_len).split(b"\0", 1)[0].decode("utf-8")
    pos += pad(name_len)
    dtype = _parse_type(r, pos)
    pos += pad(type_len)
    shape = _parse_space(r, pos)
    pos += pad(space_len)
    if shape is None:
        return name, None
    count = int(np.prod(shape)) if shape else 1
    size = (4 + r.offset_size + 4) if dtype.kind == "vlen-string" else dtype.size
    return name, _decode(r, dtype, shape, r.bytes(pos, count * size))


class _Object:
    """An object header: its messages and attributes."""

    def __init__(self, r, at, name):
        self._r, self._at, self.name = r, at, name
        self._msgs = _messages(r, at)
        for kind, mflags, body, _ in self._msgs:
            if mflags & 0x02:
                raise ValueError(f"HDF5: {name}: shared object header messages are not read")
            if kind == _ATTRIBUTE_INFO:
                flags = r.uint(body + 1, 1)
                heap = r.address(body + 2 + (2 if flags & 1 else 0))
                if heap is not None:
                    raise ValueError(f"HDF5: {name}: dense attribute storage (a fractal "
                                     "heap) is not read")
        self.attrs = dict(_parse_attribute(r, body) for kind, _, body, _ in self._msgs
                          if kind == _ATTRIBUTE)

    def _find(self, kind):
        return [(body, size) for k, _, body, size in self._msgs if k == kind]


class Dataset(_Object):
    """An array: ``shape``, ``dtype`` and ``ds[()]`` (or ``np.asarray``)."""

    def __init__(self, r, at, name):
        super().__init__(r, at, name)
        if self._find(_FILTERS):
            raise ValueError(f"HDF5: {name}: filtered (compressed) datasets are not read")
        (space_at, _), = self._find(_DATASPACE)
        (type_at, _), = self._find(_DATATYPE)
        self._type = _parse_type(r, type_at)
        self.shape = _parse_space(r, space_at) or ()
        self.dtype = np.dtype(object) if self._type.kind == "vlen-string" else self._type.dtype
        (layout_at, _), = self._find(_LAYOUT)
        self._layout = self._parse_layout(layout_at)

    def _parse_layout(self, at):
        r = self._r
        version = r.uint(at, 1)
        count = int(np.prod(self.shape)) if self.shape else 1
        size = (4 + r.offset_size + 4) if self._type.kind == "vlen-string" else self._type.size
        if version in (3, 4):
            cls = r.uint(at + 1, 1)
            if cls == 0:
                return ("compact", r.bytes(at + 4, r.uint(at + 2, 2)))
            if cls == 1:
                return ("contiguous", r.address(at + 2), count * size)
        elif version in (1, 2):
            rank, cls = r.uint(at + 1, 1), r.uint(at + 2, 1)
            if cls == 0:
                data_size = r.uint(at + 8 + 4 * rank, 4)
                return ("compact", r.bytes(at + 12 + 4 * rank, data_size))
            if cls == 1:
                return ("contiguous", r.address(at + 8), count * size)
        else:
            raise ValueError(f"HDF5: {self.name}: data layout message version {version}")
        raise ValueError(f"HDF5: {self.name}: chunked datasets are not read")

    def __getitem__(self, key):
        if key != () and key != Ellipsis:
            raise ValueError("HDF5: datasets are read whole (ds[()])")
        kind, *rest = self._layout
        if kind == "compact":
            raw = rest[0]
        else:
            address, nbytes = rest
            raw = bytes(nbytes) if address is None else self._r.bytes(address, nbytes)
        return _decode(self._r, self._type, self.shape, raw, text=False)

    def __array__(self, dtype=None, copy=None):
        value = np.asarray(self[()])
        return value if dtype is None else value.astype(dtype)


class Group(_Object):
    """A group: ``keys()``, ``g[name]`` (paths with "/" too), ``name in g``."""

    def __init__(self, r, at, name):
        super().__init__(r, at, name)
        self._links = {}
        for kind, _, body, _ in self._msgs:
            if kind == _LINK_INFO:
                flags = r.uint(body + 1, 1)
                heap = r.address(body + 2 + (8 if flags & 1 else 0))
                if heap is not None:
                    raise ValueError(f"HDF5: {name}: dense link storage (a fractal heap) "
                                     "is not read")
            elif kind == _LINK:
                self._parse_link(body)
            elif kind == _SYMBOL_TABLE:
                self._read_symbol_table(r.address(body), r.address(body + r.offset_size))

    def _parse_link(self, at):
        r = self._r
        flags = r.uint(at + 1, 1)
        pos = at + 2
        link_type = 0
        if flags & 0x08:
            link_type = r.uint(pos, 1)
            pos += 1
        if flags & 0x04:
            pos += 8
        if flags & 0x10:
            pos += 1
        width = 1 << (flags & 3)
        name_len = r.uint(pos, width)
        pos += width
        name = r.bytes(pos, name_len).decode("utf-8")
        pos += name_len
        if link_type == 0:
            self._links[name] = r.address(pos)

    def _read_symbol_table(self, btree, heap):
        r = self._r
        if r.bytes(heap, 4) != b"HEAP":
            raise ValueError("HDF5: bad local heap signature")
        heap_data = r.address(heap + 8 + 2 * r.length_size)

        def name_at(offset):
            start = heap_data + offset
            end = r.data.index(b"\0", start)
            return r.data[start:end].decode("utf-8")

        def walk(node, depth=0):
            if depth > 64:
                raise ValueError("HDF5: group B-tree too deep")
            if r.bytes(node, 4) != b"TREE":
                raise ValueError("HDF5: bad B-tree signature")
            node_type, level, used = r.uint(node + 4, 1), r.uint(node + 5, 1), r.uint(node + 6, 2)
            if node_type != 0:
                raise ValueError("HDF5: a group B-tree of another node type")
            pos = node + 8 + 2 * r.offset_size + r.length_size  # past key 0
            for _ in range(used):
                child = r.address(pos)
                if level > 0:
                    walk(child, depth + 1)
                else:
                    read_snod(child)
                pos += r.offset_size + r.length_size

        def read_snod(at):
            if r.bytes(at, 4) != b"SNOD":
                raise ValueError("HDF5: bad symbol table node signature")
            count = r.uint(at + 6, 2)
            entry = at + 8
            step = 2 * r.offset_size + 24
            for _ in range(count):
                self._links[name_at(r.offset(entry))] = r.address(entry + r.offset_size)
                entry += step

        walk(btree)

    def keys(self):
        return list(self._links)

    def __contains__(self, path):
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __getitem__(self, path):
        head, _, rest = path.strip("/").partition("/")
        if head not in self._links:
            raise KeyError(f"{path!r} not in HDF5 group {self.name!r}")
        child = _open(self._r, self._links[head], f"{self.name.rstrip('/')}/{head}")
        return child[rest] if rest else child


def _open(r, at, name):
    """The group or dataset whose object header is at ``at``."""
    kinds = {k for k, *_ in _messages(r, at)}
    if _LAYOUT in kinds:
        return Dataset(r, at, name)
    return Group(r, at, name)


class File(Group):
    """An HDF5 file, read whole into memory; a ``Group`` at its root."""

    def __init__(self, path):
        with open(path, "rb") as f:
            data = f.read()
        at = 0
        while data[at:at + 8] != _SIGNATURE:
            at = 512 if at == 0 else 2 * at
            if at + 8 > len(data):
                raise ValueError(f"{path}: not an HDF5 file")
        r = _Reader(data)
        version = data[at + 8]
        if version in (0, 1):
            r.offset_size, r.length_size = data[at + 13], data[at + 14]
            pos = at + 24 + (4 if version == 1 else 0)
            r.base = r.offset(pos)
            root_entry = pos + 4 * r.offset_size
            root = r.address(root_entry + r.offset_size)
        elif version in (2, 3):
            r.offset_size, r.length_size = data[at + 9], data[at + 10]
            pos = at + 12
            r.base = r.offset(pos)
            root = r.address(pos + 3 * r.offset_size)
        else:
            raise ValueError(f"{path}: HDF5 superblock version {version} is not read")
        if r.offset_size not in (2, 4, 8) or r.length_size not in (2, 4, 8):
            raise ValueError(f"{path}: HDF5 offsets of {r.offset_size} bytes are not read")
        super().__init__(r, root, "/")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self._r = None
