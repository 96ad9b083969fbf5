"""An HDF5 writer in the standard library and numpy, for the legacy-Keras
``.h5`` files that ``tools/export_keras.py`` writes; ``train/_hdf5.py``
reads them back, as do h5py and Keras.

It writes the subset that h5py writes by default (``libver="earliest"``):
  * superblock version 0, 8-byte offsets and lengths;
  * version 1 object headers, one chunk each;
  * groups as symbol tables: a version 1 B-tree of symbol-table nodes
    (``SNOD``) over a local heap holding the link names;
  * contiguous little-endian float32 datasets;
  * attributes of variable-length strings, whose bytes go to a global heap
    collection (``GCOL``), and the empty array.
An attribute is converted as h5py converts it: ``str`` to a variable-length
UTF-8 string, ``bytes`` to a variable-length ASCII one, a list of either to
a 1-D array of them, an empty list to an empty float64 array. That is all
a legacy-Keras file holds.

One object-header message holds at most 65535 bytes, so a long string goes
in as a variable-length string (16 bytes in the header, the text in the
global heap); an attribute whose header message would be larger raises
``ValueError``. The same tree gives the same bytes.

    root = Group()
    root.attrs["model_config"] = config_json.encode()
    root.create_group("model_weights/conv2d").create_dataset("conv2d/kernel:0", kernel)
    write_file("model.h5", root)
"""

import struct

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = (1 << 64) - 1
_MESSAGE_LIMIT = 0xFFFF

# message types
_DATASPACE, _DATATYPE, _LAYOUT, _ATTRIBUTE, _SYMBOL_TABLE = 0x01, 0x03, 0x08, 0x0C, 0x11

# group B-trees: K of a leaf symbol-table node and of an internal node
_LEAF_K, _NODE_K = 4, 16
_ENTRY_SIZE = 40  # a symbol-table entry with 8-byte offsets
_SNOD_SIZE = 8 + 2 * _LEAF_K * _ENTRY_SIZE
_TREE_SIZE = 24 + 2 * _NODE_K * 8 + (2 * _NODE_K + 1) * 8
_HEAP_HEADER = 32
_GCOL_MIN = 4096  # the smallest global heap collection HDF5 reads
_GCOL_MAX_OBJECTS = 0xFFFF  # heap object indices are 16 bits


def _pad8(data):
    return data + bytes(-len(data) % 8)


class Dataset:
    """A contiguous float32 array."""

    def __init__(self, data):
        data = np.asarray(data)
        if data.dtype != np.dtype("<f4"):
            raise ValueError(f"HDF5 writer: datasets of {data.dtype} are not written")
        self.data = np.ascontiguousarray(data)


class Group:
    """A group: ``attrs``, ``create_group`` and ``create_dataset`` (paths
    with "/" make the groups between)."""

    def __init__(self):
        self.attrs = {}
        self.children = {}

    def _parent(self, path):
        *heads, name = path.strip("/").split("/")
        group = self
        for head in heads:
            group = group.children.setdefault(head, Group())
            if not isinstance(group, Group):
                raise ValueError(f"HDF5 writer: {head!r} is a dataset, not a group")
        if not name or name in group.children:
            raise ValueError(f"HDF5 writer: {path!r} exists or is empty")
        return group, name

    def create_group(self, path):
        parent, name = self._parent(path)
        parent.children[name] = Group()
        return parent.children[name]

    def create_dataset(self, path, data):
        parent, name = self._parent(path)
        parent.children[name] = Dataset(data)
        return parent.children[name]


# ------------------------------------------------------------- encodings

def _float_type(size):
    """A little-endian IEEE float datatype message."""
    sign, exp_at, exp_bits, mant_bits, bias = {4: (31, 23, 8, 23, 127),
                                               8: (63, 52, 11, 52, 1023)}[size]
    return (bytes([0x11, 0x20, sign, 0]) + struct.pack("<I", size)
            + struct.pack("<HHBBBBI", 0, 8 * size, exp_at, exp_bits, 0, mant_bits, bias))


def _vlen_string_type(utf8):
    """A variable-length, null-terminated string datatype message over
    unsigned bytes, as HDF5 stores ``H5T_VARIABLE`` strings."""
    base = bytes([0x10, 0, 0, 0]) + struct.pack("<IHH", 1, 0, 8)
    return bytes([0x19, 0x01, 0x01 if utf8 else 0, 0]) + struct.pack("<I", 16) + base


def _space(shape):
    """A version 1 dataspace message: rank 0 is a scalar."""
    return struct.pack("<BBBBI", 1, len(shape), 0, 0, 0) + b"".join(
        struct.pack("<Q", d) for d in shape)


def _attribute_value(value):
    """An attribute's value, converted as h5py converts it -> ([str or
    bytes], shape, utf8); an empty list is None, the empty float64 array."""
    if isinstance(value, (str, bytes)):
        return [value], (), isinstance(value, str)
    if isinstance(value, (list, tuple)):
        if not value:
            return None
        if all(isinstance(v, str) for v in value) or all(isinstance(v, bytes) for v in value):
            return list(value), (len(value),), isinstance(value[0], str)
    raise ValueError("HDF5 writer: attributes other than strings, lists of them and the "
                     f"empty list are not written: {type(value).__name__}")


# ------------------------------------------------------------ the writer

class _Out:
    """The file's bytes: regions reserved at 8-byte boundaries, filled in
    when their contents are known."""

    def __init__(self):
        self.buf = bytearray()

    def reserve(self, size):
        self.buf += bytes(-len(self.buf) % 8)
        at = len(self.buf)
        self.buf += bytes(size)
        return at

    def put(self, at, data):
        self.buf[at:at + len(data)] = data


class _GlobalHeap:
    """The global heap collection of the file's variable-length strings:
    each string one object, the collection written after the superblock."""

    def __init__(self):
        self.objects = []

    def add(self, data):
        if len(self.objects) == _GCOL_MAX_OBJECTS:
            raise ValueError(f"HDF5 writer: more than {_GCOL_MAX_OBJECTS} variable-length "
                             "strings")
        self.objects.append(data)
        return len(self.objects)

    def write(self, out):
        """Lay the collection out; returns its address."""
        body = b"".join(struct.pack("<HHIQ", i, 0, 0, len(d)) + _pad8(d)
                        for i, d in enumerate(self.objects, 1))
        size = max(_GCOL_MIN, 16 + len(body) + 16)
        free = size - 16 - len(body)  # object 0: the free space, its header included
        at = out.reserve(size)
        out.put(at, b"GCOL" + struct.pack("<B3xQ", 1, size) + body
                + struct.pack("<HHIQ", 0, 0, 0, free))
        return at


def _collect_strings(node, heap, refs):
    """Give every variable-length string of every attribute its heap
    object, in a fixed walk of the tree."""
    for name in node.attrs:
        value = _attribute_value(node.attrs[name])
        if value is not None:
            refs[id(node), name] = [(len(s), heap.add(s) if s else 0)
                                    for s in (v.encode() if isinstance(v, str) else v
                                              for v in value[0])]
    for name in sorted(node.children):
        child = node.children[name]
        if isinstance(child, Group):
            _collect_strings(child, heap, refs)


class _Writer:
    def __init__(self, root):
        self.out = _Out()
        self.heap = _GlobalHeap()
        self.refs = {}
        _collect_strings(root, self.heap, self.refs)
        self.root = root

    def run(self):
        superblock = self.out.reserve(96)
        self.gcol = self.heap.write(self.out)
        root_at, (btree, local_heap) = self.group(self.root)
        entry = struct.pack("<QQII", 0, root_at, 1, 0) + struct.pack("<QQ", btree, local_heap)
        self.out.put(superblock, _SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                     + struct.pack("<HHI", _LEAF_K, _NODE_K, 0)
                     + struct.pack("<QQQQ", 0, _UNDEF, len(self.out.buf), _UNDEF) + entry)
        return bytes(self.out.buf)

    def attributes(self, node):
        messages = []
        for name, value in node.attrs.items():
            value = _attribute_value(value)
            if value is None:  # the empty float64 array
                dtype, data, shape = _float_type(8), b"", (0,)
            else:
                _, shape, utf8 = value
                dtype = _vlen_string_type(utf8)
                data = b"".join(struct.pack("<IQI", n, self.gcol if index else 0, index)
                                for n, index in self.refs[id(node), name])
            key = name.encode() + b"\0"
            space = _space(shape)
            body = (struct.pack("<BBHHH", 1, 0, len(key), len(dtype), len(space))
                    + _pad8(key) + _pad8(dtype) + _pad8(space) + data)
            if len(_pad8(body)) > _MESSAGE_LIMIT:
                raise ValueError(
                    f"HDF5 writer: attribute {name!r} needs {len(body)} bytes in its object "
                    f"header, over HDF5's {_MESSAGE_LIMIT}-byte limit for one message")
            messages.append((_ATTRIBUTE, 0, body))
        return messages

    def header(self, messages):
        """Reserve and write a version 1 object header; returns its address."""
        body = b"".join(struct.pack("<HHB3x", kind, len(_pad8(data)), flags) + _pad8(data)
                        for kind, flags, data in messages)
        at = self.out.reserve(16 + len(body))
        self.out.put(at, struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body)
        return at

    def dataset(self, node):
        data = node.data
        at_data = self.out.reserve(data.nbytes) if data.nbytes else _UNDEF
        if data.nbytes:
            self.out.put(at_data, data.tobytes())
        layout = struct.pack("<BBQQ", 3, 1, at_data, data.nbytes)
        return self.header([(_DATASPACE, 0, _space(data.shape)),
                            (_DATATYPE, 1, _float_type(4)),
                            (_LAYOUT, 0, layout)])

    def group(self, node):
        """Write a group and everything under it -> (object header address,
        (B-tree address, local heap address))."""
        names = sorted(node.children, key=str.encode)
        entries = []
        for name in names:
            child = node.children[name]
            if isinstance(child, Group):
                at, cache = self.group(child)
                entries.append((at, 1, struct.pack("<QQ", *cache)))
            else:
                entries.append((self.dataset(child), 0, bytes(16)))

        heap_data, offsets = bytearray(8), []  # offset 0: the empty name
        for name in names:
            offsets.append(len(heap_data))
            heap_data += _pad8(name.encode() + b"\0")
        local_heap = self.out.reserve(_HEAP_HEADER + len(heap_data))
        # the free list's end is the length 1 (H5HL_FREE_NULL)
        self.out.put(local_heap, b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), 1,
                                                       local_heap + _HEAP_HEADER)
                     + bytes(heap_data))

        # symbol-table nodes of 2K entries each, then B-tree levels of 2K
        # children each up to one root; a key is the heap offset of the
        # last name under the child before it ("" first)
        children = []
        for i in range(0, len(names), 2 * _LEAF_K):
            snod = self.out.reserve(_SNOD_SIZE)
            part = range(i, min(i + 2 * _LEAF_K, len(names)))
            self.out.put(snod, b"SNOD" + struct.pack("<BBH", 1, 0, len(part)) + b"".join(
                struct.pack("<QQII", offsets[j], entries[j][0], entries[j][1], 0)
                + entries[j][2] for j in part))
            children.append((snod, offsets[part[-1]]))
        level = 0
        while True:
            starts = range(0, max(len(children), 1), 2 * _NODE_K)
            groups = [children[i:i + 2 * _NODE_K] for i in starts]
            nodes = [self.out.reserve(_TREE_SIZE) for _ in groups]
            for k, (node_at, kids, first) in enumerate(zip(nodes, groups, starts)):
                left = nodes[k - 1] if k else _UNDEF
                right = nodes[k + 1] if k + 1 < len(nodes) else _UNDEF
                image = b"TREE" + struct.pack("<BBHQQ", 0, level, len(kids), left, right)
                image += struct.pack("<Q", children[first - 1][1] if first else 0)
                for child, last in kids:
                    image += struct.pack("<QQ", child, last)
                self.out.put(node_at, image)
            if len(nodes) == 1:
                break
            children = [(n, kids[-1][1]) for n, kids in zip(nodes, groups)]
            level += 1
        btree = nodes[0]
        header = self.header([(_SYMBOL_TABLE, 0, struct.pack("<QQ", btree, local_heap))]
                             + self.attributes(node))
        return header, (btree, local_heap)


def write_file(path, root):
    """Write the tree under ``root`` (a ``Group``) as an HDF5 file."""
    data = _Writer(root).run()
    with open(path, "wb") as f:
        f.write(data)
