"""A reader and a writer of the small part of HDF5 that Keras 2 model
files use, in numpy and ``struct`` (the port's own copy of what the JAX
package's Keras importer gets from h5py, which the card's machine does
not have).

The subset, which is what h5py and Keras 2 write by default (the
"earliest" file format):

- superblock version 0 (8-byte offsets and lengths);
- version-1 object headers, with continuation messages;
- groups as symbol tables: a version-1 B-tree (``TREE``) of symbol-table
  nodes (``SNOD``) naming children in a local heap (``HEAP``);
- dataspace, datatype, fill value, layout (contiguous and compact) and
  attribute messages;
- fixed-point, floating-point, fixed-length string and variable-length
  string datatypes (the strings in global heap collections, ``GCOL``),
  and arrays of them.

Anything else (chunked or compressed storage, v2 object headers, link
messages, dense attribute storage, compound or enum types, ...) raises
:class:`HDF5FormatError` naming the feature and its file offset.

Reading: ``File(path)`` (or ``File(path, "r")``) is a :class:`Group`
with ``keys()``, ``in`` and ``[...]`` on names that may contain ``/``
(Keras's weight names ``conv1/kernel:0`` nest), ``.attrs``, and
:class:`Dataset` children that ``np.asarray`` reads whole. Attribute
values follow h5py's conventions: a scalar fixed-length string is
``numpy.bytes_``, a variable-length string ``str``, arrays are numpy
arrays (variable-length strings as object arrays of ``str``).

Writing: ``File(path, "w")`` gives ``create_group``, ``create_dataset``
(contiguous; floating and integer arrays) and ``attrs[name] = value`` for
bytes (a fixed-length string), str (a variable-length UTF-8 string),
arrays or lists of bytes or str, and numeric arrays and scalars. Raw data
is written as it is created; the metadata and the superblock are written
on ``close()``."""

from __future__ import annotations

import mmap
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
#: a local heap's "no free block" value on disk
HEAP_FREE_NULL = 1
#: group B-tree and symbol-table-node widths the writer puts in its
#: superblock (the HDF5 library's defaults)
LEAF_K, INTERNAL_K = 4, 16
_SNOD_SIZE = 8 + 2 * LEAF_K * 40
_TREE_SIZE = 24 + 2 * INTERNAL_K * 8 + (2 * INTERNAL_K + 1) * 8
_GCOL_MIN = 4096

_MSG_NIL, _MSG_DATASPACE, _MSG_LINK_INFO, _MSG_DATATYPE = 0x0, 0x1, 0x2, 0x3
_MSG_FILL, _MSG_LINK, _MSG_EXTERNAL, _MSG_LAYOUT = 0x5, 0x6, 0x7, 0x8
_MSG_GROUP_INFO, _MSG_FILTERS, _MSG_ATTRIBUTE = 0xA, 0xB, 0xC
_MSG_CONTINUATION, _MSG_SYMBOL_TABLE = 0x10, 0x11
_MSG_ATTR_INFO = 0x15
_UNSUPPORTED_MSG = {
    _MSG_LINK_INFO: "link-info message (a new-style group)",
    _MSG_LINK: "link message (a new-style group)",
    _MSG_GROUP_INFO: "group-info message (a new-style group)",
    _MSG_EXTERNAL: "external data files",
    _MSG_ATTR_INFO: "dense attribute storage (fractal heap)",
    0x14: "shared message table",
}
_CLASS_NAMES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enum"}


class HDF5FormatError(ValueError):
    """The file uses HDF5 outside this module's subset, or is corrupt."""


def _fail(feature: str, offset: int, path) -> "HDF5FormatError":
    return HDF5FormatError(f"{path}: {feature} at file offset {offset:#x} "
                           "is outside the HDF5 subset this reader handles")


def File(path, mode: str = "r"):
    """``mode`` "r" opens ``path`` for reading (a :class:`ReadFile`), "w"
    creates it (a :class:`WriteFile`)."""
    if mode == "r":
        return ReadFile(path)
    if mode == "w":
        return WriteFile(path)
    raise ValueError(f"mode must be 'r' or 'w', not {mode!r}")


# =================================================================== reading
class _Datatype:
    """A parsed datatype message: the numpy dtype of one element (with an
    array type's element shape), or a variable-length string."""

    def __init__(self, dtype: Optional[np.dtype], vlen_str: bool = False,
                 sub_shape: Tuple[int, ...] = ()):
        self.dtype = dtype
        self.vlen_str = vlen_str
        self.sub_shape = sub_shape


class _Reader:
    """The file's bytes (memory-mapped) and the subset's parsers."""

    def __init__(self, path):
        self.path = Path(path)
        self._f = open(self.path, "rb")
        self.buf = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self._gcol: Dict[int, Dict[int, bytes]] = {}
        self.root_header = self._superblock()

    def close(self):
        self.buf.close()
        self._f.close()

    # ----------------------------------------------------------- primitives
    def u(self, offset: int, n: int) -> int:
        if offset + n > len(self.buf):
            raise HDF5FormatError(f"{self.path}: read past the end of the "
                                  f"file at offset {offset:#x}")
        return int.from_bytes(self.buf[offset:offset + n], "little")

    def fail(self, feature: str, offset: int) -> HDF5FormatError:
        return _fail(feature, offset, self.path)

    # ----------------------------------------------------------- superblock
    def _superblock(self) -> int:
        """The root group's object-header address."""
        if self.buf[:8] != SIGNATURE:
            raise HDF5FormatError(f"{self.path} is not an HDF5 file without "
                                  "a user block (no signature at offset 0)")
        sb = 0
        version = self.buf[sb + 8]
        if version != 0:
            raise self.fail(f"superblock version {version}", sb)
        so, sl = self.buf[sb + 13], self.buf[sb + 14]
        if so != 8 or sl != 8:
            raise self.fail(f"{so}-byte offsets / {sl}-byte lengths", sb + 13)
        if self.u(sb + 24, 8) != 0:
            raise self.fail("a base address other than 0", sb + 24)
        # 24 bytes of versions, sizes, K values and flags; 4 addresses;
        # then the root group's symbol-table entry
        return self.u(sb + 24 + 32 + 8, 8)

    # -------------------------------------------------------- object header
    def messages(self, addr: int) -> List[Tuple[int, int, int, int]]:
        """(type, flags, data offset, data size) of every message in the
        version-1 object header at ``addr``, continuations followed."""
        if self.buf[addr:addr + 4] == b"OHDR":
            raise self.fail("version-2 object header", addr)
        version = self.buf[addr]
        if version != 1:
            raise self.fail(f"object header version {version}", addr)
        nmsgs = self.u(addr + 2, 2)
        blocks = [(addr + 16, self.u(addr + 8, 4))]
        out = []
        while blocks and len(out) < nmsgs:
            start, size = blocks.pop(0)
            p, end = start, start + size
            while p + 8 <= end and len(out) < nmsgs:
                mtype, msize = self.u(p, 2), self.u(p + 2, 2)
                flags = self.buf[p + 4]
                data = p + 8
                if mtype == _MSG_CONTINUATION:
                    blocks.append((self.u(data, 8), self.u(data + 8, 8)))
                out.append((mtype, flags, data, msize))
                p = data + msize
        return out

    # ------------------------------------------------------------- dataspace
    def dataspace(self, p: int) -> Tuple[int, ...]:
        version, rank, flags = self.buf[p], self.buf[p + 1], self.buf[p + 2]
        if version == 1:
            q = p + 8
        elif version == 2:
            if self.buf[p + 3] == 2:           # null dataspace
                return (0,)
            q = p + 4
        else:
            raise self.fail(f"dataspace message version {version}", p)
        if flags & 2:
            raise self.fail("dataspace permutation indices", p)
        return tuple(self.u(q + 8 * i, 8) for i in range(rank))

    # -------------------------------------------------------------- datatype
    def datatype(self, p: int) -> Tuple[_Datatype, int]:
        """The datatype message at ``p`` and its encoded length."""
        cls, version = self.buf[p] & 0x0F, self.buf[p] >> 4
        bits = self.u(p + 1, 3)
        size = self.u(p + 4, 4)
        if cls == 0:                                    # fixed-point
            if size not in (1, 2, 4, 8):
                raise self.fail(f"{size}-byte integer", p)
            kind = "i" if bits & 0x08 else "u"
            order = ">" if bits & 1 else "<"
            return _Datatype(np.dtype(f"{order}{kind}{size}")), 12
        if cls == 1:                                    # floating-point
            if size not in (2, 4, 8) or bits & 0x40:
                raise self.fail(f"{size}-byte floating-point type", p)
            order = ">" if bits & 1 else "<"
            return _Datatype(np.dtype(f"{order}f{size}")), 20
        if cls == 3:                                    # fixed string
            return _Datatype(np.dtype(f"S{size}")), 8
        if cls == 9:                                    # variable-length
            if bits & 0x0F != 1:
                raise self.fail("variable-length sequence datatype", p)
            _, n = self.datatype(p + 8)
            return _Datatype(None, vlen_str=True), 8 + n
        if cls == 10:                                   # array
            rank = self.buf[p + 8]
            if version == 2:
                q = p + 12
                dims = tuple(self.u(q + 4 * i, 4) for i in range(rank))
                q += 8 * rank                   # sizes and permutation
            elif version == 3:
                q = p + 9
                dims = tuple(self.u(q + 4 * i, 4) for i in range(rank))
                q += 4 * rank
            else:
                raise self.fail(f"array datatype version {version}", p)
            base, n = self.datatype(q)
            if base.vlen_str:
                raise self.fail("array of variable-length strings", p)
            return _Datatype(base.dtype, sub_shape=dims), q - p + n
        raise self.fail(f"{_CLASS_NAMES.get(cls, f'class {cls}')} datatype",
                        p)

    # ------------------------------------------------------------ raw values
    def _global(self, collection: int, index: int) -> bytes:
        objs = self._gcol.get(collection)
        if objs is None:
            if self.buf[collection:collection + 4] != b"GCOL":
                raise self.fail("a global heap reference to no collection",
                                collection)
            objs = {}
            end = collection + self.u(collection + 8, 8)
            p = collection + 16
            while p + 16 <= end:
                idx, size = self.u(p, 2), self.u(p + 8, 8)
                if idx == 0:
                    break
                objs[idx] = bytes(self.buf[p + 16:p + 16 + size])
                p += 16 + (size + 7) // 8 * 8
            self._gcol[collection] = objs
        return objs[index]

    def values(self, dt: _Datatype, shape: Tuple[int, ...], p: int,
               as_str: bool = True) -> np.ndarray:
        """``shape`` elements of type ``dt`` stored from ``p``;
        variable-length strings as ``str`` (``as_str``, h5py's attributes)
        or ``bytes`` (h5py's datasets)."""
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if dt.vlen_str:
            out = np.empty(count, dtype=object)
            for i in range(count):
                q = p + 16 * i
                n = self.u(q, 4)
                raw = self._global(self.u(q + 4, 8), self.u(q + 12, 4)) \
                    if n else b""
                out[i] = raw[:n].decode("utf-8") if as_str else raw[:n]
            return out.reshape(shape)
        full = shape + dt.sub_shape
        n = int(np.prod(full, dtype=np.int64)) if full else 1
        if p == UNDEF:
            return np.zeros(full, dt.dtype.newbyteorder("="))
        arr = np.frombuffer(self.buf, dtype=dt.dtype, count=n, offset=p)
        arr = arr.reshape(full)
        if dt.dtype.kind in "iuf" and dt.dtype.byteorder == ">":
            return arr.astype(dt.dtype.newbyteorder("="))
        return arr.copy()

    # ------------------------------------------------------------ attributes
    def attribute(self, p: int, size: int) -> Tuple[str, object]:
        version = self.buf[p]
        name_len, dt_len, ds_len = (self.u(p + 2, 2), self.u(p + 4, 2),
                                    self.u(p + 6, 2))
        if version == 1:
            pad = lambda n: (n + 7) // 8 * 8
            q = p + 8
        elif version in (2, 3):
            pad = lambda n: n
            q = p + 8 + (1 if version == 3 else 0)
        else:
            raise self.fail(f"attribute message version {version}", p)
        if version >= 2 and self.buf[p + 1] & 0x3:
            raise self.fail("shared attribute datatype or dataspace", p)
        name = bytes(self.buf[q:q + name_len]).split(b"\0")[0].decode()
        q += pad(name_len)
        dt, _ = self.datatype(q)
        q += pad(dt_len)
        shape = self.dataspace(q)
        q += pad(ds_len)
        value = self.values(dt, shape, q)
        return name, value[()] if not shape else value

    def attributes(self, msgs) -> Dict[str, object]:
        out = {}
        for mtype, _, p, size in msgs:
            if mtype == _MSG_ATTRIBUTE:
                name, value = self.attribute(p, size)
                out[name] = value
        return out

    # ---------------------------------------------------------------- groups
    def _heap_data(self, heap: int) -> int:
        if self.buf[heap:heap + 4] != b"HEAP":
            raise self.fail("a local heap without its signature", heap)
        return self.u(heap + 24, 8)

    def _name(self, data: int, offset: int) -> str:
        end = self.buf.find(b"\0", data + offset)
        return bytes(self.buf[data + offset:end]).decode("utf-8")

    def group_entries(self, btree: int, heap: int) -> Dict[str, int]:
        """Child name → object header address, in the B-tree's order."""
        data = self._heap_data(heap)
        out: Dict[str, int] = {}
        nodes = [btree]
        while nodes:
            node = nodes.pop(0)
            if self.buf[node:node + 4] != b"TREE":
                raise self.fail("a group B-tree node without its signature",
                                node)
            if self.buf[node + 4] != 0:
                raise self.fail("a chunk-index B-tree where a group's was "
                                "expected", node)
            level, used = self.buf[node + 5], self.u(node + 6, 2)
            children = [self.u(node + 24 + 8 + 16 * i, 8)
                        for i in range(used)]
            if level > 0:
                nodes[0:0] = children
                continue
            for snod in children:
                if self.buf[snod:snod + 4] != b"SNOD":
                    raise self.fail("a symbol-table node without its "
                                    "signature", snod)
                for i in range(self.u(snod + 6, 2)):
                    e = snod + 8 + 40 * i
                    out[self._name(data, self.u(e, 8))] = self.u(e + 8, 8)
        return out

    def node(self, addr: int, name: str):
        msgs = self.messages(addr)
        types = {m[0] for m in msgs}
        for mtype, flags, p, _ in msgs:
            if mtype in _UNSUPPORTED_MSG:
                raise self.fail(_UNSUPPORTED_MSG[mtype], p)
            if flags & 0x02 and mtype != _MSG_NIL:
                raise self.fail(f"shared object-header message (type "
                                f"{mtype:#x})", p)
        if _MSG_SYMBOL_TABLE in types:
            return Group(self, addr, name, msgs)
        if _MSG_LAYOUT in types:
            return Dataset(self, addr, name, msgs)
        raise self.fail("an object that is neither a symbol-table group nor "
                        "a dataset", addr)


class _Attrs:
    """A read-only, dict-like view of an object's attributes."""

    def __init__(self, values: Dict[str, object]):
        self._values = values

    def __contains__(self, name) -> bool:
        return name in self._values

    def __getitem__(self, name):
        return self._values[name]

    def __iter__(self):
        return iter(self._values)

    def keys(self):
        return self._values.keys()

    def items(self):
        return self._values.items()


class _Object:
    def __init__(self, reader: _Reader, addr: int, name: str, msgs):
        self._r = reader
        self.addr = addr
        self.name = name
        self._msgs = msgs
        self._attrs = None

    @property
    def attrs(self) -> _Attrs:
        if self._attrs is None:
            self._attrs = _Attrs(self._r.attributes(self._msgs))
        return self._attrs


class Group(_Object):
    """A symbol-table group of a file being read."""

    def __init__(self, reader, addr, name, msgs):
        super().__init__(reader, addr, name, msgs)
        p = next(m[2] for m in msgs if m[0] == _MSG_SYMBOL_TABLE)
        self._btree, self._heap = reader.u(p, 8), reader.u(p + 8, 8)
        self._entries = None
        self._children: Dict[str, object] = {}

    def _links(self) -> Dict[str, int]:
        if self._entries is None:
            self._entries = self._r.group_entries(self._btree, self._heap)
        return self._entries

    def keys(self) -> List[str]:
        return list(self._links())

    def __iter__(self):
        return iter(self.keys())

    def _child(self, part: str):
        if part not in self._children:
            links = self._links()
            if part not in links:
                raise KeyError(f"{part!r} is not in {self.name}")
            path = f"{self.name.rstrip('/')}/{part}"
            self._children[part] = self._r.node(links[part], path)
        return self._children[part]

    def __getitem__(self, name: str):
        node = self
        for part in [p for p in str(name).split("/") if p]:
            if not isinstance(node, Group):
                raise KeyError(f"{node.name} is a dataset, not a group")
            node = node._child(part)
        return node

    def __contains__(self, name) -> bool:
        node = self
        for part in [p for p in str(name).split("/") if p]:
            if not isinstance(node, Group) or part not in node._links():
                return False
            node = node._child(part)
        return True



class Dataset(_Object):
    """A dataset of a file being read; ``np.asarray(ds)`` or ``ds[()]``
    reads it whole."""

    def __init__(self, reader, addr, name, msgs):
        super().__init__(reader, addr, name, msgs)
        by_type = {m[0]: m for m in msgs}
        if _MSG_FILTERS in by_type:
            raise reader.fail("a filter pipeline (compressed storage)",
                              by_type[_MSG_FILTERS][2])
        self.shape = reader.dataspace(by_type[_MSG_DATASPACE][2])
        self._dt, _ = reader.datatype(by_type[_MSG_DATATYPE][2])
        self._layout = by_type[_MSG_LAYOUT][2]
        self._data: Optional[Tuple[int, int]] = None
        self._storage()

    @property
    def dtype(self) -> np.dtype:
        return np.dtype(object) if self._dt.vlen_str else \
            self._dt.dtype.newbyteorder("=")

    def _storage(self):
        """(address, byte size) of the data; compact data lies in the
        layout message."""
        r, p = self._r, self._layout
        version = r.buf[p]
        if version in (3, 4):
            cls = r.buf[p + 1]
            if cls == 0:
                self._data = (p + 4, r.u(p + 2, 2))
            elif cls == 1:
                self._data = (r.u(p + 2, 8), r.u(p + 10, 8))
            else:
                raise self._layout_error(cls, p)
        elif version in (1, 2):
            rank, cls = r.buf[p + 1], r.buf[p + 2]
            if cls == 0:
                q = p + 8 + 4 * rank
                self._data = (q + 4, r.u(q, 4))
            elif cls == 1:
                self._data = (r.u(p + 8, 8), None)
            else:
                raise self._layout_error(cls, p)
        else:
            raise r.fail(f"data layout message version {version}", p)

    def _layout_error(self, cls: int, p: int) -> HDF5FormatError:
        feature = {2: "chunked dataset storage (layout class 2; Keras's "
                      "save_weights writes contiguous datasets: save "
                      "without chunks or compression)",
                   3: "virtual dataset storage"}.get(
            cls, f"data layout class {cls}")
        return self._r.fail(f"{feature} in {self.name}", p)

    def __getitem__(self, key):
        arr = self._r.values(self._dt, self.shape, self._data[0],
                             as_str=False)
        if key == ():
            return arr[()] if not self.shape else arr
        return arr[key]

    def __array__(self, dtype=None, copy=None):
        arr = self[()]
        return arr if dtype is None else arr.astype(dtype)


class ReadFile(Group):
    """An HDF5 file opened for reading: its root group."""

    def __init__(self, path):
        reader = _Reader(path)
        root = reader.node(reader.root_header, "/")
        if not isinstance(root, Group):
            reader.close()
            raise reader.fail("a root object that is not a group",
                              reader.root_header)
        super().__init__(reader, root.addr, "/", root._msgs)
        self.filename = str(path)

    def close(self):
        self._children.clear()
        self._r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# =================================================================== writing
def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _u(value: int, n: int) -> bytes:
    return int(value).to_bytes(n, "little")


def _dataspace_msg(shape: Tuple[int, ...]) -> bytes:
    return bytes([1, len(shape), 0, 0]) + b"\0" * 4 + \
        b"".join(_u(d, 8) for d in shape)


def _datatype_msg(dtype: np.dtype) -> bytes:
    """A numpy dtype's datatype message (little-endian numbers, fixed
    strings null-padded)."""
    dt = np.dtype(dtype)
    if dt.kind in "iu":
        bits = 0x08 if dt.kind == "i" else 0
        return bytes([0x10, bits, 0, 0]) + _u(dt.itemsize, 4) + \
            _u(0, 2) + _u(8 * dt.itemsize, 2)
    if dt.kind == "f":
        sign, exp_loc, exp_size, mant, bias = {
            2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127),
            8: (63, 52, 11, 52, 1023)}[dt.itemsize]
        return bytes([0x11, 0x20, sign, 0]) + _u(dt.itemsize, 4) + \
            _u(0, 2) + _u(8 * dt.itemsize, 2) + \
            bytes([exp_loc, exp_size, 0, mant]) + _u(bias, 4)
    if dt.kind == "S":
        return bytes([0x13, 0x01, 0, 0]) + _u(max(dt.itemsize, 1), 4)
    raise TypeError(f"cannot write numpy dtype {dt} to HDF5")


def _vlen_str_msg(utf8: bool) -> bytes:
    """A variable-length string (UTF-8 or ASCII) over a 1-byte unsigned
    base type."""
    return bytes([0x19, 0x01, 0x01 if utf8 else 0x00, 0]) + _u(16, 4) + \
        bytes([0x10, 0, 0, 0]) + _u(1, 4) + _u(0, 2) + _u(8, 2)


def _message(mtype: int, data: bytes) -> bytes:
    data = _pad8(data)
    if len(data) > 0xFFFF:
        raise HDF5FormatError(
            f"an object-header message of {len(data)} bytes (over 64 KiB, "
            "which needs dense attribute storage) is outside the subset")
    return _u(mtype, 2) + _u(len(data), 2) + b"\0" * 4 + data


class _WriteAttrs:
    """``attrs[name] = value`` of an object being written."""

    def __init__(self):
        self._values: Dict[str, object] = {}

    def __setitem__(self, name: str, value):
        self._values[str(name)] = value


class _WriteObject:
    def __init__(self, file: "WriteFile", name: str):
        self._file = file
        self.name = name
        self.attrs = _WriteAttrs()


class WriteGroup(_WriteObject):
    """A group of a file being written."""

    def __init__(self, file, name):
        super().__init__(file, name)
        self._children: Dict[str, _WriteObject] = {}

    def _place(self, name: str) -> Tuple["WriteGroup", str]:
        """(parent group, last part) of a new ``/``-separated name, the
        intermediate groups created; an existing name raises."""
        parts = [p for p in str(name).split("/") if p]
        if not parts:
            raise ValueError(f"empty name {name!r}")
        g = self
        for part in parts[:-1]:
            child = g._children.get(part)
            if child is None:
                child = g._children[part] = WriteGroup(
                    self._file, f"{g.name.rstrip('/')}/{part}")
            if not isinstance(child, WriteGroup):
                raise ValueError(f"{child.name} is a dataset, not a group")
            g = child
        if parts[-1] in g._children:
            raise ValueError(f"{name!r} exists in {self.name}")
        return g, parts[-1]

    def create_group(self, name: str) -> "WriteGroup":
        g, last = self._place(name)
        child = g._children[last] = WriteGroup(
            self._file, f"{g.name.rstrip('/')}/{last}")
        return child

    def create_dataset(self, name: str, data) -> "WriteDataset":
        g, last = self._place(name)
        arr = np.asarray(data)
        if arr.dtype.kind not in "iuf":
            raise TypeError(f"datasets of {arr.dtype} are not written; "
                            "floating and integer arrays are")
        arr = np.ascontiguousarray(arr, arr.dtype.newbyteorder("<"))
        ds = g._children[last] = WriteDataset(
            self._file, f"{g.name.rstrip('/')}/{last}", arr.shape, arr.dtype,
            self._file._raw(arr))
        return ds


class WriteDataset(_WriteObject):
    def __init__(self, file, name, shape, dtype, addr):
        super().__init__(file, name)
        self.shape, self.dtype, self.addr = shape, dtype, addr


class WriteFile(WriteGroup):
    """An HDF5 file being written in the subset; metadata and the
    superblock land on ``close()``."""

    _SUPERBLOCK = 96

    def __init__(self, path):
        self.filename = str(path)
        self._fh = open(path, "wb")
        self._fh.write(b"\0" * self._SUPERBLOCK)
        super().__init__(self, "/")
        self._closed = False

    def _raw(self, arr: np.ndarray) -> int:
        if arr.size == 0:
            return UNDEF
        addr = self._fh.tell()
        self._fh.write(arr.tobytes())
        return addr

    # --------------------------------------------------------------- layout
    def _strings(self) -> List[bytes]:
        """Every distinct variable-length string of every attribute (the
        global heap's objects, in first-seen order)."""
        out: Dict[bytes, None] = {}

        def visit(obj):
            for value in obj.attrs._values.values():
                vlen = _vlen(value)
                if vlen is not None:
                    out.update(dict.fromkeys(vlen[0]))
            for child in getattr(obj, "_children", {}).values():
                visit(child)
        visit(self)
        return list(out)

    def close(self):
        if self._closed:
            return
        self._closed = True
        try:
            self._finish()
        finally:
            self._fh.close()

    def _finish(self):
        fh = self._fh
        strings = self._strings()
        self._gcol_addr = fh.tell()
        self._heap_index = {s: i for i, s in enumerate(strings, start=1)}
        if strings:
            body = b""
            for i, s in enumerate(strings, start=1):
                body += _u(i, 2) + _u(1, 2) + b"\0" * 4 + _u(len(s), 8) + \
                    _pad8(s)
            size = max(_GCOL_MIN, 16 + len(body) + 16)
            free = size - 16 - len(body)
            gcol = b"GCOL" + bytes([1, 0, 0, 0]) + _u(size, 8) + body + \
                _u(0, 2) + _u(0, 2) + b"\0" * 4 + _u(free, 8)
            fh.write(gcol + b"\0" * (size - len(gcol)))
        root_addr, btree, heap = self._write_group(self)
        eof = fh.tell()
        sb = SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + \
            _u(LEAF_K, 2) + _u(INTERNAL_K, 2) + _u(0, 4) + \
            _u(0, 8) + _u(UNDEF, 8) + _u(eof, 8) + _u(UNDEF, 8) + \
            _u(0, 8) + _u(root_addr, 8) + _u(1, 4) + _u(0, 4) + \
            _u(btree, 8) + _u(heap, 8)
        assert len(sb) == self._SUPERBLOCK
        fh.seek(0)
        fh.write(sb)

    def _attr_msgs(self, obj) -> bytes:
        out = b""
        for name, value in obj.attrs._values.items():
            dt, shape, data = self._attr_value(value)
            nm = name.encode("utf-8") + b"\0"
            ds = _dataspace_msg(shape)
            out += _message(_MSG_ATTRIBUTE,
                            bytes([1, 0]) + _u(len(nm), 2) + _u(len(dt), 2) +
                            _u(len(ds), 2) + _pad8(nm) + _pad8(dt) +
                            _pad8(ds) + data)
        return out

    def _attr_value(self, value) -> Tuple[bytes, Tuple[int, ...], bytes]:
        """(datatype message, shape, raw data) of an attribute value."""
        vlen = _vlen(value)
        if vlen is not None:
            items, utf8, shape = vlen
            data = b"".join(_u(len(s), 4) + _u(self._gcol_addr, 8) +
                            _u(self._heap_index[s], 4) for s in items)
            return _vlen_str_msg(utf8), shape, data
        if isinstance(value, np.bytes_):
            arr = np.array(value, dtype=f"S{max(len(value), 1)}")
        else:
            arr = np.asarray(value)
        if arr.dtype.kind in "iuf":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        return _datatype_msg(arr.dtype), arr.shape, \
            np.ascontiguousarray(arr).tobytes()

    def _write_header(self, msgs: bytes) -> int:
        """A version-1 object header holding ``msgs``; its address."""
        n = 0
        p = 0
        while p < len(msgs):
            n += 1
            p += 8 + int.from_bytes(msgs[p + 2:p + 4], "little")
        addr = self._fh.tell()
        self._fh.write(bytes([1, 0]) + _u(n, 2) + _u(1, 4) +
                       _u(len(msgs), 4) + b"\0" * 4 + msgs)
        return addr

    def _write_dataset(self, ds: WriteDataset) -> int:
        msgs = _message(_MSG_DATASPACE, _dataspace_msg(ds.shape)) + \
            _message(_MSG_DATATYPE, _datatype_msg(ds.dtype)) + \
            _message(_MSG_FILL, bytes([2, 2, 2, 0])) + \
            _message(_MSG_LAYOUT, bytes([3, 1]) + _u(ds.addr, 8) +
                     _u(int(np.prod(ds.shape, dtype=np.int64)) *
                        ds.dtype.itemsize, 8)) + \
            self._attr_msgs(ds)
        return self._write_header(msgs)

    def _write_group(self, g: WriteGroup) -> Tuple[int, int, int]:
        """Write ``g``'s children, its local heap, symbol-table nodes and
        B-tree, then its header: (header, B-tree, heap) addresses."""
        fh = self._fh
        names = sorted(g._children, key=lambda s: s.encode("utf-8"))
        entries = []
        for name in names:
            child = g._children[name]
            if isinstance(child, WriteGroup):
                entries.append((name,) + self._write_group(child))
            else:
                entries.append((name, self._write_dataset(child), None, None))
        # local heap: "" at offset 0, then each name, 8-byte aligned
        data, offsets = b"\0" * 8, {}
        for name in names:
            offsets[name] = len(data)
            data += _pad8(name.encode("utf-8") + b"\0")
        heap = fh.tell()
        fh.write(b"HEAP" + bytes([0, 0, 0, 0]) + _u(len(data), 8) +
                 _u(HEAP_FREE_NULL, 8) + _u(heap + 32, 8) + data)
        # symbol-table nodes of at most 2 * LEAF_K entries
        leaves = []
        per = 2 * LEAF_K
        for i in range(0, len(entries), per):
            chunk = entries[i:i + per]
            body = b""
            for name, hdr, btree, lheap in chunk:
                body += _u(offsets[name], 8) + _u(hdr, 8)
                if btree is None:
                    body += _u(0, 4) + _u(0, 4) + b"\0" * 16
                else:
                    body += _u(1, 4) + _u(0, 4) + _u(btree, 8) + _u(lheap, 8)
            node = b"SNOD" + bytes([1, 0]) + _u(len(chunk), 2) + body
            addr = fh.tell()
            fh.write(node + b"\0" * (_SNOD_SIZE - len(node)))
            leaves.append((addr, offsets[chunk[-1][0]]))
        btree = self._write_btree(leaves, 0)
        msgs = _message(_MSG_SYMBOL_TABLE, _u(btree, 8) + _u(heap, 8)) + \
            self._attr_msgs(g)
        return self._write_header(msgs), btree, heap

    def _write_btree(self, children: List[Tuple[int, int]], level: int) -> int:
        """B-tree nodes over ``children`` ((address, heap offset of the
        largest name below it)); the root's address."""
        fh = self._fh
        per = 2 * INTERNAL_K
        nodes = []
        for i in range(0, max(len(children), 1), per):
            chunk = children[i:i + per]
            body = _u(0, 8)                  # key 0: the empty name
            for addr, key in chunk:
                body += _u(addr, 8) + _u(key, 8)
            node = b"TREE" + bytes([0, level]) + _u(len(chunk), 2) + \
                _u(UNDEF, 8) + _u(UNDEF, 8) + body
            addr = fh.tell()
            fh.write(node + b"\0" * (_TREE_SIZE - len(node)))
            nodes.append((addr, chunk[-1][1] if chunk else 0))
        if len(nodes) == 1:
            return nodes[0][0]
        return self._write_btree(nodes, level + 1)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _vlen(value) -> Optional[Tuple[List[bytes], bool, Tuple[int, ...]]]:
    """(encoded strings, UTF-8?, shape) of an attribute value stored as
    variable-length strings, as h5py stores them: a str (UTF-8), a Python
    bytes scalar (ASCII), a list of str, an array of str or objects; None
    for every other value (numpy bytes and arrays of them are fixed-length
    strings)."""
    if isinstance(value, str):
        return [value.encode("utf-8")], True, ()
    if isinstance(value, bytes) and not isinstance(value, np.bytes_):
        return [value], False, ()
    if isinstance(value, (list, tuple)) and value and \
            isinstance(value[0], str):
        return [str(v).encode("utf-8") for v in value], True, (len(value),)
    if isinstance(value, np.ndarray) and value.dtype.kind in "OU":
        return [str(v).encode("utf-8") for v in value.ravel()], True, \
            value.shape
    return None
