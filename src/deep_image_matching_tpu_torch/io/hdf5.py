"""A small HDF5 reader/writer in pure Python for the pipeline's files.

The GPU hosts this package targets ship without ``h5py``, so features.h5,
raw_matches.h5 and matches.h5 are written here directly, in the classic
HDF5 layout that every HDF5 reader (h5py, libhdf5 tools, COLMAP scripts)
understands: superblock version 0, version 1 object headers, groups as
symbol tables (a one-level v1 B-tree over symbol-table nodes and a local
name heap) and contiguous, uncompressed datasets of little-endian floats
and integers.

The API is the subset of ``h5py`` the pipeline uses: ``File`` (modes
"r", "a", "w"; a context manager), groups with ``in``, ``[]``, ``del``,
iteration in name order, ``create_group``, ``require_group`` and
``create_dataset(name, data=...)``, and datasets read with
``np.asarray``. A file opened for writing is built in memory and written on
``close()`` (to a temporary file, then renamed over the target). The reader
parses the layout this module writes; files from other writers (chunked,
compressed, or with newer object headers) raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Union

import numpy as np

_SIG = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_LEAF_K = 64        # symbol-table node capacity 2K = 128 names
_INTERNAL_K = 64    # B-tree node capacity 2K = 128 symbol-table nodes
_SNOD_CAP = 2 * _LEAF_K
_BTREE_CAP = 2 * _INTERNAL_K
_SNOD_SIZE = 8 + _SNOD_CAP * 40
_BTREE_SIZE = 24 + (_BTREE_CAP + 1) * 8 + _BTREE_CAP * 8
_HEAP_FREE_NULL = 1  # libhdf5's on-disk "no free block" marker

# numpy dtype -> (class, bit field bytes, properties)
_FLOATS = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _dtype_message(dt: np.dtype) -> bytes:
    dt = np.dtype(dt)
    if dt.byteorder == ">":
        raise ValueError("big-endian data is not supported")
    size = dt.itemsize
    if dt.kind == "f":
        exp_loc, exp_size, man_size, bias = _FLOATS[size]
        bits = bytes([0x20, size * 8 - 1, 0])  # implied mantissa msb, sign bit
        props = struct.pack("<HHBBBBI", 0, size * 8, exp_loc, exp_size, 0, man_size, bias)
        return bytes([0x11]) + bits + struct.pack("<I", size) + props
    if dt.kind in "iu":
        bits = bytes([0x08 if dt.kind == "i" else 0x00, 0, 0])
        return bytes([0x10]) + bits + struct.pack("<I", size) + struct.pack("<HH", 0, size * 8)
    if dt.kind == "b":
        return _dtype_message(np.dtype(np.uint8))
    raise ValueError(f"dtype {dt} is not supported")


def _parse_dtype(msg: bytes) -> np.dtype:
    cls = msg[0] & 0x0F
    size = struct.unpack_from("<I", msg, 4)[0]
    if msg[1] & 0x01:
        raise NotImplementedError("big-endian HDF5 data")
    if cls == 1:
        return np.dtype(f"<f{size}")
    if cls == 0:
        return np.dtype(f"<{'i' if msg[1] & 0x08 else 'u'}{size}")
    raise NotImplementedError(f"HDF5 datatype class {cls}")


class Dataset:
    """A dataset: its array in memory, or its place in an open file."""

    def __init__(self, name: str, data: Optional[np.ndarray] = None, *, file=None,
                 offset: int = 0, shape=(), dtype=None):
        self.name = name
        self._data = None if data is None else np.ascontiguousarray(data)
        if self._data is not None and self._data.dtype == np.bool_:
            self._data = self._data.astype(np.uint8)
        self._file, self._offset = file, offset
        self.shape = tuple(self._data.shape) if self._data is not None else tuple(shape)
        self.dtype = self._data.dtype if self._data is not None else np.dtype(dtype)

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize

    def __array__(self, dtype=None, copy=None):
        if self._data is None:
            if self._file is None or self._file.closed:
                raise ValueError(f"dataset {self.name} read after its file was closed")
            n = self.nbytes
            buf = b""
            if n:  # an empty dataset has no storage address
                self._file.seek(self._offset)
                buf = self._file.read(n)
            arr = np.frombuffer(buf, dtype=self.dtype).reshape(self.shape)
        else:
            arr = self._data
        return arr.astype(dtype) if dtype is not None else arr.copy()


class Group:
    def __init__(self, name: str = "/"):
        self.name = name
        self._items: Dict[str, Union["Group", Dataset]] = {}

    def _walk(self, path: str, create: bool = False):
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise KeyError("empty name")
        g = self
        for p in parts[:-1]:
            if p not in g._items:
                if not create:
                    raise KeyError(path)
                g._items[p] = Group(f"{g.name.rstrip('/')}/{p}")
            g = g._items[p]
            if not isinstance(g, Group):
                raise KeyError(f"{path}: {p} is a dataset")
        return g, parts[-1]

    def __contains__(self, path: str) -> bool:
        try:
            g, leaf = self._walk(path)
        except KeyError:
            return False
        return leaf in g._items

    def __getitem__(self, path: str):
        g, leaf = self._walk(path)
        if leaf not in g._items:
            raise KeyError(path)
        return g._items[leaf]

    def __delitem__(self, path: str) -> None:
        g, leaf = self._walk(path)
        del g._items[leaf]

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def keys(self) -> List[str]:
        return sorted(self._items, key=lambda s: s.encode())

    def items(self):
        return [(k, self._items[k]) for k in self.keys()]

    def create_group(self, path: str) -> "Group":
        g, leaf = self._walk(path, create=True)
        if leaf in g._items:
            raise ValueError(f"{path} exists")
        g._items[leaf] = Group(f"{g.name.rstrip('/')}/{leaf}")
        return g._items[leaf]

    def require_group(self, path: str) -> "Group":
        if path in self:
            obj = self[path]
            if not isinstance(obj, Group):
                raise TypeError(f"{path} is a dataset")
            return obj
        return self.create_group(path)

    def create_dataset(self, path: str, data) -> Dataset:
        g, leaf = self._walk(path, create=True)
        if leaf in g._items:
            raise ValueError(f"{path} exists")
        arr = np.asarray(data)
        if arr.ndim == 0:
            raise ValueError("scalar datasets are not supported")
        g._items[leaf] = Dataset(f"{g.name.rstrip('/')}/{leaf}", arr)
        return g._items[leaf]


class File(Group):
    def __init__(self, path, mode: str = "r"):
        super().__init__("/")
        if mode not in ("r", "a", "w"):
            raise ValueError(f"mode {mode!r}")
        self.path = Path(path)
        self.mode = mode
        self._fh = None
        if mode == "r" or (mode == "a" and self.path.exists()):
            self._fh = open(self.path, "rb")
            _Reader(self._fh).read_root(self)

    def close(self) -> None:
        if self.mode in ("a", "w"):
            tmp = self.path.with_name(f".{self.path.name}.{os.getpid()}.tmp")
            with open(tmp, "wb") as out:
                out.write(_serialize(self))
            os.replace(tmp, self.path)
            self.mode = "r"
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    body = data + b"\0" * (_pad8(len(data)) - len(data))
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _dataset_header(ds: Dataset, data_addr: int) -> bytes:
    rank = len(ds.shape)
    space = struct.pack("<BBB5x", 1, rank, 0) + b"".join(struct.pack("<Q", d) for d in ds.shape)
    fill = struct.pack("<BBBB", 2, 2, 2, 0)
    layout = struct.pack("<BBQQ", 3, 1, data_addr if ds.nbytes else _UNDEF, ds.nbytes)
    return _object_header([
        _message(0x0001, space), _message(0x0003, _dtype_message(ds.dtype), flags=1),
        _message(0x0005, fill, flags=1), _message(0x0008, layout),
    ])


def _entry(name_off: int, header: int, group: Optional[tuple] = None) -> bytes:
    if group is None:
        return struct.pack("<QQI4x16x", name_off, header, 0)
    return struct.pack("<QQI4xQQ", name_off, header, 1, *group)


class _Layout:
    """Addresses of every object, assigned in one pass before emitting."""

    def __init__(self):
        self.pos = 96  # after the superblock
        self.addr: Dict[int, dict] = {}

    def take(self, n: int) -> int:
        a = self.pos
        self.pos += _pad8(n)
        return a

    def plan(self, obj) -> None:
        if isinstance(obj, Dataset):
            hdr = len(_dataset_header(obj, 0))
            self.addr[id(obj)] = {"header": self.take(hdr), "data": self.take(obj.nbytes)}
            return
        names = obj.keys()
        if len(names) > _SNOD_CAP * _BTREE_CAP:
            raise ValueError(f"group {obj.name} holds more than {_SNOD_CAP * _BTREE_CAP} names")
        heap, offs = bytearray(b"\0" * 8), []
        for n in names:
            offs.append(len(heap))
            raw = n.encode() + b"\0"
            heap += raw + b"\0" * (_pad8(len(raw)) - len(raw))
        n_snod = -(-len(names) // _SNOD_CAP)
        self.addr[id(obj)] = {
            "header": self.take(16 + 8 + 16), "heap": self.take(32),
            "heap_data": self.take(len(heap)), "heap_bytes": bytes(heap),
            "btree": self.take(_BTREE_SIZE),
            "snods": [self.take(_SNOD_SIZE) for _ in range(n_snod)],
            "offs": offs,
        }
        for n in names:
            self.plan(obj._items[n])


def _serialize(root: File) -> bytes:
    lay = _Layout()
    lay.plan(root)
    out = bytearray(lay.pos)

    def put(addr: int, data: bytes) -> None:
        out[addr:addr + len(data)] = data

    def emit(obj) -> None:
        a = lay.addr[id(obj)]
        if isinstance(obj, Dataset):
            put(a["header"], _dataset_header(obj, a["data"]))
            if obj.nbytes:
                put(a["data"], np.asarray(obj).tobytes())
            return
        put(a["header"], _object_header([_message(0x0011, struct.pack("<QQ", a["btree"], a["heap"]))]))
        put(a["heap"], b"HEAP" + struct.pack("<B3xQQQ", 0, len(a["heap_bytes"]),
                                              _HEAP_FREE_NULL, a["heap_data"]))
        put(a["heap_data"], a["heap_bytes"])
        names = obj.keys()
        btree = bytearray(b"TREE" + struct.pack("<BBHQQ", 0, 0, len(a["snods"]), _UNDEF, _UNDEF))
        btree += struct.pack("<Q", 0)
        for i, snod in enumerate(a["snods"]):
            chunk = list(range(i * _SNOD_CAP, min(len(names), (i + 1) * _SNOD_CAP)))
            entries = b""
            for j in chunk:
                child = obj._items[names[j]]
                ca = lay.addr[id(child)]
                grp = (ca["btree"], ca["heap"]) if isinstance(child, Group) else None
                entries += _entry(a["offs"][j], ca["header"], grp)
            put(snod, b"SNOD" + struct.pack("<BBH", 1, 0, len(chunk)) + entries)
            btree += struct.pack("<QQ", snod, a["offs"][chunk[-1]])
        put(a["btree"], bytes(btree))
        for n in names:
            emit(obj._items[n])

    emit(root)
    ra = lay.addr[id(root)]
    sb = _SIG + struct.pack("<8B", 0, 0, 0, 0, 0, 8, 8, 0)
    sb += struct.pack("<HHI", _LEAF_K, _INTERNAL_K, 0)
    sb += struct.pack("<QQQQ", 0, _UNDEF, len(out), _UNDEF)
    sb += _entry(0, ra["header"], (ra["btree"], ra["heap"]))
    put(0, sb)
    return bytes(out)


# ---------------------------------------------------------------------------
# Reader (the layout above)
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, fh):
        self.fh = fh

    def _at(self, addr: int, n: int) -> bytes:
        self.fh.seek(addr)
        b = self.fh.read(n)
        if len(b) != n:
            raise ValueError("truncated HDF5 file")
        return b

    def read_root(self, root: File) -> None:
        sb = self._at(0, 96)
        if sb[:8] != _SIG:
            raise ValueError("not an HDF5 file")
        if sb[8] != 0 or sb[13] != 8 or sb[14] != 8:
            raise NotImplementedError(
                "HDF5 file from another writer (superblock version "
                f"{sb[8]}); reading it needs h5py")
        header = struct.unpack_from("<Q", sb, 56 + 8)[0]
        self._read_group(header, root)

    def _messages(self, addr: int):
        ver, _, n, _, size = struct.unpack_from("<BBHII", self._at(addr, 16))
        if ver != 1:
            raise NotImplementedError(f"object header version {ver}; reading it needs h5py")
        body = self._at(addr + 16, size)
        pos, out = 0, []
        while pos + 8 <= len(body) and len(out) < n:
            mtype, msize = struct.unpack_from("<HH", body, pos)
            out.append((mtype, body[pos + 8:pos + 8 + msize]))
            pos += 8 + msize
        return out

    def _read_group(self, header: int, group: Group) -> None:
        msgs = dict(self._messages(header))
        if 0x0011 not in msgs:
            raise NotImplementedError("group without a symbol table; reading it needs h5py")
        btree, heap = struct.unpack_from("<QQ", msgs[0x0011])
        hdr = self._at(heap, 32)
        if hdr[:4] != b"HEAP":
            raise ValueError("bad local heap")
        size, _, data_addr = struct.unpack_from("<QQQ", hdr, 8)
        names = self._at(data_addr, size)
        for name_off, child in self._entries(btree):
            name = names[name_off:names.index(b"\0", name_off)].decode()
            full = f"{group.name.rstrip('/')}/{name}"
            cm = dict(self._messages(child))
            if 0x0011 in cm:
                sub = Group(full)
                self._read_group(child, sub)
                group._items[name] = sub
            else:
                group._items[name] = self._dataset(full, cm)

    def _entries(self, btree: int):
        hdr = self._at(btree, 24)
        if hdr[:4] != b"TREE" or hdr[4] != 0:
            raise ValueError("bad group B-tree")
        level, used = hdr[5], struct.unpack_from("<H", hdr, 6)[0]
        body = self._at(btree + 24, 8 + used * 16)
        for i in range(used):
            child = struct.unpack_from("<Q", body, 8 + 16 * i)[0]
            if level > 0:
                yield from self._entries(child)
                continue
            snod = self._at(child, 8)
            if snod[:4] != b"SNOD":
                raise ValueError("bad symbol-table node")
            count = struct.unpack_from("<H", snod, 6)[0]
            raw = self._at(child + 8, 40 * count)
            for j in range(count):
                yield struct.unpack_from("<QQ", raw, 40 * j)

    def _dataset(self, name: str, msgs: dict) -> Dataset:
        space, dtype, layout = msgs.get(0x0001), msgs.get(0x0003), msgs.get(0x0008)
        if space is None or dtype is None or layout is None:
            raise NotImplementedError(f"{name}: not a plain dataset")
        rank = space[1]
        shape = struct.unpack_from(f"<{rank}Q", space, 8)
        if layout[0] != 3 or layout[1] != 1:
            raise NotImplementedError(f"{name}: chunked or compact layout; reading it needs h5py")
        addr, _ = struct.unpack_from("<QQ", layout, 2)
        return Dataset(name, file=self.fh, offset=addr, shape=shape, dtype=_parse_dtype(dtype))
