"""A frozen copy of the read path of the port's HDF5 module
(``src/deep_image_matching_tpu_torch/io/hdf5.py`` as of the benchmark's
first version), so that the benchmark reads features.h5, raw_matches.h5
and matches.h5 without h5py, which the card's host lacks, and without
importing the port. The writer is left out: the benchmark only reads.

It reads the port's own files (superblock 0, version 1 object headers,
symbol-table groups, contiguous datasets) and what h5py 3.x writes for the
pipeline under ``libver="earliest"`` and ``"latest"``: superblocks 0, 2
and 3; v1 and v2 object headers (with continuation blocks; checksums are
not verified); groups as symbol tables, compact link messages or dense
links (a fractal heap with a v2 B-tree name index); contiguous, compact and
chunked datasets, the chunks indexed by a v1 B-tree, a single chunk, a
fixed array (paged or not) or an extensible array; the deflate and shuffle
filters; little-endian floats and integers and h5py's bool enum. Anything
else raises ``NotImplementedError`` naming the structure. Datasets load
lazily on ``np.asarray``.

The API is the subset of ``h5py``'s reading that the benchmark uses:
``File(path, "r")`` (a context manager), groups with ``in``, ``[]``,
iteration in name order, ``keys`` and ``items``, and datasets read with
``np.asarray``.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Union

import numpy as np

_SIG = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _u(b: bytes) -> int:
    return int.from_bytes(b, "little")


def _enc_size(n: int) -> int:
    """libhdf5's ``H5VM_limit_enc_size``: bytes that hold ``n``."""
    return (max(n, 1).bit_length() - 1) // 8 + 1


def _log2(n: int) -> int:
    return n.bit_length() - 1


# ---------------------------------------------------------------------------
# Datatypes
# ---------------------------------------------------------------------------

def _parse_dtype(msg: bytes) -> np.dtype:
    cls, ver = msg[0] & 0x0F, msg[0] >> 4
    size = struct.unpack_from("<I", msg, 4)[0]
    if cls in (0, 1, 8) and msg[1] & 0x01:
        raise NotImplementedError("big-endian HDF5 data")
    if cls == 1:
        return np.dtype(f"<f{size}")
    if cls == 0:
        return np.dtype(f"<{'i' if msg[1] & 0x08 else 'u'}{size}")
    if cls == 8:
        n = struct.unpack_from("<H", msg, 1)[0]
        base_size = struct.unpack_from("<I", msg, 12)[0]
        q = 16 + (12 if msg[8] & 0x0F == 1 else 4)  # past the base type's message
        names = []
        for _ in range(n):
            end = msg.index(b"\0", q)
            names.append(msg[q:end])
            q = end + 1 if ver >= 3 else q + _pad8(end + 1 - q)
        vals = [_u(msg[q + i * base_size:q + (i + 1) * base_size]) for i in range(n)]
        if base_size == 1 and dict(zip(names, vals)) == {b"FALSE": 0, b"TRUE": 1}:
            return np.dtype(np.bool_)
        raise NotImplementedError("HDF5 enum datatype other than h5py's bool")
    raise NotImplementedError(f"HDF5 datatype class {cls}")


# ---------------------------------------------------------------------------
# The tree
# ---------------------------------------------------------------------------

class Dataset:
    """A dataset in an open file: its shape, dtype and how to read it."""

    def __init__(self, name: str, shape, dtype, read: Callable[[], np.ndarray],
                 addr: int = _UNDEF):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self._read = read
        self._addr = addr  # object header address

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize

    def __array__(self, dtype=None, copy=None):
        arr = self._read()
        return arr.astype(dtype) if dtype is not None else arr


class Group:
    """A group; its members are read from the file when first reached."""

    def __init__(self, name: str = "/", file: Optional["File"] = None):
        self.name = name
        self._file = file
        self._items: Dict[str, Union["Group", Dataset]] = {}
        self._links: Dict[str, int] = {}  # members not read yet: name -> header
        self._addr = _UNDEF   # object header address
        self._stab = None     # (B-tree root, local heap header) of a symbol-table group

    def _child_name(self, leaf: str) -> str:
        return f"{self.name.rstrip('/')}/{leaf}"

    def _has(self, leaf: str) -> bool:
        return leaf in self._items or leaf in self._links

    def _child(self, leaf: str):
        if leaf not in self._items:
            addr = self._links.pop(leaf)
            self._items[leaf] = self._file._reader.read_object(self, leaf, addr)
        return self._items[leaf]

    def _walk(self, path: str):
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise KeyError("empty name")
        g = self
        for p in parts[:-1]:
            if not g._has(p):
                raise KeyError(path)
            g = g._child(p)
            if not isinstance(g, Group):
                raise KeyError(f"{path}: {p} is a dataset")
        return g, parts[-1]

    def __contains__(self, path: str) -> bool:
        try:
            g, leaf = self._walk(path)
        except KeyError:
            return False
        return g._has(leaf)

    def __getitem__(self, path: str):
        g, leaf = self._walk(path)
        if not g._has(leaf):
            raise KeyError(path)
        return g._child(leaf)

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def keys(self) -> List[str]:
        return sorted([*self._items, *self._links], key=lambda s: s.encode())

    def items(self):
        return [(k, self._child(k)) for k in self.keys()]


class File(Group):
    def __init__(self, path, mode: str = "r"):
        super().__init__("/", self)
        if mode != "r":
            raise ValueError(f"mode {mode!r}: this copy only reads")
        self.path = Path(path)
        self.mode = mode
        self._fh = open(self.path, "rb")
        self._reader = _Reader(self._fh, self)
        self._reader.read_root(self)

    @property
    def closed(self) -> bool:
        return self._fh is None

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

def _read_contiguous(fh, name: str, addr: int, shape, dtype) -> Callable[[], np.ndarray]:
    def read() -> np.ndarray:
        if fh.closed:
            raise ValueError(f"dataset {name} read after its file was closed")
        arr = np.empty(shape, dtype)
        if arr.nbytes:  # an empty dataset has no storage address
            fh.seek(addr)
            if fh.readinto(memoryview(arr.reshape(-1)).cast("B")) != arr.nbytes:
                raise ValueError(f"dataset {name}: truncated HDF5 file")
        return arr
    return read


def _unfilter(raw: bytes, filters, mask: int, itemsize: int) -> bytes:
    for i in reversed(range(len(filters))):
        if mask & (1 << i):
            continue
        fid = filters[i]
        if fid == 1:
            raw = zlib.decompress(raw)
        elif fid == 2:
            n = len(raw) // itemsize
            body = np.frombuffer(raw, np.uint8, n * itemsize).reshape(itemsize, n)
            raw = body.T.tobytes() + raw[n * itemsize:]
        else:
            raise NotImplementedError(f"HDF5 filter {fid}")
    return raw


class _Reader:
    def __init__(self, fh, file: Optional[File] = None):
        self.fh = fh
        self.file = file
        sb = self.at(0, 48)
        if sb[:8] != _SIG:
            raise ValueError("not an HDF5 file")
        self.version = sb[8]
        self.leaf_k = self.internal_k = 0
        if self.version == 0:
            if sb[13] != 8 or sb[14] != 8:
                raise NotImplementedError("HDF5 superblock with offsets or lengths not of 8 bytes")
            self.leaf_k, self.internal_k = struct.unpack_from("<HH", sb, 16)
            base_addr = struct.unpack_from("<Q", sb, 24)[0]
            self.eof_field = 40
            self.root = struct.unpack_from("<Q", self.at(56, 40), 8)[0]
        elif self.version in (2, 3):
            if sb[9] != 8 or sb[10] != 8:
                raise NotImplementedError("HDF5 superblock with offsets or lengths not of 8 bytes")
            base_addr, _, _, self.root = struct.unpack_from("<QQQQ", sb, 12)
            self.eof_field = 28
        else:
            raise NotImplementedError(f"HDF5 superblock version {self.version}")
        if base_addr != 0:
            raise NotImplementedError("HDF5 file with a user block")
        self.eof = struct.unpack_from("<Q", self.at(self.eof_field, 8))[0]

    def at(self, addr: int, n: int) -> bytes:
        self.fh.seek(addr)
        b = self.fh.read(n)
        if len(b) != n:
            raise ValueError("truncated HDF5 file")
        return b

    # -- object headers ----------------------------------------------------

    def messages(self, addr: int):
        """[(type, flags, data)] of the object header at ``addr``."""
        out = []
        if self.at(addr, 4) == b"OHDR":
            pre = self.at(addr, 6)
            if pre[4] != 2:
                raise NotImplementedError(f"object header version {pre[4]}")
            flags = pre[5]
            p = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 3)
            size = _u(self.at(addr + p, width))
            blocks = [(addr + p + width, size)]
            hlen = 6 if flags & 0x04 else 4
            while blocks:
                start, size = blocks.pop(0)
                body = self.at(start, size)
                q = 0
                while q + hlen <= len(body):
                    mtype, msize, mflags = struct.unpack_from("<BHB", body, q)
                    data = body[q + hlen:q + hlen + msize]
                    q += hlen + msize
                    if mtype == 0x10:
                        off, length = struct.unpack_from("<QQ", data)
                        if self.at(off, 4) != b"OCHK":
                            raise ValueError("bad object header continuation block")
                        blocks.append((off + 4, length - 8))
                    elif mtype:
                        out.append((mtype, mflags, data))
            return out
        ver, _, n, _, size = struct.unpack_from("<BBHII", self.at(addr, 16))
        if ver != 1:
            raise NotImplementedError(f"object header version {ver}")
        blocks = [(addr + 16, size)]
        while blocks:
            start, size = blocks.pop(0)
            body = self.at(start, size)
            q = 0
            while q + 8 <= len(body):
                mtype, msize, mflags = struct.unpack_from("<HHB", body, q)
                data = body[q + 8:q + 8 + msize]
                q += 8 + msize
                if mtype == 0x10:
                    blocks.append(struct.unpack_from("<QQ", data))
                elif mtype:
                    out.append((mtype, mflags, data))
        return out

    # -- groups ------------------------------------------------------------

    def read_root(self, root: File) -> None:
        root._addr = self.root
        self._read_group(self.root, root, self.messages(self.root))

    def read_object(self, parent: Group, name: str, addr: int):
        """The group or dataset whose object header is at ``addr``."""
        msgs = self.messages(addr)
        types = {m[0] for m in msgs}
        if 0x0008 in types:
            return self._dataset(parent._child_name(name), msgs, addr)
        if types & {0x0011, 0x0002, 0x0006, 0x000A}:
            sub = Group(parent._child_name(name), self.file)
            sub._addr = addr
            self._read_group(addr, sub, msgs)
            return sub
        raise NotImplementedError(f"{parent._child_name(name)}: HDF5 object that is neither "
                                  "a group nor a dataset")

    def _read_group(self, addr: int, group: Group, msgs) -> None:
        links = []
        for mtype, _, data in msgs:
            if mtype == 0x0011:
                group._stab = struct.unpack_from("<QQ", data)
                entries = self.stab_links(group._stab[0], group._stab[1])[0]
                links += [(name, header) for name, header, _ in entries]
            elif mtype == 0x0006:
                links.append(self._link(data))
            elif mtype == 0x0002:
                flags = data[1]
                heap, name_index = struct.unpack_from("<QQ", data, 2 + (8 if flags & 1 else 0))
                if heap != _UNDEF:
                    links += self._dense_links(heap, name_index)
        group._links.update(links)

    def stab_links(self, btree: int, heap: Optional[int] = None):
        """A symbol-table group's (name, header, cached (B-tree, heap) or
        None) links, and the addresses of its symbol-table nodes and non-root
        B-tree nodes."""
        names = b""
        if heap is not None:
            hdr = self.at(heap, 32)
            if hdr[:4] != b"HEAP":
                raise ValueError("bad local heap")
            size, _, data_addr = struct.unpack_from("<QQQ", hdr, 8)
            names = self.at(data_addr, size)
        links, snods, nodes = [], [], []

        def walk(addr: int, root: bool) -> None:
            hdr = self.at(addr, 24)
            if hdr[:4] != b"TREE" or hdr[4] != 0:
                raise ValueError("bad group B-tree")
            if not root:
                nodes.append(addr)
            level, used = hdr[5], struct.unpack_from("<H", hdr, 6)[0]
            body = self.at(addr + 24, 8 + used * 16)
            for i in range(used):
                child = struct.unpack_from("<Q", body, 8 + 16 * i)[0]
                if level > 0:
                    walk(child, False)
                    continue
                snods.append(child)
                snod = self.at(child, 8)
                if snod[:4] != b"SNOD":
                    raise ValueError("bad symbol-table node")
                count = struct.unpack_from("<H", snod, 6)[0]
                raw = self.at(child + 8, 40 * count)
                for j in range(count):
                    name_off, header, cache = struct.unpack_from("<QQI", raw, 40 * j)
                    if heap is not None:
                        stab = struct.unpack_from("<QQ", raw, 40 * j + 24) if cache == 1 else None
                        links.append((names[name_off:names.index(b"\0", name_off)].decode(),
                                      header, stab))

        walk(btree, True)
        return links, snods, nodes

    @staticmethod
    def _link(data: bytes):
        flags = data[1]
        p = 2
        ltype = 0
        if flags & 0x08:
            ltype, p = data[p], p + 1
        p += (8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        n = _u(data[p:p + width])
        name = data[p + width:p + width + n].decode()
        if ltype != 0:
            raise NotImplementedError(f"{name}: HDF5 soft or external link")
        return name, struct.unpack_from("<Q", data, p + width + n)[0]

    def _dense_links(self, heap_addr: int, btree_addr: int):
        heap = _FractalHeap(self, heap_addr)
        return [self._link(heap.get(rec[4:])) for rec in self._v2_records(btree_addr)]

    def _v2_records(self, addr: int) -> List[bytes]:
        """Every record of a v2 B-tree."""
        hdr = self.at(addr, 38)
        if hdr[:4] != b"BTHD":
            raise ValueError("bad v2 B-tree header")
        node_size, rec, depth = struct.unpack_from("<IHH", hdr, 6)
        root, root_n = struct.unpack_from("<QH", hdr, 16)
        max_n = [(node_size - 10) // rec]
        nrec_size = _enc_size(max_n[0])
        cum, cum_size = [max_n[0]], [0]
        for d in range(1, depth + 1):
            ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
            max_n.append((node_size - (10 + ptr)) // (rec + ptr))
            cum.append((max_n[d] + 1) * cum[d - 1] + max_n[d])
            cum_size.append(_enc_size(cum[d]))
        out: List[bytes] = []

        def walk(node: int, n: int, d: int) -> None:
            if node == _UNDEF or n == 0:
                return
            if d == 0:
                body = self.at(node + 6, n * rec)
                out.extend(body[i * rec:(i + 1) * rec] for i in range(n))
                return
            ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
            body = self.at(node + 6, n * rec + (n + 1) * ptr)
            out.extend(body[i * rec:(i + 1) * rec] for i in range(n))
            for i in range(n + 1):
                p = n * rec + i * ptr
                child = struct.unpack_from("<Q", body, p)[0]
                walk(child, _u(body[p + 8:p + 8 + nrec_size]), d - 1)

        walk(root, root_n, depth)
        return out

    # -- datasets ----------------------------------------------------------

    def _dataset(self, name: str, msgs, addr: int) -> Dataset:
        by = {}
        for mtype, mflags, data in msgs:
            if mtype in (0x0003,) and mflags & 0x02:
                raise NotImplementedError(f"{name}: shared (committed) HDF5 datatype")
            by.setdefault(mtype, data)
        space, dtype_msg, layout = by.get(0x0001), by.get(0x0003), by.get(0x0008)
        if space is None or dtype_msg is None:
            raise NotImplementedError(f"{name}: dataset without a dataspace or datatype")
        rank, sflags = space[1], space[2]
        if space[0] == 2 and space[3] == 2:
            raise NotImplementedError(f"{name}: null dataspace")
        p = 8 if space[0] == 1 else 4
        shape = struct.unpack_from(f"<{rank}Q", space, p)
        maxshape = (struct.unpack_from(f"<{rank}Q", space, p + 8 * rank) if sflags & 1
                    else shape)
        dtype = _parse_dtype(dtype_msg)
        filters = self._filters(by.get(0x000B))
        fh = self.fh
        if layout[0] not in (3, 4):
            raise NotImplementedError(f"{name}: HDF5 data layout message version {layout[0]}")
        cls = layout[1]
        if cls == 1:
            data_addr = struct.unpack_from("<Q", layout, 2)[0]
            return Dataset(name, shape, dtype,
                           _read_contiguous(fh, name, data_addr, shape, dtype), addr)
        if cls == 0:
            n = struct.unpack_from("<H", layout, 2)[0]
            raw = bytes(layout[4:4 + n])
            count = int(np.prod(shape))
            return Dataset(name, shape, dtype,
                           lambda: np.frombuffer(raw, dtype, count).reshape(shape).copy(), addr)
        if cls != 2:
            raise NotImplementedError(f"{name}: HDF5 layout class {cls}")
        chunks = _ChunkIndex(self, name, layout, shape, maxshape, dtype.itemsize, filters)
        file = self.file

        def read() -> np.ndarray:
            if file is not None and file.closed:
                raise ValueError(f"dataset {name} read after its file was closed")
            return chunks.assemble(dtype, filters)
        return Dataset(name, shape, dtype, read, addr)

    @staticmethod
    def _filters(msg: Optional[bytes]) -> List[int]:
        if msg is None:
            return []
        ver, n = msg[0], msg[1]
        p = 8 if ver == 1 else 2
        ids = []
        for _ in range(n):
            fid = struct.unpack_from("<H", msg, p)[0]
            if ver == 1 or fid >= 256:
                name_len, _, nvals = struct.unpack_from("<HHH", msg, p + 2)
                p += 8
            else:
                name_len, (_, nvals) = 0, struct.unpack_from("<HH", msg, p + 2)
                p += 6
            p += name_len + 4 * nvals + (4 if ver == 1 and nvals % 2 else 0)
            ids.append(fid)
        return ids


class _FractalHeap:
    """Managed objects of a fractal heap (dense link storage)."""

    def __init__(self, r: _Reader, addr: int):
        h = r.at(addr, 146)
        if h[:4] != b"FRHP":
            raise ValueError("bad fractal heap header")
        self.r = r
        self.id_len, filt_len, self.flags = struct.unpack_from("<HHB", h, 5)
        if filt_len:
            raise NotImplementedError("filtered fractal heap")
        self.max_man = struct.unpack_from("<I", h, 10)[0]
        self.width = struct.unpack_from("<H", h, 110)[0]
        self.start, self.max_direct = struct.unpack_from("<QQ", h, 112)
        self.max_bits, _, self.root, self.rows = struct.unpack_from("<HHQH", h, 128)
        self.off_size = (self.max_bits + 7) // 8
        self.len_size = min((_log2(self.max_direct) + 7) // 8, _enc_size(self.max_man))
        self.direct_rows = _log2(self.max_direct) - _log2(self.start) + 2

    def _row_size(self, row: int) -> int:
        return self.start if row == 0 else self.start << (row - 1)

    def get(self, hid: bytes) -> bytes:
        if (hid[0] >> 4) & 3:  # a link message never fits a tiny object's ID
            raise NotImplementedError("huge or tiny object in a fractal heap")
        off = _u(hid[1:1 + self.off_size])
        n = _u(hid[1 + self.off_size:1 + self.off_size + self.len_size])
        if self.rows == 0:
            return self.r.at(self.root + off, n)
        return self._from_indirect(self.root, self.rows, 0, off, n)

    def _from_indirect(self, addr: int, rows: int, block_off: int, off: int, n: int) -> bytes:
        head = 4 + 1 + 8 + self.off_size
        n_direct = min(rows, self.direct_rows)
        pos = block_off
        for row in range(rows):
            size = self._row_size(row)
            for col in range(self.width):
                if pos <= off < pos + size:
                    if row < self.direct_rows:
                        slot = head + 8 * (row * self.width + col)
                    else:
                        slot = head + 8 * (n_direct * self.width
                                           + (row - n_direct) * self.width + col)
                    child = struct.unpack_from("<Q", self.r.at(addr + slot, 8))[0]
                    if row < self.direct_rows:
                        return self.r.at(child + off - pos, n)
                    child_rows = _log2(size) - (_log2(self.start) + _log2(self.width)) + 1
                    return self._from_indirect(child, child_rows, pos, off, n)
                pos += size
        raise ValueError("fractal heap offset out of range")


class _ChunkIndex:
    """The chunks of a chunked dataset: (offset, address, size, filter mask)."""

    def __init__(self, r: _Reader, name: str, layout: bytes, shape, maxshape, itemsize: int,
                 filters):
        self.r, self.name, self.shape = r, name, tuple(shape)
        self.itemsize = itemsize
        self.filtered = bool(filters)
        ver = layout[0]
        if ver == 3:
            nd = layout[2]
            self.index_addr = struct.unpack_from("<Q", layout, 3)[0]
            self.chunk = struct.unpack_from(f"<{nd}I", layout, 11)[:-1]
            self.kind, self.params = 0, None
        else:
            flags, nd, enc = layout[2], layout[3], layout[4]
            p = 5
            dims = [_u(layout[p + i * enc:p + (i + 1) * enc]) for i in range(nd)]
            self.chunk = tuple(dims[:-1])
            p += nd * enc
            self.kind = layout[p]
            p += 1
            if self.kind == 1:
                if flags & 0x02:
                    fsize, fmask = struct.unpack_from("<QI", layout, p)
                    p += 12
                else:
                    fsize, fmask = None, 0
                self.params = (fsize, fmask)
            elif self.kind == 3:
                self.params = layout[p]
                p += 1
            elif self.kind == 4:
                self.params = tuple(layout[p:p + 5])
                p += 5
            else:
                raise NotImplementedError(f"{name}: HDF5 chunk index type {self.kind} "
                                          "(implicit or v2 B-tree)")
            self.index_addr = struct.unpack_from("<Q", layout, p)[0]
        unlimited = [i for i, m in enumerate(maxshape) if m == _UNDEF]
        if unlimited and unlimited != [0] and self.kind in (3, 4):
            raise NotImplementedError(f"{name}: unlimited dimension other than the first")
        # chunk counts over the maximal dims, which order the linear chunk index
        self.grid = [-(-(m if m != _UNDEF else s) // c) if c else 0
                     for m, s, c in zip(maxshape, self.shape, self.chunk)]
        self.nbytes = int(np.prod(self.chunk, dtype=np.int64)) * itemsize

    def _coords(self, idx: int):
        out = []
        for g in reversed(self.grid[1:]):
            out.append(idx % g)
            idx //= g
        out.append(idx)
        return tuple(c * s for c, s in zip(reversed(out), self.chunk))

    def chunks(self):
        if self.index_addr == _UNDEF:
            return
        if self.kind == 0:
            yield from self._btree(self.index_addr)
        elif self.kind == 1:
            fsize, fmask = self.params
            yield (0,) * len(self.chunk), self.index_addr, fsize or self.nbytes, fmask
        elif self.kind == 3:
            yield from self._fixed_array()
        else:
            yield from self._extensible_array()

    def _element(self, raw: bytes):
        addr = struct.unpack_from("<Q", raw)[0]
        if not self.filtered:
            return addr, self.nbytes, 0
        return addr, _u(raw[8:-4]), struct.unpack_from("<I", raw, len(raw) - 4)[0]

    def _btree(self, addr: int):
        r = self.r
        hdr = r.at(addr, 24)
        if hdr[:4] != b"TREE" or hdr[4] != 1:
            raise ValueError(f"{self.name}: bad chunk B-tree")
        level, used = hdr[5], struct.unpack_from("<H", hdr, 6)[0]
        nd = len(self.chunk) + 1
        ksize = 8 + 8 * nd
        body = r.at(addr + 24, used * (ksize + 8) + ksize)
        for i in range(used):
            p = i * (ksize + 8)
            size, mask = struct.unpack_from("<II", body, p)
            offset = struct.unpack_from(f"<{nd}Q", body, p + 8)[:-1]
            child = struct.unpack_from("<Q", body, p + ksize)[0]
            if level > 0:
                yield from self._btree(child)
            else:
                yield offset, child, size, mask

    def _fixed_array(self):
        r = self.r
        h = r.at(self.index_addr, 28)
        if h[:4] != b"FAHD":
            raise ValueError(f"{self.name}: bad fixed array header")
        esize, page_bits = h[6], h[7]
        n, dblk = struct.unpack_from("<QQ", h, 8)
        page_n = 1 << page_bits
        if n <= page_n:
            body = r.at(dblk + 14, n * esize)
            for i in range(n):
                a, s, m = self._element(body[i * esize:(i + 1) * esize])
                yield self._coords(i), a, s, m
            return
        npages = -(-n // page_n)
        bitmap = r.at(dblk + 14, (npages + 7) // 8)
        first = dblk + 14 + len(bitmap) + 4
        for pg in range(npages):
            if not bitmap[pg // 8] & (0x80 >> (pg % 8)):
                continue
            k = min(page_n, n - pg * page_n)
            body = r.at(first + pg * (page_n * esize + 4), k * esize)
            for j in range(k):
                a, s, m = self._element(body[j * esize:(j + 1) * esize])
                yield self._coords(pg * page_n + j), a, s, m

    def _extensible_array(self):
        r = self.r
        h = r.at(self.index_addr, 72)
        if h[:4] != b"EAHD":
            raise ValueError(f"{self.name}: bad extensible array header")
        esize, max_bits, iblk_n, dblk_min, sblk_min_ptrs, page_bits = h[6:12]
        n_set = struct.unpack_from("<Q", h, 44)[0]
        iblock = struct.unpack_from("<Q", h, 60)[0]
        nsblks = 1 + max_bits - _log2(dblk_min)
        info, start_idx, start_dblk = [], 0, 0
        for u in range(nsblks):
            ndblks, dn = 1 << (u // 2), (1 << ((u + 1) // 2)) * dblk_min
            info.append((ndblks, dn, start_idx, start_dblk))
            start_idx += ndblks * dn
            start_dblk += ndblks
        ib_nsblks = 2 * _log2(sblk_min_ptrs)
        n_dblk_addrs = 2 * (sblk_min_ptrs - 1)
        n_sblk_addrs = nsblks - ib_nsblks
        off_size = (max_bits + 7) // 8
        page_n = 1 << page_bits
        ib = r.at(iblock + 14, iblk_n * esize + 8 * (n_dblk_addrs + n_sblk_addrs))
        dblk_addrs = struct.unpack_from(f"<{n_dblk_addrs}Q", ib, iblk_n * esize)
        sblk_addrs = struct.unpack_from(f"<{n_sblk_addrs}Q", ib, iblk_n * esize + 8 * n_dblk_addrs)

        prefix = 4 + 1 + 1 + 8 + off_size  # a data block's header
        for i in range(min(iblk_n, n_set)):
            yield (self._coords(i),) + self._element(ib[i * esize:(i + 1) * esize])
        for u, (ndblks, dn, s_idx, s_dblk) in enumerate(info):
            base = iblk_n + s_idx
            if base >= n_set:
                break
            if dn > page_n:  # past 131056 chunks
                raise NotImplementedError(f"{self.name}: paged extensible-array data block")
            if u < ib_nsblks:
                addrs = dblk_addrs[s_dblk:s_dblk + ndblks]
            else:
                sb = sblk_addrs[u - ib_nsblks]
                if sb == _UNDEF:
                    continue
                addrs = struct.unpack_from(f"<{ndblks}Q", r.at(sb + 14 + off_size, 8 * ndblks))
            for d, addr in enumerate(addrs):
                first = base + d * dn
                if first >= n_set or addr == _UNDEF:
                    continue
                count = min(dn, n_set - first)
                body = r.at(addr + prefix, count * esize)
                for j in range(count):
                    raw = body[j * esize:(j + 1) * esize]
                    yield (self._coords(first + j),) + self._element(raw)

    def assemble(self, dtype: np.dtype, filters) -> np.ndarray:
        out = np.zeros(self.shape, dtype)
        if out.size == 0:
            return out
        for offset, addr, size, mask in self.chunks():
            if addr == _UNDEF or any(o >= s for o, s in zip(offset, self.shape)):
                continue
            raw = _unfilter(self.r.at(addr, size), filters, mask, self.itemsize)
            block = np.frombuffer(raw, dtype, int(np.prod(self.chunk))).reshape(self.chunk)
            dst = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offset, self.chunk, self.shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out
