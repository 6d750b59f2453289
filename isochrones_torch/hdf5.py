"""HDF5 files without h5py: the subset that h5py and PyTables write by default.

The JAX package keeps its results files, its MCMC checkpoints and its member
tables in HDF5 through ``h5py`` and ``pandas``; the machine with the card has
neither. This module reads and writes the format itself with numpy,
``struct`` and ``zlib`` (the layouts: the HDF5 File Format Specification,
version 2).

Reading (:class:`File`, :func:`read`) covers superblock versions 0 and 1;
version-1 object headers with their continuation blocks; symbol-table groups
(a version-1 B-tree of type 0, ``SNOD`` nodes and a local heap); dataspace,
datatype, fill-value, layout (version 3: compact, contiguous, and chunked
through a version-1 B-tree of type 1), filter-pipeline (deflate, shuffle) and
compact attribute messages; fixed-point, floating-point, bitfield,
fixed-length string, compound, array, enum and variable-length string
datatypes (the strings in global heap collections); scalar, simple and null
dataspaces. Values are what ``h5py`` returns: numpy arrays of the file's
dtype, numpy scalars for scalar attributes, ``str`` for variable-length
string attributes (``bytes`` in datasets), ``numpy.bytes_`` for fixed-length
strings, ``numpy.bool_`` for h5py's boolean enum (``FALSE``/``TRUE`` over an
8-bit integer), the unsigned integer of its size for a bitfield, and ``None``
for a null dataspace (h5py's ``Empty``). Anything else (superblock 2 or 3,
version-2 object headers, link messages and fractal heaps, dense attribute
storage, other filters, other variable-length sequences, references) raises
``ValueError`` naming what it met and the file; no partial result is
returned.

Writing (:func:`write`) lays a :class:`Tree` of groups, numpy datasets and
attributes out as h5py's default (earliest) format does: superblock 0,
symbol-table groups, contiguous datasets (or, where a :class:`Data` asks
for it, one shuffled and deflated chunk), compact attributes, Python ``str``
attributes as variable-length UTF-8 strings in one global heap, ``bool`` as
h5py's enum. The file is written whole under a temporary name, then renamed
into place; to append, :func:`read` the file, change the tree, write it
again.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

__all__ = ["SIGNATURE", "File", "Group", "Dataset", "Tree", "Data", "read", "write"]

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF

_CLASS_NAMES = {2: "time datatype", 5: "opaque datatype", 7: "reference datatype"}
_FILTER_NAMES = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset", 305: "lzo", 307: "bzip2",
                 32000: "lzf", 32001: "blosc", 32004: "lz4", 32015: "zstd"}
_MESSAGE_NAMES = {0x0002: "a link info message (new-style group)", 0x0006: "a link message (new-style group)",
                  0x0007: "external data storage", 0x000A: "a group info message (new-style group)"}
#: the messages read: dataspace, datatype, fill value, layout, filter
#: pipeline, attribute, symbol table, attribute info
_KNOWN = (0x0001, 0x0003, 0x0005, 0x0008, 0x000B, 0x000C, 0x0011, 0x0015)
#: messages that carry nothing this reader needs: NIL, the old fill value,
#: bogus, comment, modification times, reference count, and the superblock
#: extension's B-tree 'K' values, file-access and file space records
_IGNORED = (0x0000, 0x0004, 0x0009, 0x000D, 0x000E, 0x0012, 0x0013, 0x0014, 0x0016, 0x0017)
_IEEE = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}


def _pad8(n):
    return (n + 7) & ~7


def _padded(data):
    """``data`` with zeros to a multiple of 8 bytes."""
    return data + bytes(_pad8(len(data)) - len(data))


class _Type:
    """A parsed HDF5 datatype: its numpy dtype (None for a variable-length
    string), its size in the file and, for strings, the character set."""

    __slots__ = ("dtype", "size", "vlen_str", "cset")

    def __init__(self, dtype, size, vlen_str=False, cset=0):
        self.dtype, self.size, self.vlen_str, self.cset = dtype, size, vlen_str, cset


class _Reader:
    """The bytes of one file and the parsers of its structures."""

    def __init__(self, filename):
        self.name = os.fspath(filename)
        with open(self.name, "rb") as f:
            self.buf = f.read()
        sb = next((p for p in (0, 512, 1024, 2048, 4096, 8192) if self.buf[p:p + 8] == SIGNATURE), None)
        if sb is None:
            self.fail("a file without the HDF5 signature")
        version = self.buf[sb + 8]
        if version not in (0, 1):
            self.fail(f"superblock version {version}")
        if self.buf[sb + 13] != 8 or self.buf[sb + 14] != 8:
            self.fail(f"{self.buf[sb + 13]}-byte offsets and {self.buf[sb + 14]}-byte lengths")
        p = sb + (24 if version == 0 else 28)
        self.base = self.u64(p)
        self.root = self.base + self.u64(p + 32 + 8)
        self._gheaps = {}

    def fail(self, what):
        raise ValueError(f"{self.name}: {what} is not supported by the HDF5 reader")

    def u64(self, p):
        return struct.unpack_from("<Q", self.buf, p)[0]

    def addr(self, a):
        return self.base + a

    # ------------------------------------------------------------ object headers
    def messages(self, addr):
        """``(type, data)`` of every message of the object header at ``addr``,
        continuation blocks followed."""
        b = self.buf
        if b[addr:addr + 4] == b"OHDR":
            self.fail("a version-2 object header")
        if b[addr] != 1:
            self.fail(f"object header version {b[addr]}")
        blocks = [(addr + 16, struct.unpack_from("<I", b, addr + 8)[0])]
        out = []
        while blocks:
            start, length = blocks.pop(0)
            p, end = start, start + length
            while p + 8 <= end:
                mtype, size, flags = struct.unpack_from("<HHB", b, p)
                data = b[p + 8:p + 8 + size]
                p += 8 + size
                if flags & 2:
                    self.fail(f"a shared (committed) message of type {mtype:#06x}")
                if mtype == 0x0010:
                    off, ln = struct.unpack_from("<QQ", data)
                    blocks.append((self.addr(off), ln))
                elif mtype in _KNOWN:
                    out.append((mtype, data))
                elif mtype not in _IGNORED:
                    self.fail(_MESSAGE_NAMES.get(mtype, f"message type {mtype:#06x}"))
        return out

    # ------------------------------------------------------------------ datatypes
    def dtype(self, d, p=0):
        """The datatype at ``d[p:]``: ``(_Type, end)``."""
        cls, version = d[p] & 0x0F, d[p] >> 4
        f0, f1 = d[p + 1], d[p + 2]
        size = struct.unpack_from("<I", d, p + 4)[0]
        q = p + 8
        order = ">" if f0 & 1 else "<"
        if cls == 0:
            if size not in (1, 2, 4, 8):
                self.fail(f"a {size}-byte integer")
            return _Type(np.dtype(f"{order}{'i' if f0 & 8 else 'u'}{size}"), size), q + 4
        if cls == 1:
            exp_loc, exp_size, mant_loc, mant_size = struct.unpack_from("<BBBB", d, q + 4)
            bias = struct.unpack_from("<I", d, q + 8)[0]
            if f0 & 0x40 or _IEEE.get(size) != (exp_loc, exp_size, mant_size, bias) or mant_loc:
                self.fail(f"a {size}-byte non-IEEE floating-point type")
            return _Type(np.dtype(f"{order}f{size}"), size), q + 12
        if cls == 3:
            return _Type(np.dtype(f"S{size}"), size, cset=f0 >> 4), q
        if cls == 4:
            if size not in (1, 2, 4, 8):
                self.fail(f"a {size}-byte bitfield")
            return _Type(np.dtype(f"{order}u{size}"), size), q + 4
        if cls == 6:
            return self._compound(d, q, version, f0 | f1 << 8, size)
        if cls == 8:
            return self._enum(d, q, version, f0 | f1 << 8, size)
        if cls == 9:
            base, end = self.dtype(d, q)
            if f0 & 0x0F != 1:
                self.fail("a variable-length sequence (only variable-length strings are read)")
            return _Type(None, size, vlen_str=True, cset=f1 & 0x0F), end
        if cls == 10:
            ndim = d[q]
            q += 1 if version >= 3 else 4
            dims = struct.unpack_from(f"<{ndim}I", d, q)
            q += 4 * ndim * (1 if version >= 3 else 2)
            base, end = self.dtype(d, q)
            if base.dtype is None:
                self.fail("an array of variable-length strings")
            return _Type(np.dtype((base.dtype, dims)), size), end
        self.fail(_CLASS_NAMES.get(cls, f"datatype class {cls}"))

    def _name(self, d, q, padded):
        end = d.index(b"\0", q)
        return d[q:end].decode("utf-8"), (q + _pad8(end + 1 - q) if padded else end + 1)

    def _compound(self, d, q, version, n, size):
        names, formats, offsets = [], [], []
        for _ in range(n):
            name, q = self._name(d, q, padded=version < 3)
            if version < 3:
                off = struct.unpack_from("<I", d, q)[0]
                q += 4
            else:
                nb = 1 if size < 1 << 8 else 2 if size < 1 << 16 else 3 if size < 1 << 24 else 4
                off = int.from_bytes(d[q:q + nb], "little")
                q += nb
            dims = ()
            if version == 1:
                ndim = d[q]
                dims = struct.unpack_from(f"<{ndim}I", d, q + 12)
                q += 28
            member, q = self.dtype(d, q)
            if member.dtype is None:
                self.fail(f"a variable-length string member ({name!r}) of a compound type")
            names.append(name)
            formats.append((member.dtype, dims) if dims else member.dtype)
            offsets.append(off)
        return _Type(np.dtype(dict(names=names, formats=formats, offsets=offsets, itemsize=size)), size), q

    def _enum(self, d, q, version, n, size):
        base, q = self.dtype(d, q)
        names = []
        for _ in range(n):
            name, q = self._name(d, q, padded=version < 3)
            names.append(name)
        values = np.frombuffer(d, base.dtype, n, q).tolist()
        q += n * base.size
        if base.dtype.kind == "i" and size == 1 and dict(zip(names, values)) == {"FALSE": 0, "TRUE": 1}:
            return _Type(np.dtype("?"), 1), q
        return _Type(base.dtype, size), q

    # ---------------------------------------------------------- other messages
    def dataspace(self, d):
        """The shape (``()`` for a scalar, None for a null dataspace)."""
        version, ndim = d[0], d[1]
        if version == 1:
            p, kind = 8, (1 if ndim else 0)
        elif version == 2:
            p, kind = 4, d[3]
        else:
            self.fail(f"dataspace version {version}")
        if kind == 2:
            return None
        return tuple(struct.unpack_from(f"<{ndim}Q", d, p))

    def filters(self, d):
        """``[(id, client data)]`` of a filter pipeline message; anything but
        deflate and shuffle fails."""
        version, n = d[0], d[1]
        p = 8 if version == 1 else 2
        out = []
        for _ in range(n):
            fid = struct.unpack_from("<H", d, p)[0]
            if version == 1 or fid >= 256:
                namelen, flags, nvals = struct.unpack_from("<HHH", d, p + 2)
                p += 8
            else:
                namelen = 0
                flags, nvals = struct.unpack_from("<HH", d, p + 2)
                p += 6
            name = d[p:p + namelen].split(b"\0")[0].decode("ascii", "replace")
            p += _pad8(namelen) if version == 1 else namelen
            vals = struct.unpack_from(f"<{nvals}I", d, p)
            p += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
            if fid not in (1, 2):
                self.fail(f"the {name or _FILTER_NAMES.get(fid, 'unknown')} filter (id {fid})")
            out.append((fid, vals))
        return out

    @staticmethod
    def fill(d):
        """The fill value's bytes, or None (zeros)."""
        version = d[0]
        if version in (1, 2) and d[3] and len(d) >= 8:
            size = struct.unpack_from("<I", d, 4)[0]
            return d[8:8 + size] or None
        if version == 3 and d[1] & 0x20:
            size = struct.unpack_from("<I", d, 2)[0]
            return d[6:6 + size] or None
        return None

    def attribute(self, d):
        """``(name, value)`` of an attribute message."""
        version = d[0]
        namesz, dtsz, dssz = struct.unpack_from("<HHH", d, 2)
        if version == 1:
            p = 8
            name = d[p:p + namesz].split(b"\0")[0]
            p += _pad8(namesz)
            t = self.dtype(d[p:p + dtsz])[0]
            p += _pad8(dtsz)
            shape = self.dataspace(d[p:p + dssz])
            p += _pad8(dssz)
        elif version in (2, 3):
            if d[1] & 3:
                self.fail("a shared attribute datatype or dataspace")
            p = 8 if version == 2 else 9
            name = d[p:p + namesz].split(b"\0")[0]
            p += namesz
            t = self.dtype(d[p:p + dtsz])[0]
            p += dtsz
            shape = self.dataspace(d[p:p + dssz])
            p += dssz
        else:
            self.fail(f"attribute message version {version}")
        name = name.decode("utf-8")
        if shape is None:
            return name, None
        value = self.decode(t, shape, d[p:], attribute=True)
        return name, (value[()] if shape == () else value)

    def attributes(self, msgs):
        out = {}
        for mtype, d in msgs:
            if mtype == 0x000C:
                name, value = self.attribute(d)
                out[name] = value
            elif mtype == 0x0015:
                flags = d[1]
                heap = struct.unpack_from("<Q", d, 4 if flags & 1 else 2)[0]
                if heap != UNDEF:
                    self.fail("dense attribute storage (a fractal heap)")
        return out

    # ------------------------------------------------------------------ values
    def decode(self, t, shape, raw, attribute=False):
        """The elements of ``raw`` as an array of ``shape``."""
        n = int(np.prod(shape, dtype=np.int64))
        if not t.vlen_str:
            return np.frombuffer(raw, t.dtype, n).reshape(shape).copy()
        out = np.empty(n, dtype=object)
        for i in range(n):
            length, coll, idx = struct.unpack_from("<IQI", raw, 16 * i)
            s = self.gheap(coll)[idx][:length] if length else b""
            out[i] = s.decode("utf-8" if t.cset == 1 else "ascii") if attribute else s
        return out.reshape(shape)

    def gheap(self, coll):
        """The objects of the global heap collection at file address ``coll``."""
        if coll not in self._gheaps:
            p = self.addr(coll)
            b = self.buf
            if b[p:p + 4] != b"GCOL":
                self.fail(f"a global heap collection without its signature at {p}")
            end = p + self.u64(p + 8)
            objs = {}
            q = p + 16
            while q + 16 <= end:
                idx = struct.unpack_from("<H", b, q)[0]
                size = self.u64(q + 8)
                if idx == 0:
                    break
                objs[idx] = b[q + 16:q + 16 + size]
                q += 16 + _pad8(size)
            self._gheaps[coll] = objs
        return self._gheaps[coll]

    # ------------------------------------------------------------------ groups
    def group_entries(self, btree, heap):
        """``{name: object header address}`` of a symbol-table group, in the
        B-tree's (name) order."""
        b = self.buf
        hp = self.addr(heap)
        if b[hp:hp + 4] != b"HEAP":
            self.fail(f"a local heap without its signature at {hp}")
        data = self.addr(self.u64(hp + 24))
        out = {}
        self._walk_group(self.addr(btree), data, out)
        return out

    def _walk_group(self, node, heap_data, out):
        b = self.buf
        if b[node:node + 4] != b"TREE" or b[node + 4] != 0:
            self.fail(f"a group B-tree node of another kind at {node}")
        level = b[node + 5]
        n = struct.unpack_from("<H", b, node + 6)[0]
        for i in range(n):
            child = self.addr(self.u64(node + 24 + 8 + 16 * i))
            if level:
                self._walk_group(child, heap_data, out)
                continue
            if b[child:child + 4] != b"SNOD":
                self.fail(f"a symbol table node without its signature at {child}")
            for j in range(struct.unpack_from("<H", b, child + 6)[0]):
                e = child + 8 + 40 * j
                off, hdr = struct.unpack_from("<QQ", b, e)
                start = heap_data + off
                name = b[start:b.index(b"\0", start)].decode("utf-8")
                out[name] = self.addr(hdr)

    # ---------------------------------------------------------------- datasets
    def dataset(self, msgs):
        """``(_Type, shape, reader)`` of a dataset's messages."""
        t = shape = layout = None
        fill, filters = None, []
        for mtype, d in msgs:
            if mtype == 0x0001:
                shape = self.dataspace(d)
            elif mtype == 0x0003:
                t = self.dtype(d)[0]
            elif mtype == 0x0005:
                fill = self.fill(d)
            elif mtype == 0x0008:
                layout = d
            elif mtype == 0x000B:
                filters = self.filters(d)
        if layout[0] != 3:
            self.fail(f"layout message version {layout[0]}")
        return t, shape, (lambda: self.read_data(t, shape, layout, fill, filters))

    def read_data(self, t, shape, layout, fill, filters):
        if shape is None:
            return None
        n = int(np.prod(shape, dtype=np.int64))
        nbytes = n * t.size
        kind = layout[1]
        if kind == 0:
            size = struct.unpack_from("<H", layout, 2)[0]
            raw = layout[4:4 + size]
        elif kind == 1:
            a, size = struct.unpack_from("<QQ", layout, 2)
            raw = self._filled(fill, t.size, n).tobytes() if a == UNDEF else self.buf[self.addr(a):self.addr(a) + size]
        elif kind == 2:
            raw = self._chunked(t, shape, layout, fill, filters)
        else:
            self.fail(f"layout class {kind} (virtual)")
        if len(raw) < nbytes:
            self.fail(f"a dataset whose storage is {len(raw)} of its {nbytes} bytes")
        return self.decode(t, shape, raw[:nbytes])

    @staticmethod
    def _filled(fill, size, n):
        out = np.zeros(n, dtype=f"V{size}")
        if fill is not None and len(fill) == size:
            out[:] = np.frombuffer(fill, f"V{size}")[0]
        return out

    def _chunked(self, t, shape, layout, fill, filters):
        ndim = layout[2]
        btree = struct.unpack_from("<Q", layout, 3)[0]
        cdims = struct.unpack_from(f"<{ndim}I", layout, 11)[:-1]
        out = self._filled(fill, t.size, int(np.prod(shape, dtype=np.int64))).reshape(shape)
        if btree == UNDEF or not out.size:
            return out.tobytes()
        for offsets, size, mask, caddr in self._chunk_entries(self.addr(btree), ndim):
            raw = self.buf[caddr:caddr + size]
            for i, (fid, vals) in reversed(list(enumerate(filters))):
                if mask & (1 << i):
                    continue
                if fid == 1:
                    raw = zlib.decompress(raw)
                else:
                    raw = self._unshuffle(raw, vals[0] if vals else t.size)
            chunk = np.frombuffer(raw, f"V{t.size}", int(np.prod(cdims))).reshape(cdims)
            sel = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offsets, cdims, shape))
            out[sel] = chunk[tuple(slice(0, s.stop - s.start) for s in sel)]
        return out.tobytes()

    @staticmethod
    def _unshuffle(raw, size):
        n = len(raw) // size
        body = np.frombuffer(raw, np.uint8, n * size).reshape(size, n).T.tobytes()
        return body + bytes(raw[n * size:])

    def _chunk_entries(self, node, ndim):
        b = self.buf
        if b[node:node + 4] != b"TREE" or b[node + 4] != 1:
            self.fail(f"a chunk B-tree node of another kind at {node}")
        level = b[node + 5]
        n = struct.unpack_from("<H", b, node + 6)[0]
        key = 8 + 8 * ndim
        p = node + 24
        for _ in range(n):
            size, mask = struct.unpack_from("<II", b, p)
            offsets = struct.unpack_from(f"<{ndim}Q", b, p + 8)[:-1]
            child = self.addr(self.u64(p + key))
            p += key + 8
            if level:
                yield from self._chunk_entries(child, ndim)
            else:
                yield offsets, size, mask, child


class Dataset:
    """A dataset of a file being read: ``shape``, ``dtype``, ``attrs`` and
    :meth:`read` (the whole array)."""

    def __init__(self, reader, msgs, path):
        self.path = path
        t, self.shape, self._read = reader.dataset(msgs)
        self.dtype = np.dtype(object) if t.vlen_str else t.dtype
        self.attrs = reader.attributes(msgs)

    def read(self):
        return self._read()


class Group:
    """A group of a file being read. ``group["a/b"]`` is a :class:`Group` or
    the numpy array of a dataset; :meth:`node` gives a :class:`Dataset` with
    its attributes; ``attrs`` is a dict."""

    def __init__(self, reader, msgs, path):
        self._reader, self.path = reader, path
        stab = next((d for mtype, d in msgs if mtype == 0x0011), None)
        self._entries = reader.group_entries(*struct.unpack_from("<QQ", stab))
        self.attrs = reader.attributes(msgs)
        self._nodes = {}

    def keys(self):
        return list(self._entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def _child(self, name):
        if name not in self._nodes:
            if name not in self._entries:
                raise KeyError(f"{name!r} is not in {self.path} of {self._reader.name}")
            path = f"{self.path.rstrip('/')}/{name}"
            msgs = self._reader.messages(self._entries[name])
            types = {mtype for mtype, _ in msgs}
            if 0x0011 in types:
                self._nodes[name] = Group(self._reader, msgs, path)
            elif 0x0008 in types:
                self._nodes[name] = Dataset(self._reader, msgs, path)
            else:
                self._reader.fail(f"an object with neither a symbol table nor a layout ({path})")
        return self._nodes[name]

    def node(self, path):
        """The :class:`Group` or :class:`Dataset` at ``path`` (``/``-separated,
        relative to this group)."""
        node = self
        for part in str(path).strip("/").split("/"):
            if part:
                if not isinstance(node, Group):
                    raise KeyError(f"{node.path} is a dataset, not a group")
                node = node._child(part)
        return node

    def __getitem__(self, path):
        node = self.node(path)
        return node.read() if isinstance(node, Dataset) else node

    def __contains__(self, path):
        try:
            self.node(path)
        except KeyError:
            return False
        return True


class File(Group):
    """An HDF5 file opened for reading (the whole file is read into memory).
    Works as a context manager, like ``h5py.File(filename, "r")``."""

    def __init__(self, filename):
        reader = _Reader(filename)
        super().__init__(reader, reader.messages(reader.root), "/")
        self.filename = reader.name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class Tree(dict):
    """A group in memory: name -> :class:`Tree` (a subgroup), or a numpy
    array or :class:`Data` (a dataset); its attributes in ``attrs``."""

    def __init__(self, *args, attrs=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.attrs = dict(attrs or {})

    def require(self, path):
        """The subgroup at ``path``, made (with its parents) where missing."""
        node = self
        for part in str(path or "").strip("/").split("/"):
            if part:
                if part not in node:
                    node[part] = Tree()
                node = node[part]
                if not isinstance(node, Tree):
                    raise ValueError(f"{path}: {part} is a dataset, not a group")
        return node

    def get_path(self, path):
        """The group or array at ``path``, or None."""
        node = self
        for part in str(path or "").strip("/").split("/"):
            if part:
                if not isinstance(node, Tree) or part not in node:
                    return None
                node = node[part]
        return node


class Data:
    """A dataset of a :class:`Tree` with its attributes; with ``deflate`` (a
    level) :func:`write` stores it compressed: one chunk of the whole array,
    shuffled, then deflated, as h5py's ``compression="gzip", shuffle=True``
    does. :func:`read` gives a dataset that has attributes as one of these,
    one without as its array."""

    def __init__(self, array, attrs=None, deflate=None):
        self.array, self.attrs, self.deflate = np.asarray(array), dict(attrs or {}), deflate


def read(filename):
    """The whole file as a :class:`Tree`: every group, dataset (a
    :class:`Data` where it has attributes) and attribute."""

    def walk(group):
        out = Tree(attrs=group.attrs)
        for name in group:
            node = group.node(name)
            if isinstance(node, Group):
                out[name] = walk(node)
            else:
                out[name] = Data(node.read(), node.attrs) if node.attrs else node.read()
        return out

    return walk(File(filename))


# --------------------------------------------------------------------- writer
def _enc_type(dt):
    """The datatype message for numpy dtype ``dt`` (``object``: a
    variable-length UTF-8 string)."""
    if dt == object:
        return struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 16) + struct.pack("<BBBBIHH", 0x10, 0, 0, 0, 1, 0, 8)
    order = 1 if dt.byteorder == ">" else 0
    if dt.kind == "b":
        base = struct.pack("<BBBBIHH", 0x10, 0x08, 0, 0, 1, 0, 8)
        return (struct.pack("<BBBBI", 0x18, 2, 0, 0, 1) + base + b"FALSE\0\0\0" + b"TRUE\0\0\0\0"
                + b"\x00\x01")
    if dt.kind in "iu":
        return struct.pack("<BBBBIHH", 0x10, order | (8 if dt.kind == "i" else 0), 0, 0, dt.itemsize, 0,
                           8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in _IEEE:
        exp_loc, exp_size, mant_size, bias = _IEEE[dt.itemsize]
        return (struct.pack("<BBBBI", 0x11, 0x20 | order, 8 * dt.itemsize - 1, 0, dt.itemsize)
                + struct.pack("<HHBBBBI", 0, 8 * dt.itemsize, exp_loc, exp_size, 0, mant_size, bias))
    if dt.kind == "S" and dt.itemsize:
        return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, dt.itemsize)
    if dt.kind == "V" and dt.names:
        body = b""
        for name in dt.names:
            field, off = dt.fields[name][:2]
            base, dims = (field.base, field.shape) if field.subdtype else (field, ())
            if len(dims) > 4:
                raise TypeError(f"field {name!r} has more than 4 dimensions")
            body += _padded(name.encode("utf-8") + b"\0")
            body += struct.pack("<IB3xI4x4I", off, len(dims), 0, *(tuple(dims) + (0,) * (4 - len(dims))))
            body += _enc_type(base)
        n = len(dt.names)
        return struct.pack("<BBBBI", 0x16, n & 0xFF, n >> 8, 0, dt.itemsize) + body
    raise TypeError(f"numpy dtype {dt} has no HDF5 counterpart in this writer")


def _enc_space(shape):
    return struct.pack("<BBBxI", 1, len(shape), 0, 0) + b"".join(struct.pack("<Q", n) for n in shape)


def _as_array(value, what):
    """``value`` as a numpy array to store: ``str`` and arrays of ``str`` or
    ``bytes`` as variable-length strings (dtype ``object``)."""
    if isinstance(value, (str, np.str_)):
        out = np.empty((), dtype=object)
        out[()] = str(value)
        return out
    if isinstance(value, bytes):
        return np.array(value, dtype=f"S{max(len(value), 1)}")
    if isinstance(value, bool):
        return np.array(value, dtype=bool)
    if isinstance(value, int):
        return np.array(value, dtype=np.int64)
    if isinstance(value, float):
        return np.array(value, dtype=np.float64)
    arr = np.asarray(value)
    if arr.dtype.kind == "U":
        arr = arr.astype(object)
    if arr.dtype == object:
        if not all(isinstance(v, (str, bytes)) for v in arr.flat):
            raise TypeError(f"{what}: an object array holds only str or bytes here")
    elif arr.dtype.kind not in "biufSV" or (arr.dtype.kind == "V" and not arr.dtype.names):
        raise TypeError(f"{what}: numpy dtype {arr.dtype} has no HDF5 counterpart in this writer")
    return arr


class _Writer:
    def __init__(self):
        self.out = bytearray(96)
        self.heap_ids = {}

    def alloc(self, data):
        at = len(self.out)
        self.out += _padded(data)
        return at

    def strings(self, tree):
        """Every variable-length string of the tree, in one global heap
        collection (several past 65535 strings)."""
        found = []

        def add(arr):
            if arr.dtype == object:
                for v in arr.flat:
                    s = v.encode("utf-8") if isinstance(v, str) else v
                    if b"\0" in s:
                        raise ValueError(f"variable-length string {v!r} holds a NUL, which HDF5 strings cannot")
                    found.append(s)

        def walk(attrs, children):
            for v in attrs.values():
                if v is not None:
                    add(_as_array(v, "attribute"))
            for v in children:
                if isinstance(v, Tree):
                    walk(v.attrs, v.values())
                else:
                    data = v if isinstance(v, Data) else Data(v)
                    walk(data.attrs, ())
                    add(_as_array(data.array, "dataset"))

        walk(tree.attrs, tree.values())
        unique = list(dict.fromkeys(s for s in found if s))
        for start in range(0, len(unique), 65535):
            objs = unique[start:start + 65535]
            body = b"".join(struct.pack("<HH4xQ", i + 1, 1, len(s)) + _padded(s) for i, s in enumerate(objs))
            size = max(4096, 16 + len(body) + 16)
            free = size - 16 - len(body)
            at = self.alloc(b"GCOL\x01\0\0\0" + struct.pack("<Q", size) + body + struct.pack("<HH4xQ", 0, 0, free)
                            + b"\0" * (free - 16))
            self.heap_ids.update({s: (at, i + 1) for i, s in enumerate(objs)})

    def values(self, arr):
        """The raw bytes of ``arr`` as stored (heap IDs for strings)."""
        if arr.dtype != object:
            return np.ascontiguousarray(arr).tobytes()
        out = b""
        for v in arr.flat:
            s = v.encode("utf-8") if isinstance(v, str) else v
            at, idx = self.heap_ids[s] if s else (0, 0)
            out += struct.pack("<IQI", len(s), at, idx)
        return out

    def attribute(self, name, value):
        """An attribute message; None is a null dataspace (h5py's ``Empty``)."""
        if value is None:
            dt, ds, raw = _enc_type(np.dtype("S1")), struct.pack("<BBBB", 2, 0, 0, 2), b""
        else:
            arr = _as_array(value, f"attribute {name!r}")
            dt, ds, raw = _enc_type(arr.dtype), _enc_space(arr.shape), self.values(arr)
        nb = name.encode("utf-8") + b"\0"
        msg = struct.pack("<BxHHH", 1, len(nb), len(dt), len(ds)) + _padded(nb) + _padded(dt) + _padded(ds) + raw
        if len(msg) > 65000:
            raise ValueError(f"attribute {name!r} is {len(msg)} bytes; compact attributes hold at most 64 KiB")
        return 0x000C, msg

    def header(self, msgs, attrs):
        msgs = list(msgs) + [self.attribute(k, v) for k, v in attrs.items()]
        body = b"".join(struct.pack("<HHB3x", t, _pad8(len(d)), 0) + _padded(d) for t, d in msgs)
        return self.alloc(struct.pack("<BxHII4x", 1, len(msgs), 1, len(body)) + body)

    def dataset(self, value, path):
        """A contiguous dataset, or with a :class:`Data`'s ``deflate`` one
        chunk, shuffled and deflated, indexed by a one-node chunk B-tree."""
        data = value if isinstance(value, Data) else Data(value)
        arr = _as_array(data.array, f"dataset {path}")
        raw = self.values(arr)
        msgs = [(0x0001, _enc_space(arr.shape)), (0x0003, _enc_type(arr.dtype)),
                (0x0005, struct.pack("<BBBB", 2, 1, 2, 0))]
        if data.deflate is None:
            at = self.alloc(raw) if raw else UNDEF
            return self.header(msgs + [(0x0008, struct.pack("<BBQQ", 3, 1, at, len(raw)))], data.attrs)
        if arr.dtype == object or not arr.size:
            raise TypeError(f"dataset {path}: deflate takes a non-empty array of fixed-size elements")
        size = arr.dtype.itemsize
        packed = zlib.compress(np.frombuffer(raw, np.uint8).reshape(-1, size).T.tobytes(), data.deflate)
        chunk = self.alloc(packed)
        dims = arr.shape + (size,)
        key = 8 + 8 * len(dims)
        node = (b"TREE" + struct.pack("<BBHQQ", 1, 0, 1, UNDEF, UNDEF)
                + struct.pack(f"<II{len(dims)}Q", len(packed), 0, *(0,) * len(dims)) + struct.pack("<Q", chunk)
                + struct.pack(f"<II{len(dims)}Q", 0, 0, *dims))
        btree = self.alloc(node + bytes(24 + 64 * 8 + 65 * key - len(node)))
        layout = struct.pack(f"<BBBQ{len(dims)}I", 3, 2, len(dims), btree, *dims)
        pipeline = (struct.pack("<BB6x", 1, 2) + struct.pack("<HHHHI4x", 2, 0, 1, 1, size)
                    + struct.pack("<HHHHI4x", 1, 0, 1, 1, data.deflate))
        return self.header(msgs + [(0x0008, layout), (0x000B, pipeline)], data.attrs)

    def group(self, tree, path):
        """The group's children, local heap, symbol table nodes and B-tree, then
        its header: ``(header, btree, heap)``."""
        children = []
        for name in sorted(tree, key=lambda s: s.encode("utf-8")):
            child = tree[name]
            sub = f"{path.rstrip('/')}/{name}"
            if "/" in name or not name:
                raise ValueError(f"{sub}: a name must be non-empty and hold no '/'")
            if isinstance(child, Tree):
                children.append((name, *self.group(child, sub)))
            else:
                children.append((name, self.dataset(child, sub), None, None))
        heap_data = bytearray(8)
        offsets = []
        for name, *_ in children:
            offsets.append(len(heap_data))
            heap_data += _padded(name.encode("utf-8") + b"\0")
        heap = self.alloc(b"HEAP\0\0\0\0" + struct.pack("<QQQ", len(heap_data), 1, len(self.out) + 32) + heap_data)
        nodes = []
        for start in range(0, len(children), 8):
            body = b""
            for (name, hdr, btree, lheap), off in zip(children[start:start + 8], offsets[start:start + 8]):
                cached = btree is not None
                body += struct.pack("<QQII", off, hdr, int(cached), 0)
                body += struct.pack("<QQ", btree, lheap) if cached else bytes(16)
            nodes.append((self.alloc(b"SNOD\x01\0" + struct.pack("<H", len(body) // 40) + body
                                     + bytes(320 - len(body))), offsets[min(start + 8, len(children)) - 1]))
        btree = self.btree(nodes, 0)
        return self.header([(0x0011, struct.pack("<QQ", btree, heap))], tree.attrs), btree, heap

    def btree(self, children, level):
        """A group B-tree over ``children`` (``(address, heap offset of its last
        name)``), 32 children a node, siblings linked."""
        groups = [children[i:i + 32] for i in range(0, len(children), 32)] or [[]]
        size = 24 + 33 * 8 + 32 * 8
        first = len(self.out)
        addrs = [first + i * size for i in range(len(groups))]
        for i, group in enumerate(groups):
            left = addrs[i - 1] if i else UNDEF
            right = addrs[i + 1] if i + 1 < len(groups) else UNDEF
            body = struct.pack("<Q", 0) + b"".join(struct.pack("<QQ", a, last) for a, last in group)
            node = b"TREE" + struct.pack("<BBHQQ", 0, level, len(group), left, right) + body
            self.alloc(node + bytes(size - len(node)))
        if len(groups) == 1:
            return addrs[0]
        return self.btree([(a, g[-1][1]) for a, g in zip(addrs, groups)], level + 1)

    def file(self, tree):
        self.strings(tree)
        root, btree, heap = self.group(tree, "/")
        entry = struct.pack("<QQII", 0, root, 1, 0) + struct.pack("<QQ", btree, heap)
        self.out[:96] = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + struct.pack("<HHI", 4, 16, 0)
                         + struct.pack("<QQQQ", 0, UNDEF, len(self.out), UNDEF) + entry)
        return bytes(self.out)


def write(filename, tree):
    """Write ``tree`` (a :class:`Tree`: subgroups, numpy arrays, attributes)
    as an HDF5 file, whole: to a temporary name, then renamed to
    ``filename``."""
    if not isinstance(tree, Tree):
        raise TypeError("write takes an hdf5.Tree")
    data = _Writer().file(tree)
    filename = os.fspath(filename)
    tmp = f"{filename}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, filename)
