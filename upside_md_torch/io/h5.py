"""A minimal HDF5 reader and writer in numpy alone.

The machine that runs the port has no h5py, and nothing else there writes
HDF5, so the logger writes its trajectories through this module and the
trajectory and analysis tools read them back through it.  It follows the
HDF Group's "HDF5 File Format Specification" (version 3.0) at its oldest
levels, the ones h5py writes by default (`libver="earliest"`):

* superblock version 0, offsets and lengths of 8 bytes;
* version 1 object headers, with continuation blocks when reading;
* old-style groups: a symbol-table message naming a version 1 B-tree of
  type 0, a local heap of link names and symbol-table nodes (SNOD);
* messages: dataspace (versions 1 and 2), datatype (fixed-point, IEEE
  float, fixed-length string, h5py's bool enumeration; variable-length
  strings in attributes only), fill value, data layout version 3
  (compact, contiguous, chunked with a version 1 B-tree of type 1) and
  attribute (versions 1-3).

The reader reads all of that, which covers the writer's files and what
h5py writes by default, and chunks filtered by deflate (gzip, through the
standard library's zlib), shuffle and fletcher32 (the checksum is
verified; a mismatch raises), each chunk's filter mask honoured.
Anything else (another filter such as szip, an external file, a shared or
committed datatype, variable-length data in a dataset, new-style groups,
a superblock above version 0 or a version 2 object header) raises
`UnsupportedFeature`, whose message names the feature: the reader never
returns data it did not understand.

The writer (`Writer`) makes groups, fixed-size contiguous datasets,
extensible datasets (unlimited first axis, chunked along it only) and
attributes, storing each type as h5py does: numpy bools as h5py's int8
enumeration, a str attribute (or an array of str) as variable-length
UTF-8 strings in a global heap, bytes as fixed-length strings.
`Writer.append` adds rows to an extensible dataset without rewriting
anything: it fills the last chunk in place, puts new chunks at
the end of the file, moves the superblock's end-of-file address past
them, then patches a fixed number of metadata bytes in place (the chunk
B-tree's new entries and the dataspace's current size).  A file is thus
valid after every call: killed between two appends it holds every row of
the first.  The chunk index is two levels deep from the start, a root of
up to 64 leaves of up to 64 chunks each (2K at the version 0 superblock's
K = 32), so a new leaf is the only new node, once every 64 chunks;
4,096 chunks of 100 rows hold 409,600 frames.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
UNLIMITED = UNDEF
GROUP_LEAF_K, GROUP_NODE_K, CHUNK_K = 4, 16, 32     # the format's defaults

# message types
NIL, DATASPACE, LINK_INFO, DATATYPE, FILL_OLD, FILL, LINK = 0, 1, 2, 3, 4, 5, 6
EXTERNAL, LAYOUT, GROUP_INFO, FILTERS, ATTRIBUTE = 7, 8, 10, 11, 12
CONTINUATION, SYMBOL_TABLE = 16, 17

TYPE_CLASSES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enumeration", 9: "variable-length",
                10: "array"}
DEFLATE, SHUFFLE, FLETCHER32 = 1, 2, 3       # the filters the reader undoes
FILTER_NAMES = {DEFLATE: "gzip (deflate)", SHUFFLE: "shuffle",
                FLETCHER32: "fletcher32", 4: "szip", 5: "nbit",
                6: "scaleoffset", 32000: "lzf"}


class UnsupportedFeature(ValueError):
    """The file uses an HDF5 feature this module does not read."""


def _pad8(n):
    return -(-n // 8) * 8


def _cstring(buf, at):
    return bytes(buf[at:buf.index(b"\0", at)]).decode()


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class _Source:
    """Positioned reads from an open file."""

    def __init__(self, path):
        self.path = path
        self.fd = os.open(path, os.O_RDONLY)
        self._gheaps = {}

    def read(self, addr, n):
        out = os.pread(self.fd, n, addr)
        if len(out) != n:
            raise ValueError(f"{self.path}: truncated at byte {addr}")
        return out

    def close(self):
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None

    def global_heap_object(self, addr, index):
        if addr not in self._gheaps:
            head = self.read(addr, 16)
            if head[:4] != b"GCOL":
                raise ValueError(f"{self.path}: no global heap at {addr}")
            size = struct.unpack_from("<Q", head, 8)[0]
            buf = self.read(addr, size)
            objs, p = {}, 16
            while p + 16 <= size:
                idx, _, _, n = struct.unpack_from("<HHIQ", buf, p)
                if idx == 0:
                    break
                objs[idx] = buf[p + 16:p + 16 + n]
                p += 16 + _pad8(n)
            self._gheaps[addr] = objs
        return self._gheaps[addr][index]


def _messages(src, addr):
    """[(type, flags, data)] of the version 1 object header at addr."""
    head = src.read(addr, 16)
    if head[:4] == b"OHDR":
        raise UnsupportedFeature("version 2 object headers (files written "
                                 "with libver='latest')")
    version, _, nmesgs, _, size = struct.unpack_from("<BBHII", head)
    if version != 1:
        raise UnsupportedFeature(f"object header version {version}")
    blocks, out = [(addr + 16, size)], []
    while blocks:
        start, size = blocks.pop(0)
        buf = src.read(start, size)
        p = 0
        while p + 8 <= size:
            mtype, msize, flags = struct.unpack_from("<HHB", buf, p)
            data = buf[p + 8:p + 8 + msize]
            p += 8 + msize
            if flags & 0x02:
                raise UnsupportedFeature("shared object header messages")
            if mtype == CONTINUATION:
                blocks.append(struct.unpack_from("<QQ", data))
            elif mtype != NIL:
                out.append((mtype, flags, data))
    return out


def _dataspace(data):
    """(shape, maxshape) of a dataspace message."""
    version, rank, flags = data[0], data[1], data[2]
    if version == 1:
        p, kind = 8, 1 if rank else 0
    elif version == 2:
        p, kind = 4, data[3]
    else:
        raise UnsupportedFeature(f"dataspace message version {version}")
    if kind == 2:
        raise UnsupportedFeature("null dataspaces")
    dims = struct.unpack_from(f"<{rank}Q", data, p)
    maxdims = dims
    if flags & 1:
        maxdims = struct.unpack_from(f"<{rank}Q", data, p + 8 * rank)
    maxdims = tuple(None if m == UNLIMITED else m for m in maxdims)
    return tuple(dims), maxdims


def _datatype(data, where):
    """numpy dtype of a datatype message; "vlen-str" for a variable-length
    string.  Returns (dtype, bytes the message used)."""
    cls, version = data[0] & 0x0F, data[0] >> 4
    bits = data[1] | data[2] << 8 | data[3] << 16
    size = struct.unpack_from("<I", data, 4)[0]
    order = ">" if bits & 1 else "<"
    if cls == 0:
        offset, precision = struct.unpack_from("<HH", data, 8)
        if offset or precision != 8 * size or size not in (1, 2, 4, 8):
            raise UnsupportedFeature(f"{where}: fixed-point type of "
                                     f"precision {precision}, offset "
                                     f"{offset}")
        return np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}"), 12
    if cls == 1:
        ieee = {2: (16, 10, 5, 0, 10, 15), 4: (32, 23, 8, 0, 23, 127),
                8: (64, 52, 11, 0, 52, 1023)}
        props = struct.unpack_from("<HHBBBBI", data, 8)
        if (bits & 0x40 or size not in ieee or props[0] != 0
                or props[1:] != ieee[size]):
            raise UnsupportedFeature(f"{where}: a non-IEEE float type")
        return np.dtype(f"{order}f{size}"), 20
    if cls == 3:
        return np.dtype(f"S{size}"), 8
    if cls == 8:
        return _enum(data, bits & 0xFFFF, size, where)
    if cls == 9 and bits & 0x0F == 1:
        return "vlen-str", 8 + _datatype(data[8:], where)[1]
    raise UnsupportedFeature(f"{where}: {TYPE_CLASSES.get(cls, cls)} "
                             f"datatype (class {cls}, version {version})")


def _enum(data, n, size, where):
    """An enumeration datatype: h5py's bool (an int8 enumeration of FALSE
    = 0 and TRUE = 1) is read as numpy's bool; any other enumeration
    raises.  Returns (dtype, bytes the message used)."""
    base, p = _datatype(data[8:], where)
    p += 8
    names = []
    for _ in range(n):
        end = bytes(data[p:]).index(b"\0")
        names.append(bytes(data[p:p + end]).decode())
        p += _pad8(end + 1)
    values = bytes(data[p:p + n * size])
    if (base != np.dtype("i1") or names != ["FALSE", "TRUE"]
            or values != b"\0\1"):
        raise UnsupportedFeature(f"{where}: an enumeration datatype other "
                                 "than h5py's bool")
    return np.dtype(bool), p + n * size


def _fill(msgs):
    """The fill value's bytes, or None for zeros."""
    for mtype, _, data in msgs:
        if mtype == FILL:
            version = data[0]
            if version in (1, 2):
                defined = data[3] if version == 2 else 1
                p = 4
            else:
                defined, p = data[1] & 0x20, 2
            if defined:
                n = struct.unpack_from("<I", data, p)[0]
                return data[p + 4:p + 4 + n] if n else None
            return None
        if mtype == FILL_OLD:
            n = struct.unpack_from("<I", data)[0]
            return data[4:4 + n] if n else None
    return None


def _filters(data, where):
    """[(filter id, client data)] of a filter pipeline message (versions 1
    and 2), in the order the writer applied them.  A filter the reader
    cannot undo raises `UnsupportedFeature` with its name."""
    version, n = data[0], data[1]
    if version not in (1, 2):
        raise UnsupportedFeature(f"{where}: filter pipeline message version "
                                 f"{version}")
    p, out = 8 if version == 1 else 2, []
    for _ in range(n):
        fid = struct.unpack_from("<H", data, p)[0]
        p += 2
        name_len = 0
        if version == 1 or fid >= 256:
            name_len = struct.unpack_from("<H", data, p)[0]
            p += 2
        nvals = struct.unpack_from("<HH", data, p)[1]
        p += 4 + (_pad8(name_len) if version == 1 else name_len)
        vals = struct.unpack_from(f"<{nvals}I", data, p)
        p += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
        if fid not in (DEFLATE, SHUFFLE, FLETCHER32):
            raise UnsupportedFeature(
                f"{where}: the filter {FILTER_NAMES.get(fid, f'filter {fid}')}")
        out.append((fid, vals))
    return out


def _unshuffle(buf, size):
    """Undo the shuffle filter: byte k of every element was stored in plane
    k; bytes past the last whole element stay as they are."""
    n = len(buf) // size
    a = np.frombuffer(buf, np.uint8)
    return a[:n * size].reshape(size, n).T.tobytes() + bytes(a[n * size:])


def _fletcher32(buf):
    """The HDF5 library's Fletcher-32 of `buf` (H5_checksum_fletcher32):
    big-endian 16-bit words summed in blocks of 360, each sum folded to 16
    bits after a block."""
    words = np.frombuffer(buf, ">u2", len(buf) // 2).astype(np.int64)
    blocks = -(-len(words) // 360)
    w = np.zeros(blocks * 360, np.int64)
    w[:len(words)] = words
    w = w.reshape(blocks, 360)
    lengths = [360] * blocks
    if blocks and len(words) % 360:
        lengths[-1] = len(words) % 360
    sums = w.sum(1).tolist()
    # a block's words in reverse rank: word k adds to t - k running sums
    ranked = (w * np.arange(360, 0, -1)).sum(1).tolist()
    s1 = s2 = 0
    for t, b1, b2 in zip(lengths, sums, ranked):
        s2 += t * s1 + b2 - (360 - t) * b1
        s1 += b1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if len(buf) % 2:
        s1 += buf[-1] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return ((s2 << 16) | s1) & 0xFFFFFFFF


def _check_fletcher32(buf, where):
    """`buf` without its trailing checksum, which must equal the data's
    Fletcher-32 (or its 16-bit byte-swapped form, which the library also
    accepts for files of its releases before 1.6.3)."""
    stored = struct.unpack_from("<I", buf, len(buf) - 4)[0]
    data = buf[:-4]
    f = _fletcher32(data)
    swapped = ((f & 0x00FF00FF) << 8) | ((f >> 8) & 0x00FF00FF)
    if stored not in (f, swapped):
        raise ValueError(f"{where}: Fletcher-32 checksum mismatch (stored "
                         f"{stored:#010x}, computed {f:#010x})")
    return data


def _attribute(src, data, where):
    """(name, value) of an attribute message, valued as h5py gives it."""
    version = data[0]
    name_size, dt_size, ds_size = struct.unpack_from("<HHH", data, 2)
    if version == 1:
        p, pad = 8, _pad8
    elif version in (2, 3):
        p, pad = 8 if version == 2 else 9, (lambda n: n)
        if data[1]:
            raise UnsupportedFeature(f"{where}: shared attribute types")
    else:
        raise UnsupportedFeature(f"{where}: attribute message version "
                                 f"{version}")
    name = bytes(data[p:p + name_size]).rstrip(b"\0").decode()
    p += pad(name_size)
    dtype = _datatype(data[p:p + dt_size], f"{where}@{name}")[0]
    p += pad(dt_size)
    shape, _ = _dataspace(data[p:p + ds_size])
    p += pad(ds_size)
    n = int(np.prod(shape, dtype=np.int64))
    if dtype == "vlen-str":
        vals = []
        for i in range(n):
            length, heap, index = struct.unpack_from("<IQI", data, p + 16 * i)
            vals.append(bytes(src.global_heap_object(heap, index)[:length])
                        .decode())
        value = np.array(vals, dtype=object).reshape(shape)
        return name, value[()] if shape == () else value
    value = np.frombuffer(data, dtype, n, p).reshape(shape).copy()
    return name, value[()] if shape == () else value


class _Node:
    def __init__(self, src, addr, name, msgs):
        self._src, self.name, self._msgs = src, name, msgs
        self.attrs = dict(_attribute(src, d, name) for t, _, d in msgs
                          if t == ATTRIBUTE)


def _open(src, addr, name):
    msgs = _messages(src, addr)
    types = {t for t, _, _ in msgs}
    if types & {LINK_INFO, LINK, GROUP_INFO}:
        raise UnsupportedFeature(f"{name}: new-style groups (link "
                                 "messages)")
    if SYMBOL_TABLE in types:
        return Group(src, addr, name, msgs)
    if LAYOUT in types:
        return Dataset(src, addr, name, msgs)
    raise UnsupportedFeature(f"{name}: an object that is neither an "
                             "old-style group nor a dataset (a committed "
                             "datatype?)")


class Group(_Node):
    """A group: a read-only mapping of link names to groups and datasets,
    in the format's (byte-wise name) order."""

    def __init__(self, src, addr, name, msgs):
        super().__init__(src, addr, name, msgs)
        data = next(d for t, _, d in msgs if t == SYMBOL_TABLE)
        btree, heap = struct.unpack_from("<QQ", data)
        head = src.read(heap, 32)
        if head[:4] != b"HEAP":
            raise ValueError(f"{name}: no local heap at {heap}")
        size, _, data_addr = struct.unpack_from("<QQQ", head, 8)
        names = src.read(data_addr, size)
        self._links = {}
        self._walk(btree, names)

    def _walk(self, addr, names):
        head = self._src.read(addr, 24)
        if head[:4] != b"TREE" or head[4] != 0:
            raise ValueError(f"{self.name}: bad group B-tree at {addr}")
        level, n = head[5], struct.unpack_from("<H", head, 6)[0]
        body = self._src.read(addr + 24, 16 * n + 8)
        for i in range(n):
            child = struct.unpack_from("<Q", body, 8 + 16 * i)[0]
            if level:
                self._walk(child, names)
                continue
            snod = self._src.read(child, 8)
            if snod[:4] != b"SNOD":
                raise ValueError(f"{self.name}: bad symbol node at {child}")
            count = struct.unpack_from("<H", snod, 6)[0]
            entries = self._src.read(child + 8, 40 * count)
            for k in range(count):
                off, obj, cache = struct.unpack_from("<QQI", entries, 40 * k)
                link = _cstring(names, off)
                if cache == 2 or obj == UNDEF:
                    raise UnsupportedFeature(f"{self.name}/{link}: soft "
                                             "links")
                self._links[link] = obj

    def _child(self, key):
        if key not in self._links:
            raise KeyError(f"{self.name}: no member {key!r}")
        path = f"{self.name.rstrip('/')}/{key}"
        return _open(self._src, self._links[key], path)

    def __getitem__(self, path):
        node = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group):
                raise KeyError(f"{node.name} is a dataset")
            node = node._child(part)
        return node

    def __contains__(self, path):
        try:
            self[path]
        except KeyError:
            return False
        return True

    def keys(self):
        return list(self._links)

    def __iter__(self):
        return iter(self._links)

    def __len__(self):
        return len(self._links)

    def items(self):
        return [(k, self._child(k)) for k in self._links]

    def visititems(self, fn):
        """fn(relative name, object) for every member, depth first, as
        h5py's `visititems` (a non-None return stops the walk)."""
        def visit(group, prefix):
            for k in group:
                obj = group._child(k)
                out = fn(prefix + k, obj)
                if out is not None:
                    return out
                if isinstance(obj, Group):
                    out = visit(obj, prefix + k + "/")
                    if out is not None:
                        return out
            return None
        return visit(self, "")


class Dataset(_Node):
    """A dataset; its values are read on first use (`ds[()]`, `ds[i]`,
    `np.asarray(ds)`)."""

    def __init__(self, src, addr, name, msgs):
        super().__init__(src, addr, name, msgs)
        by = {}
        for t, _, d in msgs:
            by.setdefault(t, d)
        self._filters = _filters(by[FILTERS], name) if FILTERS in by \
            else []
        if EXTERNAL in by:
            raise UnsupportedFeature(f"{name}: external data files")
        self.shape, self.maxshape = _dataspace(by[DATASPACE])
        self.dtype = _datatype(by[DATATYPE], name)[0]
        if isinstance(self.dtype, str):
            raise UnsupportedFeature(f"{name}: variable-length data in a "
                                     "dataset")
        self._fill = _fill(msgs)
        layout = by[LAYOUT]
        if layout[0] != 3:
            raise UnsupportedFeature(f"{name}: data layout message version "
                                     f"{layout[0]}")
        self._layout = layout
        self.chunks = None
        if layout[1] == 2:
            ndims = layout[2]
            self.chunks = struct.unpack_from(f"<{ndims}I", layout, 11)[:-1]
        elif layout[1] not in (0, 1):
            raise UnsupportedFeature(f"{name}: layout class {layout[1]}")
        self._value = None

    size = property(lambda self: int(np.prod(self.shape, dtype=np.int64)))

    def _empty(self):
        out = np.zeros(self.shape, self.dtype)
        if self._fill is not None:
            out[...] = np.frombuffer(self._fill, self.dtype, 1)[0]
        return out

    def _read(self):
        lay, src = self._layout, self._src
        nbytes = self.size * self.dtype.itemsize
        if lay[1] == 0:
            n = struct.unpack_from("<H", lay, 2)[0]
            return np.frombuffer(lay, self.dtype, self.size, 4).reshape(
                self.shape).copy() if n else self._empty()
        if lay[1] == 1:
            addr = struct.unpack_from("<Q", lay, 2)[0]
            if addr == UNDEF:
                return self._empty()
            return np.frombuffer(src.read(addr, nbytes), self.dtype).reshape(
                self.shape).copy()
        out = self._empty()
        btree = struct.unpack_from("<Q", lay, 3)[0]
        if btree != UNDEF:
            self._chunks(btree, out)
        return out

    def _chunks(self, addr, out):
        rank = len(self.shape)
        key = 8 + 8 * (rank + 1)
        head = self._src.read(addr, 24)
        if head[:4] != b"TREE" or head[4] != 1:
            raise ValueError(f"{self.name}: bad chunk B-tree at {addr}")
        level, n = head[5], struct.unpack_from("<H", head, 6)[0]
        body = self._src.read(addr + 24, (key + 8) * n + key)
        c = self.chunks
        csize = int(np.prod(c)) * self.dtype.itemsize
        for i in range(n):
            p = (key + 8) * i
            size, mask = struct.unpack_from("<II", body, p)
            offs = struct.unpack_from(f"<{rank}Q", body, p + 8)
            child = struct.unpack_from("<Q", body, p + key)[0]
            if level:
                self._chunks(child, out)
                continue
            raw = self._src.read(child, size)
            if self._filters:
                raw = self._unfilter(raw, mask, offs)
            elif mask:
                raise ValueError(f"{self.name}: a filter mask without a "
                                 "filter pipeline")
            if len(raw) != csize:
                raise ValueError(f"{self.name}: a chunk of {len(raw)} bytes, "
                                 f"expected {csize}")
            chunk = np.frombuffer(raw, self.dtype).reshape(c)
            dst = tuple(slice(o, min(o + k, s))
                        for o, k, s in zip(offs, c, self.shape))
            out[dst] = chunk[tuple(slice(0, d.stop - d.start) for d in dst)]

    def _unfilter(self, raw, mask, offs):
        """A stored chunk's bytes with the pipeline undone, last filter
        first; bit i of the chunk's filter mask set means filter i was
        skipped for it."""
        where = f"{self.name} chunk at {offs[:-1]}"
        for i in reversed(range(len(self._filters))):
            if mask >> i & 1:
                continue
            fid, vals = self._filters[i]
            if fid == DEFLATE:
                raw = zlib.decompress(raw)
            elif fid == SHUFFLE:
                raw = _unshuffle(raw, vals[0] if vals
                                 else self.dtype.itemsize)
            else:
                raw = _check_fletcher32(raw, where)
        return raw

    def __getitem__(self, idx):
        if self._value is None:
            self._value = self._read()
        return self._value[idx]

    def __array__(self, dtype=None, copy=None):
        a = self[()]
        return a if dtype is None else a.astype(dtype)

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of a scalar dataset")
        return self.shape[0]

    def __iter__(self):
        return iter(self[()])


class File(Group):
    """An HDF5 file opened for reading: the root group, closed by `close`
    or a `with` block."""

    def __init__(self, path, mode="r"):
        if mode != "r":
            raise ValueError("File opens for reading only; write with "
                             "Writer")
        src = _Source(path)
        try:
            sb = src.read(0, 96)
            if sb[:8] != SIGNATURE:
                raise ValueError(f"{path}: not an HDF5 file")
            if sb[8] != 0:
                raise UnsupportedFeature(f"superblock version {sb[8]}")
            if sb[13] != 8 or sb[14] != 8:
                raise UnsupportedFeature("offsets or lengths other than 8 "
                                         "bytes")
            root = struct.unpack_from("<Q", sb, 64)[0]
            super().__init__(src, root, "/", _messages(src, root))
        except BaseException:
            src.close()
            raise

    def close(self):
        self._src.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _le(dtype):
    """The little-endian dtype the writer stores `dtype` as."""
    dtype = np.dtype(dtype)
    if dtype.kind == "U":
        raise TypeError("unicode arrays: encode them to bytes ('S') first")
    if dtype.kind not in "biufS" or (dtype.kind == "f"
                                     and dtype.itemsize not in (4, 8)):
        raise TypeError(f"cannot write dtype {dtype}")
    return dtype.newbyteorder("<") if dtype.kind in "iuf" else dtype


# h5py's bool: an int8 enumeration, FALSE = 0 and TRUE = 1
BOOL_MSG = (struct.pack("<B3BI", 0x18, 2, 0, 0, 1)
            + struct.pack("<B3BIHH", 0x10, 0x08, 0, 0, 1, 0, 8)
            + b"FALSE\0\0\0TRUE\0\0\0\0\0\1")
# a variable-length UTF-8 string of unsigned bytes, as h5py writes a str
VLEN_STR_MSG = (struct.pack("<B3BI", 0x19, 0x01, 0x01, 0, 16)
                + struct.pack("<B3BIHH", 0x10, 0, 0, 0, 1, 0, 8))


def _datatype_msg(dtype):
    size = dtype.itemsize
    if dtype.kind == "b":
        return BOOL_MSG
    if dtype.kind in "iu":
        return struct.pack("<B3BIHH", 0x10, 8 if dtype.kind == "i" else 0,
                           0, 0, size, 0, 8 * size)
    if dtype.kind == "f":
        props = {4: (32, 23, 8, 0, 23, 127), 8: (64, 52, 11, 0, 52, 1023)}
        return struct.pack("<B3BIHHBBBBI", 0x11, 0x20, 8 * size - 1, 0,
                           size, 0, *props[size])
    return struct.pack("<B3BI", 0x13, 0x01, 0, 0, size)   # null-padded


def _dataspace_msg(shape, maxshape=None):
    if not shape:
        return struct.pack("<BBBB4x", 1, 0, 0, 0)
    maxshape = shape if maxshape is None else maxshape
    return (struct.pack("<BBBB4x", 1, len(shape), 1, 0)
            + struct.pack(f"<{len(shape)}Q", *shape)
            + struct.pack(f"<{len(shape)}Q",
                          *(UNLIMITED if m is None else m for m in maxshape)))


def _fill_msg(alloc_time):
    # version 2, fill written if set, the default (zero) fill defined
    return struct.pack("<4BI", 2, alloc_time, 2, 1, 0)


def _as_array(value):
    """A dataset value as an array the writer can store (text as
    fixed-length bytes)."""
    if isinstance(value, str):
        value = value.encode()
    a = np.asarray(value)
    if a.dtype == object:          # strings read back from a vlen attribute
        a = np.array([s.encode() if isinstance(s, str) else s
                      for s in a.ravel()]).reshape(a.shape)
    if a.dtype.kind == "U":
        a = np.char.encode(a)
    return np.asarray(a, _le(a.dtype), order="C")


def _vlen_strings(value):
    """An attribute value that h5py stores as variable-length strings (a
    str, a unicode array, an object array of str, as read back) as an
    object array of their UTF-8 bytes; None for any other value."""
    if isinstance(value, str):
        return np.array(value.encode(), dtype=object)
    a = np.asarray(value) if isinstance(value, (list, tuple, np.ndarray)) \
        else None
    if a is None or a.dtype.kind not in "UO" or (
            a.dtype == object and not all(isinstance(s, str)
                                          for s in a.ravel())):
        return None
    return np.array([s.encode() for s in a.ravel().tolist()],
                    dtype=object).reshape(a.shape)


def _attribute_msg(name, dt, shape, data):
    name_b = name.encode() + b"\0"
    ds = _dataspace_msg(shape)
    return (struct.pack("<BBHHH", 1, 0, len(name_b), len(dt), len(ds))
            + name_b.ljust(_pad8(len(name_b)), b"\0")
            + dt.ljust(_pad8(len(dt)), b"\0")
            + ds.ljust(_pad8(len(ds)), b"\0") + data)


class _Extensible:
    """An extensible dataset's state: rows, chunk addresses and the
    places of the bytes an append patches."""

    def __init__(self, dtype, row_shape, chunk_rows):
        self.dtype, self.row_shape, self.chunk_rows = dtype, row_shape, \
            chunk_rows
        self.rank = 1 + len(row_shape)
        self.row_bytes = int(np.prod(row_shape, dtype=np.int64)) * \
            dtype.itemsize
        self.chunk_bytes = chunk_rows * self.row_bytes
        self.key = 8 + 8 * (self.rank + 1)
        self.node_bytes = 24 + 2 * CHUNK_K * (self.key + 8) + self.key
        self.n_rows = 0
        self.chunks = []           # chunk addresses, in row order
        self.leaves = []           # leaf node addresses
        self.root = None
        self.dims_at = None        # the dataspace's current first dim

    def left_key(self, j):
        return struct.pack("<II", self.chunk_bytes, 0) + struct.pack(
            f"<{self.rank + 1}Q", j * self.chunk_rows, *[0] * self.rank)

    def right_key(self, j):
        return struct.pack("<II", 0, 0) + struct.pack(
            f"<{self.rank + 1}Q", (j + 1) * self.chunk_rows,
            *self.row_shape, self.dtype.itemsize)


class Writer:
    """Writes a new HDF5 file at `path` (replacing one there).  Paths name
    members from the root ("output/pos").  Groups and datasets are linked
    into their parent group at the next `flush`; `append` and `flush` each
    leave a valid file behind them.  `attrs` are the root group's."""

    def __init__(self, path, attrs=None):
        self.path = path
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
        self._eof = 96
        self._size = 0
        self._groups = {}           # path -> [header, stab at, links, dirty]
        self._ext = {}              # path -> _Extensible
        self._write(0, b"\0" * 96)
        root = self._new_group("/", attrs)
        self._write(0, SIGNATURE + struct.pack(
            "<8BHHI4Q", 0, 0, 0, 0, 0, 8, 8, 0, GROUP_LEAF_K, GROUP_NODE_K,
            0, 0, UNDEF, self._eof, UNDEF) + struct.pack(
            "<QQII16x", 0, root, 1, 0))
        self.flush()

    # -- low level ----------------------------------------------------------

    def _write(self, addr, data):
        os.pwrite(self._fd, data, addr)
        self._size = max(self._size, addr + len(data))

    def _alloc(self, n):
        addr = self._eof
        self._eof += _pad8(n)
        return addr

    def _commit_eof(self):
        """Extend the file to the allocated end and record it in the
        superblock: after this every allocated block may be pointed at."""
        if self._size < self._eof:
            os.ftruncate(self._fd, self._eof)
            self._size = self._eof
        self._write(40, struct.pack("<Q", self._eof))

    def _header(self, messages):
        """Write a version 1 object header of (type, flags, data)
        messages; returns (address, [address of each message's data])."""
        body, at = b"", []
        for mtype, flags, data in messages:
            at.append(16 + len(body) + 8)
            body += struct.pack("<HHB3x", mtype, _pad8(len(data)), flags) \
                + data.ljust(_pad8(len(data)), b"\0")
        addr = self._alloc(16 + len(body))
        self._write(addr, struct.pack("<BBHII4x", 1, 0, len(messages), 1,
                                      len(body)) + body)
        return addr, [addr + a for a in at]

    def _global_heap(self, objects):
        """Write a global heap collection of `objects` (bytes), numbered
        from 1, at the end of the file; returns its address.  It takes at
        least the library's 4 KiB, the rest an object 0 of free space."""
        body = b"".join(struct.pack("<HH4xQ", i, 1, len(b))
                        + b.ljust(_pad8(len(b)), b"\0")
                        for i, b in enumerate(objects, 1))
        size = max(4096, 16 + len(body) + 16)
        addr = self._alloc(size)
        free = size - 16 - len(body)
        self._write(addr, b"GCOL" + struct.pack("<B3xQ", 1, size) + body
                    + struct.pack("<HH4xQ", 0, 0, free)
                    + b"\0" * (free - 16))
        return addr

    def _attrs(self, attrs):
        """Attribute messages of `attrs`, as h5py writes them: a str (or
        an array of str) as variable-length strings, in one global heap
        collection for all of them."""
        attrs = dict(attrs or {})
        vlen = {k: _vlen_strings(v) for k, v in attrs.items()}
        flat = [b for v in vlen.values() if v is not None
                for b in v.ravel()]
        heap = self._global_heap(flat) if flat else None
        out, index = [], 1
        for k, v in attrs.items():
            if vlen[k] is None:
                a = _as_array(v)
                msg = _attribute_msg(k, _datatype_msg(a.dtype), a.shape,
                                     a.tobytes())
            else:
                s = vlen[k]
                data = b"".join(struct.pack("<IQI", len(b), heap, index + i)
                                for i, b in enumerate(s.ravel()))
                index += s.size
                msg = _attribute_msg(k, VLEN_STR_MSG, s.shape, data)
            out.append((ATTRIBUTE, 0, msg))
        return out

    def _link(self, path, addr):
        parent, _, name = path.strip("/").rpartition("/")
        group = self._groups.get("/" + parent if parent else "/")
        if group is None:
            raise KeyError(f"{self.path}: no group {parent!r} for {path!r}")
        if not name or name in group[2]:
            raise ValueError(f"{self.path}: {path!r} exists or is empty")
        group[2][name] = addr
        group[3] = True

    def _new_group(self, path, attrs):
        addr, at = self._header([(SYMBOL_TABLE, 0, b"\0" * 16)]
                                + self._attrs(attrs))
        self._groups[path] = [addr, at[0], {}, True]
        return addr

    def _group_index(self, links):
        """Write a local heap, symbol-table nodes and their B-tree for
        `links` at the end of the file; returns (B-tree, heap)."""
        names = sorted(links, key=str.encode)
        heap_data, offset = b"\0" * 8, {}
        for nm in names:
            offset[nm] = len(heap_data)
            b = nm.encode() + b"\0"
            heap_data += b.ljust(_pad8(len(b)), b"\0")
        used = len(heap_data)
        heap_data += struct.pack("<QQ", 1, 16)   # one free block, list end
        heap = self._alloc(32 + len(heap_data))
        self._write(heap, b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data),
                                                used, heap + 32) + heap_data)
        per = 2 * GROUP_LEAF_K
        groups = [names[i:i + per] for i in range(0, len(names), per)]
        if len(groups) > 2 * GROUP_NODE_K:
            raise ValueError(f"{self.path}: more than "
                             f"{2 * GROUP_NODE_K * per} members in a group")
        snods = []
        for part in groups:
            snods.append(self._alloc(8 + 40 * per))
            self._write(snods[-1], b"SNOD" + struct.pack(
                "<BBH", 1, 0, len(part)) + b"".join(
                struct.pack("<QQII16x", offset[nm], links[nm], 0, 0)
                for nm in part).ljust(40 * per, b"\0"))
        # key i is the last name of child i - 1, key 0 the empty name
        keys = [0] + [offset[part[-1]] for part in groups]
        entries = b"".join(struct.pack("<QQ", k, c)
                           for k, c in zip(keys, snods)) + struct.pack(
            "<Q", keys[-1])
        tree = self._alloc(24 + 2 * GROUP_NODE_K * 16 + 8)
        self._write(tree, b"TREE" + struct.pack("<BBHQQ", 0, 0, len(groups),
                                                UNDEF, UNDEF)
                    + entries.ljust(2 * GROUP_NODE_K * 16 + 8, b"\0"))
        return tree, heap

    # -- public ---------------------------------------------------------------

    def create_group(self, path, attrs=None):
        path = "/" + path.strip("/")
        self._link(path, self._new_group(path, attrs))

    def create_dataset(self, path, data, attrs=None):
        """A fixed-size contiguous dataset holding `data`."""
        a = _as_array(data)
        addr = UNDEF
        if a.nbytes:
            addr = self._alloc(a.nbytes)
            self._write(addr, a.tobytes())
        head, _ = self._header(
            [(DATASPACE, 0, _dataspace_msg(a.shape)),
             (DATATYPE, 1, _datatype_msg(a.dtype)), (FILL, 1, _fill_msg(2)),
             (LAYOUT, 0, struct.pack("<BBQQ", 3, 1, addr, a.nbytes))]
            + self._attrs(attrs))
        self._link("/" + path.strip("/"), head)

    def create_extensible(self, path, rows, chunk_rows=100, attrs=None):
        """A dataset of `rows` (n, ...) whose first axis grows by `append`,
        in chunks of `chunk_rows` rows."""
        rows = _as_array(rows)
        if rows.ndim < 1 or 0 in rows.shape[1:] or chunk_rows < 1:
            raise ValueError(f"{path}: rows of shape {rows.shape}, chunks "
                             f"of {chunk_rows} rows")
        ds = _Extensible(rows.dtype, rows.shape[1:], int(chunk_rows))
        ds.root, ds.leaves = self._alloc(ds.node_bytes), [
            self._alloc(ds.node_bytes)]
        for addr, level in ((ds.root, 1), (ds.leaves[0], 0)):
            self._write(addr, b"TREE" + struct.pack(
                "<BBHQQ", 1, level, 0, UNDEF, UNDEF) + b"\0" * (
                ds.node_bytes - 24))
        self._write(ds.root + 24 + ds.key, struct.pack("<Q", ds.leaves[0]))
        self._write(ds.root + 6, struct.pack("<H", 1))
        head, at = self._header(
            [(DATASPACE, 0, _dataspace_msg((0,) + ds.row_shape,
                                           (None,) + ds.row_shape)),
             (DATATYPE, 1, _datatype_msg(ds.dtype)), (FILL, 1, _fill_msg(3)),
             (LAYOUT, 0, struct.pack("<BBBQ", 3, 2, ds.rank + 1, ds.root)
              + struct.pack(f"<{ds.rank + 1}I", ds.chunk_rows, *ds.row_shape,
                            ds.dtype.itemsize))] + self._attrs(attrs))
        ds.dims_at = at[0] + 8
        path = "/" + path.strip("/")
        self._ext[path] = ds
        self.append(path, rows)
        self._link(path, head)

    def append(self, path, rows):
        """Add `rows` (n, ...) to the extensible dataset at `path`: the
        rows, then the end-of-file address, then the chunk index, then the
        dataspace's size."""
        ds = self._ext["/" + path.strip("/")]
        rows = np.asarray(rows, ds.dtype, order="C")
        if rows.ndim < 1 or rows.shape[1:] != ds.row_shape:
            raise ValueError(f"{path}: rows of shape {rows.shape[1:]}, the "
                             f"dataset's are {ds.row_shape}")
        c, n0, k = ds.chunk_rows, ds.n_rows, len(rows)
        first_new = len(ds.chunks)
        i = 0
        while i < k:
            r = n0 + i
            if r // c == len(ds.chunks):
                ds.chunks.append(self._alloc(ds.chunk_bytes))
            take = min(k - i, c - r % c)
            self._write(ds.chunks[r // c] + (r % c) * ds.row_bytes,
                        rows[i:i + take].tobytes())
            i += take
        new = range(first_new, len(ds.chunks))
        n_leaves = -(-len(ds.chunks) // (2 * CHUNK_K))
        if n_leaves > 2 * CHUNK_K:
            raise ValueError(f"{path}: more than {(2 * CHUNK_K) ** 2} "
                             "chunks; use larger chunks")
        while len(ds.leaves) < n_leaves:
            leaf = self._alloc(ds.node_bytes)
            self._write(leaf, b"TREE" + struct.pack(
                "<BBHQQ", 1, 0, 0, ds.leaves[-1], UNDEF) + b"\0" * (
                ds.node_bytes - 24))
            ds.leaves.append(leaf)
        self._commit_eof()
        slot = ds.key + 8
        for j in new:
            li, e = divmod(j, 2 * CHUNK_K)
            leaf = ds.leaves[li]
            if e == 0 and li:
                # the new leaf: linked from its left sibling and the root
                self._write(ds.leaves[li - 1] + 16, struct.pack("<Q", leaf))
                self._write(ds.root + 24 + li * slot, ds.left_key(j)
                            + struct.pack("<Q", leaf) + ds.right_key(j))
                self._write(ds.root + 6, struct.pack("<H", li + 1))
            self._write(leaf + 24 + e * slot, ds.left_key(j) + struct.pack(
                "<Q", ds.chunks[j]) + ds.right_key(j))
            self._write(leaf + 6, struct.pack("<H", e + 1))
            if e == 0 and li == 0:
                self._write(ds.root + 24, ds.left_key(j))
            self._write(ds.root + 24 + li * slot + slot, ds.right_key(j))
        ds.n_rows = n0 + k
        if ds.dims_at is not None:
            self._write(ds.dims_at, struct.pack("<Q", ds.n_rows))

    def __contains__(self, path):
        path = "/" + path.strip("/")
        parent, _, name = path[1:].rpartition("/")
        group = self._groups.get("/" + parent if parent else "/")
        return path in self._groups or (group is not None
                                        and name in group[2])

    def copy(self, node, dest):
        """Copy a reader `Group` or `Dataset` (and everything below it) to
        `dest`; datasets become fixed-size contiguous ones."""
        if isinstance(node, Dataset):
            self.create_dataset(dest, node[()], node.attrs)
            return
        self.create_group(dest, node.attrs)
        for k, child in node.items():
            self.copy(child, f"{dest.rstrip('/')}/{k}")

    def flush(self):
        """Link what was created since the last flush into its groups:
        each changed group's index is written anew at the end of the file,
        then the end-of-file address, then the group's pointer to it."""
        dirty = {path: self._group_index(g[2])
                 for path, g in self._groups.items() if g[3]}
        self._commit_eof()
        for path, tree_heap in dirty.items():
            group = self._groups[path]
            self._write(group[1], struct.pack("<QQ", *tree_heap))
            group[3] = False
            if path == "/":
                # the superblock's copy of the root's symbol table
                self._write(80, struct.pack("<QQ", *tree_heap))

    def close(self):
        if self._fd is not None:
            self.flush()
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
