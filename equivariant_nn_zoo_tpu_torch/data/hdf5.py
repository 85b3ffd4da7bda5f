"""HDF5 dataset files in numpy and the standard library, without ``h5py``.

``read(path)`` returns ``(data, attrs)``: every dataset of the root group
as a numpy array (in name order, as ``h5py``'s ``File.keys()``) and every
attribute of the root group in the form ``h5py`` hands it back
(``File.attrs[key]``): a numpy scalar for a scalar number or bool, ``str``
for a scalar variable-length string, an ``ndarray`` for an array (of
``str`` objects for variable-length strings).  ``write(path, data,
attrs)`` writes such a file, in the form ``Data.dumpHDF5`` of both
packages gives it through ``h5py``.

What is read is what ``h5py`` writes with its default settings (``libver``
earliest): superblock version 0 or 1 with any sizes of offsets and
lengths; the root group as a symbol table (a version 1 B-tree of
symbol-table nodes over a local heap, at any depth) or as link messages
in its header (what HDF5 writes for names that are not ASCII); version 1
object headers with their continuation blocks; scalar, simple and empty
dataspaces; fixed-point numbers of either byte order, IEEE floats of 16,
32 and 64 bits, fixed-length strings, variable-length strings (through
the global heap), enums (``h5py``'s bool, an int8 ``FALSE``/``TRUE``
enum, read back as ``bool``); compact, contiguous and chunked layouts
(version 3), chunks through a version 1 B-tree with the deflate, shuffle
and fletcher32 filters.  Anything else (another filter, superblock
version 2 or 3 and version 2 object headers from ``libver='latest'``,
links in a fractal heap, nested groups, shared messages, compound or
reference types) raises ``ValueError`` naming the file, the object and
what was met: a file is read whole and right, or not at all.

What is written: superblock version 0 with 8-byte offsets and lengths,
the root group's symbol table in one node (the superblock's group leaf K
is set large enough), contiguous datasets in little-endian order (bool as
``h5py``'s enum), and root attributes: a tuple or list of ``str`` as an
array of variable-length UTF-8 strings in a global heap, a ``str`` as a
scalar one, an int, float, bool or numpy scalar or array as its numpy
type (Python ``int`` and ``float`` as int64 and float64, as ``h5py``).
"""

from __future__ import annotations

import mmap
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
NIL, DATASPACE, LINK_INFO, DATATYPE, FILL_OLD, FILL, LINK = 0, 1, 2, 3, 4, 5, 6
LAYOUT, GROUP_INFO, FILTERS, ATTRIBUTE, COMMENT = 8, 10, 11, 12, 13
MTIME_OLD, CONTINUATION, SYMBOL_TABLE, MTIME, BTREE_K = 14, 16, 17, 18, 19
ATTR_INFO = 21
SKIPPED = {NIL, FILL_OLD, FILL, GROUP_INFO, COMMENT, MTIME_OLD, MTIME,
           BTREE_K}
DEFLATE, SHUFFLE, FLETCHER32 = 1, 2, 3
TYPE_CLASSES = ("fixed-point", "floating-point", "time", "string",
                "bitfield", "opaque", "compound", "reference", "enum",
                "variable-length", "array")


class _Reader:
    """One open file: its superblock's sizes and the parsed global heap
    collections."""

    def __init__(self, path, mm):
        self.path, self.mm = path, mm
        self.heaps = {}
        base = next((b for b in _superblock_offsets(len(mm))
                     if mm[b:b + 8] == SIGNATURE), None)
        if base is None:
            self.fail("the file", "no HDF5 signature (not an HDF5 file)")
        version = mm[base + 8]
        if version not in (0, 1):
            self.fail("the superblock", f"superblock version {version} "
                      f"(written with libver='latest'); only versions 0 "
                      f"and 1 are read")
        self.O, self.L = mm[base + 13], mm[base + 14]
        if self.O not in (2, 4, 8) or self.L not in (2, 4, 8):
            self.fail("the superblock", f"sizes of offsets {self.O} and "
                      f"lengths {self.L}")
        p = base + 24 + (4 if version == 1 else 0)
        self.base, _, eof, _ = (self.uint(p + i * self.O, self.O)
                                for i in range(4))
        # the end-of-file address counts the user block too (h5py's files
        # with one store the file's whole length)
        if eof > len(mm):
            self.fail("the file", f"{len(mm)} bytes, the superblock says "
                      f"{eof}: truncated")
        self.root_entry = p + 4 * self.O

    # -- primitives ---------------------------------------------------------

    def fail(self, where, what):
        raise ValueError(f"{self.path}: {where}: {what}")

    def uint(self, p, n):
        return int.from_bytes(self.mm[p:p + n], "little")

    def undefined(self, value, n):
        return value == (1 << (8 * n)) - 1

    def at(self, addr, n, where):
        """The file offset of ``n`` bytes at relative address ``addr``."""
        p = self.base + addr
        if p + n > len(self.mm):
            self.fail(where, f"{n} bytes at address {addr} lie past the end "
                      f"of the file ({len(self.mm)} bytes): truncated")
        return p

    # -- object headers -----------------------------------------------------

    def messages(self, addr, where):
        """A version 1 object header's messages as (type, offset, size,
        flags), continuation blocks followed."""
        p = self.at(addr, 16, where)
        if self.mm[p:p + 4] == b"OHDR":
            self.fail(where, "a version 2 object header (written with "
                      "libver='latest')")
        if self.mm[p] != 1:
            self.fail(where, f"object header version {self.mm[p]}")
        n_msgs, = struct.unpack_from("<H", self.mm, p + 2)
        size, = struct.unpack_from("<I", self.mm, p + 8)
        chunks, out = [(p + 16, size)], []
        while chunks and len(out) < n_msgs:
            q, size = chunks.pop(0)
            end = q + size
            while q + 8 <= end and len(out) < n_msgs:
                mtype, msize, flags = struct.unpack_from("<HHB", self.mm, q)
                q += 8
                if q + msize > end:
                    self.fail(where, f"message {mtype} of {msize} bytes "
                              f"runs past its header block")
                if flags & 2:
                    self.fail(where, f"a shared message (type {mtype})")
                if mtype == CONTINUATION:
                    c_addr = self.uint(q, self.O)
                    c_len = self.uint(q + self.O, self.L)
                    chunks.append((self.at(c_addr, c_len, where), c_len))
                out.append((mtype, q, msize, flags))
                q += msize
        if len(out) != n_msgs:
            self.fail(where, f"the header holds {len(out)} of its {n_msgs} "
                      f"messages")
        return out

    def object_kind(self, msgs, where):
        types = {m[0] for m in msgs}
        if ATTR_INFO in types:
            self.fail(where, "dense attribute storage (attribute info "
                      "message)")
        for mtype in types - SKIPPED - {DATASPACE, DATATYPE, LAYOUT, FILTERS,
                                        ATTRIBUTE, CONTINUATION,
                                        SYMBOL_TABLE, LINK_INFO, LINK}:
            self.fail(where, f"object header message type {mtype}")
        if types & {SYMBOL_TABLE, LINK_INFO}:
            return "group"
        if LAYOUT in types:
            return "dataset"
        self.fail(where, "an object that is neither a group nor a dataset "
                  "(a committed datatype?)")

    # -- the root group -----------------------------------------------------

    def root(self):
        """The root group's links as {name: object header address} and its
        header's messages."""
        addr = self.uint(self.root_entry + self.O, self.O)
        msgs = self.messages(addr, "the root group")
        if self.object_kind(msgs, "the root group") != "group":
            self.fail("the root group", "no symbol table or link info "
                      "message")
        links = {}
        table = [m[1] for m in msgs if m[0] == SYMBOL_TABLE]
        if table:
            q = table[0]
            btree, heap = self.uint(q, self.O), self.uint(q + self.O, self.O)
            self.group_node(btree, self.local_heap(heap), links, depth=0)
        else:
            self.compact_links(msgs, links)
        return dict(sorted(links.items(), key=lambda kv: kv[0].encode())), \
            msgs

    def compact_links(self, msgs, links):
        """A new-style group's links held in its header (HDF5 writes these
        for link names that are not ASCII, or with ``libver`` past the
        earliest); links in a fractal heap are refused."""
        where = "the root group's links"
        q = next(m[1] for m in msgs if m[0] == LINK_INFO)
        heap = self.uint(q + 2 + (8 if self.mm[q + 1] & 1 else 0), self.O)
        if not self.undefined(heap, self.O):
            self.fail(where, "dense link storage (a fractal heap of links)")
        for mtype, q, _, _ in msgs:
            if mtype != LINK:
                continue
            version, flags = self.mm[q], self.mm[q + 1]
            if version != 1:
                self.fail(where, f"link message version {version}")
            p = q + 2
            kind = 0
            if flags & 0x8:
                kind, p = self.mm[p], p + 1
            p += (8 if flags & 0x4 else 0) + (1 if flags & 0x10 else 0)
            size = 1 << (flags & 3)
            n = self.uint(p, size)
            name = bytes(self.mm[p + size:p + size + n]).decode(
                "utf-8", "surrogateescape")
            if kind != 0:
                self.fail(where, f"{name!r}: a soft or external link")
            links[name] = self.uint(p + size + n, self.O)

    def local_heap(self, addr):
        p = self.at(addr, 8 + 2 * self.L + self.O, "the root group's heap")
        if self.mm[p:p + 4] != b"HEAP":
            self.fail("the root group's heap", "no HEAP signature")
        size = self.uint(p + 8, self.L)
        seg = self.uint(p + 8 + 2 * self.L, self.O)
        q = self.at(seg, size, "the root group's heap")
        return bytes(self.mm[q:q + size])

    def group_node(self, addr, names, links, depth):
        where = "the root group's B-tree"
        if depth > 64:
            self.fail(where, "more than 64 levels (a cycle?)")
        p = self.at(addr, 8 + 2 * self.O, where)
        if self.mm[p:p + 4] != b"TREE" or self.mm[p + 4] != 0:
            self.fail(where, "no group B-tree node (TREE, type 0)")
        level = self.mm[p + 5]
        used, = struct.unpack_from("<H", self.mm, p + 6)
        q = p + 8 + 2 * self.O + self.L           # past key 0
        for _ in range(used):
            child = self.uint(q, self.O)
            q += self.O + self.L
            if level:
                self.group_node(child, names, links, depth + 1)
            else:
                self.symbol_node(child, names, links)

    def symbol_node(self, addr, names, links):
        where = "the root group's symbol table"
        p = self.at(addr, 8, where)
        if self.mm[p:p + 4] != b"SNOD":
            self.fail(where, "no SNOD signature")
        n, = struct.unpack_from("<H", self.mm, p + 6)
        entry = 2 * self.O + 24
        self.at(addr, 8 + n * entry, where)
        for i in range(n):
            q = p + 8 + i * entry
            off = self.uint(q, self.O)
            end = names.find(b"\0", off)
            if end < 0:
                self.fail(where, f"link name at heap offset {off} is not "
                          f"terminated")
            links[names[off:end].decode("utf-8", "surrogateescape")] = \
                self.uint(q + self.O, self.O)

    # -- dataspace and datatype --------------------------------------------

    def dataspace(self, q, where):
        version, rank, flags = self.mm[q], self.mm[q + 1], self.mm[q + 2]
        if version == 1:
            if flags & 2:
                self.fail(where, "a dataspace with a permutation index")
            p, kind = q + 8, ("scalar" if rank == 0 else "simple")
        elif version == 2:
            kind = {0: "scalar", 1: "simple", 2: "null"}.get(self.mm[q + 3])
            p = q + 4
        else:
            self.fail(where, f"dataspace message version {version}")
        if kind not in ("scalar", "simple"):
            self.fail(where, f"a {kind or 'unknown'} dataspace")
        return tuple(self.uint(p + i * self.L, self.L) for i in range(rank))

    def datatype(self, q, where):
        """(numpy dtype or ("vlen-str", charset), size in the file, bytes
        of the message consumed)."""
        cls, version = self.mm[q] & 15, self.mm[q] >> 4
        bits = self.mm[q + 1:q + 4]
        size, = struct.unpack_from("<I", self.mm, q + 4)
        order = ">" if bits[0] & 1 else "<"
        if cls == 0:                                    # fixed-point
            offset, precision = struct.unpack_from("<HH", self.mm, q + 8)
            if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
                self.fail(where, f"a {size}-byte integer of {precision} bits "
                          f"at bit {offset}")
            kind = "i" if bits[0] & 8 else "u"
            return np.dtype(f"{order}{kind}{size}"), size, 12
        if cls == 1:                                    # floating point
            layout = struct.unpack_from("<HHBBBBI", self.mm, q + 8)
            ieee = {2: (0, 16, 10, 5, 0, 10, 15),
                    4: (0, 32, 23, 8, 0, 23, 127),
                    8: (0, 64, 52, 11, 0, 52, 1023)}
            if bits[0] & 0x40 or ieee.get(size) != layout or \
                    bits[1] != 8 * size - 1:
                self.fail(where, f"a {size}-byte float that is not IEEE "
                          f"{8 * size}-bit")
            return np.dtype(f"{order}f{size}"), size, 20
        if cls == 3:                                    # fixed-length string
            return np.dtype(f"S{size}"), size, 8
        if cls == 8:                                    # enum
            n_members = bits[0] | bits[1] << 8
            base, base_size, used = self.datatype(q + 8, where)
            if not isinstance(base, np.dtype) or base.kind not in "iu":
                self.fail(where, "an enum over a non-integer type")
            p, names = q + 8 + used, []
            for _ in range(n_members):
                end = self.mm.find(b"\0", p)
                names.append(bytes(self.mm[p:end]))
                p = end + 1
                if version < 3:
                    p = q + 8 + used + _pad8(p - (q + 8 + used))
            values = np.frombuffer(self.mm, base, n_members, p).tolist()
            p += n_members * base_size
            if base.itemsize == 1 and dict(zip(names, values)) == \
                    {b"FALSE": 0, b"TRUE": 1}:
                return np.dtype(bool), size, p - q
            return base, size, p - q
        if cls == 9:                                    # variable-length
            if bits[0] & 15 != 1:
                self.fail(where, "a variable-length sequence (only strings "
                          "are read)")
            _, _, used = self.datatype(q + 8, where)
            return ("vlen-str", bits[1] & 15), size, 8 + used
        self.fail(where, f"a {TYPE_CLASSES[cls] if cls < 11 else cls} "
                  f"datatype (class {cls})")

    # -- values ------------------------------------------------------------

    def values(self, raw, dtype, shape, where):
        """An array of ``shape`` from the element bytes ``raw``."""
        count = int(np.prod(shape, dtype=np.int64))
        if isinstance(dtype, np.dtype):
            return np.frombuffer(raw, dtype, count).reshape(shape).copy()
        step = 4 + self.O + 4
        out = np.empty(count, dtype=object)
        for i in range(count):
            length = int.from_bytes(raw[i * step:i * step + 4], "little")
            addr = int.from_bytes(raw[i * step + 4:i * step + 4 + self.O],
                                  "little")
            index = int.from_bytes(raw[i * step + 4 + self.O:(i + 1) * step],
                                   "little")
            out[i] = self.heap_object(addr, index, where)[:length] \
                if length else b""
        return out.reshape(shape)

    def heap_object(self, addr, index, where):
        if addr not in self.heaps:
            self.heaps[addr] = self.collection(addr, where)
        objects = self.heaps[addr]
        if index not in objects:
            self.fail(where, f"global heap object {index} missing from the "
                      f"collection at {addr}")
        return objects[index]

    def collection(self, addr, where):
        p = self.at(addr, 8 + self.L, where)
        if self.mm[p:p + 4] != b"GCOL":
            self.fail(where, f"no global heap collection (GCOL) at {addr}")
        size = self.uint(p + 8, self.L)
        self.at(addr, size, where)
        objects, q, end = {}, p + 8 + self.L, p + size
        head = 8 + self.L
        while q + head <= end:
            index, = struct.unpack_from("<H", self.mm, q)
            n = self.uint(q + 8, self.L)
            if index == 0:                       # the free space
                break
            objects[index] = bytes(self.mm[q + head:q + head + n])
            q += head + _pad8(n)
        return objects

    # -- datasets and attributes ---------------------------------------------

    def dataset(self, name, addr):
        where = f"object {name!r}"
        msgs = self.messages(addr, where)
        if self.object_kind(msgs, where) != "dataset":
            self.fail(where, "a nested group (only the root group is read)")
        found = {m[0]: m for m in msgs}
        for need in (DATASPACE, DATATYPE):
            if need not in found:
                self.fail(where, f"no {'dataspace' if need == 1 else 'datatype'}"
                          f" message")
        shape = self.dataspace(found[DATASPACE][1], where)
        dtype, size, _ = self.datatype(found[DATATYPE][1], where)
        filters = self.filters(found[FILTERS][1], where) \
            if FILTERS in found else []
        q = found[LAYOUT][1]
        version, layout = self.mm[q], self.mm[q + 1]
        if version != 3:
            self.fail(where, f"data layout message version {version}")
        count = int(np.prod(shape, dtype=np.int64))
        numpy_dtype = dtype if isinstance(dtype, np.dtype) else object
        if count == 0:
            return np.empty(shape, dtype=numpy_dtype)
        if layout == 0:                                  # compact
            n, = struct.unpack_from("<H", self.mm, q + 2)
            raw = bytes(self.mm[q + 4:q + 4 + n])
        elif layout == 1:                                # contiguous
            data_addr = self.uint(q + 2, self.O)
            if self.undefined(data_addr, self.O):
                return np.zeros(shape, dtype=numpy_dtype)
            p = self.at(data_addr, count * size, where)
            if isinstance(dtype, np.dtype):
                return np.frombuffer(self.mm, dtype, count, p).reshape(
                    shape).copy()
            raw = bytes(self.mm[p:p + count * size])
        elif layout == 2:                                # chunked
            raw = self.chunked(q, shape, size, filters, where)
        else:
            self.fail(where, f"data layout class {layout}")
        if len(raw) < count * size:
            self.fail(where, f"{len(raw)} bytes of data for {count} elements "
                      f"of {size} bytes")
        return self.values(raw, dtype, shape, where)

    def filters(self, q, where):
        version, n = self.mm[q], self.mm[q + 1]
        p, out = q + (8 if version == 1 else 2), []
        if version not in (1, 2):
            self.fail(where, f"filter pipeline message version {version}")
        for _ in range(n):
            fid, = struct.unpack_from("<H", self.mm, p)
            p += 2
            name_len = 0
            if version == 1 or fid >= 256:
                name_len, = struct.unpack_from("<H", self.mm, p)
                p += 2
            _, n_values = struct.unpack_from("<HH", self.mm, p)
            p += 4 + (_pad8(name_len) if version == 1 else name_len)
            p += 4 * n_values + (4 if version == 1 and n_values % 2 else 0)
            if fid not in (DEFLATE, SHUFFLE, FLETCHER32):
                known = {32000: "LZF", 32001: "BLOSC", 32004: "LZ4",
                         32015: "ZSTD", 4: "SZIP", 5: "N-bit",
                         6: "scale-offset"}
                self.fail(where, f"filter {fid}"
                          f"{' (' + known[fid] + ')' if fid in known else ''}"
                          f"; only deflate, shuffle and fletcher32 are read")
            out.append(fid)
        return out

    def chunked(self, q, shape, size, filters, where):
        rank = self.mm[q + 2] - 1
        btree = self.uint(q + 3, self.O)
        chunk = struct.unpack_from(f"<{rank + 1}I", self.mm, q + 3 + self.O)
        if rank != len(shape) or chunk[-1] != size:
            self.fail(where, f"chunk dimensions {chunk} for shape {shape} and "
                      f"{size}-byte elements")
        out = np.zeros(shape, dtype=np.dtype(f"V{size}"))
        if self.undefined(btree, self.O):
            return out.tobytes()
        chunk = chunk[:-1]
        for offsets, addr, n, mask in self.chunk_node(btree, rank, where, 0):
            p = self.at(addr, n, where)
            raw = bytes(self.mm[p:p + n])
            for i, fid in reversed(list(enumerate(filters))):
                if not mask >> i & 1:
                    raw = _unfilter(fid, raw, size, self, where)
            block = np.frombuffer(raw, out.dtype, int(np.prod(chunk)))
            block = block.reshape(chunk)
            dst = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(offsets, chunk, shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out.tobytes()

    def chunk_node(self, addr, rank, where, depth):
        if depth > 64:
            self.fail(where, "a chunk B-tree of more than 64 levels")
        p = self.at(addr, 8 + 2 * self.O, where)
        if self.mm[p:p + 4] != b"TREE" or self.mm[p + 4] != 1:
            self.fail(where, "no chunk B-tree node (TREE, type 1)")
        level = self.mm[p + 5]
        used, = struct.unpack_from("<H", self.mm, p + 6)
        key = 8 + 8 * (rank + 1)
        q = p + 8 + 2 * self.O
        for _ in range(used):
            n, mask = struct.unpack_from("<II", self.mm, q)
            offsets = struct.unpack_from(f"<{rank}Q", self.mm, q + 8)
            child = self.uint(q + key, self.O)
            q += key + self.O
            if level:
                yield from self.chunk_node(child, rank, where, depth + 1)
            else:
                yield offsets, child, n, mask

    def attribute(self, q, where):
        version = self.mm[q]
        if version not in (1, 2, 3):
            self.fail(where, f"attribute message version {version}")
        if version > 1 and self.mm[q + 1] & 3:
            self.fail(where, "an attribute with a shared datatype or "
                      "dataspace")
        name_len, dt_len, ds_len = struct.unpack_from("<HHH", self.mm, q + 2)
        p = q + 8 + (1 if version == 3 else 0)
        pad = _pad8 if version == 1 else (lambda n: n)
        name = bytes(self.mm[p:p + name_len]).rstrip(b"\0").decode(
            "utf-8", "surrogateescape")
        where = f"attribute {name!r}"
        p += pad(name_len)
        dtype, size, _ = self.datatype(p, where)
        p += pad(dt_len)
        shape = self.dataspace(p, where)
        p += pad(ds_len)
        count = int(np.prod(shape, dtype=np.int64))
        value = self.values(bytes(self.mm[p:p + count * size]), dtype, shape,
                            where)
        if not isinstance(dtype, np.dtype):             # h5py decodes these
            flat = [v.decode("utf-8", "surrogateescape") for v in value.flat]
            value = np.array(flat + [None], dtype=object)[:-1].reshape(shape)
        return name, value[()] if value.ndim == 0 else value


def _superblock_offsets(n):
    yield 0
    b = 512
    while b + 8 <= n:
        yield b
        b *= 2


def _pad8(n):
    return (n + 7) // 8 * 8


def _unfilter(fid, raw, size, reader, where):
    if fid == DEFLATE:
        try:
            return zlib.decompress(raw)
        except zlib.error as exc:
            reader.fail(where, f"a chunk does not inflate ({exc})")
    if fid == SHUFFLE:
        n = len(raw) // size * size
        body = np.frombuffer(raw[:n], np.uint8).reshape(size, -1)
        return body.T.tobytes() + raw[n:]
    body, want = raw[:-4], int.from_bytes(raw[-4:], "little")
    got = _fletcher32(body)
    # HDF5 before 1.6.3 stored the two halves swapped; it accepts both
    if want not in (got, (got >> 16) | (got & 0xFFFF) << 16):
        reader.fail(where, "a chunk fails its fletcher32 checksum")
    return body


def _fletcher32(data):
    """HDF5's Fletcher-32: big-endian 16-bit words in blocks of 360, an
    odd last byte as the high byte of one more word."""
    words = np.frombuffer(data[:len(data) // 2 * 2], ">u2").astype(np.int64)
    s1 = s2 = 0
    for start in range(0, len(words), 360):
        block = words[start:start + 360]
        s2 += len(block) * s1 + int(np.cumsum(block).sum())
        s1 += int(block.sum())
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if len(data) % 2:
        s1 += data[-1] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return s2 << 16 | s1


def read(path):
    """The root group of the HDF5 file at ``path``: ``(data, attrs)``, the
    datasets as numpy arrays in name order and the attributes as ``h5py``
    gives them.  Raises ``ValueError`` on what it does not read."""
    path = str(path)
    with open(path, "rb") as f:
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:                       # an empty file
            raise ValueError(f"{path}: the file: empty (not an HDF5 file)")
    try:
        reader = _Reader(path, mm)
        links, msgs = reader.root()
        data = {name: reader.dataset(name, addr)
                for name, addr in links.items()}
        attrs = dict(sorted(
            (reader.attribute(m[1], "the root group's attributes")
             for m in msgs if m[0] == ATTRIBUTE),
            key=lambda kv: kv[0].encode()))
    finally:
        mm.close()
    return data, attrs


# --------------------------------------------------------------- the writer

UNDEF8 = b"\xff" * 8


def _u(n, value):
    return value.to_bytes(n, "little")


def _pad(b):
    return b + b"\0" * (_pad8(len(b)) - len(b))


def _int_type(size, signed):
    return bytes([0x10, 8 if signed else 0, 0, 0]) + _u(4, size) + \
        _u(2, 0) + _u(2, 8 * size)


FLOAT_TYPES = {2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127),
               8: (63, 52, 11, 52, 1023)}


def _float_type(size):
    sign, exp_loc, exp_size, mant_size, bias = FLOAT_TYPES[size]
    return bytes([0x11, 0x20, sign, 0]) + _u(4, size) + \
        struct.pack("<HHBBBBI", 0, 8 * size, exp_loc, exp_size, 0,
                    mant_size, bias)


BOOL_TYPE = bytes([0x18, 2, 0, 0]) + _u(4, 1) + _int_type(1, True) + \
    _pad(b"FALSE\0") + _pad(b"TRUE\0") + b"\x00\x01"
VLEN_STR_TYPE = bytes([0x19, 0x01, 0x01, 0]) + _u(4, 16) + _int_type(1, False)


def _numeric_type(dtype, where):
    if dtype.kind == "b":
        return BOOL_TYPE
    if dtype.kind in "iu" and dtype.itemsize in (1, 2, 4, 8):
        return _int_type(dtype.itemsize, dtype.kind == "i")
    if dtype.kind == "f" and dtype.itemsize in FLOAT_TYPES:
        return _float_type(dtype.itemsize)
    raise ValueError(f"{where}: cannot write dtype {dtype} (bool, integers "
                     f"and 16/32/64-bit floats are written)")


def _dataspace(shape):
    """A version 1 dataspace; an array's maximum dimensions are its
    dimensions, as ``h5py`` writes them."""
    dims = b"".join(_u(8, int(d)) for d in shape)
    return bytes([1, len(shape), 1 if shape else 0, 0]) + b"\0" * 4 + \
        dims + dims


def _message(mtype, body, flags=0):
    body = _pad(body)
    if len(body) > 0xFFFF:
        raise ValueError(f"an object header message of {len(body)} bytes "
                         f"(at most 65535)")
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header(messages):
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


class _GlobalHeap:
    """The strings of variable-length string attributes, in one global
    heap collection."""

    def __init__(self):
        self.objects = []

    def add(self, text):
        self.objects.append(text.encode("utf-8", "surrogateescape"))
        if len(self.objects) > 0xFFFE:
            raise ValueError("more than 65534 strings in the attributes")
        return len(self.objects)

    def size(self):
        used = 16 + sum(16 + _pad8(len(b)) for b in self.objects)
        return max(4096, used)

    def encode(self):
        size = self.size()
        out = b"GCOL" + bytes([1, 0, 0, 0]) + _u(8, size)
        for i, b in enumerate(self.objects, 1):
            out += struct.pack("<HH4x", i, 1) + _u(8, len(b)) + _pad(b)
        free = size - len(out)
        if free >= 16:
            out += struct.pack("<HH4x", 0, 0) + _u(8, free)
        return out + b"\0" * (size - len(out))


def _attribute_value(key, value):
    """("strs", shape, strings), ("str", (), [string]) or ("array", shape,
    array) for one attribute, in ``h5py``'s types: a tuple, list or object
    array of ``str`` is an array of variable-length strings."""
    where = f"attribute {key!r}"
    if isinstance(value, str):
        return "str", (), [value]
    if isinstance(value, (tuple, list)) and value and all(
            isinstance(v, str) for v in value):
        return "strs", (len(value),), list(value)
    if isinstance(value, np.ndarray) and value.dtype == object and all(
            isinstance(v, str) for v in value.flat):
        return "strs", value.shape, list(value.flat)
    if isinstance(value, (bytes, np.bytes_)) or (
            isinstance(value, np.ndarray) and value.dtype.kind in "OSUV"):
        raise ValueError(f"{where}: cannot write {type(value).__name__} "
                         f"values of {np.asarray(value).dtype} (str, "
                         f"sequences of str and numbers are written)")
    arr = np.asarray(value)
    if arr.dtype.kind not in "biuf":
        raise ValueError(f"{where}: cannot write {arr.dtype} values")
    return "array", arr.shape, arr


def write(path, data, attrs):
    """Write ``data`` ({name: array}) as the root group's datasets and
    ``attrs`` ({name: value}) as its attributes, as an HDF5 file that
    ``h5py`` and this module's ``read`` read back to the same values."""
    names = sorted(data, key=lambda k: k.encode())
    arrays = []
    for name in names:
        arr = np.asarray(data[name])
        where = f"{path}: dataset {name!r}"
        if arr.dtype.kind in "OUSV":
            raise ValueError(f"{where}: cannot write {arr.dtype} arrays "
                             f"(bool, integers and floats are written)")
        dtype_msg = _numeric_type(arr.dtype, where)
        arrays.append((np.asarray(
            arr, arr.dtype.newbyteorder("<") if arr.dtype.kind != "b"
            else bool, order="C"), dtype_msg))
    heap = _GlobalHeap()
    attr_items = []
    for key, value in attrs.items():
        kind, shape, v = _attribute_value(key, value)
        if kind == "array":
            if v.dtype.kind == "b":
                raw = v.astype(np.uint8).tobytes()
            else:
                raw = np.asarray(v, v.dtype.newbyteorder("<")).tobytes()
            attr_items.append((key, _numeric_type(
                v.dtype, f"{path}: attribute {key!r}"), shape, raw))
        else:
            attr_items.append((key, VLEN_STR_TYPE, shape, [
                (len(s.encode("utf-8", "surrogateescape")), heap.add(s))
                for s in v]))

    # the root group's local heap: "" at 0, then the names
    heap_data, offsets = b"\0" * 8, []
    for name in names:
        offsets.append(len(heap_data))
        heap_data += _pad(name.encode("utf-8", "surrogateescape") + b"\0")
    leaf_k = max(4, (len(names) + 1) // 2)
    if leaf_k > 0xFFFF:
        raise ValueError(f"{path}: {len(names)} datasets (at most 131070)")
    internal_k = 16

    # sizes, then addresses, in file order
    def root_header(btree, lheap, gheap):
        msgs = [_message(SYMBOL_TABLE, _u(8, btree) + _u(8, lheap))]
        for key, dtype_msg, shape, raw in attr_items:
            if isinstance(raw, list):
                raw = b"".join(_u(4, n) + _u(8, gheap) + _u(4, i)
                               for n, i in raw)
            name = key.encode("utf-8", "surrogateescape") + b"\0"
            space = _dataspace(shape)
            msgs.append(_message(ATTRIBUTE, struct.pack(
                "<BBHHH", 1, 0, len(name), len(dtype_msg), len(space))
                + _pad(name) + _pad(dtype_msg) + _pad(space) + raw))
        return _object_header(msgs)

    def dataset_header(arr, dtype_msg, addr):
        # version 2, allocated late, written if set, the default value
        fill = bytes([2, 2, 2, 1]) + _u(4, 0)
        layout = bytes([3, 1]) + (UNDEF8 if arr.size == 0 else _u(8, addr)) \
            + _u(8, arr.nbytes)
        return _object_header([_message(DATASPACE, _dataspace(arr.shape)),
                               _message(DATATYPE, dtype_msg, flags=1),
                               _message(FILL, fill, flags=1),
                               _message(LAYOUT, layout)])

    superblock_size = 24 + 4 * 8 + 40
    gheap_size = heap.size() if heap.objects else 0
    lheap_header = 32
    btree_size = 24 + 2 * internal_k * 8 + (2 * internal_k + 1) * 8
    snod_size = 8 + 2 * leaf_k * 40
    root_size = len(root_header(0, 0, 0))
    ds_sizes = [len(dataset_header(a, t, 0)) for a, t in arrays]

    addr = superblock_size
    gheap_addr = addr
    addr += gheap_size
    lheap_addr = addr
    addr += lheap_header + len(heap_data)
    btree_addr = addr
    addr += btree_size
    snod_addr = addr
    addr += snod_size
    root_addr = addr
    addr += root_size
    ds_addrs = []
    for n in ds_sizes:
        ds_addrs.append(addr)
        addr += n
    data_addrs = []
    for arr, _ in arrays:
        data_addrs.append(addr)
        addr += _pad8(arr.nbytes)
    eof = addr

    def entry(name_off, obj, cache, scratch):
        """A symbol-table entry: the name's heap offset, the object header,
        the cache type and its 16-byte scratch pad."""
        return _u(8, name_off) + _u(8, obj) + _u(4, cache) + b"\0" * 4 + \
            scratch.ljust(16, b"\0")

    out = bytearray()
    out += SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + \
        struct.pack("<HHI", leaf_k, internal_k, 0) + _u(8, 0) + UNDEF8 + \
        _u(8, eof) + UNDEF8 + \
        entry(0, root_addr, 1, _u(8, btree_addr) + _u(8, lheap_addr))
    if heap.objects:
        out += heap.encode()
    # no free block: HDF5 marks the free list's end with offset 1
    out += b"HEAP" + bytes(4) + _u(8, len(heap_data)) + _u(8, 1) + \
        _u(8, lheap_addr + lheap_header) + heap_data
    keys = [0, offsets[-1]] if names else [0]
    node = b"TREE" + bytes([0, 0]) + _u(2, 1 if names else 0) + UNDEF8 + \
        UNDEF8 + _u(8, keys[0])
    if names:
        node += _u(8, snod_addr) + _u(8, keys[1])
    out += node.ljust(btree_size, b"\0")
    snod = b"SNOD" + bytes([1, 0]) + _u(2, len(names)) + b"".join(
        entry(off, a, 0, b"") for off, a in zip(offsets, ds_addrs))
    out += snod.ljust(snod_size, b"\0")
    out += root_header(btree_addr, lheap_addr, gheap_addr)
    for (arr, dtype_msg), a in zip(arrays, data_addrs):
        out += dataset_header(arr, dtype_msg, a)
    with open(path, "wb") as f:
        f.write(out)
        for arr, _ in arrays:
            f.write(memoryview(arr.reshape(-1)).cast("B"))
            f.write(b"\0" * (_pad8(arr.nbytes) - arr.nbytes))
        if f.tell() != eof:
            raise RuntimeError(f"{path}: wrote {f.tell()} bytes, the "
                               f"superblock says {eof}")
