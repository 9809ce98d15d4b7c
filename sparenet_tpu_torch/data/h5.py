"""A reader and writer for the one HDF5 layout the data pipeline uses, with
no HDF5 library (the card's installation has no ``h5py``).

The JAX package reads and writes ``.h5`` clouds with h5py
(``sparenet_tpu/data/io.py``): one float dataset named ``data`` written by
``create_dataset("data", data=arr)``. h5py's default file for that is
superblock version 0 (8-byte offsets and lengths), a root group kept as a
symbol table (a version-1 group B-tree, a local heap of names and symbol
table nodes), and the dataset's version-1 object header with a dataspace,
an IEEE float datatype, a fill value and a version-3 layout message whose
data is contiguous (or compact, when asked for). ``read(path)`` reads
exactly that: the dataset ``data``, float32 or float64 of either byte
order, contiguous or compact, object-header continuations followed.
Anything else (another superblock version, chunked or filtered storage,
another datatype, no ``data``) raises ``ValueError`` naming what it found.
``write(path, arr)`` writes a float32 or float64 array as h5py does, byte
for byte (raw data at offset 2048, after the metadata block).
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["read", "write"]

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF
DATASET = "data"

# message types of an object header
_NIL, _DATASPACE, _DATATYPE, _FILL, _LAYOUT = 0, 1, 3, 5, 8
_EXTERNAL, _FILTERS, _CONTINUATION, _SYMBOL_TABLE = 7, 11, 16, 17
# IEEE float properties: (precision, exponent location, exponent size,
# mantissa location, mantissa size, bias, sign location) by byte size
_IEEE = {4: (32, 23, 8, 0, 23, 127, 31), 8: (64, 52, 11, 0, 52, 1023, 63)}


class _File:
    def __init__(self, path: str, buf: bytes):
        self.path, self.buf = path, buf

    def fail(self, what: str):
        raise ValueError(f"{self.path}: {what}; this reader takes h5py's "
                         f"default layout (superblock 0, a symbol-table root "
                         f"group, one contiguous or compact float dataset "
                         f"named {DATASET!r})")

    def unpack(self, fmt: str, off: int):
        try:
            return struct.unpack_from("<" + fmt, self.buf, off)
        except struct.error:
            self.fail(f"truncated at offset {off}")

    def bytes_at(self, off: int, n: int) -> bytes:
        if off < 0 or off + n > len(self.buf):
            self.fail(f"truncated: {n} bytes at offset {off} of {len(self.buf)}")
        return self.buf[off:off + n]

    def messages(self, addr: int) -> list:
        """(type, flags, body) of every message of the version-1 object
        header at ``addr``, continuation blocks followed."""
        version, _, n_msgs, _, size = self.unpack("BBHII", addr)
        if version != 1:
            self.fail(f"object header version {version} at offset {addr}")
        blocks, out = [(addr + 16, size)], []
        while blocks and len(out) < n_msgs:
            start, length = blocks.pop(0)
            off = start
            while off + 8 <= start + length and len(out) < n_msgs:
                mtype, msize, flags = self.unpack("HHB", off)
                body = self.bytes_at(off + 8, msize)
                if mtype == _CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", body))
                out.append((mtype, flags, body))
                off += 8 + msize
        return out

    def cstring(self, off: int) -> str:
        end = self.buf.find(b"\0", off)
        if end < 0:
            self.fail(f"unterminated name at offset {off}")
        return self.buf[off:end].decode("latin-1")

    def group_entries(self, btree: int, heap: int) -> dict:
        """name -> object header address of a symbol-table group."""
        if self.bytes_at(heap, 4) != b"HEAP":
            self.fail(f"no local heap at offset {heap}")
        (names,) = self.unpack("Q", heap + 24)
        out = {}

        def walk(node: int):
            if self.bytes_at(node, 4) != b"TREE":
                self.fail(f"no B-tree node at offset {node}")
            ntype, level, used = self.unpack("BBH", node + 4)
            if ntype != 0:
                self.fail(f"B-tree node type {ntype} in the root group")
            for i in range(used):
                (child,) = self.unpack("Q", node + 24 + 8 + 16 * i)
                if level:
                    walk(child)
                    continue
                if self.bytes_at(child, 4) != b"SNOD":
                    self.fail(f"no symbol table node at offset {child}")
                (n_sym,) = self.unpack("H", child + 6)
                for j in range(n_sym):
                    name_off, header = self.unpack("QQ", child + 8 + 40 * j)
                    out[self.cstring(names + name_off)] = header
        walk(btree)
        return out


def _dtype(f: _File, body: bytes) -> np.dtype:
    cls, version = body[0] & 0x0F, body[0] >> 4
    if cls != 1:
        f.fail(f"datatype class {cls} (version {version}), not floating point")
    bits = body[1] | body[2] << 8 | body[3] << 16
    (size,) = struct.unpack_from("<I", body, 4)
    if size not in _IEEE or bits & 0x40:
        f.fail(f"a {size}-byte floating-point type with bit field {bits:#x}")
    off, prec, eloc, esize, mloc, msize, bias = struct.unpack_from(
        "<HHBBBBI", body, 8)
    want = _IEEE[size]
    if (off, prec, eloc, esize, mloc, msize, bias, bits >> 8 & 0xFF) != (
            0,) + want:
        f.fail(f"a non-IEEE {size}-byte float (precision {prec}, exponent "
               f"{eloc}/{esize}, mantissa {mloc}/{msize}, bias {bias})")
    return np.dtype((">" if bits & 1 else "<") + f"f{size}")


def _shape(f: _File, body: bytes) -> tuple:
    version, rank = body[0], body[1]
    if version == 1:
        start = 8
    elif version == 2:
        if body[3] == 2:
            f.fail("a null dataspace")
        start = 4
    else:
        f.fail(f"dataspace message version {version}")
    return struct.unpack_from(f"<{rank}Q", body, start)


def read(path: str) -> np.ndarray:
    """The dataset ``data`` of the .h5 file ``path`` (its dtype and shape)."""
    with open(path, "rb") as fh:
        f = _File(path, fh.read())
    if f.buf[:8] != SIGNATURE:
        f.fail("no HDF5 signature at offset 0")
    if f.buf[8] != 0:
        f.fail(f"superblock version {f.buf[8]}")
    if f.buf[13:15] != b"\x08\x08":
        f.fail(f"{f.buf[13]}-byte offsets and {f.buf[14]}-byte lengths")
    (base,) = f.unpack("Q", 24)
    if base != 0:
        f.fail(f"base address {base}")
    (root,) = f.unpack("Q", 0x38 + 8)
    tables = [b for t, _, b in f.messages(root) if t == _SYMBOL_TABLE]
    if not tables:
        f.fail("a root group without a symbol table (new-style links)")
    entries = f.group_entries(*struct.unpack_from("<QQ", tables[0]))
    if DATASET not in entries:
        f.fail(f"no dataset {DATASET!r} (the root group holds "
               f"{sorted(entries)})")
    dtype = shape = layout = None
    for mtype, _, body in f.messages(entries[DATASET]):
        if mtype == _DATASPACE:
            shape = _shape(f, body)
        elif mtype == _DATATYPE:
            dtype = _dtype(f, body)
        elif mtype == _LAYOUT:
            layout = body
        elif mtype == _FILTERS:
            f.fail("a filter pipeline (compressed or filtered data)")
        elif mtype == _EXTERNAL:
            f.fail("an external file list")
    if dtype is None or shape is None or layout is None:
        f.fail(f"{DATASET!r} is not a dataset (no dataspace, datatype or "
               f"layout message)")
    count = int(np.prod(shape, dtype=np.int64))
    nbytes = count * dtype.itemsize
    if layout[0] != 3:
        f.fail(f"layout message version {layout[0]}")
    if layout[1] == 0:                      # compact: the data in the header
        (size,) = struct.unpack_from("<H", layout, 2)
        raw = layout[4:4 + size]
    elif layout[1] == 1:                    # contiguous
        addr, size = struct.unpack_from("<QQ", layout, 2)
        if addr == UNDEFINED:
            if count:
                f.fail(f"{DATASET!r} has no storage allocated")
            raw = b""
        else:
            raw = f.bytes_at(addr, size)
    else:
        f.fail("chunked storage" if layout[1] == 2
               else f"layout class {layout[1]}")
    if len(raw) < nbytes:
        f.fail(f"{len(raw)} bytes of data for {count} elements of {dtype}")
    return np.frombuffer(raw[:nbytes], dtype=dtype).reshape(shape).copy()


# h5py's default placement: superblock, root group header, B-tree, local
# heap, dataset header, symbol table node; raw data after the 2048-byte
# metadata block
_ROOT, _BTREE, _HEAP, _HEAP_DATA = 0x60, 0x88, 0x2A8, 0x2C8
_HEADER, _SNOD, _RAW = 0x320, 0x430, 0x800
_HEAP_SIZE, _HEADER_SIZE, _METADATA_END = 88, 256, 0x578


def _message(mtype: int, flags: int, body: bytes) -> bytes:
    body += b"\0" * (-len(body) % 8)
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def write(path: str, arr) -> None:
    """Write ``arr`` (float32 or float64) as the dataset ``data`` of a new
    .h5 file, as h5py's ``create_dataset("data", data=arr)`` writes it."""
    arr = np.asarray(arr)
    if arr.dtype.kind != "f" or arr.dtype.itemsize not in _IEEE:
        raise ValueError(f"{path}: .h5 output takes float32 or float64 "
                         f"arrays, not {arr.dtype}")
    arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
    raw = arr.tobytes()                     # C order
    size = arr.dtype.itemsize
    prec, eloc, esize, mloc, msize, bias, sign = _IEEE[size]
    addr, eof = (_RAW, _RAW + len(raw)) if raw else (UNDEFINED, _METADATA_END)

    buf = bytearray(max(eof, _METADATA_END))
    # superblock 0 with the root group's symbol table entry (cached B-tree
    # and heap addresses)
    struct.pack_into("<8s8BHHIQQQQQQII QQ", buf, 0, SIGNATURE, 0, 0, 0, 0, 0,
                     8, 8, 0, 4, 16, 0, 0, UNDEFINED, eof, UNDEFINED, 0, _ROOT,
                     1, 0, _BTREE, _HEAP)
    # the root group's object header: one symbol table message
    msg = _message(_SYMBOL_TABLE, 0, struct.pack("<QQ", _BTREE, _HEAP))
    struct.pack_into("<BBHII4x", buf, _ROOT, 1, 0, 1, 1, len(msg))
    buf[_ROOT + 16:_ROOT + 16 + len(msg)] = msg
    # a group B-tree leaf with one child, the symbol table node; keys are
    # heap offsets of names (0: the empty name, 8: "data")
    struct.pack_into("<4sBBHQQQQQ", buf, _BTREE, b"TREE", 0, 0, 1, UNDEFINED,
                     UNDEFINED, 0, _SNOD, 8)
    # the local heap of names: "" at 0, "data" at 8, the rest one free block
    struct.pack_into("<4sB3xQQQ", buf, _HEAP, b"HEAP", 0, _HEAP_SIZE, 16,
                     _HEAP_DATA)
    struct.pack_into("<8x8sQQ", buf, _HEAP_DATA, DATASET.encode(), 1,
                     _HEAP_SIZE - 16)
    # the dataset's object header
    rank = arr.ndim
    space = struct.pack(f"<BBB5x{rank}Q{rank}Q", 1, rank, 1 if rank else 0,
                        *arr.shape, *arr.shape)
    dtype = struct.pack("<B3BIHHBBBBI", 0x11, 0x20, sign, 0, size, 0, prec,
                        eloc, esize, mloc, msize, bias)
    fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)
    layout = struct.pack("<BBQQ", 3, 1, addr, len(raw))
    msgs = b"".join([_message(_DATASPACE, 0, space),
                     _message(_DATATYPE, 1, dtype), _message(_FILL, 1, fill),
                     _message(_LAYOUT, 0, layout)])
    msgs += _message(_NIL, 0, b"\0" * (_HEADER_SIZE - len(msgs) - 8))
    struct.pack_into("<BBHII4x", buf, _HEADER, 1, 0, 5, 1, _HEADER_SIZE)
    buf[_HEADER + 16:_HEADER + 16 + _HEADER_SIZE] = msgs
    # the symbol table node: one entry, "data" -> the dataset's header
    struct.pack_into("<4sBxHQQ", buf, _SNOD, b"SNOD", 1, 1, 8, _HEADER)
    buf[_RAW:_RAW + len(raw)] = raw
    with open(path, "wb") as fh:
        fh.write(bytes(buf))
