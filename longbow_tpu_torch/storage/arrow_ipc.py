"""A minimal Arrow IPC stream codec in numpy, for the WAL's put frames.

longbow_tpu logs a put as an Arrow IPC stream written by pyarrow
(storage/wal.py append_batch / decode_batch). The port keeps that frame
format without pyarrow: this module writes and reads the stream format
(a Schema message, RecordBatch messages, the end-of-stream marker) for
the types a put can carry, and nothing else:

- top-level columns: int64, int32, float64, float32, bool, utf8;
- FixedSizeList<float32 | float16 | int8 | uint8 | int32> (the vector
  column, a 2-d array here);
- schema custom_metadata (`longbow.metric`).

Messages are flatbuffers (metadata version V5) behind the 0xFFFFFFFF
continuation marker; bodies are 8-byte aligned. Reading takes any number
of RecordBatch messages and concatenates them. Any other type, a
dictionary batch, body compression or a null raises ValueError.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np

CONTINUATION = 0xFFFFFFFF
METADATA_V5 = 4
# Message.header union
_HDR_SCHEMA, _HDR_DICTIONARY, _HDR_RECORD_BATCH = 1, 2, 3
# Type union
_T_INT, _T_FLOAT, _T_UTF8, _T_BOOL, _T_FSL = 2, 3, 5, 6, 16
_PRECISION = {np.dtype(np.float16): 0, np.dtype(np.float32): 1, np.dtype(np.float64): 2}
_FROM_PRECISION = {v: k for k, v in _PRECISION.items()}

SCALAR_DTYPES = frozenset(
    np.dtype(t) for t in (np.int64, np.int32, np.float64, np.float32, np.bool_)
)
LIST_DTYPES = frozenset(
    np.dtype(t) for t in (np.float32, np.float16, np.int8, np.uint8, np.int32)
)


class Table:
    """Named columns of equal length (numpy arrays; the vector column is
    2-d) and the schema's custom metadata."""

    def __init__(self, columns: dict, metadata: Optional[dict] = None):
        self._cols = {str(k): v for k, v in columns.items()}
        lens = {len(v) for v in self._cols.values()}
        if len(lens) > 1:
            raise ValueError(f"columns of unequal length {sorted(lens)}")
        self.schema_metadata = dict(metadata or {})

    @property
    def column_names(self) -> list[str]:
        return list(self._cols)

    @property
    def num_rows(self) -> int:
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def column(self, name: str) -> np.ndarray:
        return self._cols[name]


# -- flatbuffers: a front-to-back writer ---------------------------------
#
# Every offset a flatbuffer stores (to a table, string or vector) is
# unsigned and points forward, so each object is laid out after the one
# that refers to it; a table's vtable, reached by a signed offset, sits
# just before the table.

class _FbTable:
    def __init__(self, fields: dict):
        self.fields = fields  # slot -> (format, value); format "obj" for children


class _FbStructs:
    """A vector of structs whose members are int64 (8-byte aligned)."""

    def __init__(self, raw: bytes, count: int):
        self.raw, self.count = raw, count


_SIZES = {"b": 1, "B": 1, "?": 1, "h": 2, "i": 4, "q": 8}


def _pad_to(buf: bytearray, align: int, rem: int = 0) -> None:
    buf.extend(b"\0" * ((rem - len(buf)) % align))


def _place(buf: bytearray, obj) -> int:
    """Appends obj (and, after it, everything it refers to); returns its
    position."""
    if isinstance(obj, str):
        _pad_to(buf, 4)
        pos = len(buf)
        raw = obj.encode()
        buf += struct.pack("<I", len(raw)) + raw + b"\0"
        return pos
    if isinstance(obj, list):  # a vector of tables
        _pad_to(buf, 4)
        pos = len(buf)
        buf += struct.pack("<I", len(obj)) + b"\0" * (4 * len(obj))
        for j, child in enumerate(obj):
            slot = pos + 4 + 4 * j
            struct.pack_into("<I", buf, slot, _place(buf, child) - slot)
        return pos
    if isinstance(obj, _FbStructs):
        _pad_to(buf, 8, 4)  # the elements start 8-byte aligned
        pos = len(buf)
        buf += struct.pack("<I", obj.count) + obj.raw
        return pos
    # a table: scalars widest first behind the 4-byte vtable offset, with
    # the table placed at 4 mod 8 so that the 8-byte fields are aligned
    order = sorted(
        obj.fields.items(),
        key=lambda kv: -(4 if kv[1][0] == "obj" else _SIZES[kv[1][0]]),
    )
    offsets, off = {}, 4
    for slot, (fmt, _) in order:
        offsets[slot] = off
        off += 4 if fmt == "obj" else _SIZES[fmt]
    n_slots = max(obj.fields, default=-1) + 1
    vt = struct.pack(
        f"<HH{n_slots}H", 4 + 2 * n_slots, off,
        *(offsets.get(s, 0) for s in range(n_slots)),
    )
    _pad_to(buf, 2)
    vt_pos = len(buf)
    buf += vt
    _pad_to(buf, 8, 4)
    pos = len(buf)
    buf += struct.pack("<i", pos - vt_pos) + b"\0" * (off - 4)
    children = []
    for slot, (fmt, val) in order:
        if fmt == "obj":
            children.append((pos + offsets[slot], val))
        else:
            struct.pack_into("<" + fmt, buf, pos + offsets[slot], val)
    for at, child in children:
        struct.pack_into("<I", buf, at, _place(buf, child) - at)
    return pos


def _finish(root: _FbTable) -> bytes:
    buf = bytearray(4)
    struct.pack_into("<I", buf, 0, _place(buf, root))
    return bytes(buf)


# -- flatbuffers: a reader -------------------------------------------------

class _FbView:
    """A table inside a flatbuffer, read by slot."""

    def __init__(self, buf, pos: int):
        self.buf, self.pos = buf, pos
        self.vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vt_size = struct.unpack_from("<H", buf, self.vt)[0]

    def _off(self, slot: int) -> int:
        o = 4 + 2 * slot
        return struct.unpack_from("<H", self.buf, self.vt + o)[0] if o < self.vt_size else 0

    def scalar(self, slot: int, fmt: str, default=0):
        off = self._off(slot)
        return struct.unpack_from("<" + fmt, self.buf, self.pos + off)[0] if off else default

    def _ref(self, slot: int) -> Optional[int]:
        off = self._off(slot)
        if not off:
            return None
        at = self.pos + off
        return at + struct.unpack_from("<I", self.buf, at)[0]

    def table(self, slot: int) -> Optional["_FbView"]:
        at = self._ref(slot)
        return None if at is None else _FbView(self.buf, at)

    def string(self, slot: int) -> Optional[str]:
        at = self._ref(slot)
        if at is None:
            return None
        n = struct.unpack_from("<I", self.buf, at)[0]
        return bytes(self.buf[at + 4: at + 4 + n]).decode()

    def tables(self, slot: int) -> list["_FbView"]:
        at = self._ref(slot)
        if at is None:
            return []
        n = struct.unpack_from("<I", self.buf, at)[0]
        out = []
        for j in range(n):
            e = at + 4 + 4 * j
            out.append(_FbView(self.buf, e + struct.unpack_from("<I", self.buf, e)[0]))
        return out

    def structs(self, slot: int, fmt: str) -> list[tuple]:
        at = self._ref(slot)
        if at is None:
            return []
        n = struct.unpack_from("<I", self.buf, at)[0]
        size = struct.calcsize("<" + fmt)
        return [struct.unpack_from("<" + fmt, self.buf, at + 4 + size * j) for j in range(n)]


def _root(buf) -> _FbView:
    return _FbView(buf, struct.unpack_from("<I", buf, 0)[0])


# -- types -------------------------------------------------------------------

def _type_of(dt: np.dtype) -> tuple[int, _FbTable]:
    if dt.kind in "iu":
        return _T_INT, _FbTable({0: ("i", dt.itemsize * 8), 1: ("?", dt.kind == "i")})
    if dt.kind == "f":
        return _T_FLOAT, _FbTable({0: ("h", _PRECISION[dt])})
    if dt.kind == "b":
        return _T_BOOL, _FbTable({})
    raise ValueError(f"unsupported Arrow column dtype {dt}")


def _dtype_of(type_id: int, t: Optional[_FbView]) -> np.dtype:
    if type_id == _T_INT:
        bits, signed = t.scalar(0, "i"), bool(t.scalar(1, "?"))
        try:
            return np.dtype(f"{'i' if signed else 'u'}{bits // 8}")
        except TypeError:
            raise ValueError(f"unsupported Arrow int width {bits}") from None
    if type_id == _T_FLOAT:
        return _FROM_PRECISION[t.scalar(0, "h")]
    if type_id == _T_BOOL:
        return np.dtype(np.bool_)
    raise ValueError(f"unsupported Arrow type id {type_id}")


def _field(name: str, type_id: int, type_table: _FbTable, children=()) -> _FbTable:
    # nullable, as pyarrow writes a field by default
    return _FbTable({0: ("obj", name), 1: ("?", True), 2: ("B", type_id),
                     3: ("obj", type_table), 5: ("obj", list(children))})


def _is_text(arr: np.ndarray) -> bool:
    return arr.dtype.kind in "USO"


# -- writing -------------------------------------------------------------

def _message(header_type: int, header: _FbTable, body_len: int) -> bytes:
    fb = _finish(_FbTable({0: ("h", METADATA_V5), 1: ("B", header_type),
                           2: ("obj", header), 3: ("q", body_len)}))
    pad = (-(8 + len(fb))) % 8
    return struct.pack("<Ii", CONTINUATION, len(fb) + pad) + fb + b"\0" * pad


def encode_stream(table: Table) -> bytes:
    """The table as one Arrow IPC stream: Schema, one RecordBatch, EOS."""
    fields, nodes, buffers, body = [], [], [], []
    size = 0

    def add_buffer(raw: bytes) -> None:
        nonlocal size
        buffers.append((size, len(raw)))
        body.append(raw)
        size += len(raw)
        pad = -size % 8
        body.append(b"\0" * pad)
        size += pad

    n = table.num_rows
    for name in table.column_names:
        arr = np.asarray(table.column(name))
        if arr.ndim == 2:
            dt = arr.dtype
            if dt not in LIST_DTYPES:
                raise ValueError(f"column {name!r}: unsupported list element dtype {dt}")
            tid, tt = _type_of(dt)
            item = _field("item", tid, tt)
            fields.append(_field(name, _T_FSL, _FbTable({0: ("i", arr.shape[1])}), [item]))
            nodes += [(n, 0), (arr.size, 0)]
            add_buffer(b"")
            add_buffer(b"")
            add_buffer(np.ascontiguousarray(arr).tobytes())
        elif arr.ndim != 1:
            raise ValueError(f"column {name!r} has {arr.ndim} dimensions")
        elif _is_text(arr):
            if arr.dtype.kind == "O" and not all(isinstance(v, str) for v in arr):
                raise ValueError(f"column {name!r}: an object column must hold str only")
            raw = [str(v).encode() for v in arr]
            offs = np.zeros(n + 1, np.int32)
            np.cumsum([len(r) for r in raw], out=offs[1:])
            fields.append(_field(name, _T_UTF8, _FbTable({})))
            nodes.append((n, 0))
            add_buffer(b"")
            add_buffer(offs.tobytes())
            add_buffer(b"".join(raw))
        else:
            if arr.dtype not in SCALAR_DTYPES:
                raise ValueError(f"column {name!r}: unsupported dtype {arr.dtype}")
            tid, tt = _type_of(arr.dtype)
            fields.append(_field(name, tid, tt))
            nodes.append((n, 0))
            add_buffer(b"")
            data = (
                np.packbits(arr, bitorder="little").tobytes()
                if arr.dtype.kind == "b"
                else np.ascontiguousarray(arr).tobytes()
            )
            add_buffer(data)

    schema = {1: ("obj", fields)}
    if table.schema_metadata:
        schema[2] = ("obj", [
            _FbTable({0: ("obj", str(k)), 1: ("obj", str(v))})
            for k, v in table.schema_metadata.items()
        ])
    batch = _FbTable({
        0: ("q", n),
        1: ("obj", _FbStructs(b"".join(struct.pack("<qq", *x) for x in nodes), len(nodes))),
        2: ("obj", _FbStructs(b"".join(struct.pack("<qq", *x) for x in buffers), len(buffers))),
    })
    return b"".join([
        _message(_HDR_SCHEMA, _FbTable(schema), 0),
        _message(_HDR_RECORD_BATCH, batch, size),
        *body,
        struct.pack("<Ii", CONTINUATION, 0),
    ])


# -- reading -------------------------------------------------------------

def _messages(buf: memoryview):
    """Yields (Message view, body) until the end-of-stream marker."""
    pos = 0
    while pos + 8 <= len(buf):
        marker, n = struct.unpack_from("<II", buf, pos)
        if marker != CONTINUATION:
            raise ValueError("not an Arrow IPC stream (no continuation marker)")
        pos += 8
        if n == 0:
            return  # end of stream
        msg = _root(buf[pos: pos + n])
        pos += n
        body_len = msg.scalar(3, "q")
        yield msg, buf[pos: pos + body_len]
        pos += body_len


def _schema(msg: _FbView) -> tuple[list, dict]:
    schema = msg.table(2)
    if schema.scalar(0, "h") != 0:
        raise ValueError("big-endian Arrow streams are not supported")
    fields = []
    for f in schema.tables(1):
        name = f.string(0)
        if f.table(4) is not None:
            raise ValueError(f"column {name!r} is dictionary-encoded; not supported")
        tid = f.scalar(2, "B")
        if tid == _T_FSL:
            (child,) = f.tables(5)
            dt = _dtype_of(child.scalar(2, "B"), child.table(3))
            if dt not in LIST_DTYPES:
                raise ValueError(f"column {name!r}: unsupported list element dtype {dt}")
            fields.append((name, "list", dt, f.table(3).scalar(0, "i")))
        elif tid == _T_UTF8:
            fields.append((name, "utf8", None, 0))
        else:
            dt = _dtype_of(tid, f.table(3))
            if dt not in SCALAR_DTYPES:
                raise ValueError(f"column {name!r}: unsupported dtype {dt}")
            fields.append((name, "scalar", dt, 0))
    meta = {kv.string(0): kv.string(1) for kv in schema.tables(2)}
    return fields, meta


def _batch(msg: _FbView, body: memoryview, fields: list) -> dict:
    rb = msg.table(2)
    if rb.table(3) is not None:
        raise ValueError("compressed Arrow record batches are not supported")
    nodes = iter(rb.structs(1, "qq"))
    bufs = iter(rb.structs(2, "qq"))

    def node() -> int:
        length, nulls = next(nodes)
        if nulls:
            raise ValueError("Arrow columns with nulls are not supported")
        return length

    def data(dtype, count: int) -> np.ndarray:
        off, length = next(bufs)
        return np.frombuffer(body, dtype, count, off).copy()

    out = {}
    for name, kind, dt, width in fields:
        n = node()
        next(bufs)  # validity: no nulls
        if kind == "list":
            m = node()
            next(bufs)
            if m != n * width:
                raise ValueError(f"column {name!r}: {m} list values for {n} x {width}")
            out[name] = data(dt, m).reshape(n, width)
        elif kind == "utf8":
            offs = data(np.int32, n + 1)
            off, length = next(bufs)
            raw = bytes(body[off: off + length])
            out[name] = np.array(
                [raw[offs[j]: offs[j + 1]].decode() for j in range(n)], dtype=str
            )
        elif dt.kind == "b":
            off, length = next(bufs)
            bits = np.frombuffer(body, np.uint8, length, off)
            out[name] = np.unpackbits(bits, count=n, bitorder="little").astype(bool)
        else:
            out[name] = data(dt, n)
    return out


def decode_stream(payload) -> Table:
    """An Arrow IPC stream -> Table (its record batches concatenated)."""
    buf = memoryview(payload)
    fields, meta, parts = None, {}, []
    for msg, body in _messages(buf):
        htype = msg.scalar(1, "B")
        if htype == _HDR_SCHEMA:
            fields, meta = _schema(msg)
        elif htype == _HDR_RECORD_BATCH:
            if fields is None:
                raise ValueError("Arrow record batch before its schema")
            parts.append(_batch(msg, body, fields))
        elif htype == _HDR_DICTIONARY:
            raise ValueError("Arrow dictionary batches are not supported")
        else:
            raise ValueError(f"unsupported Arrow IPC message type {htype}")
    if fields is None:
        raise ValueError("no Arrow schema in the stream")
    cols = {}
    for name, kind, dt, width in fields:
        if parts:
            cols[name] = np.concatenate([p[name] for p in parts])
        elif kind == "list":
            cols[name] = np.zeros((0, width), dt)
        else:
            cols[name] = np.zeros(0, str if kind == "utf8" else dt)
    return Table(cols, meta)
