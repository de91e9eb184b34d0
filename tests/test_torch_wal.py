"""longbow_tpu_torch's WAL against longbow_tpu's, on the CPU: the native
library's CRC32C and frame scan against their plain Python versions,
frames byte for byte equal to the reference's for the same fields, a
corrupt frame and a torn tail, the Arrow IPC codec against pyarrow in
both directions for each type it carries (equal tables and arrays;
equal bytes are not required, a flatbuffer's field order is free), and
whole logs written by either package replayed in the other.
"""
import io

import numpy as np
import pyarrow as pa
import pytest

from longbow_tpu.storage import engine as jax_engine
from longbow_tpu.storage import wal as jax_wal
from longbow_tpu_torch.storage import arrow_ipc, native
from longbow_tpu_torch.storage import engine as port_engine
from longbow_tpu_torch.storage import wal as port_wal
from longbow_tpu_torch.storage.wal import WAL


def test_crc32c_known_vector_library_and_plain():
    # RFC 3720's test vector
    assert native.crc32c(b"123456789") == 0xE3069283
    assert native._py_crc32c(b"123456789") == 0xE3069283
    assert native.crc32c(b"") == native._py_crc32c(b"") == 0


@pytest.mark.parametrize("size", [1, 7, 8, 9, 63, 4096, 10_007])
def test_crc32c_library_equals_plain(size):
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    assert native.crc32c(data) == native._py_crc32c(data)
    assert native.crc32c(data, 0x1234) == native._py_crc32c(data, 0x1234)


@pytest.mark.parametrize("name,kind,payload", [
    (b"ds", port_wal.KIND_OP, b'{"op": "drop"}'),
    (b"ns/dataset-1", port_wal.KIND_BATCH, bytes(range(256)) * 9),
    (b"", port_wal.KIND_OP, b""),
])
def test_frames_equal_the_reference_bytes(name, kind, payload):
    for seq, ts in ((1, 0.0), (2**40 + 3, 1792209226.9926548)):
        assert port_wal._encode_frame(seq, ts, name, kind, payload) == \
            jax_wal._encode_frame(seq, ts, name, kind, payload)


def _frames(n):
    return b"".join(
        port_wal._encode_frame(i + 1, 10.0 + i, b"d", port_wal.KIND_OP, b"x" * (i * 13))
        for i in range(n)
    )


def test_scan_equals_plain_on_a_corrupt_frame_and_a_torn_tail():
    clean = _frames(6)
    offsets, valid = port_wal._scan_frames(clean)
    assert (offsets, valid) == port_wal._py_scan_frames(clean)
    assert len(offsets) == 6 and valid == len(clean)
    bad = bytearray(clean)
    bad[offsets[3] + 30] ^= 0x40                # a payload byte of frame 4
    assert port_wal._scan_frames(bytes(bad)) == port_wal._py_scan_frames(bytes(bad))
    assert port_wal._scan_frames(bytes(bad)) == (offsets[:3], offsets[3])
    torn = clean[:-5]                           # the last frame cut short
    assert port_wal._scan_frames(torn) == port_wal._py_scan_frames(torn) == (
        offsets[:5], offsets[5])


def test_reopen_cuts_the_torn_tail_and_resumes_the_sequence(tmp_path):
    path = tmp_path / "w.log"
    path.write_bytes(_frames(4)[:-3])
    w = WAL(path, sync="always")
    assert path.stat().st_size == port_wal._scan_frames(_frames(3))[1]
    assert w.append_op("d", {"op": "drop"}) == 4
    w.close()
    assert [f[0] for f in WAL.replay(path)] == [1, 2, 3, 4]


# -- the Arrow IPC codec -----------------------------------------------------

N = 7
SCALARS = {
    "int64": np.arange(N, dtype=np.int64) - 3 * 2**40,
    "int32": np.arange(N, dtype=np.int32) - 3,
    "float64": np.linspace(-1.5, 2.5, N),
    "float32": np.linspace(-1, 1, N).astype(np.float32),
    "bool": np.array([True, False, False, True, True, False, True]),
    "utf8": np.array(["", "a", "émoji 🙂", "longer text here", "x", "y", "z"]),
}
LISTS = {
    dt: (np.arange(N * 5).reshape(N, 5) % 120 - 60).astype(dt)
    for dt in ("float32", "float16", "int8", "uint8", "int32")
}
LISTS["uint8"] = (np.arange(N * 5).reshape(N, 5) % 250).astype(np.uint8)


def _pa_column(arr):
    if arr.ndim == 2:
        return pa.FixedSizeListArray.from_arrays(pa.array(arr.reshape(-1)), arr.shape[1])
    return pa.array(arr)


def _pa_table(cols, meta=None):
    t = pa.table({k: _pa_column(v) for k, v in cols.items()})
    return t.replace_schema_metadata(meta) if meta else t


def _pa_bytes(table, batches=1):
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, table.schema) as w:
        for _ in range(batches):
            w.write_table(table)
    return sink.getvalue()


def _cases():
    out = [(f"scalar-{k}", {"id": SCALARS["int64"], k: v}) for k, v in SCALARS.items()]
    out += [(f"list-{k}", {"id": SCALARS["int64"], "vector": v}) for k, v in LISTS.items()]
    return out


@pytest.mark.parametrize("label,cols", _cases(), ids=[c[0] for c in _cases()])
def test_port_bytes_read_in_pyarrow_as_an_equal_table(label, cols):
    meta = {"longbow.metric": "cosine"}
    raw = arrow_ipc.encode_stream(arrow_ipc.Table(cols, meta))
    got = pa.ipc.open_stream(io.BytesIO(raw)).read_all()
    assert got.equals(_pa_table(cols, meta), check_metadata=True)


@pytest.mark.parametrize("label,cols", _cases(), ids=[c[0] for c in _cases()])
def test_pyarrow_bytes_read_in_the_port_as_equal_arrays(label, cols):
    t = arrow_ipc.decode_stream(_pa_bytes(_pa_table(cols, {"longbow.metric": "dot"})))
    assert t.column_names == list(cols) and t.schema_metadata == {"longbow.metric": "dot"}
    for k, v in cols.items():
        np.testing.assert_array_equal(t.column(k), v)
        assert t.column(k).dtype == v.dtype and t.column(k).shape == v.shape


def test_many_record_batches_and_an_empty_table():
    cols = {"id": SCALARS["int64"], "vector": LISTS["float32"], "s": SCALARS["utf8"],
            "b": SCALARS["bool"]}
    t = arrow_ipc.decode_stream(_pa_bytes(_pa_table(cols), batches=3))
    assert t.num_rows == 3 * N and t.schema_metadata == {}
    for k, v in cols.items():
        np.testing.assert_array_equal(t.column(k), np.concatenate([v] * 3))
    empty = {"id": SCALARS["int64"][:0], "vector": LISTS["int8"][:0]}
    raw = arrow_ipc.encode_stream(arrow_ipc.Table(empty))
    assert pa.ipc.open_stream(io.BytesIO(raw)).read_all().equals(_pa_table(empty))
    back = arrow_ipc.decode_stream(_pa_bytes(_pa_table(empty), batches=0))
    assert back.num_rows == 0 and back.column("vector").shape == (0, 5)


@pytest.mark.parametrize("arr", [
    pa.array(np.arange(N, dtype=np.int16)),
    pa.array(np.arange(N, dtype=np.uint32)),
    pa.array([1, None, 3, 4, 5, 6, 7], pa.int64()),
    pa.array(["a", "b"] * 3 + ["a"]).dictionary_encode(),
    pa.array(["a"] * N, pa.large_string()),
    pa.FixedSizeListArray.from_arrays(pa.array(np.arange(2 * N, dtype=np.float64)), 2),
], ids=["int16", "uint32", "null", "dictionary", "large_utf8", "list-float64"])
def test_unsupported_arrow_input_raises(arr):
    with pytest.raises(ValueError):
        arrow_ipc.decode_stream(_pa_bytes(pa.table({"c": arr})))


def test_bytes_without_the_continuation_marker_raise():
    raw = _pa_bytes(_pa_table({"id": SCALARS["int64"]}))
    with pytest.raises(ValueError, match="continuation"):
        arrow_ipc.decode_stream(raw[4:])  # the legacy framing: length first


def test_compressed_batches_raise():
    if not pa.Codec.is_available("zstd"):
        pytest.skip("pyarrow has no zstd codec here")
    table = _pa_table({"id": SCALARS["int64"]})
    sink = io.BytesIO()
    opts = pa.ipc.IpcWriteOptions(compression="zstd")
    with pa.ipc.new_stream(sink, table.schema, options=opts) as w:
        w.write_table(table)
    with pytest.raises(ValueError, match="compressed"):
        arrow_ipc.decode_stream(sink.getvalue())


@pytest.mark.parametrize("cols", [
    {"c": np.arange(N, dtype=np.int16)},
    {"c": np.arange(N).astype(np.complex64)},
    {"c": np.array(["a", None, "c", "d", "e", "f", "g"], dtype=object)},
    {"v": np.zeros((N, 3), np.float64)},
], ids=["int16", "complex", "object-null", "list-float64"])
def test_unsupported_columns_raise_on_write(cols):
    with pytest.raises(ValueError):
        arrow_ipc.encode_stream(arrow_ipc.Table(cols))


def test_put_table_matches_the_reference_table():
    """The port's put frame reads in pyarrow as the table the reference
    builds for the same put, and the reverse."""
    rng = np.random.default_rng(0)
    ids = np.arange(9)
    vec = rng.standard_normal((9, 6)).astype(np.float32)
    cols = {"category": np.arange(9) % 3, "price": np.arange(9) * 0.5,
            "tag": np.array(list("abcabcabc")), "flag": np.arange(9) % 2 == 0}
    ts = np.linspace(1.0, 2.0, 9)
    for v in (vec, vec.astype(np.float16), (vec * 10).astype(np.int8)):
        ref = jax_engine._put_table(ids, v, cols, timestamp=ts).replace_schema_metadata(
            {"longbow.metric": "l2"})
        mine = port_engine._put_table(ids, v, cols, timestamp=ts, metric="l2")
        raw = arrow_ipc.encode_stream(mine)
        assert pa.ipc.open_stream(io.BytesIO(raw)).read_all().equals(ref, check_metadata=True)
        back = port_engine._table_to_put(arrow_ipc.decode_stream(_pa_bytes(ref)))
        want = jax_engine._table_to_put(ref)
        np.testing.assert_array_equal(back[0], want[0])
        np.testing.assert_array_equal(back[1], want[1])
        assert back[1].dtype == want[1].dtype
        np.testing.assert_array_equal(back[3], want[3])
        for k in cols:
            np.testing.assert_array_equal(back[2][k], want[2][k])
    str_ids = np.array(["a", "b"])
    t = port_engine._put_table(str_ids, vec[:2], None)
    assert t.column("id").tolist() == ["a", "b"] and t.column_names == ["id", "vector"]


# -- whole logs across the packages --------------------------------------------

def _write_log(wal_cls, engine_mod, path):
    w = wal_cls(path, sync="always")
    rng = np.random.default_rng(3)
    vec = rng.standard_normal((5, 4)).astype(np.float32)
    table = engine_mod._put_table(np.arange(5), vec, {"n": np.arange(5)}, timestamp=7.0)
    if engine_mod is jax_engine:
        table = table.replace_schema_metadata({"longbow.metric": "cosine"})
    else:
        table.schema_metadata["longbow.metric"] = "cosine"
    w.append_batch("ds", table)
    w.append_op("ds", {"op": "delete", "ids": [1, 2]})
    w.append_op("ds", {"op": "add_edge", "from": 1, "to": 3, "type": "r", "weight": 0.5})
    w.close()
    return vec


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_log_replays_in_the_other_package(tmp_path, writer):
    path = tmp_path / "wal.log"
    if writer == "jax":
        vec = _write_log(jax_wal.WAL, jax_engine, path)
        frames = list(port_wal.WAL.replay(path))
        table = port_wal.WAL.decode_batch(frames[0][4])
        ids, vecs, cols, ts = port_engine._table_to_put(table)
        meta = table.schema_metadata.get("longbow.metric")
    else:
        vec = _write_log(port_wal.WAL, port_engine, path)
        frames = list(jax_wal.WAL.replay(path))
        table = jax_wal.WAL.decode_batch(frames[0][4])
        ids, vecs, cols, ts = jax_engine._table_to_put(table)
        meta = table.schema.metadata[b"longbow.metric"].decode()
    assert [f[0] for f in frames] == [1, 2, 3] and [f[2] for f in frames] == ["ds"] * 3
    assert [f[3] for f in frames] == [0, 1, 1]
    np.testing.assert_array_equal(ids, np.arange(5))
    np.testing.assert_array_equal(vecs, vec)
    np.testing.assert_array_equal(cols["n"], np.arange(5))
    np.testing.assert_array_equal(ts, np.full(5, 7.0))
    assert meta == "cosine"
    assert frames[1][4] == b'{"op": "delete", "ids": [1, 2]}'


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    """No quiet fallback: a source that does not compile raises with g++'s
    output, and so does a host without g++."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(native.NativeBuildError, match="broken.cpp"):
        native._build(tmp_path / "out" / "lib.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ was not found"):
        native._build(tmp_path / "out" / "lib.so")
