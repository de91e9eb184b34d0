"""Durability of longbow_tpu_torch's store: write -> crash -> replay, on the
CPU. The first part is the port's counterpart of each test in
tests/test_persistence.py (all but the periodic snapshot loop, which
needs serve.py, and the mesh dataset, whose kind is not ported). The
second holds persistence across the two packages: a snapshot and a WAL
written by either recover in the other, kind by kind, with equal
answers; and the column layout of the snapshots (aux.npz) equal to the
reference's for the same puts.

Tolerances of the cross-package cases are those of the kind's own
test_torch_* file: flat, sq8, sq8r, bq, ivf and disk re-rank in f32 and
agree to rtol 1e-5 / atol 1e-4 with equal ids (clustered Gaussian rows,
no ties); pq's ADC without a re-rank is the same f32 table sum; the
graph tier after migration runs on integer rows (lattice), where ids
and scores must be EQUAL.
"""
import json
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longbow_tpu.index.hnsw import HNSWConfig as JaxConfig
from longbow_tpu.query.parser import Filter as JaxFilter
from longbow_tpu.store.vector_store import VectorStore as JaxStore
from longbow_tpu_torch.index.hnsw import HNSWConfig
from longbow_tpu_torch.query.parser import Filter
from longbow_tpu_torch.storage import engine as eng
from longbow_tpu_torch.storage import native
from longbow_tpu_torch.storage.arrow_ipc import Table
from longbow_tpu_torch.storage.native import crc32c
from longbow_tpu_torch.storage.wal import WAL
from longbow_tpu_torch.store.vector_store import VectorStore as _PortStore


def VectorStore(**kw):
    """The port's store on the CPU."""
    return _PortStore(device="cpu", **kw)


def _vecs(n, d, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d), dtype=np.float32)


def _ids_table(ids):
    return Table({"id": np.asarray(ids, np.int64)})


# -- the port's counterparts of tests/test_persistence.py ------------------

def test_native_library_builds():
    lib = native.get_lib()
    assert lib is not None and native.library_path().exists()
    assert native.library_path().parent.parent.name == ".native_build"


def test_crc32c_known_vector():
    # RFC 3720's test vector: crc32c("123456789") == 0xE3069283
    assert crc32c(b"123456789") == 0xE3069283


def test_wal_roundtrip(tmp_path):
    wal = WAL(tmp_path / "w.log", sync="always")
    wal.append_batch("ds1", _ids_table([1, 2]))
    wal.append_op("ds1", {"op": "delete", "ids": [1]})
    wal.close()

    entries = list(WAL.replay(tmp_path / "w.log"))
    assert len(entries) == 2
    seq, ts, name, kind, payload = entries[0]
    assert name == "ds1" and kind == 0
    assert WAL.decode_batch(payload).num_rows == 2
    assert entries[1][3] == 1


def test_wal_detects_corruption(tmp_path):
    wal = WAL(tmp_path / "w.log", sync="always")
    for _ in range(3):
        wal.append_batch("d", _ids_table([1]))
    wal.close()
    raw = bytearray((tmp_path / "w.log").read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    (tmp_path / "w.log").write_bytes(bytes(raw))
    entries = list(WAL.replay(tmp_path / "w.log"))
    assert 0 < len(entries) < 3  # stops at the corrupt frame


def test_crash_replay_restores_store(tmp_path):
    v = _vecs(50, 8)
    store = VectorStore(persist_dir=tmp_path, wal_sync="always")
    store.put("docs", np.arange(50), v, columns={"price": np.arange(50.0)})
    store.delete("docs", [7])
    store.add_edge("docs", 1, 2, "rel", 1.0)
    del store  # a crash: no close(), no snapshot

    store2 = VectorStore(persist_dir=tmp_path, wal_sync="always")
    assert store2.get("docs").live_count == 49
    ids, scores, ok = store2.search("docs", v[3], 1, use_cache=False)
    assert ids[0, 0] == 3
    ids, _, _ = store2.search("docs", v[7], 1, use_cache=False)
    assert ids[0, 0] != 7
    ids, _, ok = store2.search(
        "docs", v[3], 3, filters=[Filter("price", "<", "10")], use_cache=False,
    )
    assert all(i < 10 for i in ids[0] if i is not None)
    assert store2.traverse_graph("docs", 1, 2) == [1, 2]


def test_snapshot_and_wal_truncate(tmp_path):
    v = _vecs(30, 8)
    store = VectorStore(persist_dir=tmp_path, wal_sync="always")
    store.put("a", np.arange(30), v,
              columns={"text": np.array([f"doc {i} words" for i in range(30)])})
    store.snapshot()
    assert store.engine.wal.size_bytes == 0
    del store

    store2 = VectorStore(persist_dir=tmp_path, wal_sync="always")
    assert store2.get("a").live_count == 30
    assert len(store2.get("a").bm25) == 30
    ids, _, _ = store2.search("a", v[5], 1, use_cache=False)
    assert ids[0, 0] == 5


def test_snapshot_plus_tail(tmp_path):
    store = VectorStore(persist_dir=tmp_path, wal_sync="always")
    v = _vecs(20, 8)
    store.put("a", np.arange(20), v)
    store.snapshot()
    v2 = _vecs(5, 8, seed=2)
    store.put("a", np.arange(100, 105), v2)  # lands in the WAL tail
    del store

    store2 = VectorStore(persist_dir=tmp_path, wal_sync="always")
    assert store2.get("a").live_count == 25
    ids, _, _ = store2.search("a", v2[0], 1, use_cache=False)
    assert ids[0, 0] == 100


def test_upsert_after_recovery(tmp_path):
    store = VectorStore(persist_dir=tmp_path, wal_sync="always")
    v = _vecs(10, 8)
    store.put("a", np.arange(10), v)
    store.put("a", np.array([3]), v[3] + 50.0)
    del store
    store2 = VectorStore(persist_dir=tmp_path, wal_sync="always")
    assert store2.get("a").live_count == 10
    ids, _, _ = store2.search("a", v[3] + 50.0, 1, use_cache=False)
    assert ids[0, 0] == 3


def test_drop_survives_recovery(tmp_path):
    store = VectorStore(persist_dir=tmp_path, wal_sync="always")
    store.put("gone", [1], _vecs(1, 4))
    store.put("kept", [1], _vecs(1, 4))
    store.drop("gone")
    del store
    store2 = VectorStore(persist_dir=tmp_path, wal_sync="always")
    assert store2.list_datasets() == ["kept"]


def test_snapshot_preserves_columns(tmp_path):
    """A filter on a column that only lives in the snapshot (the WAL was
    truncated) still works."""
    v = _vecs(40, 8)
    store = VectorStore(persist_dir=tmp_path, wal_sync="always")
    store.put("docs", np.arange(40), v,
              columns={"price": np.arange(40.0), "cat": np.array(["a", "b"] * 20)})
    store.snapshot()
    del store

    store2 = VectorStore(persist_dir=tmp_path, wal_sync="always")
    ids, _, ok = store2.search(
        "docs", v[3], 5, filters=[Filter("price", "<", "10")], use_cache=False,
    )
    got = [i for i in ids[0] if i is not None]
    assert got and all(i < 10 for i in got)
    ids, _, _ = store2.search("docs", v[2], 3, filters=[Filter("cat", "=", "a")],
                              use_cache=False)
    got = [i for i in ids[0] if i is not None]
    assert got and all(i % 2 == 0 for i in got)


def test_snapshot_restores_graph_index_without_rebuild(tmp_path, monkeypatch):
    """The snapshot holds the graph's adjacency; recovery imports it and
    links nothing."""
    v = _vecs(600, 16)
    store = VectorStore(persist_dir=tmp_path, wal_sync="always")
    store.get_or_create("g", 16, index_kind="hnsw")
    store.put("g", np.arange(600), v)
    ds = store.get("g")
    assert ds.index.kind == "hnsw"
    nbrs_before = ds.index._graph.state.nbrs[:600].numpy().copy()
    store.close()

    import longbow_tpu_torch.index.hnsw as hnsw_mod

    def boom(*a, **kw):
        raise AssertionError("recovery must not rebuild the graph")

    for fn in ("insert_batch", "bulk_build_edges", "bulk_build_rp", "bulk_build_clustered"):
        monkeypatch.setattr(hnsw_mod, fn, boom)

    store2 = VectorStore(persist_dir=tmp_path, wal_sync="always")
    ds2 = store2.get("g")
    assert ds2.index.kind == "hnsw" and ds2.index_kind == "hnsw"
    np.testing.assert_array_equal(ds2.index._graph.state.nbrs[:600].numpy(), nbrs_before)
    ids, _, _ = store2.search("g", v[11], 1, use_cache=False)
    assert ids[0, 0] == 11


def test_pq_codes_stable_across_restart(tmp_path):
    """Recovery imports the PQ codebooks: retraining would change every
    code."""
    v = _vecs(800, 16)
    store = VectorStore(persist_dir=tmp_path, wal_sync="always")
    store.get_or_create("p", 16, index_kind="pq", index_params={"pq_m": 4})
    store.put("p", np.arange(800), v)
    inner = store.get("p").index._inner
    codes = inner.codes[: inner.count].numpy().copy()
    books = inner.codebooks.numpy().copy()
    store.close()

    store2 = VectorStore(persist_dir=tmp_path, wal_sync="always")
    inner2 = store2.get("p").index._inner
    np.testing.assert_array_equal(inner2.codes[: inner2.count].numpy(), codes)
    np.testing.assert_array_equal(inner2.codebooks.numpy(), books)
    ids, _, _ = store2.search("p", v[5], 1, use_cache=False)
    assert ids[0, 0] == 5


def test_lww_survives_snapshot(tmp_path):
    """Deletion markers and write timestamps persist: a stale write that
    arrives after the restart still loses."""
    store = VectorStore(persist_dir=tmp_path, wal_sync="always")
    v = _vecs(10, 8)
    store.put("a", np.arange(10), v, timestamp=1000.0)
    store.delete("a", [3])
    store.snapshot()
    del store

    store2 = VectorStore(persist_dir=tmp_path, wal_sync="always")
    ds = store2.get("a")
    assert 3 not in ds._id_to_row and 3 in ds._lww
    store2.put("a", [5], _vecs(1, 8, seed=9), timestamp=10.0)
    ids, _, _ = store2.search("a", v[5], 1, use_cache=False)
    assert ids[0, 0] == 5


def test_wal_seq_monotonic_after_reopen(tmp_path):
    wal = WAL(tmp_path / "w.log", sync="always")
    for _ in range(3):
        wal.append_batch("d", _ids_table([1]))
    wal.close()
    wal2 = WAL(tmp_path / "w.log", sync="always")
    s = wal2.append_batch("d", _ids_table([1]))
    wal2.close()
    seqs = [e[0] for e in WAL.replay(tmp_path / "w.log")]
    assert seqs == [1, 2, 3, 4] and s == 4


def test_dot_metric_index_survives_restart(tmp_path):
    """The MIPS augmentation's bound persists: without it a restored dot
    graph scores wrongly and rejects adds."""
    rng = np.random.default_rng(3)
    v = rng.standard_normal((300, 8), dtype=np.float32)
    store = VectorStore(persist_dir=tmp_path, wal_sync="always")
    store.get_or_create("m", 8, metric="dot", index_kind="hnsw")
    store.put("m", np.arange(300), v)
    q = rng.standard_normal((1, 8), dtype=np.float32)
    _, s1, _ = store.search("m", q, 5, use_cache=False)
    store.close()

    store2 = VectorStore(persist_dir=tmp_path, wal_sync="always")
    _, s2, _ = store2.search("m", q, 5, use_cache=False)
    np.testing.assert_allclose(s1, s2, rtol=1e-4)
    store2.put("m", [1000], v[:1] * 0.5)
    assert store2.get("m").live_count == 301


def test_adaptive_wal_sync(tmp_path):
    """The group-commit interval adapts to the write load."""
    wal = WAL(tmp_path / "w.log", sync="adaptive", sync_interval_s=0.02)
    t = _ids_table(np.arange(500))
    for _ in range(50):
        wal.append_batch("d", t)
    time.sleep(0.1)
    for _ in range(30):  # idle: the interval shrinks toward its floor
        time.sleep(0.02)
        if wal._sync_interval <= 0.01:
            break
    assert wal._sync_interval <= 0.02
    wal.close()
    assert len(list(WAL.replay(tmp_path / "w.log"))) == 50


def test_snapshot_remote_mirror(tmp_path):
    """Snapshots mirror to a backend, and a fresh node recovers from it."""
    from longbow_tpu_torch.storage.backends import LocalBackend

    mirror = tmp_path / "mirror"
    v = _vecs(30, 8)
    store = VectorStore(persist_dir=tmp_path / "node_a", wal_sync="always",
                        snapshot_backend=LocalBackend(mirror))
    store.put("m", np.arange(30), v)
    store.snapshot()
    del store
    store2 = VectorStore(persist_dir=tmp_path / "node_b", wal_sync="always",
                         snapshot_backend=LocalBackend(mirror))
    assert store2.get("m").live_count == 30
    ids, _, _ = store2.search("m", v[4], 1, use_cache=False)
    assert ids[0, 0] == 4


def test_wal_io_uring_backend(tmp_path):
    """io_uring writes, fsync and truncate. Skips where the kernel or its
    seccomp filter refuses io_uring (the WAL then serves from the file backend)."""
    w = WAL(tmp_path / "u.log", sync="always", io_uring=True)
    if w.backend_name != "io_uring":
        w.close()
        pytest.skip("io_uring unavailable on this host")
    for i in range(50):
        w.append_op("ds", {"op": "delete", "ids": [i]})
    w.flush()
    assert w.size_bytes > 0
    frames = list(WAL.replay(tmp_path / "u.log"))
    assert len(frames) == 50 and frames[-1][0] == 50
    w.truncate()
    assert w.size_bytes == 0
    w.append_op("ds", {"op": "delete", "ids": [99]})
    w.close()
    frames = list(WAL.replay(tmp_path / "u.log"))
    assert len(frames) == 1 and frames[0][0] == 51


def test_store_with_io_uring_wal(tmp_path):
    vs = VectorStore(persist_dir=tmp_path, wal_sync="always", wal_io_uring=True)
    v = np.random.default_rng(0).standard_normal((20, 8), np.float32)
    vs.put("d", np.arange(20), v)
    vs.engine.wal.flush()
    vs2 = VectorStore(persist_dir=tmp_path, wal_sync="always", wal_io_uring=True)
    assert vs2.get("d").live_count == 20
    vs.close()
    vs2.close()


def test_snapshot_concurrent_with_puts_loses_nothing(tmp_path):
    """A snapshot's capture and rotation exclude the WAL append + apply
    unit: every acknowledged write survives, however snapshots interleave."""
    vs = VectorStore(persist_dir=str(tmp_path), wal_sync="always")
    errors = []

    def put_loop():
        try:
            for i in range(40):
                vs.put("race", np.arange(i * 50, (i + 1) * 50), _vecs(50, 8, seed=i))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def snap_loop():
        try:
            for _ in range(15):
                vs.snapshot()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=put_loop), threading.Thread(target=snap_loop),
               threading.Thread(target=snap_loop)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    vs.close()
    vs2 = VectorStore(persist_dir=str(tmp_path))
    assert vs2.get("race").live_count == 2000
    vs2.close()


def test_rejected_write_does_not_poison_wal(tmp_path):
    """A put whose column type is rejected is checked before the WAL
    append, and recovery skips a frame it cannot apply."""
    vs = VectorStore(persist_dir=str(tmp_path), wal_sync="always")
    v = _vecs(5, 8)
    vs.put("se", np.arange(5), v, columns={"price": np.arange(5.0)})
    with pytest.raises(ValueError):
        vs.put("se", np.arange(5, 10), v, columns={"price": np.asarray(["x"] * 5)})
    vs.close()
    vs2 = VectorStore(persist_dir=str(tmp_path))
    assert vs2.get("se").live_count == 5
    vs2.close()


def test_unreplayable_frame_is_skipped_and_counted(tmp_path):
    from longbow_tpu_torch.metrics import get_registry

    reg = get_registry()
    before = reg.counter("longbow_wal_replay_skipped_frames_total")._only().value
    wal = WAL(tmp_path / "wal.log", sync="always")
    wal.append_op("nowhere", {"op": "delete", "ids": [1]})  # no such dataset
    wal.close()
    vs = VectorStore(persist_dir=str(tmp_path))
    assert vs.list_datasets() == []
    assert reg.counter("longbow_wal_replay_skipped_frames_total")._only().value == before + 1
    vs.close()


def test_wal_torn_tail_truncated_on_reopen(tmp_path):
    """A torn tail is cut off at reopen, so frames written after it stay
    reachable."""
    w = WAL(tmp_path / "w.log", sync="always")
    w.append_batch("d", _ids_table([1]))
    w.close()
    with open(tmp_path / "w.log", "ab") as f:
        f.write(b"\x01\x02half-a-frame")
    w2 = WAL(tmp_path / "w.log", sync="always")
    w2.append_batch("d", _ids_table([1]))
    w2.close()
    assert len(list(WAL.replay(tmp_path / "w.log"))) == 2


def test_bm25_int_ids_survive_snapshot_roundtrip(tmp_path):
    store = VectorStore(persist_dir=str(tmp_path), wal_sync="always")
    v = _vecs(10, 8)
    store.put("h", np.arange(10), v,
              columns={"text": np.asarray([f"doc {i} alpha" for i in range(10)])})
    store.snapshot()
    store.close()
    store2 = VectorStore(persist_dir=str(tmp_path))
    hits = store2.get("h").bm25.search("alpha", 5)
    assert hits and all(isinstance(doc, int) for doc, _ in hits)
    ids, _, ok = store2.hybrid_search("h", v[:1], 3, text_query="alpha", alpha=0.5)
    assert ids[0, 0] is not None and isinstance(ids[0, 0], (int, np.integer))
    store2.close()


def test_snapshot_survives_crash_between_renames(tmp_path):
    store = VectorStore(persist_dir=str(tmp_path), wal_sync="always")
    store.put("s", np.arange(8), _vecs(8, 8))
    store.snapshot()
    store.close()
    (tmp_path / "snapshot").rename(tmp_path / "snapshot.old.999999")
    store2 = VectorStore(persist_dir=str(tmp_path))
    assert store2.get("s").live_count == 8
    store2.close()


def test_weighted_path_hop_budget_not_blocked_by_cheap_long_path():
    from longbow_tpu_torch.hybrid.graph_store import GraphStore

    g = GraphStore()
    g.add_edge("src", "a", weight=10.0)
    g.add_edge("a", "b", weight=10.0)
    g.add_edge("b", "X", weight=10.0)
    g.add_edge("src", "Y", weight=0.5)
    g.add_edge("Y", "X", weight=0.5)
    g.add_edge("X", "dst", weight=1.0)
    assert g.weighted_path("src", "dst", max_hops=3) == ["src", "Y", "X", "dst"]


def test_replay_resolves_lww_by_origin_timestamp(tmp_path):
    """A stale write that lost LWW in memory is still logged; replay
    resolves it by its origin timestamp, so it does not come back."""
    store = VectorStore(persist_dir=tmp_path, wal_sync="always")
    v = _vecs(2, 8)
    store.put("a", np.array([1]), v[:1], timestamp=100.0)
    store.put("a", np.array([1]), v[1:], timestamp=50.0)  # stale, dropped
    ids, _, _ = store.search("a", v[0], 1, use_cache=False)
    assert ids[0, 0] == 1
    del store

    store2 = VectorStore(persist_dir=tmp_path, wal_sync="always")
    ds = store2.get("a")
    assert ds.live_count == 1
    ids, scores, _ = store2.search("a", v[0], 1, use_cache=False)
    assert ids[0, 0] == 1 and float(scores[0, 0]) < 1e-3
    assert ds._lww[1] == 100.0


def test_replay_per_row_timestamps(tmp_path):
    store = VectorStore(persist_dir=tmp_path, wal_sync="always")
    v = _vecs(3, 8)
    store.put("a", np.array([1, 2, 1]), v, timestamp=np.array([10.0, 20.0, 5.0]))
    del store
    store2 = VectorStore(persist_dir=tmp_path, wal_sync="always")
    ds = store2.get("a")
    assert ds.live_count == 2
    assert ds._lww[1] == 10.0 and ds._lww[2] == 20.0
    ids, scores, _ = store2.search("a", v[0], 1, use_cache=False)
    assert ids[0, 0] == 1 and float(scores[0, 0]) < 1e-3


def test_wal_direct_io_backend(tmp_path):
    """O_DIRECT staging keeps every frame across syncs, partial-tail
    rewrites, reopen and truncate. Skips where the file system refuses
    O_DIRECT."""
    w = WAL(tmp_path / "d.log", sync="always", direct_io=True)
    if w.backend_name != "direct":
        w.close()
        pytest.skip("O_DIRECT unavailable on this filesystem")
    for i in range(200):  # frames straddle the 4096-byte block boundary
        w.append_op("ds", {"op": "delete", "ids": [i], "pad": "x" * 37})
    w.flush()
    assert len(list(WAL.replay(tmp_path / "d.log"))) == 200
    w.close()
    w2 = WAL(tmp_path / "d.log", sync="always", direct_io=True)
    w2.append_op("ds", {"op": "delete", "ids": [999]})
    w2.close()
    frames = list(WAL.replay(tmp_path / "d.log"))
    assert len(frames) == 201 and frames[-1][0] == 201
    w3 = WAL(tmp_path / "d.log", sync="always", direct_io=True)
    w3.truncate()
    assert w3.size_bytes == 0
    w3.append_op("ds", {"op": "delete", "ids": [1]})
    w3.close()
    assert len(list(WAL.replay(tmp_path / "d.log"))) == 1


def test_wal_direct_io_unclean_stop_keeps_synced_frames(tmp_path):
    w = WAL(tmp_path / "c.log", sync="always", direct_io=True)
    if w.backend_name != "direct":
        w.close()
        pytest.skip("O_DIRECT unavailable on this filesystem")
    for i in range(25):
        w.append_op("ds", {"op": "delete", "ids": [i]})
    w.flush()
    os.close(w._backend._fd)  # a crash: the handle dropped without close()
    w._backend._buf.close()
    assert len(list(WAL.replay(tmp_path / "c.log"))) == 25


class _FakeS3Client:
    """An in-memory S3 surface (upload_file, download_file,
    get_paginator) with fail-N-times injection and small pages."""

    def __init__(self, fail_uploads: int = 0):
        self.objects: dict[str, bytes] = {}
        self.fail_uploads = fail_uploads
        self.upload_calls = 0

    def upload_file(self, filename, bucket, key):
        self.upload_calls += 1
        if self.fail_uploads > 0:
            self.fail_uploads -= 1
            raise OSError("injected mid-upload failure")
        with open(filename, "rb") as f:
            self.objects[key] = f.read()

    def download_file(self, bucket, key, filename):
        with open(filename, "wb") as f:
            f.write(self.objects[key])

    def get_paginator(self, op):
        assert op == "list_objects_v2"
        client = self

        class _Pager:
            def paginate(self, Bucket, Prefix, Delimiter=None):
                keys = sorted(k for k in client.objects if k.startswith(Prefix))
                if Delimiter:
                    prefixes = sorted({
                        k[: len(Prefix)] + k[len(Prefix):].split(Delimiter)[0] + Delimiter
                        for k in keys if Delimiter in k[len(Prefix):]
                    })
                    for p in prefixes:
                        yield {"CommonPrefixes": [{"Prefix": p}]}
                    if not prefixes:
                        yield {}
                    return
                for i in range(0, len(keys), 2):
                    yield {"Contents": [{"Key": k} for k in keys[i: i + 2]]}
                if not keys:
                    yield {}

        return _Pager()


def test_s3_backend_upload_list_download(tmp_path):
    from longbow_tpu_torch.storage.backends import S3Backend

    be = S3Backend("bkt", prefix="lb", client=_FakeS3Client())
    src = tmp_path / "snapdir"
    (src / "sub").mkdir(parents=True)
    (src / "a.bin").write_bytes(b"alpha")
    (src / "sub" / "b.bin").write_bytes(b"beta" * 100)
    be.upload(src, "snapshot")
    be.upload(src, "snapshot-2")
    assert be.list_snapshots() == ["snapshot", "snapshot-2"]
    dst = tmp_path / "restored"
    assert be.download("snapshot", dst) is True
    assert (dst / "a.bin").read_bytes() == b"alpha"
    assert (dst / "sub" / "b.bin").read_bytes() == b"beta" * 100
    assert be.download("missing", tmp_path / "nope") is False


def test_s3_backend_retry_and_raise(tmp_path):
    from longbow_tpu_torch.metrics import get_registry
    from longbow_tpu_torch.storage.backends import S3Backend

    src = tmp_path / "d"
    src.mkdir()
    (src / "x").write_bytes(b"x")
    retries = get_registry().counter("longbow_s3_retries_total", ("operation",))
    before = retries.labels(operation="upload").value

    fake = _FakeS3Client(fail_uploads=1)
    S3Backend("bkt", client=fake).upload(src, "s")  # the retry succeeds
    assert any(k.endswith("/s/x") for k in fake.objects)
    assert retries.labels(operation="upload").value == before + 1

    fake2 = _FakeS3Client(fail_uploads=99)
    with pytest.raises(OSError):
        S3Backend("bkt", client=fake2).upload(src, "s")
    assert fake2.upload_calls == 3  # one try and two retries


def test_s3_backend_full_snapshot_restore(tmp_path):
    from longbow_tpu_torch.storage.backends import AsyncBackend, S3Backend

    fake = _FakeS3Client()
    v = _vecs(30, 8)
    store = VectorStore(persist_dir=tmp_path / "node_a", wal_sync="always",
                        snapshot_backend=AsyncBackend(S3Backend("bkt", client=fake)))
    store.put("m", np.arange(30), v)
    store.snapshot()
    store.engine.backend.wait()
    del store
    assert fake.objects, "the snapshot never reached the backend"

    store2 = VectorStore(persist_dir=tmp_path / "node_b", wal_sync="always",
                         snapshot_backend=S3Backend("bkt", client=fake))
    assert store2.get("m").live_count == 30
    ids, _, _ = store2.search("m", v[4], 1, use_cache=False)
    assert ids[0, 0] == 4


def test_wal_rotation_snapshot_crash_safety(tmp_path, monkeypatch):
    """A snapshot that fails after rotating keeps the rotated segment,
    which replays before the live log; the next snapshot covers and
    deletes it."""
    v = _vecs(40, 8)
    store = VectorStore(persist_dir=tmp_path, wal_sync="always")
    store.put("r", np.arange(20), v[:20])
    real_write = eng.write_snapshot

    def boom(*a, **kw):
        raise OSError("injected snapshot failure")

    monkeypatch.setattr(eng, "write_snapshot", boom)
    with pytest.raises(OSError):
        store.snapshot()
    pre = tmp_path / "wal.log.pre-snapshot"
    assert pre.exists(), "the rotated segment must survive the failure"
    store.put("r", np.arange(20, 40), v[20:])
    del store

    store2 = VectorStore(persist_dir=tmp_path, wal_sync="always")
    assert store2.get("r").live_count == 40
    ids, _, _ = store2.search("r", v[7], 1, use_cache=False)
    assert ids[0, 0] == 7
    ids, _, _ = store2.search("r", v[33], 1, use_cache=False)
    assert ids[0, 0] == 33

    monkeypatch.setattr(eng, "write_snapshot", real_write)
    store2.snapshot()
    assert not pre.exists()
    store2.put("r", np.arange(40, 45), _vecs(5, 8, seed=2))
    del store2
    store3 = VectorStore(persist_dir=tmp_path, wal_sync="always")
    assert store3.get("r").live_count == 45


# -- the port's own rules ------------------------------------------------------

def test_capture_copies_the_columns(tmp_path):
    """The snapshot's arrays are copies taken at capture (ADVICE.md's
    engine.py:237 fault, not copied): a write that lands in a live buffer
    after the capture, while the files are written outside the lock,
    cannot reach the snapshot."""
    store = VectorStore(persist_dir=tmp_path, wal_sync="always", dtype=torch.float32,
                        default_index_kind="flat")
    store.put("c", np.arange(20), _vecs(20, 8),
              columns={"n": np.arange(20), "s": np.array(["x", "y"] * 10)})
    ds = store.get("c")
    with ds._lock:
        blob = store.engine._export_dataset(ds)
    want = {k: v.copy() for k, v in blob["aux"].items()}
    valid = blob["index_state"]["valid"].copy()
    ds.columns._numeric["n"][:20] = -5          # writes into the live tensors
    ds.columns._str_codes["s"][:20] = 7
    ds.index.delete_rows(np.arange(10))
    for k, v in want.items():
        np.testing.assert_array_equal(blob["aux"][k], v)
    np.testing.assert_array_equal(blob["index_state"]["valid"], valid)


def test_version_1_snapshot_raises(tmp_path):
    store = VectorStore(persist_dir=tmp_path, wal_sync="always")
    store.put("s", np.arange(4), _vecs(4, 8))
    store.close()
    (tmp_path / "snapshot" / "s" / "data.parquet").write_bytes(b"PAR1")
    with pytest.raises(ValueError, match="version 1"):
        VectorStore(persist_dir=tmp_path)


def test_wal_triggered_snapshot_runs_in_the_background(tmp_path):
    store = VectorStore(persist_dir=tmp_path, wal_sync="never")
    store.engine.max_wal_bytes = 1000
    store.put("b", np.arange(100), _vecs(100, 8))  # about 4 KB of WAL
    store.engine._snap_bg.join(timeout=60)
    assert not store.engine._snap_bg.is_alive()
    assert (tmp_path / "snapshot" / "MANIFEST.json").exists()
    assert store.engine.wal.size_bytes == 0
    store.engine.close()
    assert VectorStore(persist_dir=tmp_path).get("b").live_count == 100


def test_graph_disk_edge_log_lives_beside_the_wal(tmp_path):
    """A graph_disk dataset's edges are in <persist_dir>/graphs/, and the
    restored dataset re-attaches that log: no edge is doubled by the
    WAL's add_edge frames."""
    store = VectorStore(persist_dir=tmp_path, wal_sync="always")
    store.get_or_create("g", 8, index_params={"graph_disk": True})
    store.put("g", np.arange(10), _vecs(10, 8))
    store.snapshot()
    for i in range(5):
        store.add_edge("g", i, i + 1, "next", 1.0)
    path = tmp_path / "graphs" / "g.edges"
    assert store.get("g").graph.path == path and path.exists()
    del store  # a crash: the edges are in the WAL tail and in the log
    store2 = VectorStore(persist_dir=tmp_path, wal_sync="always")
    g = store2.get("g").graph
    assert g.path == path and g.stats()["edges"] == 5
    assert store2.traverse_graph("g", 0, 5, max_hops=5) == [0, 1, 2, 3, 4, 5]
    store2.close()
    store3 = VectorStore(persist_dir=tmp_path)
    assert store3.get("g").graph.stats()["edges"] == 5


def test_block_lists_and_tensors_are_logged(tmp_path):
    """A list of blocks and a tensor are logged as one frame each, in
    their own dtype (a float16 put makes a float16 dataset again)."""
    v = _vecs(30, 8)
    store = VectorStore(persist_dir=tmp_path, wal_sync="always", dtype=torch.float32)
    store.put("a", np.arange(10), [v[:4], v[4:10]])
    store.put("a", np.arange(10, 30), torch.from_numpy(v[10:]))
    store.put("h", np.arange(5), v[:5].astype(np.float16))
    want = store.get("a").get_vectors_by_rows(np.arange(30))
    del store
    store2 = VectorStore(persist_dir=tmp_path, dtype=torch.float32)
    np.testing.assert_array_equal(store2.get("a").get_vectors_by_rows(np.arange(30)), want)
    assert store2.get("h").dtype == torch.float16
    assert [f[2] for f in WAL.replay(tmp_path / "wal.log")] == ["a", "a", "h"]
    store2.engine.close()


def test_recovery_reports_its_parts(tmp_path):
    from longbow_tpu_torch.metrics import get_registry

    store = VectorStore(persist_dir=tmp_path, wal_sync="always")
    store.put("a", np.arange(30), _vecs(30, 8))
    store.snapshot()
    store.put("a", np.arange(30, 40), _vecs(10, 8, seed=1))
    store.delete("a", [1, 2])
    del store
    store2 = VectorStore(persist_dir=tmp_path)
    st = store2.engine.recovery_stats
    assert (st["datasets"], st["frames"], st["rows_replayed"]) == (1, 2, 10)
    assert min(st["snapshot_read_s"], st["index_import_s"], st["wal_replay_s"]) >= 0
    assert get_registry().gauge("longbow_warmup_progress_percent")._only().value == 100
    store2.close()


# -- across the two packages ----------------------------------------------------

D = 16
CFG = dict(m=8, m_max=16, ef_construction=32, ef_search=48, insert_batch_size=256)
KINDS = {
    # kind: (index_params, rows, graph_disk)
    "flat": ({}, 600, True),
    "sq8": ({}, 600, False),
    "sq8r": ({"n_clusters": 4}, 600, False),
    "pq": ({"pq_m": 4, "rerank": False}, 600, False),
    "bq": ({}, 600, False),
    "ivf": ({"n_cells": 8}, 600, False),
    "disk": ({}, 600, True),
    "adaptive": ({}, 1300, True),
}


def _rows(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "adaptive":  # integer rows: exact f32 arithmetic in both
        centers = np.random.default_rng(5).integers(-20, 21, (16, D))
        return (centers[rng.integers(0, 16, n)] + rng.integers(-2, 3, (n, D))).astype(np.float32)
    centers = np.random.default_rng(5).standard_normal((12, D)).astype(np.float32) * 3
    return (centers[rng.integers(0, 12, n)] + rng.standard_normal((n, D))).astype(np.float32)


def _make(pkg, kind, path):
    params, _, graph_disk = KINDS[kind]
    params = dict(params, graph_disk=True) if graph_disk else dict(params)
    if pkg == "jax":
        store = JaxStore(persist_dir=path, wal_sync="always", migration_threshold=800,
                         hnsw_config=JaxConfig(**CFG), default_index_kind=kind,
                         default_index_params=params)
    else:
        store = VectorStore(persist_dir=path, wal_sync="always", migration_threshold=800,
                            hnsw_config=HNSWConfig(**CFG), default_index_kind=kind,
                            default_index_params=params)
    return store


def _write(pkg, kind, path, n):
    """Puts with numeric, string and text columns and LWW timestamps,
    a snapshot, then a WAL tail (more rows, an upsert, deletes, edges,
    a second dataset put and dropped); no close()."""
    store = _make(pkg, kind, path)
    v = _rows(kind, n, 1)
    first = n * 3 // 4
    cols = {
        "category": np.arange(n) % 7,
        "big": np.arange(n, dtype=np.int64) + (2**40 if kind == "flat" else 0),
        "price": np.arange(n) * 0.5,
        "tag": np.array(["red", "green", "blue"])[np.arange(n) % 3],
        "text": np.array([f"doc{i} w{i % 11} w{i % 5}" for i in range(n)]),
    }
    store.put("d", np.arange(first), v[:first], {k: c[:first] for k, c in cols.items()},
              timestamp=100.0)
    if kind == "adaptive":
        store.get("d").index.wait_migration()
    store.snapshot()
    store.put("d", np.arange(first, n), v[first:], {k: c[first:] for k, c in cols.items()},
              timestamp=np.linspace(200.0, 300.0, n - first))
    store.put("d", np.array([5]), v[6:7], {k: c[6:7] for k, c in cols.items()},
              timestamp=400.0)
    store.delete("d", [3, first + 2])
    store.get_or_create("tmp", D, index_kind="flat")
    store.put("tmp", np.arange(4), v[:4])
    store.drop("tmp")
    for i in range(6):
        store.add_edge("d", i, i + 10, "rel", 0.5 + i)
    return store, v


def _answers(store, pkg, q, kind):
    filt = JaxFilter if pkg == "jax" else Filter
    exact = {"adaptive": {"ef_search": 64}}.get(kind, {})
    out = [store.search("d", q, 10, use_cache=False, **exact)]
    out.append(store.search("d", q, 10, filters=[filt("tag", "eq", "green")],
                            use_cache=False, **exact))
    out.append(store.search("d", q, 10, filters=[filt("category", "<", "3")],
                            use_cache=False, **exact))
    return out


def _same_up_to_ties(ia, sa, ib, sb):
    """Equal scores; the ids of each group of equal scores equal as a set,
    but for the group cut at k, which may hold other members of the tie."""
    np.testing.assert_array_equal(sa, sb)
    for ra, rb, rs in zip(ia.tolist(), ib.tolist(), sa.tolist()):
        last = rs[-1]
        for val in set(rs) - {last}:
            pick = [j for j, x in enumerate(rs) if x == val]
            assert {ra[j] for j in pick} == {rb[j] for j in pick}


def _assert_same(a, b, kind):
    """The searches of _answers: the graph search (the first) on
    integer rows EQUAL; the filtered ones there take the exact route,
    whose tie order is torch.topk's in the port and the row order in
    longbow_tpu (ROADMAP.md, known differences). longbow_tpu's sq8 on
    the CPU serves its bf16 scan without a re-rank (test_torch_sq8.py):
    an overlap of 0.9 with the port's. The rest re-rank in f32."""
    for j, ((ia, sa, oa), (ib, sb, ob)) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(oa, ob)
        if kind == "adaptive" and j == 0:
            assert ia.tolist() == ib.tolist()
            np.testing.assert_array_equal(sa, sb)
        elif kind == "adaptive":
            _same_up_to_ties(ia, sa, ib, sb)
        elif kind == "sq8":
            hits = sum(len(set(x) & set(y)) for x, y in zip(ia.tolist(), ib.tolist()))
            assert hits >= 0.9 * ia.size
        else:
            np.testing.assert_allclose(sa, sb, rtol=1e-5, atol=1e-4)
            assert ia.tolist() == ib.tolist()


def _int_state(store):
    """The index state's integer and bool arrays (codes, validity,
    adjacency, cell lists), which must cross exactly."""
    st = store.get("d").index.export_state()
    return {k: np.asarray(v) for k, v in st.items()
            if isinstance(v, np.ndarray) and v.dtype.kind in "biu"}


def _state(store):
    ds = store.get("d")
    return {
        "live": ds.live_count,
        # a delete's marker takes the time of its replay (delete frames
        # carry no timestamp, in either package): compare its key only
        "lww": {k: (ts if k in ds._id_to_row else "deleted") for k, ts in ds._lww.items()},
        "row_to_id": list(ds._row_to_id),
        # every match, by id: equal scores may rank in any order
        "bm25": sorted(ds.bm25.search("w3 doc7", 10_000)),
        "edges": store.traverse_graph("d", 2, 12),
        "edge_count": ds.graph.stats()["edges"],
        "datasets": store.list_datasets(),
    }


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_persistence_crosses_packages(tmp_path, kind, writer):
    """The writer's snapshot and WAL tail, after a crash, recover in the
    other package with the answers and state of the writer's own
    package's recovery of a copy of the same directory; the other
    package's close() snapshot then recovers in the writer's package
    with those answers again.

    Recovery is held to recovery, not to the writer's live store: a
    graph that took the tail's inserts live links some rows otherwise
    than the same inserts replayed into the imported graph, in both
    packages alike."""
    import shutil

    reader = "port" if writer == "jax" else "jax"
    n = KINDS[kind][1]
    q = _rows(kind, 8, 2)
    live = tmp_path / "live"
    store, _ = _write(writer, kind, live, n)
    st = _state(store)
    assert st["live"] == n - 2 and st["datasets"] == ["d"]
    assert st["edge_count"] == 6 and st["lww"][5] == 400.0
    if kind == "adaptive":
        assert store.get("d").index.kind == "hnsw"
    del store  # a crash: the tail is only in the WAL
    shutil.copytree(live, tmp_path / "copy")

    mirror = _make(writer, kind, tmp_path / "copy")
    want, want_state, want_ints = (_answers(mirror, writer, q, kind), _state(mirror),
                                   _int_state(mirror))
    assert want_state == st
    moved = _make(reader, kind, live)
    assert moved.get("d").index.kind == ("hnsw" if kind == "adaptive" else kind)
    _assert_same(want, _answers(moved, reader, q, kind), kind)
    assert _state(moved) == want_state
    got_ints = _int_state(moved)
    assert want_ints and sorted(got_ints) == sorted(want_ints)
    for k, arr in want_ints.items():
        np.testing.assert_array_equal(got_ints[k], arr, err_msg=k)
    moved.close()  # a snapshot of the whole state, the WAL emptied

    assert (live / "wal.log").stat().st_size == 0
    back = _make(writer, kind, live)
    for (ia, sa, oa), (ib, sb, ob) in zip(want, _answers(back, writer, q, kind)):
        assert ia.tolist() == ib.tolist()
        np.testing.assert_array_equal(sa, sb)
        np.testing.assert_array_equal(oa, ob)
    assert _state(back) == want_state
    back.close()


def test_column_layout_matches_jax(tmp_path):
    """aux.npz of the same puts: the same keys and dtypes in both
    packages (int columns that fit int32 as int32, others as int64) and
    the same values; state.json equal."""
    n = 50
    cols = {
        "small": np.arange(n) - 25,
        "big": np.arange(n, dtype=np.int64) * (2**33),
        "edge": np.full(n, -(2**31), np.int64),
        "price": np.arange(n) * 0.25,
        "tag": np.array(["a", "b", "c", "d", "e"])[np.arange(n) % 5],
    }
    v = _vecs(n, 8)
    for pkg, cls in (("jax", JaxStore), ("port", VectorStore)):
        store = cls(persist_dir=tmp_path / pkg, wal_sync="always")
        store.put("c", np.arange(30), v[:30], {k: c[:30] for k, c in cols.items()},
                  timestamp=5.0)
        store.put("c", np.arange(30, n), v[30:], {k: c[30:] for k, c in cols.items()},
                  timestamp=6.0)
        store.close()
    got = {}
    for pkg in ("jax", "port"):
        with np.load(tmp_path / pkg / "snapshot" / "c" / "aux.npz") as z:
            got[pkg] = {k: z[k] for k in z.files}
    assert sorted(got["jax"]) == sorted(got["port"])
    for k, a in got["jax"].items():
        assert got["port"][k].dtype == a.dtype, k
        np.testing.assert_array_equal(got["port"][k], a)
    assert got["port"]["colnum:small"].dtype == np.int32
    assert got["port"]["colnum:big"].dtype == np.int64
    assert got["port"]["colnum:edge"].dtype == np.int64
    states = [json.loads((tmp_path / p / "snapshot" / "c" / "state.json").read_text())
              for p in ("jax", "port")]
    assert states[0] == states[1]
    metas = [json.loads((tmp_path / p / "snapshot" / "c" / "meta.json").read_text())
             for p in ("jax", "port")]
    assert metas[0] == metas[1] and metas[1]["dtype"] == "bfloat16"
    # either package's snapshot filters the big-int column exactly
    for pkg in ("jax", "port"):
        store = VectorStore(persist_dir=tmp_path / pkg)
        ids, _, ok = store.search("c", v[:1], 5, filters=[Filter("big", "eq", str(7 * 2**33))],
                                  use_cache=False)
        assert ids[ok].tolist() == [7]
        store.engine.close()
