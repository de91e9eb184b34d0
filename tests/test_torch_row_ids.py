"""The port's search answer, rows to user ids, against a plain per-hit
reference; the row -> id map it is gathered from, written by puts and
deletes and installed whole only by a compaction or a snapshot's load,
always the exact inverse of the id -> row map; and the snapshot layout of
a dataset's ids (Dataset.export_ids / import_ids)."""
import json

import numpy as np
import pytest
import torch

from longbow_tpu_torch.ops.distance import MASKED_GUARD, Metric
from longbow_tpu_torch.query.parser import Filter
from longbow_tpu_torch.store.compaction import compact_dataset
from longbow_tpu_torch.store.vector_store import VectorStore

D = 16


def _ids_of(id_kind):
    if id_kind == "int":
        return lambda n: np.asarray(n, np.int64)
    return lambda n: np.array([f"doc-{x}" for x in n], dtype=object)


def _reference(ds, d, r):
    """The answer one hit at a time: a row that is in range and holds an id
    (read after the index search, from the id -> row map) answers with that
    id, every other slot with None and not ok."""
    r2i = {row: uid for uid, row in ds._id_to_row.items()}
    ids = np.empty(r.shape, dtype=object)
    ok = np.zeros(r.shape, dtype=bool)
    for b in range(r.shape[0]):
        for j in range(r.shape[1]):
            row = int(r[b, j])
            if d[b, j] < MASKED_GUARD and row in r2i:
                ids[b, j] = r2i[row]
                ok[b, j] = True
    return ids, (-d if ds.metric == Metric.DOT else d), ok


def _assert_same(got, want):
    (gi, gs, gok), (wi, ws, wok) = got, want
    np.testing.assert_array_equal(gok, wok)
    np.testing.assert_array_equal(gs, ws)
    assert gi.dtype == object and gi.shape == wi.shape
    for g, w in zip(gi.ravel().tolist(), wi.ravel().tolist()):
        assert type(g) is type(w) and g == w
    assert all(x is None for x in gi[~gok])


def _recording(monkeypatch, ds, before_return=None):
    """Wraps the index's search: records each (d, r) it returns, after
    calling `before_return(r)`."""
    seen = []
    search = ds.index.search

    def recorded(*a, **kw):
        d, r = search(*a, **kw)
        if before_return is not None:
            before_return(np.asarray(r))
        seen.append((np.asarray(d).copy(), np.asarray(r).copy()))
        return d, r

    monkeypatch.setattr(ds.index, "search", recorded)
    return seen


@pytest.mark.parametrize("kind", ["flat", "sq8r"])
@pytest.mark.parametrize("id_kind", ["int", "str"])
def test_answer_matches_per_hit_reference(monkeypatch, id_kind, kind):
    ids_of = _ids_of(id_kind)
    rng = np.random.default_rng(11)
    v = rng.standard_normal((1500, D), dtype=np.float32)
    n = np.arange(1500)
    store = VectorStore(device="cpu", dtype=torch.float32)
    store.get_or_create("a", D, index_kind=kind)
    store.put("a", ids_of(n), v, {"n": n % 500})
    store.delete("a", ids_of(np.arange(0, 1500, 9)))  # deleted rows
    store.put("a", ids_of(np.arange(100, 140)), v[200:240])  # upserts tombstone 40 rows
    ds = store.get("a")
    q = v[:6] + 0.01
    seen = _recording(monkeypatch, ds)
    cases = [
        (q, 10, None),
        (v[100:104], 10, None),  # queries near upserted and tombstoned rows
        (q, 10, [Filter("n", "eq", "7")]),  # 3 rows left: fewer than k hits
        (q, 300, None),
    ]
    for queries, k, filters in cases:
        got = ds.search(queries, k, filters=filters)
        _assert_same(got, _reference(ds, *seen[-1]))
    assert seen[2][1].shape == (6, 10)
    assert (~_reference(ds, *seen[2])[2]).any(axis=1).all()  # each query short of k

    # a row deleted after the index search, before the answer, is not ok
    monkeypatch.undo()
    gone = []

    def delete_first_hit(r):
        uid = ds.row_ids_array()[int(r[0, 0])]
        gone.append(uid)
        ds.delete(np.asarray([uid], dtype=object if id_kind == "str" else np.int64))

    seen = _recording(monkeypatch, ds, delete_first_hit)
    ids, scores, ok = got = ds.search(q, 10)
    assert not ok[0, 0] and ids[0, 0] is None and gone[0] not in ds._id_to_row
    _assert_same(got, _reference(ds, *seen[-1]))


def _assert_mirror(ds):
    """The row -> id map is the exact inverse of the id -> row map: each
    live id at its row, `live` exactly there, None elsewhere, nothing past
    `n`, and `n` the index's rows."""
    m, i2r = ds._rows, ds._id_to_row
    assert m.n == len(ds.index)
    want = [None] * m.n
    for uid, row in i2r.items():
        want[row] = uid
    arr = ds.row_ids_array()
    assert arr.dtype == object and len(arr) == m.n
    got = arr.tolist()
    assert got == want and all(type(g) is type(w) for g, w in zip(got, want))
    np.testing.assert_array_equal(m.live[: m.n], [u is not None for u in want])
    assert int(m.live.sum()) == len(i2r)
    assert not m.live[m.n:].any() and all(x is None for x in m.ids[m.n:])


@pytest.mark.parametrize("id_kind", ["int", "str"])
def test_mirror_follows_the_row_map(tmp_path, id_kind):
    ids_of = _ids_of(id_kind)
    rng = np.random.default_rng(5)
    v = rng.standard_normal((400, D), dtype=np.float32)
    store = VectorStore(device="cpu", persist_dir=tmp_path, wal_sync="always")
    store.get_or_create("a", D, index_kind="flat")
    ds = store.get("a")
    m0 = ds._rows
    store.put("a", ids_of(range(10)), v[:10])
    cap = len(ds._rows.ids)
    store.put("a", ids_of(range(10, 20)), v[10:20])  # past its capacity: doubled
    assert cap < 20 and len(ds._rows.ids) == 2 * cap
    store.put("a", ids_of(range(20, 200)), v[20:200])
    _assert_mirror(ds)
    store.delete("a", ids_of(range(0, 200, 3)))
    store.put("a", ids_of(range(150, 250)), v[150:250])  # upserts and new rows
    _assert_mirror(ds)
    for i in range(100):
        store.search("a", v[i % 50: i % 50 + 2], 5, use_cache=False)
    store.put("a", ids_of(range(250, 300)), v[250:300])
    store.delete("a", ids_of(range(250, 260)))
    _assert_mirror(ds)
    assert ds._rows is m0  # searches, puts and deletes write the one map

    compact_dataset(ds)
    m1 = ds._rows
    assert m1 is not m0  # installed whole, once
    _assert_mirror(ds)
    for i in range(100):
        store.search("a", v[i: i + 2], 5, use_cache=False)
    store.put("a", ids_of(range(300, 320)), v[300:320])
    store.delete("a", ids_of(range(300, 305)))
    _assert_mirror(ds)
    assert ds._rows is m1
    live = sorted(ds._id_to_row, key=str)

    store.close()  # a snapshot, then the WAL closed
    store2 = VectorStore(device="cpu", persist_dir=tmp_path, wal_sync="always")
    ds2 = store2.get("a")
    _assert_mirror(ds2)
    m2 = ds2._rows
    for i in range(100):
        ids, _, ok = store2.search("a", v[i: i + 2], 5, use_cache=False)
        assert all(u in ds2._id_to_row for u in ids[ok])
    assert sorted(ds2._id_to_row, key=str) == live
    store2.put("a", ids_of(range(320, 330)), v[320:330])
    store2.delete("a", ids_of(range(320, 322)))
    _assert_mirror(ds2)
    assert ds2._rows is m2
    store2.close()


def test_mirror_under_concurrent_puts_deletes_and_searches():
    """More threads than cores put, upsert, delete and search one dataset
    with a short switch interval: every answer's ok slots hold ids that
    were put, and once all are done the mirror equals the row map."""
    import os
    import sys
    import threading

    store = VectorStore(device="cpu", dtype=torch.float32)
    store.get_or_create("a", D, index_kind="flat")
    ds = store.get("a")
    rng = np.random.default_rng(9)
    v = rng.standard_normal((64, D), dtype=np.float32)
    store.put("a", np.arange(64), v)
    n_writers = os.cpu_count() or 4
    bad: list = []
    stop = threading.Event()

    def writer(w):
        for i in range(40):
            base = 1000 * (w + 1) + 10 * i
            store.put("a", np.arange(base, base + 10), v[i % 50: i % 50 + 10])
            store.put("a", np.arange(base, base + 3), v[:3])  # upserts
            store.delete("a", np.arange(base + 5, base + 8))

    def searcher():
        while not stop.is_set():
            ids, _, ok = ds.search(v[:4], 8)
            if any(u is None or not 0 <= u < 1000 * (n_writers + 1) for u in ids[ok]):
                bad.append(ids)
            if any(u is not None for u in ids[~ok]):
                bad.append(ids)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        writers = [threading.Thread(target=writer, args=(w,)) for w in range(n_writers)]
        searchers = [threading.Thread(target=searcher) for _ in range(2)]
        for t in writers + searchers:
            t.start()
        for t in writers:
            t.join(timeout=120)
        stop.set()
        for t in searchers:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in writers + searchers)
    assert not bad
    _assert_mirror(ds)
    assert len(ds._id_to_row) == 64 + n_writers * 40 * 7


# a dataset's id keys in state.json, as the snapshot layout before
# Dataset.export_ids wrote them (row_to_id, then lww) after _id_scenario's
# writes: int ids after deletes and upserts; string ids after a
# compaction and later writes; int ids, every row deleted, then compacted
# (an empty index, recovered through get_or_create and the lww map alone)
WRITTEN_IDS = {
    "int": '{"row_to_id": [0, null, null, 3, null, 5, 6, null, 8, null, 10, 11, 2, 7, 20], '
           '"lww": [[0, 100.5], [1, 200.25], [2, 300.0], [3, 103.5], [4, 200.25], '
           '[5, 105.5], [6, 106.5], [7, 300.0], [8, 108.5], [9, 200.25], [10, 110.5], '
           '[11, 111.5], [20, 300.0]]}',
    "str-compacted": '{"row_to_id": ["doc-0", "doc-2", null, null, "doc-6", "doc-7", '
                     '"doc-8", "doc-10", "doc-11", "doc-20", "doc-21", "doc-3"], '
                     '"lww": [["doc-0", 100.5], ["doc-1", 200.25], ["doc-2", 300.0], '
                     '["doc-3", 400.0], ["doc-4", 200.25], ["doc-5", 401.0], '
                     '["doc-6", 106.5], ["doc-7", 300.0], ["doc-8", 108.5], '
                     '["doc-9", 200.25], ["doc-10", 110.5], ["doc-11", 111.5], '
                     '["doc-20", 300.0], ["doc-21", 400.0]]}',
    "emptied": '{"row_to_id": [], "lww": [[1, 60.0]]}',
}


def _id_scenario(store, case):
    ids_of = _ids_of("str" if case.startswith("str") else "int")
    v = np.random.default_rng(3).standard_normal((40, 8), dtype=np.float32)
    store.get_or_create("a", 8, index_kind="flat")
    if case == "emptied":
        store.put("a", ids_of([1]), v[:1], timestamp=50.0)
        store.delete("a", ids_of([1]), timestamp=60.0)
        compact_dataset(store.get("a"))
        return
    store.put("a", ids_of(range(12)), v[:12], timestamp=np.arange(12, dtype=np.float64) + 100.5)
    store.delete("a", ids_of([1, 4, 9]), timestamp=200.25)
    store.put("a", ids_of([2, 7, 20]), v[20:23], timestamp=300.0)
    if case == "str-compacted":
        compact_dataset(store.get("a"))
        store.put("a", ids_of([21, 3]), v[23:25], timestamp=400.0)
        store.delete("a", ids_of([5]), timestamp=401.0)


@pytest.mark.parametrize("case", sorted(WRITTEN_IDS))
def test_snapshot_ids_keep_their_layout(tmp_path, case):
    """A snapshot's id keys are written as before, load into the id maps
    and LWW map they were written from (the id -> row map in row order,
    the row -> id map its exact inverse), and export back byte for byte."""
    written = WRITTEN_IDS[case]
    js = json.loads(written)
    store = VectorStore(device="cpu", persist_dir=tmp_path, wal_sync="always")
    _id_scenario(store, case)
    assert json.dumps(store.get("a").export_ids()) == written
    store.close()
    state = tmp_path / "snapshot" / "a" / "state.json"
    first = state.read_bytes()
    on_disk = json.loads(first)
    assert json.dumps({k: on_disk[k] for k in ("row_to_id", "lww")}) == written

    store2 = VectorStore(device="cpu", persist_dir=tmp_path, wal_sync="always")
    ds = store2.get("a")
    want = [(uid, r) for r, uid in enumerate(js["row_to_id"]) if uid is not None]
    assert list(ds._id_to_row.items()) == want
    assert ds.row_ids_array().tolist() == js["row_to_id"]
    assert list(ds._lww.items()) == [tuple(p) for p in js["lww"]]
    if js["row_to_id"]:
        _assert_mirror(ds)
    assert json.dumps(ds.export_ids()) == written
    store2.close()
    assert state.read_bytes() == first
