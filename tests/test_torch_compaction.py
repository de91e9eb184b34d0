"""longbow_tpu_torch's compaction, eviction and memory backpressure
(store/compaction.py) against longbow_tpu's on the CPU.

The cases of tests/test_compaction.py that need no device mesh, run on
the port; where both packages can run a case, the reclaimed and live
rows, the capacity, the device bytes (the port's `device_bytes` against
the reference's `hbm_bytes`, on datasets whose columns are float and
string: the reference keeps int columns as int32; for sq8 the port also
counts the affine) and the search
results after the compaction are compared with longbow_tpu's: scores
to rtol 1e-5 / atol 1e-4 (both rank exactly in f32), ids equal wherever
neighbouring scores are more than 1e-4 apart.
"""
import threading
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longbow_tpu.query.parser import Filter as JaxFilter
from longbow_tpu.store import compaction as jax_comp
from longbow_tpu.store.vector_store import VectorStore as JaxStore
from longbow_tpu_torch.query.parser import Filter
from longbow_tpu_torch.store import compaction as comp
from longbow_tpu_torch.store.compaction import (
    CompactionWorker,
    EvictionManager,
    FragmentationTracker,
    MemoryBackpressureController,
    MemoryPressureError,
    compact_dataset,
)
from longbow_tpu_torch.store.vector_store import VectorStore


def _vecs(n, d, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d), dtype=np.float32)


def _port(**kw):
    return VectorStore(device="cpu", **kw)


# the two packages behind one surface, for the cases run in both
PORT = SimpleNamespace(name="port", store=_port, comp=comp, Filter=Filter,
                       nbytes=lambda ds: ds.device_bytes())
JAX = SimpleNamespace(name="jax", store=JaxStore, comp=jax_comp, Filter=JaxFilter,
                      nbytes=lambda ds: ds.hbm_bytes())


def _in_both(case):
    """case(P) for P in (port, JAX) -> the port's summary; the summaries
    must be equal."""
    got, want = case(PORT), case(JAX)
    assert got == want, (got, want)
    return got


# -- both packages, one scenario -------------------------------------------

def _scenario(store, compact, filt, kind):
    """Put 600 rows with a float and a string column, delete 360,
    compact; -> (stats, capacity, bytes, searches)."""
    v = _vecs(600, 16)
    if kind != "adaptive":
        store.get_or_create("d", 16, index_kind=kind)
    store.put("d", np.arange(600), v,
              columns={"price": np.arange(600.0), "cat": np.array(["a", "b"] * 300)})
    store.delete("d", list(range(0, 600, 5)) + list(range(1, 600, 5))
                 + list(range(2, 600, 5)))
    ds = store.get("d")
    st = compact(ds)
    nbytes = ds.device_bytes() if hasattr(ds, "device_bytes") else ds.hbm_bytes()
    q = v[[3, 4, 8, 9, 13]] + 0.01
    # sq8 at k past the scan's pool: on the CPU both packages then score
    # every code alike (below it the port re-ranks its pool in f32 and the
    # reference does not)
    k = 80 if kind == "sq8" else 10
    outs = [
        store.search("d", q, k, use_cache=False),
        store.search("d", q, k, filters=[filt("price", ">", "300")], use_cache=False),
        store.search("d", q, k, filters=[filt("cat", "=", "b")], use_cache=False),
    ]
    return st, ds.index.capacity, nbytes, len(ds.index), outs


@pytest.mark.parametrize("kind", ["adaptive", "flat", "sq8"])
def test_compaction_matches_jax(kind):
    jst, jcap, jbytes, jlen, jouts = _scenario(
        JaxStore(dtype=jnp.bfloat16), jax_comp.compact_dataset, JaxFilter, kind)
    pst, pcap, pbytes, plen, pouts = _scenario(
        _port(dtype=torch.bfloat16), compact_dataset, Filter, kind)
    for key in ("reclaimed_rows", "live_rows", "delta_upserts", "delta_deletes"):
        assert pst[key] == jst[key], key
    assert (pst["reclaimed_rows"], pst["live_rows"]) == (360, 240)
    assert (pcap, plen) == (jcap, jlen) == (jcap, 240)
    # the reference's hbm_bytes leaves an sq8 index's affine (lo, hi: two
    # f32 rows of D) out; the port counts every tensor of the index
    assert pbytes == jbytes + (2 * 16 * 4 if kind == "sq8" else 0)
    for want, got in zip(jouts, pouts):
        assert_same_results(want, got)


def assert_same_results(want, got, tie=1e-4):
    """ok masks equal, scores to rtol 1e-5 / atol 1e-4, and ids equal
    wherever a score is more than `tie` from its neighbours' (a tie's
    order depends on the f32 sums' order)."""
    (wi, ws, wok), (gi, gs, gok) = want, got
    np.testing.assert_array_equal(gok, wok)
    np.testing.assert_allclose(np.where(gok, gs, 0), np.where(wok, ws, 0),
                               rtol=1e-5, atol=1e-4)
    gap = np.full(ws.shape, np.inf)
    step = np.abs(np.diff(ws, axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    sure = (gap > tie) & wok
    np.testing.assert_array_equal(gi[sure], wi[sure])
    assert sure.mean() > 0.9


def test_sq8_codes_survive_compaction_and_equal_jax():
    """The affine is carried into the rebuilt index, so each live row's
    int8 codes are bit for bit the ones it had, and the ones JAX's
    compaction leaves."""
    v = _vecs(3000, 16, seed=3)
    codes = {}
    for name, store, compact in (("port", _port(), compact_dataset),
                                 ("jax", JaxStore(), jax_comp.compact_dataset)):
        store.get_or_create("s", 16, index_kind="sq8")
        store.put("s", np.arange(3000), v)
        ds = store.get("s")
        before = np.asarray(ds.index._inner.codes)[[ds._id_to_row[u] for u in range(2000, 3000)]]
        store.delete("s", list(range(2000)))
        compact(ds)
        after = np.asarray(ds.index._inner.codes)[[ds._id_to_row[u] for u in range(2000, 3000)]]
        np.testing.assert_array_equal(after, before)
        codes[name] = after.astype(np.int16) + (128 if after.dtype == np.uint8 else 0)
    np.testing.assert_array_equal(codes["port"], codes["jax"])


def test_sq8r_compaction_keeps_its_clusters():
    """A reference fault not copied: longbow_tpu carries the residual
    affine of an sq8r index into the rebuilt one without its cluster
    centres, so the first add after a compaction raises. The port carries
    the centres too; the codes of the live rows stay the same."""
    store = _port()
    v = _vecs(3000, 16, seed=4)
    store.get_or_create("r", 16, index_kind="sq8r")
    store.put("r", np.arange(3000), v)
    ds = store.get("r")
    inner = ds.index._inner
    centers = inner.centers.clone()
    before = inner.get_vectors(np.asarray([ds._id_to_row[u] for u in range(2000, 3000)]))
    store.delete("r", list(range(2000)))
    st = compact_dataset(ds)
    assert (st["reclaimed_rows"], st["live_rows"]) == (2000, 1000)
    inner = ds.index._inner
    assert torch.equal(inner.centers, centers)
    after = inner.get_vectors(np.asarray([ds._id_to_row[u] for u in range(2000, 3000)]))
    np.testing.assert_array_equal(after, before)
    ids, _, _ = store.search("r", v[2500], 1, use_cache=False)
    assert ids[0, 0] == 2500


# -- tests/test_compaction.py, on the port (and in both packages where a
# case compacts) -----------------------------------------------------------

def test_compaction_reclaims_tombstones():
    def case(P):
        vs = P.store()
        v = _vecs(100, 8)
        vs.put("d", np.arange(100), v, columns={"price": np.arange(100.0),
                                                "cat": np.array(["a", "b"] * 50)})
        vs.delete("d", list(range(0, 60)))
        ds = vs.get("d")
        assert P.comp.FragmentationTracker().needs_compaction(ds)
        st = P.comp.compact_dataset(ds)
        assert st["reclaimed_rows"] == 60
        assert st["live_rows"] == 40
        assert len(ds.index) == 40
        ids, _, ok = ds.search(v[75][None], 1)
        assert ids[0, 0] == 75
        f_ids, _, ok = ds.search(v[75][None], 3, filters=[P.Filter("price", ">", "70")])
        assert all(i > 70 for i in f_ids[0] if i is not None)
        c_ids, _, ok = ds.search(v[75][None], 3, filters=[P.Filter("cat", "=", "b")])
        assert all(int(i) % 2 == 1 for i in c_ids[0] if i is not None)
        return (st["reclaimed_rows"], st["live_rows"], ds.index.capacity, P.nbytes(ds),
                f_ids.tolist(), c_ids.tolist())

    _in_both(case)


def test_compaction_gathers_on_the_device_and_frees_capacity():
    """The live rows reach the new index as a tensor (get_vectors_device),
    and the capacity halves when the live rows fit half of it."""
    vs = _port(default_index_kind="flat")
    v = _vecs(9000, 8)
    vs.put("d", np.arange(9000), v)
    ds = vs.get("d")
    cap, nbytes = ds.index.capacity, ds.device_bytes()
    fed = []
    orig = comp._fresh_index

    def spy(dataset):
        idx = orig(dataset)
        add = idx.add
        idx.add = lambda vecs: (fed.append(type(vecs)), add(vecs))[1]
        return idx

    comp._fresh_index = spy
    try:
        vs.delete("d", list(range(6000)))
        compact_dataset(ds)
    finally:
        comp._fresh_index = orig
    assert fed == [torch.Tensor]
    assert (cap, ds.index.capacity) == (16384, 4096)
    assert ds.device_bytes() == nbytes // 4


def test_ttl_eviction():
    vs = _port()
    vs.put("d", np.arange(20), _vecs(20, 8))
    ds = vs.get("d")
    for uid in range(10):
        ds._lww[uid] = time.time() - 100
    assert EvictionManager(ttl_s=50).sweep(ds) == 10
    assert ds.live_count == 10


def test_lru_eviction_to_max_rows():
    vs = _port()
    vs.put("d", np.arange(30), _vecs(30, 8))
    ds = vs.get("d")
    ev = EvictionManager(policy="lru", max_rows=20)
    ev.record_access(range(10, 30))  # 0-9 cold
    assert ev.sweep(ds) == 10
    assert ds.live_count == 20
    assert all(uid in ds._id_to_row for uid in range(10, 30))


def test_lfu_eviction():
    vs = _port()
    vs.put("d", np.arange(10), _vecs(10, 8))
    ds = vs.get("d")
    ev = EvictionManager(policy="lfu", max_rows=8)
    for _ in range(5):
        ev.record_access(range(2, 10))
    ev.record_access([0, 1])
    assert ev.sweep(ds) == 2
    assert 0 not in ds._id_to_row and 1 not in ds._id_to_row


def test_store_searches_feed_the_eviction_manager():
    vs = _port()
    v = _vecs(40, 8)
    vs.put("d", np.arange(40), v)
    vs.eviction = ev = EvictionManager(policy="lru", max_rows=30)
    vs.search("d", v[:5], 1)
    vs.search("d", v[:5], 1)  # a cache hit is a read too
    assert ev._freq == {0: 2, 1: 2, 2: 2, 3: 2, 4: 2}


def test_compaction_worker_run_once():
    def case(P):
        vs = P.store()
        vs.put("a", np.arange(50), _vecs(50, 8))
        vs.delete("a", list(range(30)))
        w = P.comp.CompactionWorker(vs, frag_threshold=0.3)
        first = w.run_once()["a"]
        assert first["compacted"]["live_rows"] == 20
        assert w.run_once()["a"]["compacted"] is None
        ds = vs.get("a")
        st = first["compacted"]
        return (st["reclaimed_rows"], st["live_rows"], first["evicted"], first["fragmentation"],
                ds.index.capacity, P.nbytes(ds))

    _in_both(case)


def test_compaction_of_quantized_dataset():
    """pq compacts through the dataset's construction params and keeps
    its trained codebooks."""
    vs = _port()
    v = _vecs(600, 16)
    vs.get_or_create("q", 16, index_kind="pq", index_params={"pq_m": 4})
    vs.put("q", np.arange(600), v)
    books = vs.get("q").index._inner.codebooks.clone()
    vs.delete("q", list(range(300)))
    stats = compact_dataset(vs.get("q"))
    assert stats["live_rows"] == 300 and stats["reclaimed_rows"] == 300
    ds = vs.get("q")
    assert ds.index.kind == "pq" and len(ds.index) == 300
    assert torch.equal(ds.index._inner.codebooks, books)
    ids, _, _ = vs.search("q", v[450], 1, use_cache=False)
    assert ids[0, 0] == 450


def test_compaction_worker_handles_quantized():
    def case(P):
        vs = P.store()
        vs.get_or_create("s", 8, index_kind="sq8")
        vs.put("s", np.arange(50), _vecs(50, 8))
        vs.delete("s", list(range(30)))
        st = P.comp.CompactionWorker(vs, frag_threshold=0.3).run_once()["s"]["compacted"]
        assert st["live_rows"] == 20
        ds = vs.get("s")
        # the port also counts the sq8 affine: two f32 rows of D
        extra = 2 * 8 * 4 if P is PORT else 0
        return st["reclaimed_rows"], st["live_rows"], ds.index.capacity, P.nbytes(ds) - extra

    _in_both(case)


def test_memory_backpressure():
    """The soft limit evicts the coldest rows to the target; the hard
    limit rejects writes."""
    def case(P):
        vs = P.store()
        v = _vecs(12000, 16)
        vs.put("big", np.arange(12000), v, timestamp=100.0)
        vs.put("big", np.arange(10000, 12000), v[10000:], timestamp=200.0)  # hot tail
        used = P.nbytes(vs.get("big"))
        ctrl = P.comp.MemoryBackpressureController(soft_bytes=int(used * 0.7), batch_rows=2048)
        vs.backpressure = ctrl
        evicted = ctrl.enforce(vs)
        assert evicted > 0
        assert ctrl.total_bytes(vs) <= int(used * 0.7)
        live = vs.get("big")._id_to_row
        assert 11999 in live and 0 not in live
        vs.backpressure = hard = P.comp.MemoryBackpressureController(hard_bytes=1)
        with pytest.raises(P.comp.MemoryPressureError):
            vs.put("big", [99999], _vecs(1, 16))
        assert hard.rejected_total == 1
        assert 99999 not in vs.get("big")._id_to_row
        return used, evicted, ctrl.total_bytes(vs), sorted(live)

    _in_both(case)


def test_backpressure_evicts_least_recently_read_with_an_eviction_manager():
    vs = _port()
    v = _vecs(9000, 8)
    vs.put("d", np.arange(9000), v)
    ev = EvictionManager()
    vs.eviction = ev
    ev.record_access(range(4000, 9000))
    ev.record_access(range(4000))  # read later: the first 4,000 are the warmest
    ctrl = MemoryBackpressureController(soft_bytes=vs.get("d").device_bytes() // 2,
                                        eviction=ev)
    assert ctrl.enforce(vs) >= 1000
    live = vs.get("d")._id_to_row
    assert all(u in live for u in range(4000)) and 4000 not in live


def test_dataset_ttl_drops_idle_datasets():
    store = _port()
    v = _vecs(10, 8)
    store.put("stale", np.arange(10), v)
    store.put("fresh", np.arange(10), v)
    w = CompactionWorker(store, dataset_ttl_s=0.5)
    time.sleep(0.7)
    store.search("fresh", v[0], 1, use_cache=False)  # touches fresh
    w.run_once()
    assert store.list_datasets() == ["fresh"]


def test_upsert_clears_stale_row_slot_for_sparse_filters():
    store = _port()
    v = _vecs(10, 8)
    store.put("up", np.arange(10), v, columns={"color": np.asarray(["red"] * 10)})
    ds = store.get("up")
    old_row = ds._id_to_row[3]
    store.put("up", np.asarray([3]), v[3:4], columns={"color": np.asarray(["blue"])})
    assert ds.row_ids_array()[old_row] is None
    ids, _, ok = store.search("up", v[3], 10, filters=[Filter("color", "=", "red")],
                              use_cache=False)
    assert 3 not in [i for i in ids[0] if i is not None]


def test_compaction_reclaims_fully_deleted_dataset():
    def case(P):
        store = P.store()
        store.put("gone", np.arange(40_000), _vecs(40_000, 16))
        ds = store.get("gone")
        before = P.nbytes(ds)
        store.delete("gone", list(range(40_000)))
        out = P.comp.compact_dataset(ds)
        assert out["reclaimed_rows"] == 40_000
        assert P.nbytes(ds) < before
        assert len(ds.index) == 0
        again = P.comp.compact_dataset(ds)["reclaimed_rows"]
        assert again == 0  # a no-op, not a re-trigger
        return before, P.nbytes(ds), ds.index.capacity

    _in_both(case)


# ---- the rebuild runs outside the dataset lock ----

def _slow_build_hook(monkeypatch, in_build, release, module=comp):
    """Park the compaction's first bulk add on `release` after signalling
    `in_build` (the reconcile's add runs normally)."""
    orig_fresh = module._fresh_index

    def slow_fresh(dataset):
        idx = orig_fresh(dataset)
        orig_add = idx.add
        state = {"first": True}

        def add(vecs):
            if state["first"]:
                state["first"] = False
                in_build.set()
                assert release.wait(30), "test never released the build"
            return orig_add(vecs)

        idx.add = add
        return idx

    monkeypatch.setattr(module, "_fresh_index", slow_fresh)


def test_compaction_does_not_block_serving(monkeypatch):
    def case(P):
        vs = P.store()
        v = _vecs(3000, 16)
        vs.put("c", np.arange(3000), v)
        vs.delete("c", list(range(1500)))
        ds = vs.get("c")
        in_build, release = threading.Event(), threading.Event()
        _slow_build_hook(monkeypatch, in_build, release, P.comp)
        out = {}
        t = threading.Thread(target=lambda: out.update(P.comp.compact_dataset(ds)))
        t.start()
        assert in_build.wait(30)
        t0 = time.time()
        ids, _, ok = ds.search(v[2000][None], 1)
        assert ids[0, 0] == 2000
        ds.put(np.array([99_001]), _vecs(1, 16, seed=9))
        assert time.time() - t0 < 5.0
        release.set()
        t.join(timeout=120)
        assert not t.is_alive()
        assert 99_001 in ds._id_to_row
        assert out["live_rows"] == 1501
        out.pop("seconds")
        return out, ds.index.capacity, P.nbytes(ds)

    _in_both(case)


def test_compaction_reconciles_concurrent_mutations(monkeypatch):
    def case(P):
        vs = P.store()
        v = _vecs(500, 16)
        vs.put("r", np.arange(500), v, columns={"tag": np.array(["old"] * 500)})
        vs.delete("r", list(range(0, 250)))
        ds = vs.get("r")
        in_build, release = threading.Event(), threading.Event()
        _slow_build_hook(monkeypatch, in_build, release, P.comp)
        out = {}
        t = threading.Thread(target=lambda: out.update(P.comp.compact_dataset(ds)))
        t.start()
        assert in_build.wait(30)
        new_vec = _vecs(1, 16, seed=42)
        ds.put(np.array([300]), new_vec, columns={"tag": np.array(["new"])})
        ds.put(np.array([777]), _vecs(1, 16, seed=7))
        ds.delete(np.array([301]))
        release.set()
        t.join(timeout=120)
        assert not t.is_alive()
        assert out["delta_upserts"] == 2
        assert out["delta_deletes"] >= 2
        ids, dist, ok = ds.search(new_vec, 1)
        assert ids[0, 0] == 300 and dist[0, 0] < 1e-3
        tag_ids, _, tag_ok = ds.search(new_vec, 5, filters=[P.Filter("tag", "=", "new")])
        assert tag_ids[0, 0] == 300
        assert 777 in ds._id_to_row
        assert 301 not in ds._id_to_row
        near, _, ok = ds.search(v[301][None], 1)
        assert near[0, 0] != 301
        for uid, row in ds._id_to_row.items():
            assert ds.row_ids_array()[row] == uid
        out.pop("seconds")
        return out, sorted(ds._id_to_row), tag_ids[tag_ok].tolist(), near.tolist()

    _in_both(case)


def test_fragmentation_ratio_not_torn_by_ingest():
    vs = _port()
    vs.put("t", np.arange(100), _vecs(100, 16))
    ds = vs.get("t")
    tracker = FragmentationTracker()
    stop = threading.Event()
    fired = []

    def poll():
        while not stop.is_set():
            if tracker.needs_compaction(ds):
                fired.append(tracker.ratio(ds))

    th = threading.Thread(target=poll)
    th.start()
    base = 100
    try:
        for _ in range(60):
            ds.put(np.arange(base, base + 2000), _vecs(2000, 16, seed=base))
            base += 2000
    finally:
        stop.set()
        th.join(timeout=10)
    assert not fired, f"spurious compaction triggers mid-ingest: {fired}"
