"""longbow_tpu_torch.index.adaptive.AdaptiveIndex and index.hardness
against longbow_tpu's on the CPU: the hardness probe, the migration from
the flat tier to the graph in the background with puts and searches from
a second thread, parity of the migrated state on lattice rows (EQUAL
adjacency and results), state carried across both ways, and a migration
that fails.
"""
import logging
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longbow_tpu.index import hardness as jhard
from longbow_tpu.index.adaptive import AdaptiveIndex as JaxAdaptive
from longbow_tpu.index.hnsw import HNSWConfig as JaxConfig
from longbow_tpu_torch.index import hardness as thard
from longbow_tpu_torch.index.adaptive import AdaptiveIndex
from longbow_tpu_torch.index.factory import import_index, make_index
from longbow_tpu_torch.index.hnsw import HNSWConfig, HNSWIndex
from longbow_tpu_torch.ops._kernels import KernelError
from longbow_tpu_torch.store.vector_store import VectorStore
from test_torch_graph import gaussian, lattice
from test_torch_hnsw import assert_same, assert_states_equal, recall

D = 16
CFG = dict(m=8, m_max=16, ef_construction=32, ef_search=48, insert_batch_size=256)


def uniform(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def clustered_lattice(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.integers(-20, 21, (16, d))
    return (centers[rng.integers(0, 16, n)] + rng.integers(-2, 3, (n, d))).astype(np.float32)


@pytest.mark.parametrize("kind", ["clustered", "uniform"])
def test_relative_contrast_matches_jax(kind):
    """On integer rows, where a query's distance to its own copy in the
    sample is exactly 0 in both packages. On real-valued rows that
    distance is rounding noise around 0, the probe's cut-off (1e-9 of the
    mean) lies below the noise, and which copies count as neighbours
    differs from one matmul to the next (0.3% of the contrast here)."""
    data = clustered_lattice(4096, D, 70) if kind == "clustered" else lattice(4096, 64, 71)
    for count in (4096, 3000):
        want = jhard.relative_contrast(jnp.asarray(data), count)
        got = thard.relative_contrast(torch.from_numpy(data), count)
        assert got == pytest.approx(want, abs=1e-4, rel=1e-5)
    assert (got < thard.DEFAULT_MIN_CONTRAST) == (kind == "uniform")
    assert thard.relative_contrast(torch.from_numpy(data), 1000) == float("inf")
    db, q = thard.sample_for_contrast(torch.from_numpy(data), 3000)
    jdb, jq = jhard.sample_for_contrast(jnp.asarray(data), 3000)
    np.testing.assert_array_equal(db.numpy(), np.asarray(jdb))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_uniform_data_stays_flat():
    idx = AdaptiveIndex(64, migration_threshold=2000, hnsw_config=HNSWConfig(**CFG),
                        device="cpu")
    data = uniform(5000, 64, 72)
    idx.add(data[:2500])
    assert idx.wait_migration() is False and idx.kind == "flat"
    assert idx.last_contrast < 2.0 and idx.migration_error is None
    idx.add(data[2500:4000])  # below the next doubling: no second probe
    assert idx._contrast_checked_at == 2500
    idx.add(data[4000:])      # 5000 rows: probed again, still flat
    assert idx.wait_migration() is False and idx._contrast_checked_at == 5000
    _, r = idx.search(data[:4], 1)
    assert (r[:, 0] == np.arange(4)).all()


def test_migrated_state_matches_jax_on_lattice():
    data, q = lattice(3000, D, 73), lattice(16, D, 74)
    ji = JaxAdaptive(D, migration_threshold=1500, hnsw_config=JaxConfig(**CFG),
                     min_contrast=0)
    ti = AdaptiveIndex(D, migration_threshold=1500, hnsw_config=HNSWConfig(**CFG),
                       min_contrast=0, device="cpu")
    for idx in (ji, ti):
        idx.add(data[:1000])
        assert idx.kind == "flat"
        idx.delete_rows(np.array([3, 4]))
        idx.add([data[1000:1400], data[1400:2000]])  # a list of blocks crosses the threshold
        assert idx.wait_migration() and idx.kind == "hnsw"
        idx.add(data[2000:])  # the graph's incremental route
        idx.delete_rows(np.array([2500]))
    assert len(ti) == 3000 and ti.capacity == ji.capacity
    assert_states_equal(ji._graph, ti._graph)
    assert_same(ji.search(q, 10), ti.search(q, 10), exact=True)
    te = ti.search(q, 10, exact=True)
    # the exact scan's ties come in any order: the distances are equal
    np.testing.assert_array_equal(np.asarray(ji.search(q, 10, exact=True)[0]), te[0])
    assert not np.isin(te[1], [3, 4, 2500]).any()
    mask = np.arange(ti.capacity) % 3 == 0
    assert_same(ji.search(q, 10, filter_mask=jnp.asarray(mask), ef_search=64),
                ti.search(q, 10, filter_mask=mask, ef_search=64), exact=True)
    np.testing.assert_array_equal(ti.get_vectors(np.array([7, 2999])), data[[7, 2999]])
    assert torch.equal(ti.get_vectors_device(np.array([7])), torch.from_numpy(data[[7]]))


def test_background_migration_with_puts_and_searches_from_a_second_thread():
    data = gaussian(4096, D, 75)
    idx = AdaptiveIndex(D, migration_threshold=1024, hnsw_config=HNSWConfig(**CFG),
                        device="cpu")
    errors, done, kinds = [], threading.Event(), set()

    def reader():
        try:
            while not done.is_set():
                n = len(idx)
                if n < 8:
                    continue
                kinds.add(idx.kind)
                _, r = idx.search(data[:8], 3)
                # every row acknowledged before the search began is served
                assert (r[:, 0] == np.arange(8)).all(), (idx.kind, r[:, 0])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    readers = [threading.Thread(target=reader) for _ in range(3)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)  # switch threads often: a torn state would show
    try:
        for t in readers:
            t.start()
        acked = []
        for off in range(0, 4096, 256):
            acked.append(idx.add(data[off:off + 256]))
            if off == 1536:
                idx.delete_rows(np.array([100, 1500]))  # lands while the migration runs
        assert idx.wait_migration(120.0)
        idx.add(data[:64] + 0.25)  # after the swap: straight into the graph
    finally:
        done.set()
        for t in readers:
            t.join(60.0)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in readers)
    assert not errors, errors
    assert idx.kind == "hnsw" and idx.migration_error is None and kinds >= {"hnsw"}
    np.testing.assert_array_equal(np.concatenate(acked), np.arange(4096))  # row ids kept
    assert len(idx) == 4096 + 64 and idx.last_contrast > 2.0
    q = gaussian(32, D, 76)
    got = idx.search(q, 10, ef_search=64)[1]
    want = idx.search(q, 10, exact=True)[1]
    assert recall(got, want) >= 0.9
    assert not np.isin(got, [100, 1500]).any() and not np.isin(want, [100, 1500]).any()
    _, r = idx.search(data[4000:4008], 1)  # rows put during the build were caught up
    assert (r[:, 0] == np.arange(4000, 4008)).all()


def test_a_failing_migration_leaves_the_flat_tier_serving(monkeypatch, caplog):
    def boom(self, vecs):
        raise RuntimeError("no graph today")

    monkeypatch.setattr(HNSWIndex, "add", boom)
    data = gaussian(1200, D, 77)
    idx = AdaptiveIndex(D, migration_threshold=1000, min_contrast=0, device="cpu")
    with caplog.at_level(logging.ERROR, logger="longbow.adaptive"):
        idx.add(data)
        assert idx.wait_migration() is False
    assert idx.kind == "flat" and isinstance(idx.migration_error, RuntimeError)
    assert "staying flat" in caplog.text
    _, r = idx.search(data[:4], 1)
    assert (r[:, 0] == np.arange(4)).all()
    # no new attempt before the row count has doubled
    first = idx.migration_error
    idx.add(gaussian(100, D, 81))
    assert idx._migrator is None and idx.migration_error is first
    idx.add(gaussian(1100, D, 82))  # 2,400 rows: the next try, which fails too
    assert idx.wait_migration() is False and idx.migration_error is not first
    # asked for by name, a graph that cannot be built is an error
    hn = make_index("hnsw", D, "l2", dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="no graph today"):
        hn.add(data)


def test_a_kernel_failure_in_the_migration_is_raised_from_the_next_add(monkeypatch):
    def boom(self, vecs):
        raise KernelError("fused_scan launch failed: cudaError 98")

    monkeypatch.setattr(HNSWIndex, "add", boom)
    data = gaussian(1200, D, 83)
    store = VectorStore(device="cpu", migration_threshold=1000)
    ds = store.get_or_create("k", D, index_params={"min_contrast": 0})
    ds.put(np.arange(1200), data)
    idx = ds.index
    assert idx.wait_migration() is False and idx.kind == "flat"
    assert "cudaError 98" in ds.stats()["migration_error"]
    assert "cudaError 98" in store.readiness()["migration_errors"]["k"]
    with pytest.raises(KernelError, match="cudaError 98"):
        ds.put(np.arange(1200, 1300), gaussian(100, D, 84))
    assert len(idx) == 1200  # the failed put stored nothing
    ds.put(np.arange(1200, 1300), gaussian(100, D, 84))  # raised once, then flat serves
    assert len(idx) == 1300 and idx.kind == "flat"
    ids, _, ok = ds.search(data[:4], 1)
    assert ok.all() and ids[:, 0].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("stage", ["flat", "hnsw"])
def test_state_carried_across_both_ways(stage):
    data, q = gaussian(1500, D, 78), gaussian(16, D, 79)
    thr = 1000 if stage == "hnsw" else 10_000
    ji = JaxAdaptive(D, dtype=jnp.bfloat16, migration_threshold=thr,
                     hnsw_config=JaxConfig(**CFG), min_contrast=0)
    ti = AdaptiveIndex(D, dtype=torch.bfloat16, migration_threshold=thr,
                       hnsw_config=HNSWConfig(**CFG), min_contrast=0, device="cpu")
    for idx in (ji, ti):
        idx.add(data)
        idx.wait_migration()
        idx.delete_rows(np.array([9]))
        assert idx.kind == stage
    st = ji.export_state()
    moved = import_index(st, device="cpu")
    assert isinstance(moved, AdaptiveIndex) and moved.kind == stage
    assert moved.migration_threshold == thr and len(moved) == 1500
    assert_same(ji.search(q, 10), moved.search(q, 10), exact=False, atol=1e-4)
    back = JaxAdaptive.import_state(ti.export_state())
    assert back.kind == stage
    assert_same(back.search(q, 10), ti.search(q, 10), exact=False, atol=1e-4)
    assert not np.isin(moved.search(q, 10)[1], [9]).any()


def test_factory_kinds_and_parameters(monkeypatch):
    cfg = HNSWConfig(**CFG)
    a = make_index("adaptive", D, "l2", dtype=torch.bfloat16, device="cpu",
                   migration_threshold=123, hnsw_config=cfg, storage="sq8",
                   min_contrast=0.5, capacity=10_000)
    assert (a.migration_threshold, a.hnsw_config, a.storage, a.min_contrast) == (
        123, cfg, "sq8", 0.5)
    assert a.capacity == 16384 and a.dtype == torch.bfloat16
    monkeypatch.setenv("LONGBOW_ADAPTIVE_MIN_CONTRAST", "3.5")
    assert make_index(None, D, "l2", dtype=torch.float32, device="cpu").min_contrast == 3.5
    h = make_index("hnsw", D, "cosine", dtype=torch.float32, device="cpu", hnsw_config=cfg)
    assert h.migration_threshold == 0 and h.kind == "flat"
    h.add(gaussian(300, D, 80))  # the first add builds the graph, no probe
    assert h.kind == "hnsw" and h.last_contrast is None
    for kind in ("adaptive", "hnsw"):
        p = make_index(kind, D, "l2", dtype=torch.float32, device="cpu", storage="pq", pq_m=8)
        assert (p.storage, p.pq_m) == ("pq", 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_index("adaptive", D, "l2", dtype=torch.float32)


def test_sq8_graph_tier_after_migration():
    data, q = gaussian(2048, D, 81), gaussian(16, D, 82)
    idx = AdaptiveIndex(D, migration_threshold=1024, hnsw_config=HNSWConfig(**CFG),
                        storage="sq8", device="cpu")
    idx.add(data)
    assert idx.wait_migration() and idx._graph.state.vectors.dtype == torch.uint8
    got = idx.search(q, 10, ef_search=64)[1]
    want = idx.search(q, 10, exact=True)[1]
    assert recall(got, want) >= 0.9


def test_pq_graph_tier_after_migration():
    data, q = gaussian(2048, D, 83), gaussian(16, D, 84)
    idx = AdaptiveIndex(D, migration_threshold=1024, hnsw_config=HNSWConfig(**CFG),
                        storage="pq", pq_m=8, device="cpu")
    idx.add(data)
    assert idx.wait_migration() and idx._graph.state.vectors.shape[1] == 8
    from longbow_tpu_torch.ops.distance import exact_search

    got = idx.search(q, 10, ef_search=64)[1]
    # the pool is re-ranked against the original rows: hold it to them
    assert recall(got, exact_search(q, data, 10, device="cpu")[1].numpy()) >= 0.9
    assert idx.host_bytes() == idx.capacity * D * 2
    again = import_index(idx.export_state(), device="cpu")
    assert again.storage == "pq" and again.pq_m == 8
    np.testing.assert_array_equal(again.search(q, 10, ef_search=64)[1], got)
