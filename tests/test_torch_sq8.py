"""longbow_tpu_torch.index.sq8 (SQ8Index, SQ8ResidualIndex) against
longbow_tpu.index.sq8 on the CPU, and the quantized kinds through the
port's factory and VectorStore.

Training differs between the packages only by the k-means init RNG, so
the comparisons give both the same trained state: through
export_state/import_state, or by setting centers, lo and hi on both.

Tolerances. Codes, layouts and slot maps are compared exactly. Both
packages re-rank sq8r candidates exactly in f32, so ids agree on every
slot whose distance lies below the k-th by more than the tolerance, and
distances to rtol 1e-5 / atol 1e-4. longbow_tpu's sq8 search on the CPU
returns its bf16 scan without a re-rank, so the port's sq8 is held to an
f64 oracle over the dequantized rows (rtol 1e-5 / atol 1e-4) and only
to an overlap of 0.9 with longbow_tpu; at k > 64 both run the same
chunked scan (rtol 1e-5 / atol 1e-3: the f32 sums of the bf16 products
are taken in another order around values of order 100).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longbow_tpu.index.sq8 import SQ8Index as JaxSQ8
from longbow_tpu.index.sq8 import SQ8ResidualIndex as JaxSQ8R
from longbow_tpu.index.sq8 import _quantize as jax_quantize
from longbow_tpu.store.vector_store import VectorStore as JaxStore
from longbow_tpu_torch.index import sq8
from longbow_tpu_torch.index.factory import import_index, make_index
from longbow_tpu_torch.index.sq8 import (
    GROUP,
    SQ8Index,
    SQ8ResidualIndex,
    _quantize,
    interleave_stride,
)
from longbow_tpu_torch.metrics import registry
from longbow_tpu_torch.metrics.registry import get_registry
from longbow_tpu_torch.ops.distance import MASKED, Metric, cosine_report
from longbow_tpu_torch.query.parser import Filter
from longbow_tpu_torch.store.vector_store import VectorStore

CPU = "cpu"


def _clustered(n, d, n_centers=32, seed=0, spread=3.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * spread
    return centers[rng.integers(0, n_centers, n)] + rng.standard_normal((n, d)).astype(
        np.float32
    )


def _oracle(q, rows, k, metric=Metric.L2, valid=None):
    """f64 exact k-NN -> (dist, ids), masked rows excluded."""
    q64, r64 = q.astype(np.float64), rows.astype(np.float64)
    if metric == Metric.DOT:
        dist = -(q64 @ r64.T)
    else:
        if metric == Metric.COSINE:
            q64 = q64 / np.linalg.norm(q64, axis=1, keepdims=True)
        dist = (q64 * q64).sum(1)[:, None] - 2 * q64 @ r64.T + (r64 * r64).sum(1)[None, :]
        dist = np.maximum(dist, 0.0)
        if metric == Metric.COSINE:
            dist = 0.5 * dist
    if valid is not None:
        dist = np.where(valid[None, :], dist, np.inf)
    ids = np.argsort(dist, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(dist, ids, 1), ids


def _agree(d_ref, i_ref, d, i, rtol, atol):
    """Distances within tolerance slot by slot, and every reference id
    whose distance lies below the k-th by more than the tolerance is
    found."""
    d_ref = np.asarray(d_ref, np.float64)
    np.testing.assert_allclose(d, d_ref, rtol=rtol, atol=atol)
    tol = atol + rtol * np.abs(d_ref)
    for b in range(d_ref.shape[0]):
        sure = d_ref[b] < d_ref[b, -1] - tol[b]
        assert set(np.asarray(i_ref[b])[sure].tolist()) <= set(np.asarray(i[b]).tolist()), b


def _recall(got, want):
    k = want.shape[1]
    return np.mean([len(set(g.tolist()) & set(w.tolist())) / k for g, w in zip(got, want)])


# -- quantizer ------------------------------------------------------------


def test_quantize_codes_bit_identical():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((3000, 48)).astype(np.float32) * 5
    lo, hi = v.min(axis=0), v.max(axis=0)
    # values that land on exact halves of the grid: round half to even
    halves = lo + (np.arange(48) % 7 + 0.5)[None, :] * (hi - lo) / 255.0
    v = np.concatenate([v, halves.astype(np.float32), lo[None], hi[None]])
    want = np.asarray(jax_quantize(jnp.asarray(v), jnp.asarray(lo), jnp.asarray(hi)))
    got = _quantize(torch.from_numpy(v), torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int8


@pytest.mark.parametrize("dtype", [np.int8, np.uint8])
def test_integer_input_is_stored_one_to_one(dtype):
    rng = np.random.default_rng(1)
    info = np.iinfo(dtype)
    v = rng.integers(info.min, info.max + 1, (500, 16)).astype(dtype)
    jidx, tidx = JaxSQ8(16), SQ8Index(16, device=CPU)
    jidx.add(v)
    tidx.add(v)
    codes = tidx.export_state()["codes"]
    np.testing.assert_array_equal(codes, jidx.export_state()["codes"])
    np.testing.assert_array_equal(codes.astype(np.int16) + (128 if dtype == np.uint8 else 0),
                                  v.astype(np.int16))
    np.testing.assert_array_equal(tidx.get_vectors(np.arange(500)), v.astype(np.float32))


# -- state carried between the packages -----------------------------------


def test_sq8_state_both_ways():
    v = _clustered(2500, 24, seed=2)
    jidx = JaxSQ8(24)
    jidx.add(v)
    jidx.delete_rows(np.arange(0, 2500, 7))
    st = jidx.export_state()
    port = SQ8Index.import_state(st, device=CPU)
    back = JaxSQ8.import_state(port.export_state())
    for key in ("lo", "hi", "codes", "valid"):
        np.testing.assert_array_equal(port.export_state()[key], st[key])
        np.testing.assert_array_equal(np.asarray(back.export_state()[key]), st[key])
    assert port.count == 2500
    # legacy archives stored raw uint8 codes
    legacy = dict(st, codes=(st["codes"].astype(np.int16) + 128).astype(np.uint8),
                  codes_centered=False)
    np.testing.assert_array_equal(SQ8Index.import_state(legacy, device=CPU).export_state()["codes"],
                                  st["codes"])


def test_sq8r_state_both_ways():
    v = _clustered(3000, 16, seed=3)
    jidx = JaxSQ8R(16, n_clusters=16)
    jidx.rebuild_min = 512
    jidx.add(v[:2000])
    jidx.add(v[2000:])
    jidx.delete_rows(np.arange(0, 3000, 11))
    st = jidx.export_state()
    port = SQ8ResidualIndex.import_state(st, device=CPU)
    back = JaxSQ8R.import_state(port.export_state())
    for key in ("lo", "hi", "centers", "codes", "cluster_ids", "valid"):
        np.testing.assert_array_equal(port.export_state()[key], st[key])
        np.testing.assert_array_equal(np.asarray(back.export_state()[key]), st[key])
    np.testing.assert_allclose(port.get_vectors(np.arange(1, 40)),
                               jidx.get_vectors(np.arange(1, 40)), rtol=1e-6, atol=1e-6)


def _trained_pair(dim=16, n_clusters=8, rebuild_min=256, seed=4):
    """A JAX and a port sq8r index holding the same trained parameters."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 3
    lo = np.full(dim, -3.5, np.float32) + rng.random(dim).astype(np.float32) * 0.1
    hi = np.full(dim, 3.5, np.float32) + rng.random(dim).astype(np.float32) * 0.1
    jidx, tidx = JaxSQ8R(dim, n_clusters=n_clusters), SQ8ResidualIndex(
        dim, n_clusters=n_clusters, device=CPU)
    jidx.centers, jidx.lo, jidx.hi = jnp.asarray(centers), jnp.asarray(lo), jnp.asarray(hi)
    tidx.centers, tidx.lo, tidx.hi = (torch.from_numpy(centers), torch.from_numpy(lo),
                                      torch.from_numpy(hi))
    jidx.rebuild_min = tidx.rebuild_min = rebuild_min
    return jidx, tidx, centers


def test_sq8r_layout_after_the_same_adds_matches_jax():
    jidx, tidx, centers = _trained_pair()
    rng = np.random.default_rng(5)
    for n in (300, 200, 500, 90, 700, 60):
        v = centers[rng.integers(0, 8, n)] + rng.standard_normal((n, 16)).astype(np.float32)
        np.testing.assert_array_equal(tidx.add(v), jidx.add(v))
        tidx.delete_rows(np.arange(0, tidx.count, 13))
        jidx.delete_rows(np.arange(0, jidx.count, 13))
    assert tidx.m_live == jidx.m_live > 0 and tidx.d_count == jidx.d_count > 0
    np.testing.assert_array_equal(tidx.m_codes.numpy(), np.asarray(jidx.m_codes))
    np.testing.assert_array_equal(tidx.m_gcid.numpy(), np.asarray(jidx.m_gcid))
    np.testing.assert_array_equal(tidx.m_ext.numpy(), np.asarray(jidx.m_ext))
    np.testing.assert_array_equal(tidx.m_valid.numpy(), np.asarray(jidx.m_valid))
    np.testing.assert_array_equal(tidx._slot, jidx._slot)
    np.testing.assert_array_equal(tidx.d_codes.numpy(), np.asarray(jidx.d_codes))
    np.testing.assert_allclose(tidx.m_norms.numpy(), np.asarray(jidx.m_norms), rtol=1e-6)


# -- search on the same state ---------------------------------------------


@pytest.mark.parametrize("metric", [Metric.L2, Metric.COSINE, Metric.DOT])
def test_sq8r_search_matches_jax_on_same_state(metric):
    v = _clustered(4000, 16, seed=6)
    q = _clustered(12, 16, seed=7)
    jsrc = JaxSQ8R(16, metric, n_clusters=16)
    jsrc.rebuild_min = 1024
    jsrc.add(v[:3000])
    jsrc.add(v[3000:])  # lands in the delta
    jsrc.delete_rows(np.arange(0, 4000, 9))
    st = jsrc.export_state()
    jidx = JaxSQ8R.import_state(st)
    tidx = SQ8ResidualIndex.import_state(st, device=CPU)
    tidx.add(v[:300])  # the same rows into both deltas
    jidx.add(v[:300])
    jd, ji = jidx.search(q, 10)
    td, ti = tidx.search(q, 10)
    _agree(jd, ji, td, ti, rtol=1e-5, atol=1e-4)


def test_sq8_search_against_oracle_and_jax():
    v = _clustered(3000, 32, seed=8)
    q = _clustered(16, 32, seed=9)
    jidx = JaxSQ8(32)
    jidx.add(v)
    jidx.delete_rows(np.arange(0, 3000, 5))
    st = jidx.export_state()
    tidx = SQ8Index.import_state(st, device=CPU)
    deq = np.asarray(jidx._dequant(jidx.codes))[:3000]
    for k in (10, 32, 64):
        td, ti = tidx.search(q, k)
        od, oi = _oracle(q, deq, k, valid=st["valid"])
        if k < 64:
            _agree(od, oi, td, ti, rtol=1e-5, atol=1e-4)
        else:  # the pool is k: its bf16 ranking decides the last places
            assert _recall(ti, oi) >= 0.95
        _, ji = jidx.search(q, k)
        assert _recall(ti, np.asarray(ji)) >= 0.9


def test_sq8_search_past_the_pool_matches_jax_scan():
    v = _clustered(3000, 32, seed=10)
    q = _clustered(8, 32, seed=11)
    jidx = JaxSQ8(32)
    jidx.add(v)
    jidx.delete_rows(np.arange(0, 3000, 3))
    tidx = SQ8Index.import_state(jidx.export_state(), device=CPU)
    jd, ji = jidx.search(q, 100)
    td, ti = tidx.search(q, 100)
    _agree(np.asarray(jd), np.asarray(ji), td, ti, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("metric", [Metric.L2, Metric.DOT])
def test_sq8r_k_past_64_is_exact_over_dequantized_rows(metric):
    """longbow_tpu keeps 64 candidates per scan chunk (sq8.py:517) and so
    drops neighbours at k > 64; the port keeps min(pool, chunk)."""
    v = _clustered(3000, 16, seed=12)
    q = _clustered(6, 16, seed=13)
    idx = SQ8ResidualIndex(16, metric, n_clusters=16, device=CPU)
    idx.rebuild_min = 1024
    idx.add(v[:2500])
    idx.add(v[2500:])
    assert idx.m_live and idx.d_count
    deq = idx.get_vectors(np.arange(3000))
    td, ti = idx.search(q, 100)
    od, oi = _oracle(q, deq, 100, metric)
    _agree(od, oi, td, ti, rtol=1e-5, atol=1e-3)


# -- counterparts of tests/test_quantized.py ------------------------------


def test_sq8_recall_gate():
    vecs = _clustered(4000, 64)
    q = _clustered(32, 64, seed=5)
    idx = SQ8Index(64, device=CPU)
    idx.add(vecs)
    _, r = idx.search(q, 10)
    assert _recall(r, _oracle(q, vecs, 10)[1]) >= 0.95


def test_sq8r_beats_global_sq8_on_clustered():
    rng = np.random.default_rng(11)
    n, d, k, nq, ncl = 20_000, 64, 10, 64, 256
    centers = rng.standard_normal((ncl, d)).astype(np.float32) * 4.0
    allv = centers[rng.integers(0, ncl, n + nq)] + rng.standard_normal(
        (n + nq, d)).astype(np.float32)
    vecs, q = allv[:n], allv[n:]
    want = _oracle(q, vecs, k)[1]

    def recall(idx):
        idx.add(vecs)
        return _recall(idx.search(q, k)[1], want)

    r_sq8 = recall(SQ8Index(d, device=CPU))
    r_sq8r = recall(SQ8ResidualIndex(d, n_clusters=256, device=CPU))
    assert r_sq8r >= 0.95, r_sq8r
    assert r_sq8r > r_sq8 + 0.01, (r_sq8r, r_sq8)


def _mk_sq8r(dim=16, n_clusters=8, rebuild_min=256):
    idx = SQ8ResidualIndex(dim, n_clusters=n_clusters, device=CPU)
    idx.rebuild_min = rebuild_min
    return idx


def test_sq8r_ext_ids_stable_across_rebuilds():
    rng = np.random.default_rng(0)
    idx = _mk_sq8r()
    all_v = []
    for _ in range(5):
        v = rng.standard_normal((300, 16)).astype(np.float32)
        rows = idx.add(v)
        all_v.append(v)
        assert list(rows) == list(range(idx.count - 300, idx.count))
    assert idx.m_live > 0, "no relayout ever ran"
    vv = np.concatenate(all_v)
    probe = np.asarray([3, 299, 300, 777, 1200, 1499])
    err = np.linalg.norm(idx.get_vectors(probe) - vv[probe], axis=1)
    assert (err < np.linalg.norm(vv[probe], axis=1) * 0.25).all()
    _, i = idx.search(vv[777], 3)
    assert int(i[0, 0]) == 777


def test_sq8r_groups_single_cluster():
    rng = np.random.default_rng(1)
    idx = _mk_sq8r()
    v = rng.standard_normal((1500, 16)).astype(np.float32)
    idx.add(v)
    idx._rebuild_layout()
    want_all = idx._assign(torch.from_numpy(v)).numpy()
    gcid, valid, ext = idx.m_gcid.numpy(), idx.m_valid.numpy(), idx.m_ext.numpy()
    slots = np.nonzero(valid)[0]
    np.testing.assert_array_equal(gcid[slots // GROUP], want_all[ext[slots]])
    assert (ext[~valid] == -1).all()
    assert idx.m_codes.shape[0] % 16384 == 0


def test_sq8r_delete_across_regions():
    rng = np.random.default_rng(2)
    idx = _mk_sq8r()
    v = rng.standard_normal((600, 16)).astype(np.float32)
    idx.add(v)
    w = rng.standard_normal((50, 16)).astype(np.float32)
    rows_w = idx.add(w)
    assert idx.d_count > 0
    idx.delete_rows(np.asarray([5, rows_w[3]]))
    assert 5 not in idx.search(v[5], 5)[1][0].tolist()
    assert rows_w[3] not in idx.search(w[3], 5)[1][0].tolist()
    idx._rebuild_layout()
    assert 5 not in idx.search(v[5], 5)[1][0].tolist()
    assert idx.m_live == 648


def test_sq8r_main_region_search_skips_the_delta():
    """_search with has_delta=False returns main-region rows only;
    search covers both regions."""
    rng = np.random.default_rng(5)
    idx = _mk_sq8r()
    v = rng.standard_normal((600, 16)).astype(np.float32)
    idx.add(v)
    w = rng.standard_normal((50, 16)).astype(np.float32)
    rows_w = idx.add(w)
    assert idx.m_live == 600 and idx.d_count == 50
    _, i = idx._search(w[:5], 10, None, has_delta=False)
    assert ((i >= 0) & (i < 600)).all()
    _, i = idx.search(w[:5], 1)
    assert i[:, 0].tolist() == rows_w[:5].tolist()


@pytest.mark.parametrize("kind", ["sq8", "sq8r"])
def test_adapter_passes_masks_of_any_length(kind):
    """The adapter hands the filter mask to the index as it is: a mask
    longer than the index is cut, a shorter one excludes the rows past
    its end."""
    rng = np.random.default_rng(6)
    params = {"n_clusters": 8} if kind == "sq8r" else {}
    idx = make_index(kind, 16, Metric.L2, dtype=torch.float32, device=CPU, **params)
    v = rng.standard_normal((500, 16)).astype(np.float32)
    idx.add(v)
    mask = np.zeros(idx.capacity + 1000, bool)
    mask[100:200] = True
    _, i = idx.search(v[150:151], 5, filter_mask=torch.from_numpy(mask))
    assert int(i[0, 0]) == 150
    assert all(100 <= x < 200 for x in i[0] if x >= 0)
    _, i = idx.search(v[450:451], 5, filter_mask=torch.ones(300, dtype=torch.bool))
    assert ((i[0] >= 0) & (i[0] < 300)).all()


def test_sq8r_filter_mask_is_external():
    rng = np.random.default_rng(3)
    idx = _mk_sq8r()
    v = rng.standard_normal((500, 16)).astype(np.float32)
    idx.add(v)
    mask = np.zeros(idx.capacity, bool)
    mask[100:200] = True
    _, i = idx.search(v[150], 5, filter_mask=torch.from_numpy(mask))
    assert int(i[0, 0]) == 150
    assert all(100 <= x < 200 for x in i[0] if x >= 0)
    # a mask shorter than the ids excludes the rows past its end
    _, i = idx.search(v[450], 5, filter_mask=torch.ones(300, dtype=torch.bool))
    assert (i[0] < 300).all()


@pytest.mark.parametrize("g_total", [32, 4096, 40150, 80256, 1 << 17, 1 << 20])
def test_sq8r_interleave_stride_no_overflow(g_total):
    """The stride is longbow_tpu's (capped so group * stride fits int32
    there); the port's arithmetic is int64, and the permutation of the
    groups is a bijection."""
    stride = interleave_stride(g_total)
    max_stride = max((2**31 - 1) // g_total - 1, 1)
    want = min(max(1, int(g_total * 0.6180339887)), max_stride) | 1
    while want > 1 and math.gcd(want, g_total) != 1:
        want -= 2
    assert stride == want and math.gcd(stride, g_total) == 1
    assert stride * (g_total - 1) < 2**31 - 1
    perm = torch.arange(g_total, dtype=torch.int64) * stride % g_total
    assert torch.unique(perm).numel() == g_total
    if g_total >= 4096:
        assert stride >= 32


def test_cosine_distance_convention():
    rng = np.random.default_rng(21)
    v = rng.standard_normal((800, 32)).astype(np.float32)
    q = v[17] * 3.0 + rng.standard_normal(32).astype(np.float32) * 0.01
    vn = v / np.linalg.norm(v, axis=1, keepdims=True)
    want = np.sort(1.0 - vn @ (q / np.linalg.norm(q)))[:5]
    for kind, params in (("sq8", {}), ("sq8r", {"n_clusters": 16})):
        idx = make_index(kind, 32, Metric.COSINE, dtype=torch.float32, device=CPU, **params)
        idx.add(v)
        dist, rows = idx.search(q[None, :], 5)
        assert rows[0, 0] == 17, (kind, rows)
        assert abs(float(dist[0, 0]) - float(want[0])) <= 3e-2
        assert dist[0, 0] >= -1e-4


# -- factory and store ----------------------------------------------------


def test_factory_round_trip_and_device_bytes():
    v = _clustered(1000, 16, seed=14)
    for kind in ("sq8", "sq8r"):
        idx = make_index(kind, 16, "l2", dtype=torch.bfloat16, device=CPU, n_clusters=8)
        assert idx.capacity >= 1 and len(idx) == 0
        assert (idx.search(v[:2], 3)[1] == -1).all()  # empty: all ghosts
        idx.add(v)
        again = import_index(idx.export_state(), device=CPU)
        assert again.kind == kind and len(again) == 1000
        np.testing.assert_array_equal(again.search(v[:4], 5)[1], idx.search(v[:4], 5)[1])
        assert idx.device_bytes() >= 1000 * 16  # one byte per dim and row at least
        idx.flush()
        idx.warm()
    sq8 = make_index("sq8", 64, "l2", dtype=torch.bfloat16, device=CPU)
    sq8.add(_clustered(100, 64))
    # codes are one byte per dim; capacity-padded, so count per row
    assert sq8._inner.codes[:100].numel() * sq8._inner.codes.element_size() == 100 * 64


@pytest.mark.parametrize("kind", ["sq8", "sq8r"])
def test_store_put_search_delete_filter(kind):
    rng = np.random.default_rng(15)
    v = _clustered(3000, 16, seed=15)
    q = v[:8] + 0.05 * rng.standard_normal((8, 16)).astype(np.float32)
    store = VectorStore(device=CPU, dtype=torch.bfloat16, default_index_kind="flat")
    ds = store.get_or_create("q", 16, index_kind=kind, index_params={"n_clusters": 16})
    if kind == "sq8r":
        ds.index._inner.rebuild_min = 1024
    ids = np.arange(3000)
    for s in range(0, 3000, 700):
        store.put("q", ids[s:s + 700], v[s:s + 700], {"category": ids[s:s + 700] % 10})
    if kind == "sq8r":
        assert ds.index._inner.m_live and ds.index._inner.d_count
    deq = ds.index.get_vectors(ids)
    got, scores, ok = store.search("q", q, 10)
    od, oi = _oracle(q, deq, 10)
    assert ok.all()
    _agree(od, oi, scores, got.astype(np.int64), rtol=1e-5, atol=1e-4)
    fids, _, fok = store.search("q", q, 10, filters=[Filter("category", "eq", "3")])
    assert fok.any() and all(x % 10 == 3 for x in fids[fok])
    dead = rng.choice(3000, 300, replace=False)
    assert store.delete("q", dead) == 300
    did, _, dok = store.search("q", v[dead[:50]], 10)
    assert not set(did[dok].tolist()) & set(dead.tolist())
    stats = ds.stats()
    assert (stats["live_rows"], stats["tombstones"], stats["index_kind"]) == (2700, 300, kind)
    assert stats["device_bytes"] >= 3000 * 16


@pytest.mark.parametrize("dtype", [np.int8, np.uint8])
def test_integer_vectors_take_the_sq8_route(dtype):
    rng = np.random.default_rng(16)
    info = np.iinfo(dtype)
    v = rng.integers(info.min, info.max + 1, (2000, 32)).astype(dtype)
    port, ref = VectorStore(device=CPU), JaxStore()
    port.put("i", np.arange(2000), v)
    ref.put("i", np.arange(2000), v)
    assert port.get("i").index.kind == ref.get("i").index.kind == "sq8"
    np.testing.assert_array_equal(port.get("i").index.export_state()["codes"],
                                  ref.get("i").index.export_state()["codes"])
    q = v[:20].astype(np.float32) + rng.standard_normal((20, 32)).astype(np.float32)
    got, scores, ok = port.search("i", q, 10)
    od, oi = _oracle(q, v.astype(np.float32), 10)
    # |q|^2 + |v|^2 is near 1e6 at int8 magnitudes, where an f32 ulp is 0.06
    _agree(od, oi, scores, got.astype(np.int64), rtol=1e-5, atol=0.5)
    # an explicit kind, or a store whose default is not adaptive, wins
    port.get_or_create("explicit", 32, index_kind="sq8r", dtype_hint=np.int8)
    assert port.get("explicit").index.kind == "sq8r"
    flat = VectorStore(device=CPU, default_index_kind="flat")
    flat.put("f", np.arange(10), v[:10])
    assert flat.get("f").index.kind == "flat"


def test_empty_and_masked_results_are_canonical():
    idx = SQ8ResidualIndex(8, device=CPU)
    d, i = idx.search(np.zeros((2, 8), np.float32), 4)
    assert (i == -1).all() and (d == np.float32(MASKED)).all()
    idx = SQ8Index(8, device=CPU)
    idx.add(np.eye(8, dtype=np.float32))
    idx.delete_rows(np.arange(6))
    d, i = idx.search(np.eye(8, dtype=np.float32)[:1], 5)
    assert set(i[0][:2]) == {6, 7} and (i[0][2:] == -1).all()
    assert (d[0][2:] == np.float32(MASKED)).all()


# -- the delta region through K2 and its cluster-grouped view -------------


def _plain_delta(idx, q, k, filter_mask=None):
    """The same search with the delta scanned by the plain chunked scan
    (_region_scores), as dot and k > 64 scan it."""
    normalize = idx.metric == Metric.COSINE
    mask = None if filter_mask is None else torch.as_tensor(filter_mask).bool()
    d, i = sq8._sq8r_search(
        torch.as_tensor(q, dtype=torch.float32),
        idx.m_codes, idx.m_gcid, idx.m_norms, idx.m_valid, idx.m_ext,
        idx.d_codes, idx.d_cid, idx.d_norms, idx.d_valid, idx.d_ext,
        idx.centers, idx.lo, idx.hi, mask,
        k, Metric.L2 if normalize else idx.metric, normalize, True, idx.d_count > 0, CPU,
    )
    d = d.numpy()
    return (cosine_report(d) if normalize else d), i.numpy()


def _same_answers(want, got):
    """Distances to rtol 1e-5, and the same id in every slot whose
    distance ties with neither neighbour."""
    (dw, iw), (dg, ig) = want, got
    np.testing.assert_allclose(dg, dw, rtol=1e-5, atol=1e-6)
    d = dw.astype(np.float64)
    apart = np.diff(d, axis=1) > 1e-5 * np.abs(d[:, 1:]) + 1e-6
    untied = np.ones(d.shape, bool)
    untied[:, 1:] &= apart
    untied[:, :-1] &= apart
    np.testing.assert_array_equal(ig[untied], iw[untied])


def _delta_counts() -> dict:
    """longbow_sq8r_delta_scans_total by route and the views built."""
    reg = get_registry()
    out = {"k2": 0.0, "plain": 0.0, "views": 0.0}
    for name, key in (("longbow_sq8r_delta_scans_total", None),
                      ("longbow_sq8r_delta_views_total", "views")):
        for sample, pairs, value in reg._metrics[name].samples():
            if sample.endswith("_total"):
                out[key or dict(pairs)["route"]] = value
    return out


def _check_view(idx):
    """Every group of the delta's view holds one cluster, and its slots
    are the delta's live rows at its build, each once."""
    view = idx._d_view
    slot = view.slot.numpy()
    real = slot >= 0
    assert view.codes.shape[0] == len(slot) == view.gcid.shape[0] * GROUP
    np.testing.assert_array_equal(idx.d_cid.numpy()[slot[real]],
                                  view.gcid.numpy()[np.nonzero(real)[0] // GROUP])
    np.testing.assert_array_equal(view.codes.numpy()[real], idx.d_codes.numpy()[slot[real]])
    assert len(set(slot[real].tolist())) == real.sum()


@pytest.mark.parametrize("metric", [Metric.L2, Metric.COSINE])
@pytest.mark.parametrize("case", ["delta_only", "with_main", "delete_after_build", "filter",
                                  "add_after_search", "fold"])
def test_sq8r_delta_k2_route_matches_plain(metric, case, monkeypatch):
    """A fused search scans the delta with K2 over its cluster-grouped
    view (on the CPU, K2's plain version): the same answers as the plain
    chunked scan, no padding position or deleted row returned, one view
    built per add that changed the delta, none kept across a fold. In 8
    clusters the view is at most 3,072 rows, within the rule for a delta
    of 4,096 rows' capacity."""
    monkeypatch.setattr(registry, "_global", registry.MetricsRegistry())
    rng = np.random.default_rng(31)
    v = _clustered(4000, 16, n_centers=8, seed=32)
    idx = SQ8ResidualIndex(16, metric, n_clusters=8, device=CPU)
    idx.rebuild_min = 10_000 if case == "delta_only" else 1024
    idx.add(v[:1500] if case != "delta_only" else v[:2500])
    if case != "delta_only":
        idx.add(v[1500:2500])
    assert idx.d_count and bool(idx.m_live) == (case != "delta_only")
    q = v[rng.choice(2500, 24, replace=False)] + 0.3 * rng.standard_normal(
        (24, 16)).astype(np.float32)
    mask = None
    if case == "filter":
        mask = np.zeros(idx.capacity, bool)
        mask[rng.choice(2500, 900, replace=False)] = True
    got = idx.search(q, 10, filter_mask=mask)
    assert _delta_counts() == {"k2": 1, "plain": 0, "views": 1}
    _same_answers(_plain_delta(idx, q, 10, mask), got)  # one "plain" scan more
    _check_view(idx)
    dead = np.empty(0, np.int64)
    if case == "delete_after_build":
        # rows each query found in the delta, deleted with the view built
        dead = np.unique(got[1][got[1] >= 1500])
        idx.delete_rows(dead)
    elif case == "add_after_search":
        idx.add(v[2500:2520])
    elif case == "fold":  # as an add past the fold rule does
        idx._rebuild_layout()
        assert idx.d_count == 0 and idx._d_view is None
    got = idx.search(q, 10, filter_mask=mask)
    counts = _delta_counts()
    _same_answers(_plain_delta(idx, q, 10, mask), got)
    ids = got[1][got[1] >= 0]
    allowed = np.ones(idx.count, bool) if mask is None else mask[:idx.count].copy()
    allowed[dead] = False
    assert allowed[ids].all()
    assert (got[1] >= 0).sum() == 24 * min(10, allowed.sum())
    if case == "fold":  # no delta left to scan
        assert counts == {"k2": 1, "plain": 1, "views": 1}
        return
    _check_view(idx)
    assert counts == {"k2": 2, "plain": 1, "views": 2 if case == "add_after_search" else 1}
    if case == "add_after_search":
        _, i = idx.search(v[2500:2510], 1)
        assert i[:, 0].tolist() == list(range(2500, 2510))


@pytest.mark.parametrize("metric, k", [(Metric.DOT, 10), (Metric.L2, 100)])
def test_sq8r_delta_plain_route_off_the_fused_gate(metric, k, monkeypatch):
    """Dot and k > 64 scan the delta in plain ops: no view is built and
    the scans count under route "plain"."""
    monkeypatch.setattr(registry, "_global", registry.MetricsRegistry())
    v = _clustered(2000, 16, n_centers=8, seed=33)
    idx = SQ8ResidualIndex(16, metric, n_clusters=8, device=CPU)
    idx.rebuild_min = 1024
    idx.add(v[:1200])
    idx.add(v[1200:])
    idx.search(v[:5], k)
    assert idx._d_view is None
    assert _delta_counts() == {"k2": 0, "plain": 1, "views": 0}


def _many_cluster_delta(rows: int, n_clusters: int = 1024):
    """An sq8r index trained into `n_clusters` clusters on 8 rows a
    cluster, then given `rows` rows of the same recipe, all in its delta."""
    v = _clustered(8 * n_clusters + rows, 16, n_centers=n_clusters, seed=34)
    idx = SQ8ResidualIndex(16, n_clusters=n_clusters, device=CPU)
    idx.train(v[:8 * n_clusters])
    idx.rebuild_min = 2 * rows
    idx.add(v[8 * n_clusters:])
    assert idx.n_clusters == n_clusters and idx.d_count == rows
    return idx, v[8 * n_clusters:]


@pytest.mark.parametrize("rows, n_clusters, route", [
    (2_500, 8, "k2"),        # a view of 3,072 rows at most, capacity 4,096
    (2_000, 1024, "plain"),  # some 880 clusters of 2 rows: a view of ~113,000, capacity 4,096
    (9_000, 1024, "k2"),     # a view of 131,072 rows at most, capacity 16,384
])
def test_sq8r_delta_route_rule(rows, n_clusters, route, monkeypatch):
    """DELTA_VIEW_MAX: K2 takes the delta while its view holds at most 16
    times the rows of the delta's capacity, whatever the batch; the route
    is decided once after an add, and both routes answer alike."""
    monkeypatch.setattr(registry, "_global", registry.MetricsRegistry())
    idx, v = _many_cluster_delta(rows, n_clusters)
    want = sq8.delta_view_rows(idx.d_cid, idx.d_valid, idx.n_clusters)
    assert (want <= sq8.DELTA_VIEW_MAX * idx.d_codes.shape[0]) == (route == "k2")
    q = v[:40] + 0.1
    for b in (1, 40):
        got = idx.search(q[:b], 10)
        _same_answers(_plain_delta(idx, q[:b], 10), got)
    assert (idx._d_view is None) == (route == "plain")
    if route == "k2":
        assert idx._d_view.codes.shape[0] == want
        _check_view(idx)
    assert _delta_counts() == {"k2": 2 * (route == "k2"), "plain": 2 + 2 * (route == "plain"),
                               "views": int(route == "k2")}


def test_sq8r_small_delta_takes_the_plain_route(monkeypatch):
    """A delta whose view would be mostly padding (2,000 rows over 1,024
    clusters) builds no view and is scanned in plain ops, with the same
    answers as K2 over the view."""
    monkeypatch.setattr(registry, "_global", registry.MetricsRegistry())
    idx, v = _many_cluster_delta(2_000)
    got = idx.search(v[:5], 10)
    assert idx._d_view is None
    assert _delta_counts() == {"k2": 0, "plain": 1, "views": 0}
    monkeypatch.setattr(sq8, "DELTA_VIEW_MAX", 64)
    idx.add(v[:1] + 100.0)  # far from every query; the route is decided anew
    _same_answers(got, idx.search(v[:5], 10))
    assert _delta_counts() == {"k2": 1, "plain": 1, "views": 1}


def test_sq8r_delta_counts_reads_a_window(monkeypatch):
    """tools/sq8r_delta_counts: the delta's two counters', the coalescer's
    overlap counter's and batch histogram's samples, their growth between
    two readings (a sample first written in between grew from 0), and the
    window's share of overlapped dispatches and mean batch."""
    from longbow_tpu_torch.tools import sq8r_delta_counts as tool

    monkeypatch.setattr(registry, "_global", registry.MetricsRegistry())
    registry.count("longbow_sq8r_delta_scans_total", route="k2")
    registry.get_registry().observe(tool.BATCH, 7)
    start = tool.readings()
    for _ in range(3):
        registry.count("longbow_sq8r_delta_scans_total", route="k2")
    registry.count("longbow_sq8r_delta_scans_total", route="plain")
    registry.count("longbow_sq8r_delta_views_total")
    for b in (1_000, 2_000, 3_000, 2_000):
        registry.get_registry().observe(tool.BATCH, b)
    for _ in range(3):
        registry.count("longbow_coalescer_overlapped_dispatches_total")
    k2, plain = ('longbow_sq8r_delta_scans_total{"route": "%s"}' % r for r in ("k2", "plain"))
    views = "longbow_sq8r_delta_views_total{}"
    over = "longbow_coalescer_overlapped_dispatches_total{}"
    n, total = tool.BATCH + "_count{}", tool.BATCH + "_sum{}"
    assert start == {k2: 1.0, views: 0.0, over: 0.0, n: 1.0, total: 7.0}
    win = tool.window(start, tool.readings())
    assert win == {k2: 3.0, plain: 1.0, views: 1.0, over: 3.0, n: 4.0, total: 8_000.0}
    assert tool.coalescer(win) == {"dispatches": 4.0, "overlapped_share": 0.75,
                                   "mean_batch": 2_000.0}
    assert tool.coalescer(tool.window(start, start)) == {}
