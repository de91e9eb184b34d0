"""longbow_tpu_torch.index.hnsw.HNSWIndex against longbow_tpu's on the CPU,
fed the same rows, deletes, filters and queries, and state carried
across both ways.

Lattice rows (small integers: exact f32 arithmetic, many ties) must give
EQUAL adjacency and results. Gaussian rows, cosine, the MIPS augmentation
and sq8 codes are held to rtol 1e-5 / atol 1e-5 on distances (sq8 and
cosine: 1e-4, their rows are rounded or normalized in another order of
operations), ids where neighbouring distances differ by more, and recall
against exact search. Batches are powers of two: the JAX index pads other
sizes with zero queries, which take part in its batch-wide stop.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longbow_tpu.index.hnsw import HNSWConfig as JaxConfig
from longbow_tpu.index.hnsw import HNSWIndex as JaxHNSW
from longbow_tpu.ops.distance import exact_search as jax_exact
from longbow_tpu_torch.index.hnsw import HNSWConfig, HNSWIndex
from test_torch_graph import gaussian, lattice

D = 16
CFG = dict(m=8, m_max=16, ef_construction=32, ef_search=32, insert_batch_size=256)


def pair(metric="l2", cfg=None, jkw=None, tkw=None):
    cfg = dict(CFG, **(cfg or {}))
    return (JaxHNSW(D, metric, JaxConfig(**cfg), **(jkw or {})),
            HNSWIndex(D, metric, HNSWConfig(**cfg), device="cpu", **(tkw or {})))


def assert_states_equal(ji, ti, exact=True):
    n = ji.count
    assert ti.count == n and ti.capacity == ji.capacity
    for name in ("nbrs", "nbr_count", "valid"):
        a, b = np.asarray(getattr(ji.state, name)[:n]), getattr(ti.state, name)[:n].numpy()
        if exact:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert (a == b).mean() > 0.99, name
    np.testing.assert_allclose(
        ti.state.nbr_dists[:n].float().numpy(),
        np.asarray(ji.state.nbr_dists[:n].astype(jnp.float32)), rtol=1e-5, atol=1e-5)


def assert_same(jres, tres, exact, atol=1e-5):
    jd, ji = (np.asarray(x) for x in jres)
    td, ti = tres
    assert td.dtype == np.float32 and ti.dtype == np.int32
    real = jd < 1e37
    np.testing.assert_array_equal(real, td < 1e37)
    if exact:
        np.testing.assert_array_equal(jd, td)
        np.testing.assert_array_equal(ji, ti)
        return
    np.testing.assert_allclose(td[real], jd[real], rtol=1e-5, atol=atol)
    gap = np.full(jd.shape, np.inf)
    step = np.abs(jd[:, 1:] - jd[:, :-1])
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    sure = real & (gap > 10 * (atol + 1e-5 * np.abs(jd)))
    np.testing.assert_array_equal(ji[sure], ti[sure])


def recall(got, want):
    return np.mean([len(set(g.tolist()) & set(w.tolist())) / len(w) for g, w in zip(got, want)])


def test_bulk_add_search_delete_filter_lattice():
    data, q = lattice(1500, D, 30), lattice(16, D, 31)
    ji, ti = pair()
    np.testing.assert_array_equal(ji.add(data), ti.add(data))  # bulk route
    assert_states_equal(ji, ti)
    assert_same(ji.search(q, 10), ti.search(q, 10), exact=True)
    assert ti.last_search_iters > 0
    dead = np.arange(0, 1500, 5)
    ji.delete_rows(dead)
    ti.delete_rows(dead)
    jr, tr = ji.search(q, 10, ef_search=48), ti.search(q, 10, ef_search=48)
    assert_same(jr, tr, exact=True)
    assert not np.isin(tr[1], dead).any()
    mask = np.arange(ji.capacity) % 4 == 1
    jr = ji.search(q, 10, filter_mask=jnp.asarray(mask))
    tr = ti.search(q, 10, filter_mask=mask)
    assert_same(jr, tr, exact=True)
    assert (tr[1][tr[1] >= 0] % 4 == 1).all()
    # a short mask is padded with False, a long one cut
    assert_same(jr, ti.search(q, 10, filter_mask=mask[:1600]), exact=True)
    # heavy tombstoning switches to tracked results in both
    more = np.arange(1, 1500, 5)
    ji.delete_rows(more)
    ti.delete_rows(more)
    assert_same(ji.search(q, 10), ti.search(q, 10), exact=True)


def test_incremental_adds_with_padded_tail_and_growth():
    data, q = lattice(9000, D, 32), lattice(8, D, 33)
    ji, ti = pair(cfg=dict(ef_construction=24))
    for off in (0, 700, 1400):  # 700 = 2 batches + a padded tail
        ji.add(data[off:off + 700])
        ti.add(data[off:off + 700])
    assert_states_equal(ji, ti)
    assert_same(ji.search(q, 10), ti.search(q, 10), exact=True)
    # growth past the first capacity keeps rows and adjacency
    ti.add(data[2100:])
    assert ti.capacity == 16384 and len(ti) == 9000
    assert (ti.state.nbrs[:2100].numpy() >= -1).all()
    _, rows = ti.search(data[8000:8016], 1)
    assert (rows[:, 0] >= 0).all()


def test_ef_retry_on_underfilled_filter():
    data, q = lattice(1500, D, 34), lattice(8, D, 35)
    ji, ti = pair(cfg=dict(ef_search=10))
    ji.add(data)
    ti.add(data)
    mask = np.zeros(ji.capacity, bool)
    mask[np.arange(3, 1500, 97)] = True  # 16 eligible rows
    jr = ji.search(q, 10, filter_mask=jnp.asarray(mask))
    tr = ti.search(q, 10, filter_mask=mask)
    assert_same(jr, tr, exact=True)
    ti.config.adaptive_ef_retries = 0
    td, _ = ti.search(q, 10, filter_mask=mask)
    # the retries (ef 10 -> 50 -> 250) found rows the first pass did not
    assert (tr[0] < 1e37).sum() > (td < 1e37).sum()


@pytest.mark.parametrize("cfg", [dict(search_m_max=8, search_expand=8), dict(search_expand=1)])
def test_search_profiles(cfg):
    data, q = lattice(1500, D, 36), lattice(16, D, 37)
    ji, ti = pair(cfg=cfg)
    ji.add(data)
    ti.add(data)
    assert_same(ji.search(q, 10), ti.search(q, 10), exact=True)


def test_gaussian_bf16_rows_and_edges():
    data, q = gaussian(2048, D, 38), gaussian(16, D, 39)
    ji, ti = pair(jkw=dict(dtype=jnp.bfloat16, edge_dtype=jnp.bfloat16),
                  tkw=dict(dtype=torch.bfloat16, edge_dtype=torch.bfloat16))
    ji.add(data)
    ti.add(data)
    assert ti.state.vectors.dtype == torch.bfloat16
    assert ti.state.nbr_dists.dtype == torch.bfloat16
    # norms are those of the rounded rows
    vf = ti.state.vectors[:2048].float()
    np.testing.assert_allclose(ti.state.norms_sq[:2048].numpy(), (vf * vf).sum(1).numpy(),
                               rtol=1e-6)
    assert_states_equal(ji, ti, exact=False)
    tr = ti.search(q, 10, ef_search=64)
    assert_same(ji.search(q, 10, ef_search=64), tr, exact=False, atol=1e-4)
    _, want = jax_exact(jnp.asarray(q), jnp.asarray(data), 10)
    assert recall(tr[1], np.asarray(want)) >= 0.9
    np.testing.assert_array_equal(ti.get_vectors(np.array([5, 9])), vf[[5, 9]].numpy())


def test_device_tensor_fast_path():
    data = gaussian(1500, D, 40)
    a = HNSWIndex(D, "l2", HNSWConfig(**CFG), dtype=torch.bfloat16, device="cpu")
    b = HNSWIndex(D, "l2", HNSWConfig(**CFG), dtype=torch.bfloat16, device="cpu")
    a.add(data)
    b.add(torch.from_numpy(data).to(torch.bfloat16))
    assert torch.equal(a.state.nbrs, b.state.nbrs)
    assert torch.equal(a.state.norms_sq, b.state.norms_sq)


def test_cosine():
    data, q = gaussian(1500, D, 41), gaussian(16, D, 42)
    ji, ti = pair("cosine")
    ji.add(data)
    ti.add(data)
    jr, tr = ji.search(q, 10, ef_search=64), ti.search(q, 10, ef_search=64)
    assert_same(jr, tr, exact=False, atol=1e-4)
    unit = data / np.linalg.norm(data, axis=1, keepdims=True)
    want = np.argsort(-(q / np.linalg.norm(q, axis=1, keepdims=True)) @ unit.T, axis=1)[:, :10]
    assert recall(tr[1], want) >= 0.9
    _, r = ti.search(data[123] * 4.2, 1)  # a scaled copy: cosine-nearest is row 123
    assert r[0, 0] == 123
    assert_same(ji.exact_search(q, 10), ti.exact_search(q, 10), exact=False, atol=1e-4)


def test_dot_through_the_mips_augmentation():
    rng = np.random.default_rng(43)
    data = (gaussian(1500, D, 43) * rng.uniform(0.5, 2.0, (1500, 1))).astype(np.float32)
    q = gaussian(16, D, 44)
    ji, ti = pair("dot")
    ji.add(data)
    ti.add(data)
    assert ti.state.vectors.shape[1] == D + 1
    assert ti._mips_msq == pytest.approx(ji._mips_msq, rel=1e-12)
    jr, tr = ji.search(q, 10, ef_search=64), ti.search(q, 10, ef_search=64)
    assert_same(jr, tr, exact=False, atol=1e-3)  # -ip = (dist - |q|^2 - M^2) / 2
    want = np.argsort(-(q @ data.T), axis=1)[:, :10]
    assert recall(tr[1], want) >= 0.9
    assert_same(ji.exact_search(q, 10), ti.exact_search(q, 10), exact=False, atol=1e-3)
    np.testing.assert_allclose(ti.get_vectors(np.arange(4)), data[:4], rtol=1e-6)
    with pytest.raises(ValueError, match="bound exceeded"):
        ti.add(data[:1] * 10.0)


def test_sq8_storage():
    data, q = gaussian(2048, D, 45), gaussian(16, D, 46)
    ji, ti = pair(jkw=dict(storage="sq8"), tkw=dict(storage="sq8"))
    ji.add(data[:1500])
    ti.add(data[:1500])
    ji.add(data[1500:])  # the quantizer is trained once, later rows are clipped
    ti.add(data[1500:])
    assert ti.state.vectors.dtype == torch.uint8
    np.testing.assert_allclose(ti.state.scale.numpy(), np.asarray(ji.state.scale), rtol=1e-6)
    np.testing.assert_array_equal(ti.state.offset.numpy(), np.asarray(ji.state.offset))
    codes_j, codes_t = np.asarray(ji.state.vectors[:2048]), ti.state.vectors[:2048].numpy()
    assert (codes_j == codes_t).mean() > 0.999
    tr = ti.search(q, 10, ef_search=64)
    deq = ti.get_vectors(np.arange(2048))
    _, want = jax_exact(jnp.asarray(q), jnp.asarray(deq), 10)
    assert recall(tr[1], np.asarray(want)) >= 0.9
    jrec = recall(np.asarray(ji.search(q, 10, ef_search=64)[1]), np.asarray(want))
    assert recall(tr[1], np.asarray(want)) >= jrec - 0.03
    te = ti.exact_search(q, 10)
    assert recall(te[1], np.asarray(want)) >= 0.97  # the scan runs on bf16 copies


@pytest.mark.parametrize("case", ["l2_bf16", "sq8", "dot"])
def test_state_carried_across_both_ways(case):
    data, q = gaussian(1500, D, 47), gaussian(16, D, 48)
    metric = "dot" if case == "dot" else "l2"
    jkw = dict(l2_bf16=dict(dtype=jnp.bfloat16, edge_dtype=jnp.bfloat16),
               sq8=dict(storage="sq8"), dot={})[case]
    tkw = dict(l2_bf16=dict(dtype=torch.bfloat16, edge_dtype=torch.bfloat16),
               sq8=dict(storage="sq8"), dot={})[case]
    cfg = dict(search_expand=2)
    ji, ti = pair(metric, cfg=cfg, jkw=jkw, tkw=tkw)
    ji.add(data)
    ti.add(data)
    for idx in (ji, ti):
        idx.delete_rows(np.array([5, 6, 700]))
    # JAX -> port
    st = ji.export_state()
    assert all(isinstance(v, (np.ndarray, str, int, float)) for v in st.values())
    moved = HNSWIndex.import_state(st, device="cpu")
    assert len(moved) == 1500 and moved.config.search_expand == 2
    assert moved.dtype == ti.dtype and moved.edge_dtype == ti.edge_dtype
    assert moved.state.vectors.dtype == ti.state.vectors.dtype
    assert_same(ji.search(q, 10, ef_search=48), moved.search(q, 10, ef_search=48),
                exact=False, atol=1e-3 if case == "dot" else 1e-4)
    # port -> JAX
    back = JaxHNSW.import_state(ti.export_state())
    assert back.state.vectors.dtype == ji.state.vectors.dtype
    assert_same(back.search(q, 10, ef_search=48), ti.search(q, 10, ef_search=48),
                exact=False, atol=1e-3 if case == "dot" else 1e-4)
    # and the port reads its own export; later adds still link
    again = HNSWIndex.import_state(ti.export_state(), device="cpu")
    a, b = again.search(q, 10), ti.search(q, 10)
    np.testing.assert_array_equal(a[1], b[1])
    rows = again.add(data[:300] * 0.5)
    assert rows[0] == 1500 and (again.state.nbr_count[1500:1800] > 0).all()
    empty = HNSWIndex.import_state(
        HNSWIndex(D, metric, device="cpu", **tkw).export_state(), device="cpu")
    assert len(empty) == 0


def test_searches_from_a_second_thread_while_adding():
    data = gaussian(4096, D, 49)
    idx = HNSWIndex(D, "l2", HNSWConfig(**CFG), device="cpu")
    idx.add(data[:1024])
    errors, done = [], threading.Event()

    def reader():
        try:
            while not done.is_set():
                d, r = idx.search(data[:8], 5, ef_search=32)
                assert (r[:, 0] == np.arange(8)).all(), r[:, 0]
                assert (r < len(idx)).all()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    t = threading.Thread(target=reader)
    t.start()
    try:
        for off in range(1024, 4096, 512):
            idx.add(data[off:off + 512])
    finally:
        done.set()
        t.join(60.0)
    assert not t.is_alive() and not errors, errors
    _, r = idx.search(data[4000:4016], 1)
    assert (r[:, 0] == np.arange(4000, 4016)).all()


def test_no_card_no_pq_and_bad_input():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HNSWIndex(D)
    # storage="pq": l2 and cosine only, pq_m must divide the dim
    with pytest.raises(ValueError, match="pq"):
        HNSWIndex(D, "dot", storage="pq", device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        HNSWIndex(D, storage="pq", pq_m=5, device="cpu")
    assert HNSWIndex(D, storage="pq", device="cpu").pq_m == D // 4
    with pytest.raises(ValueError):
        HNSWIndex(D, storage="nope", device="cpu")
    idx = HNSWIndex(D, device="cpu")
    with pytest.raises(ValueError):
        idx.add(np.ones((3, D + 1), np.float32))
    assert idx.device_bytes() == 8192 * (D * 4 + 4 + 1 + 64 * 4 + 64 * 4 + 4)


def test_pq_storage_recall_incremental_and_round_trip():
    """tests/test_hnsw.py::test_pq_graph_storage's fixture and gate: PQ
    codes as the traversal payload, books trained on the first batch, an
    exact re-rank of the ADC pool against the host f16 copy, incremental
    adds through the trained books, and an export/import round trip."""
    from longbow_tpu_torch.ops.distance import exact_search

    rng = np.random.default_rng(0)
    n, d = 4000, 32
    centers = rng.standard_normal((64, d)).astype(np.float32) * 4.0
    v = centers[rng.integers(0, 64, n)] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    idx = HNSWIndex(d, config=HNSWConfig(m=12, m_max=24, ef_search=64), dtype=torch.bfloat16,
                    storage="pq", pq_m=8, capacity=n, device="cpu")
    idx.add(v)
    assert idx.state.vectors.shape == (idx.capacity, 8)
    assert idx.state.vectors.dtype == torch.uint8
    assert idx.state.pq_books.shape == (8, 256, 4)
    assert idx.host_bytes() == idx.capacity * d * 2
    q = v[:64] + 0.01 * rng.standard_normal((64, d)).astype(np.float32)
    _, want = exact_search(q, v, 10, device="cpu")
    _, rr = idx.search(q, 10)
    assert recall(rr, want.numpy()) >= 0.9
    idx.add(v[:100] + 0.05)
    assert idx.count == n + 100
    dd, rr = idx.search(q, 10)
    st = idx.export_state()
    assert st["vectors"].dtype == np.uint8 and st["pq_rerank_host"].dtype == np.float16
    again = HNSWIndex.import_state(st, device="cpu")
    d2, r2 = again.search(q, 10)
    np.testing.assert_array_equal(r2, rr)
    np.testing.assert_array_equal(d2, dd)
    # exact=True scans a transient bf16 decode of the codes
    _, re = again.exact_search(q, 10)
    _, want_decoded = exact_search(q, again.get_vectors(np.arange(n + 100)), 10, device="cpu")
    assert recall(re, want_decoded.numpy()) >= 0.97


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_pq_storage_matches_jax(monkeypatch, metric):
    """Both packages train from JAX's init (the port's draw differs), so
    books agree to rtol 1e-4 / atol 1e-5; codes and adjacency are then
    equal but for rounding near ties; results as assert_same; state
    crosses both ways."""
    from longbow_tpu.ops.kmeans import kmeans_init as jax_kmeans_init
    from longbow_tpu_torch.index import pq as tpq

    data, q = gaussian(1500, D, 50), gaussian(16, D, 51)
    rows = data / np.linalg.norm(data, axis=1, keepdims=True) if metric == "cosine" else data
    sub = jnp.asarray(rows).reshape(-1, 4, D // 4).transpose(1, 0, 2)
    init = torch.from_numpy(np.array(jax_kmeans_init(sub, 256, 0)))
    monkeypatch.setattr(tpq, "kmeans_init", lambda x, k, seed=0: init)
    ji, ti = pair(metric, jkw=dict(storage="pq", pq_m=4), tkw=dict(storage="pq", pq_m=4))
    ji.add(data)
    ti.add(data)
    np.testing.assert_allclose(ti.state.pq_books.numpy(), np.asarray(ji.state.pq_books),
                               rtol=1e-4, atol=1e-5)
    assert (ti.state.vectors[:1500].numpy() == np.asarray(ji.state.vectors[:1500])).mean() > 0.999
    nbrs_j, nbrs_t = np.asarray(ji.state.nbrs[:1500]), ti.state.nbrs[:1500].numpy()
    assert (nbrs_j == nbrs_t).mean() > 0.99
    assert_same(ji.search(q, 10), ti.search(q, 10), exact=False, atol=1e-4)
    for idx in (ji, ti):
        idx.delete_rows(np.array([3, 9]))
    moved = HNSWIndex.import_state(ji.export_state(), device="cpu")
    assert moved.pq_m == 4 and moved._rerank_host.dtype == np.float16
    assert_same(ji.search(q, 10), moved.search(q, 10), exact=False, atol=1e-4)
    back = JaxHNSW.import_state(ti.export_state())
    assert_same(back.search(q, 10), ti.search(q, 10), exact=False, atol=1e-4)
