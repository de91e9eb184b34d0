"""longbow_tpu_torch.index.tiered ("disk") against longbow_tpu.index.tiered
on the CPU, and the repaired pool against the exact oracle.

Both packages re-rank the device scan's pool exactly on the host in f32,
so at k <= 8, where the true neighbours lie deep inside either pool of
64, ids are EQUAL and distances agree to rtol 1e-5 / atol 1e-5. At
k = 100 longbow_tpu clamps the pool to k itself (no oversampling), so the
int8 scan's misorderings reach the result; the port takes
k * rerank_factor candidates and must return the exact top 100 (held to
an f64 oracle over the host rows, rtol 1e-5 / atol 1e-4).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from longbow_tpu.index.tiered import TieredIndex as JaxTiered
from longbow_tpu_torch.index.tiered import HostVectorStore, TieredIndex
from longbow_tpu_torch.ops.distance import MASKED

D = 24


def clustered(n, seed):
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(77).standard_normal((30, D)).astype(np.float32) * 3
    return (centers[rng.integers(0, 30, n)] + rng.standard_normal((n, D))).astype(np.float32)


def oracle(q, rows, k, metric, valid):
    q64, r64 = q.astype(np.float64), rows.astype(np.float64)
    if metric == "dot":
        dist = -(q64 @ r64.T)
    elif metric == "cosine":
        qn = q64 / np.linalg.norm(q64, axis=1, keepdims=True)
        dist = 1.0 - qn @ (r64 / np.linalg.norm(r64, axis=1, keepdims=True)).T
    else:
        dist = ((q64[:, None, :] - r64[None, :, :]) ** 2).sum(-1)
    dist[:, ~valid] = np.inf
    ids = np.argsort(dist, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(dist, ids, axis=1), ids


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_small_k_matches_jax(metric, tmp_path):
    v, q = clustered(3000, 0), clustered(12, 1)
    ji = JaxTiered(D, metric)
    ti = TieredIndex(D, metric, path=str(tmp_path / "rows.f32"), device="cpu")
    for batch in (v[:1000], v[1000:]):
        np.testing.assert_array_equal(ji.add(batch), ti.add(batch))
    dead = np.arange(0, 3000, 7)
    ji.delete_rows(dead)
    ti.delete_rows(dead)
    for k in (1, 8):
        jd, jids = ji.search(q, k)
        td, tids = ti.search(q, k)
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
    mask = np.arange(ti.capacity) % 2 == 0
    jd, jids = ji.search(q, 8, filter_mask=jnp.asarray(mask))
    td, tids = ti.search(q, 8, filter_mask=mask)
    np.testing.assert_array_equal(tids, jids)
    assert (tids % 2 == 0).all() and not np.isin(tids, dead).any()


@pytest.mark.parametrize("metric", ["l2", "cosine", "dot"])
def test_k_past_64_is_exact(metric):
    """The repaired pool: the reference re-ranks only the scan's own top
    100 at k = 100."""
    v, q = clustered(2500, 2), clustered(6, 3)
    v[:5] *= 10  # five far rows widen the int8 step, so the scan misorders
    ti = TieredIndex(D, metric, device="cpu")
    ti.add(v)
    dead = np.arange(1, 2500, 5)
    ti.delete_rows(dead)
    valid = np.ones(2500, bool)
    valid[dead] = False
    want_d, want_i = oracle(q, v, 100, metric, valid)
    td, tids = ti.search(q, 100)
    assert ti.pool(100) == 800 and ti.pool(10) == 64 and ti.pool(64) == 64
    assert (tids >= 0).all()
    np.testing.assert_allclose(td, want_d, rtol=1e-5, atol=1e-4)
    gap = np.full(want_d.shape, np.inf)
    step = np.diff(want_d, axis=1)
    gap[:, 1:] = np.minimum(gap[:, 1:], step)
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    sure = gap > 1e-3
    np.testing.assert_array_equal(tids[sure], want_i[sure])
    _, jids = JaxTiered.import_state(ti.export_state()).search(q, 100)
    hits = [len(set(a) & set(b)) for a, b in zip(np.asarray(jids).tolist(), want_i.tolist())]
    if metric != "cosine":  # (normalized rows have no far outliers)
        assert sum(hits) < want_i.size  # the reference's clamp loses true neighbours


def test_mmap_grows_across_adds(tmp_path):
    path = tmp_path / "cold" / "rows.f32"
    hs = HostVectorStore(D, str(path))
    assert path.stat().st_size == 4096 * D * 4
    a, b = clustered(3000, 4), clustered(6000, 5)
    hs.append(a)
    hs.append(b)  # 9,000 rows: two doublings
    hs.flush()
    assert hs.capacity == 16384 and path.stat().st_size == 16384 * D * 4
    np.testing.assert_array_equal(hs.get(np.arange(9000)), np.concatenate([a, b]))
    np.testing.assert_array_equal(np.fromfile(path, np.float32)[: 9000 * D].reshape(9000, D),
                                  np.concatenate([a, b]))
    ram = HostVectorStore(D)
    ram.append(b)
    assert ram.capacity == 8192 and ram.nbytes() == 8192 * D * 4


def test_state_crosses_both_ways(tmp_path):
    v, q = clustered(1500, 6), clustered(8, 7)
    ji = JaxTiered(D, "l2", rerank_factor=4)
    ji.add(v)
    ji.delete_rows([0, 1])
    ti = TieredIndex.import_state(ji.export_state(), path=str(tmp_path / "a.f32"), device="cpu")
    assert ti.rerank_factor == 4 and ti.count == 1500
    for a, b in zip(ti.search(q, 5), ji.search(q, 5)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ti.get_vectors([2, 9]), v[[2, 9]])
    back = JaxTiered.import_state(ti.export_state())
    for a, b in zip(ti.search(q, 5), back.search(q, 5)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
    # device bytes: codes, norms and validity; the host rows apart
    assert ti.device_bytes() == ji.hbm_bytes() == 4096 * (D + 4 + 1)
    assert ti.host_bytes() == 4096 * D * 4
