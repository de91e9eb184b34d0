"""longbow_tpu_torch.index.ivf against longbow_tpu.index.ivf on the CPU.

The packages differ only by the k-means init draw, so the port is handed
JAX's init. On rows that are clustered far apart the assignments cannot
flip by rounding, so cell_rows, cell_fill and the spill rows must be
EQUAL after several adds that spill. Distances |q|^2 - 2 q.v + |v|^2
come from f32 products summed in another order, with |q|^2 and |v|^2
near 600 on these rows, so they agree to rtol 1e-5 / atol 1e-3 (a few
f32 steps at 600), ids wherever neighbouring distances differ by more.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longbow_tpu.index.ivf import IVFIndex as JaxIVF
from longbow_tpu.ops.kmeans import kmeans_init as jax_kmeans_init
from longbow_tpu_torch.index import ivf as tivf
from longbow_tpu_torch.index.ivf import IVFIndex
from longbow_tpu_torch.ops.distance import MASKED
from test_torch_pq import assert_close_results

D = 16


def close(jres, tres, k):
    assert_close_results(jres, tres, k, atol=1e-3)


def clustered(n, seed, n_centers=40):
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(99).standard_normal((n_centers, D)).astype(np.float32) * 6
    return (centers[rng.integers(0, n_centers, n)]
            + 0.5 * rng.standard_normal((n, D))).astype(np.float32)


def with_jax_init(monkeypatch, first, metric):
    """Hand the port the init JAX's train draws for the first batch."""
    v = first
    if metric == "cosine":
        v = v / np.linalg.norm(v, axis=1, keepdims=True)
    n = len(v)
    n_cells = max(16, min(4096, int(np.sqrt(n) * 2)))
    sample = v[np.linspace(0, n - 1, min(n, 131072), dtype=np.int64)]
    init = torch.from_numpy(np.array(jax_kmeans_init(jnp.asarray(sample)[None], n_cells, 0)))
    monkeypatch.setattr(tivf, "kmeans_init", lambda data, k, seed=0: init)


def assert_layout_equal(ji, ti):
    np.testing.assert_array_equal(ti.cell_rows.numpy(), np.asarray(ji.cell_rows))
    np.testing.assert_array_equal(ti.cell_fill, ji.cell_fill)
    np.testing.assert_array_equal(ti._spill_rows, ji._spill_rows)
    np.testing.assert_array_equal(ti.cells.float().numpy(),
                                  np.asarray(ji.cells.astype(jnp.float32)))
    np.testing.assert_allclose(ti.cell_norms.numpy(), np.asarray(ji.cell_norms), rtol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_adds_that_spill_match_jax(monkeypatch, metric):
    first, q = clustered(1200, 0), clustered(16, 1)
    with_jax_init(monkeypatch, first, metric)
    ji, ti = JaxIVF(D, metric, n_probe=4), IVFIndex(D, metric, n_probe=4, device="cpu")
    for batch in (first, clustered(1500, 2), clustered(900, 3)):  # later adds spill
        np.testing.assert_array_equal(ji.add(batch), ti.add(batch))
    np.testing.assert_allclose(ti.centroids.numpy(), np.asarray(ji.centroids), rtol=1e-4,
                               atol=1e-5)
    assert_layout_equal(ji, ti)
    assert ti.spill_rows > 1000 and ti.capacity == ji.valid.shape[0]
    for k in (1, 10, 40):
        close(ji.search(q, k), ti.search(q, k), k)
    dead = np.arange(0, 3600, 3)
    ji.delete_rows(dead)
    ti.delete_rows(dead)
    mask = np.arange(ji.valid.shape[0]) % 2 == 1
    jres = ji.search(q, 10, filter_mask=jnp.asarray(mask))
    tres = ti.search(q, 10, filter_mask=mask)
    close(jres, tres, 10)
    ids = tres[1][tres[1] >= 0]
    assert (ids % 2 == 1).all() and not np.isin(ids, dead).any()
    rows = np.array([0, 5, 1250, 3550, 2000])
    np.testing.assert_array_equal(ti.get_vectors(rows), ji.get_vectors(rows))


def test_state_crosses_both_ways():
    ji = JaxIVF(D, "l2")
    ji.add(clustered(800, 4))
    ji.add(clustered(900, 5))
    ji.delete_rows([3, 4])
    q = clustered(8, 6)
    ti = IVFIndex.import_state(ji.export_state(), device="cpu")
    assert_layout_equal(ji, ti)
    close(ji.search(q, 10), ti.search(q, 10), 10)
    # the port adds on top of JAX's state the way JAX does
    extra = clustered(300, 7)
    ji.add(extra)
    ti.add(extra)
    assert_layout_equal(ji, ti)
    back = JaxIVF.import_state(ti.export_state())
    close(back.search(q, 10), ti.search(q, 10), 10)
    st = ti.export_state()
    assert st["cells"].dtype == np.float32 and st["cell_rows"].dtype == np.int32
    np.testing.assert_array_equal(st["spill_rows"], ji._spill_rows)


def test_empty_dot_and_small():
    with pytest.raises(ValueError):
        IVFIndex(D, "dot", device="cpu")
    ti = IVFIndex(D, device="cpu")
    d, i = ti.search(np.zeros(D, np.float32), 3)
    assert (d == MASKED).all() and (i == -1).all()
    ti.add(clustered(40, 8))  # 16 cells of cap 16
    assert ti.n_cells == 16 and ti.cells.shape[1] == 16
    d, i = ti.search(clustered(2, 9), 60)  # more than the probed rows
    assert (i[:, 40:] == -1).all() and (d[:, 40:] == MASKED).all()
