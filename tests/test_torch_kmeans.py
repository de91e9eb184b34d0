"""longbow_tpu_torch.ops.kmeans against longbow_tpu.ops.kmeans on the CPU.

Both run Lloyd iterations in f32 from the same numpy init; the update
sums rows in another order (a matmul by a one-hot there, a scatter-add
here), so centroids agree to rtol 1e-4 / atol 1e-5 and the assignments
exactly. kmeans_init draws its rows from a torch.Generator and cannot
reproduce jax.random.choice's, so it is tested on its own.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longbow_tpu.ops.kmeans import lloyd as jax_lloyd
from longbow_tpu_torch.ops.kmeans import kmeans_init, lloyd


def _clustered(n, d, g=1, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((g, 32, d)).astype(np.float32) * 3
    pick = rng.integers(0, 32, (g, n))
    out = np.take_along_axis(centers, pick[:, :, None], axis=1)
    return out + rng.standard_normal((g, n, d)).astype(np.float32)


@pytest.mark.parametrize("g,n,d,k,iters", [(1, 2000, 16, 32, 8), (3, 700, 8, 12, 5),
                                           (1, 1500, 24, 64, 10)])
def test_lloyd_matches_jax(g, n, d, k, iters):
    data = _clustered(n, d, g, seed=n)
    rng = np.random.default_rng(1)
    init = np.stack([data[i, rng.choice(n, k, replace=False)] for i in range(g)])
    jc, ja = jax_lloyd(jnp.asarray(data), jnp.asarray(init), n_iters=iters)
    tc, ta = lloyd(torch.from_numpy(data), torch.from_numpy(init), iters)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)


def test_lloyd_keeps_an_empty_clusters_centroid():
    data = _clustered(500, 8, seed=3)
    init = np.concatenate([data[:, :7], np.full((1, 1, 8), 1e3, np.float32)], axis=1)
    jc, _ = jax_lloyd(jnp.asarray(data), jnp.asarray(init), n_iters=4)
    tc, ta = lloyd(torch.from_numpy(data), torch.from_numpy(init), 4)
    assert not (ta == 7).any()
    np.testing.assert_array_equal(tc[0, 7].numpy(), init[0, 7])
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)


def test_kmeans_reduces_distortion():
    data = torch.from_numpy(_clustered(2000, 16))
    cent, assign = lloyd(data, kmeans_init(data, 32, 0), 8)
    d2 = ((data[0] - cent[0][assign[0]]) ** 2).sum(-1).mean()
    assert d2 < 0.5 * data[0].var(dim=0).sum()


def test_kmeans_init_is_seeded_and_distinct():
    data = torch.from_numpy(_clustered(1000, 8, g=2))
    a, b, c = kmeans_init(data, 50, 0), kmeans_init(data, 50, 0), kmeans_init(data, 50, 1)
    assert a.shape == (2, 50, 8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.unique(a[0], dim=0).shape[0] == 50
    # rows of the data, the same rows for every problem
    rows = [(data[0] == r).all(dim=1).nonzero()[0, 0] for r in a[0]]
    assert torch.equal(a[1], data[1][torch.stack(rows)])


def test_kmeans_init_wants_k_distinct_rows():
    """As jax.random.choice without replacement: k > n raises (a PQ index's
    first add needs 256 rows, an IVF index's 16)."""
    with pytest.raises(ValueError, match="distinct"):
        kmeans_init(torch.zeros((1, 10, 4)), 11, 0)
