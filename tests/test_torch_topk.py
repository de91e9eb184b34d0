"""longbow_tpu_torch.ops.topk against longbow_tpu.ops.topk on the CPU."""
import jax.numpy as jnp
import numpy as np
import torch

from longbow_tpu.ops import topk as jt
from longbow_tpu_torch.ops import topk as tt


def _dist(shape, seed):
    # distinct values: equal distances may come back in either order
    rng = np.random.default_rng(seed)
    return rng.permutation(np.prod(shape)).reshape(shape).astype(np.float32) / 7.0


def test_topk_smallest_matches_jax():
    d = _dist((4, 50), 0)
    wd, wi = jt.topk_smallest(jnp.asarray(d), 9)
    gd, gi = tt.topk_smallest(torch.from_numpy(d), 9)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_masked_topk_matches_jax():
    d = _dist((3, 40), 1)
    mask = np.random.default_rng(1).random((3, 40)) > 0.5
    wd, wi = jt.masked_topk(jnp.asarray(d), jnp.asarray(mask), 6)
    gd, gi = tt.masked_topk(torch.from_numpy(d), torch.from_numpy(mask), 6)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert mask[np.arange(3)[:, None], gi.numpy()].all()


def test_merge_topk_matches_jax():
    d = _dist((2, 3, 20), 2)
    d1, d2 = d[..., :10], d[..., 10:]
    i1 = np.arange(10, dtype=np.int32)[None, None].repeat(3, 1).repeat(2, 0)
    i2 = i1 + 100
    wd, wi = jt.merge_topk(*(jnp.asarray(x) for x in (d1, i1, d2, i2)), 7)
    gd, gi = tt.merge_topk(*(torch.from_numpy(x) for x in (d1, i1, d2, i2)), 7)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_dedup_distances_matches_jax():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 6, (4, 12)).astype(np.int32)
    d = _dist((4, 12), 3)
    want = np.asarray(jt.dedup_distances(jnp.asarray(d), jnp.asarray(idx)))
    got = tt.dedup_distances(torch.from_numpy(d), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)


def test_sort_by_distance_matches_jax():
    d = _dist((5, 16), 4)
    idx = np.random.default_rng(4).integers(0, 1000, (5, 16)).astype(np.int32)
    wd, wi = jt.sort_by_distance(jnp.asarray(d), jnp.asarray(idx))
    gd, gi = tt.sort_by_distance(torch.from_numpy(d), torch.from_numpy(idx))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
