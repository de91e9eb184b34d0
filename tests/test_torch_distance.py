"""longbow_tpu_torch.ops.distance against longbow_tpu.ops.distance on the CPU.

The same seeded numpy inputs go through both. Tolerance rtol 1e-5 /
atol 1e-4: both compute in float32 and differ only in summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longbow_tpu.ops import distance as jd
from longbow_tpu_torch.ops import distance as td

RTOL, ATOL = 1e-5, 1e-4
METRICS = ["l2", "dot", "cosine"]


def _data(n=900, d=48, b=6, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, d), dtype=np.float32),
        rng.standard_normal((n, d), dtype=np.float32),
        rng,
    )


def _check_search(jres, tres):
    jdist, jidx = (np.asarray(x) for x in jres)
    tdist, tidx = (x.numpy() for x in tres)
    real = jdist < td.MASKED_GUARD
    np.testing.assert_array_equal(real, tdist < td.MASKED_GUARD)
    np.testing.assert_array_equal(np.where(real, jidx, -1), np.where(real, tidx, -1))
    np.testing.assert_allclose(tdist, jdist, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", METRICS)
def test_exact_search_matches_jax(metric):
    q, c, _ = _data()
    jres = jd.exact_search(jnp.asarray(q), jnp.asarray(c), 10, metric)
    tres = td.exact_search(q, c, 10, metric, device="cpu")
    _check_search(jres, tres)


@pytest.mark.parametrize("metric", METRICS)
def test_exact_search_valid_and_extra_mask(metric):
    q, c, rng = _data(seed=1)
    valid = rng.random(c.shape[0]) > 0.3
    extra = rng.random(c.shape[0]) > 0.5
    norms = np.sum(c * c, axis=1)
    jres = jd.exact_search(
        jnp.asarray(q), jnp.asarray(c), 12, metric,
        corpus_norms_sq=jnp.asarray(norms), valid=jnp.asarray(valid),
        extra_mask=jnp.asarray(extra),
    )
    tres = td.exact_search(
        q, c, 12, metric, corpus_norms_sq=norms, valid=valid,
        extra_mask=extra, device="cpu",
    )
    _check_search(jres, tres)
    allowed = valid & extra
    assert allowed[tres[1].numpy()].all()


@pytest.mark.parametrize("metric", METRICS)
def test_exact_search_chunked(metric):
    q, c, rng = _data(n=1000, seed=2)
    valid = rng.random(c.shape[0]) > 0.1
    jres = jd.exact_search(
        jnp.asarray(q), jnp.asarray(c), 10, metric,
        valid=jnp.asarray(valid), normalize=metric == "cosine", chunk_rows=256,
    )
    tres = td.exact_search(
        q, c, 10, metric, valid=valid, normalize=metric == "cosine",
        chunk_rows=256, device="cpu",
    )
    _check_search(jres, tres)
    # the chunked scan agrees with one unchunked pass
    whole = td.exact_search(q, c, 10, metric, valid=valid,
                            normalize=metric == "cosine", device="cpu")
    np.testing.assert_array_equal(whole[1].numpy(), tres[1].numpy())


@pytest.mark.parametrize("metric", METRICS)
def test_distance_matrix_matches_jax(metric):
    q, c, rng = _data(n=300, seed=3)
    valid = rng.random(c.shape[0]) > 0.2
    norms = np.sum(c * c, axis=1)
    want = np.asarray(jd.distance_matrix(
        jnp.asarray(q), jnp.asarray(c), metric,
        corpus_norms_sq=jnp.asarray(norms), valid=jnp.asarray(valid),
    ))
    got = td.distance_matrix(
        torch.from_numpy(q), torch.from_numpy(c), metric,
        corpus_norms_sq=torch.from_numpy(norms), valid=torch.from_numpy(valid),
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got[:, ~valid] == np.float32(td.MASKED)).all()


def test_tombstone_rows_matches_jax():
    rng = np.random.default_rng(4)
    valid = rng.random(500) > 0.2
    rows = np.concatenate([rng.choice(500, 40, replace=False), [500, 900]])
    want = np.asarray(jd.tombstone_rows(jnp.asarray(valid), rows))
    tv = torch.from_numpy(valid.copy())
    got = td.tombstone_rows(tv, rows)
    assert got is tv  # in place
    np.testing.assert_array_equal(got.numpy(), want)


def test_cosine_report_matches_jax():
    d = np.array([[0.0, 0.5, 2.0, td.MASKED], [1.0, 3.9, td.MASKED, td.MASKED]],
                 np.float32)
    want = np.asarray(jd.cosine_report(d))
    np.testing.assert_array_equal(td.cosine_report(d), want)
    np.testing.assert_array_equal(td.cosine_report(torch.from_numpy(d)).numpy(), want)


def test_bucket_queries_and_pad_to_match_jax():
    for b in (1, 3, 4, 5, 100, 4096, 5000):
        q = np.ones((b, 8), np.float32)
        jp, jb = jd.bucket_queries(q)
        tp, tb = td.bucket_queries(q)
        assert jb == tb == b
        np.testing.assert_array_equal(tp, jp)
    for n, m in ((0, 128), (1, 128), (128, 128), (129, 128), (700, 256)):
        assert td.pad_to(n, m) == jd.pad_to(n, m)


def test_metric_validate_matches_jax():
    for name in ("l2", "euclidean", "squared_l2", "ip", "dot_product", "cosine",
                 "hamming", None):
        assert td.Metric.validate(name) == jd.Metric.validate(name)
    with pytest.raises(ValueError):
        td.Metric.validate("manhattan")


def test_exact_search_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: None means the card")
    q, c, _ = _data(n=50, b=2)
    with pytest.raises(RuntimeError):
        td.exact_search(q, c, 5)


# -- complex and float64 inputs (the compute form of _canon_dtype) -------------


def _complex(n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) + 1j * rng.standard_normal((n, d))).astype(np.complex64)


@pytest.mark.parametrize("metric", METRICS)
def test_exact_search_complex_matches_jax_and_the_widened_view(metric):
    """complex64 rows search as their [real, imag] widening, in both
    packages."""
    c, q = _complex(700, 16, 0), _complex(5, 16, 1)
    tres = td.exact_search(q, c, 10, metric, device="cpu")
    _check_search(jd.exact_search(jnp.asarray(q), jnp.asarray(c), 10, metric), tres)
    wide = td.exact_search(np.concatenate([q.real, q.imag], 1),
                           np.concatenate([c.real, c.imag], 1), 10, metric, device="cpu")
    np.testing.assert_array_equal(tres[1].numpy(), wide[1].numpy())
    np.testing.assert_array_equal(tres[0].numpy(), wide[0].numpy())
    assert td.complex_as_real(torch.from_numpy(c)).shape == (700, 32)


@pytest.mark.parametrize("metric", METRICS)
def test_f64_inputs_compute_in_f32_like_jax(metric):
    """float64 becomes float32 (JAX with x64 off, its default): the same
    answers as the f32 call, and as JAX's."""
    q, c, _ = _data(seed=3)
    q64, c64 = q.astype(np.float64), c.astype(np.float64)
    tres = td.exact_search(q64, c64, 10, metric, device="cpu")
    f32 = td.exact_search(q, c, 10, metric, device="cpu")
    np.testing.assert_array_equal(tres[0].numpy(), f32[0].numpy())
    np.testing.assert_array_equal(tres[1].numpy(), f32[1].numpy())
    _check_search(jd.exact_search(jnp.asarray(q64), jnp.asarray(c64), 10, metric), tres)
    assert td._canon_dtype(c64).dtype == torch.float32


@pytest.mark.parametrize("metric", METRICS)
def test_complex_distance_matrix_norms_and_pairwise_match_jax(metric):
    c, q = _complex(60, 8, 2), _complex(4, 8, 3)
    np.testing.assert_allclose(td.distance_matrix(torch.from_numpy(q), torch.from_numpy(c),
                                                  metric).numpy(),
                               np.asarray(jd.distance_matrix(jnp.asarray(q), jnp.asarray(c),
                                                             metric)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(td.squared_norms(c).numpy(),
                               np.asarray(jd.squared_norms(jnp.asarray(c))), rtol=RTOL)
    for a, b in ((c[:4], q), (c[:4].real.astype(np.float64), q.real.astype(np.float64))):
        np.testing.assert_allclose(td.pairwise_distance(a, b, metric).numpy(),
                                   np.asarray(jd.pairwise_distance(jnp.asarray(a), jnp.asarray(b),
                                                                   metric)),
                                   rtol=RTOL, atol=ATOL)
