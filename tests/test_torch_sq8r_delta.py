"""sq8r's delta region on the card: kernel K2 over the delta's
cluster-grouped view (index/sq8.py::delta_view) against the plain chunked
scan it replaced, at Deep-10M's width. Needs a CUDA card (the kernel has
no CPU mode) and skips without one; the CPU cases, with K2's plain
version, are in test_torch_sq8.py.

The two routes sum the same f32 terms in another order, so a pool may
swap candidates whose coarse distances tie within that rounding: the
pools are held equal on every candidate below the 64th distance by more
than 1e-4 of it, and their sorted distances to 1e-4 relative.
"""
import numpy as np
import pytest
import torch

from longbow_tpu_torch.index.sq8 import (
    POOL,
    SQ8ResidualIndex,
    _sq8r_search,
    delta_pool,
    query_terms,
)
from longbow_tpu_torch.ops.distance import Metric

RTOL = 1e-4


@pytest.mark.cuda
def test_delta_k2_pool_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    n, d, c, b, k = 300_000, 96, 1024, 1_000, 10
    g = torch.Generator(device="cuda").manual_seed(17)
    centres = torch.randn((c, d), generator=g, device="cuda") * 4.0
    rows = centres[torch.randint(0, c, (n,), generator=g, device="cuda")] + torch.randn(
        (n, d), generator=g, device="cuda")
    idx = SQ8ResidualIndex(d, n_clusters=c, device="cuda")
    idx.rebuild_min = 2 * n  # every row stays in the delta
    idx.add(rows)
    assert idx.d_count == n and idx.m_codes.shape[0] == 0
    dead = torch.randperm(n, generator=g, device="cuda")[: n // 100].cpu().numpy()
    idx.delete_rows(dead)
    q = rows[torch.randint(0, n, (b,), generator=g, device="cuda")] + 0.3 * torch.randn(
        (b, d), generator=g, device="cuda")

    with idx._mu:
        view = idx._delta_view()
    assert view is not None  # the view, 375,808 rows or so, is under 16 x 524,288
    terms = query_terms(q, idx.centers, idx.lo, idx.hi, False)
    region = (idx.d_codes, idx.d_cid, idx.d_norms, idx.d_valid, Metric.L2, POOL, idx.device)
    kd, ks = delta_pool(terms, view, *region)
    pd, ps = delta_pool(terms, None, *region)
    torch.cuda.synchronize()
    kd, ks, pd, ps = (t.cpu().numpy() for t in (kd, ks, pd, ps))
    np.testing.assert_allclose(kd, pd, rtol=RTOL, atol=0)
    live = np.ones(n, bool)
    live[dead] = False
    assert ((ks >= 0) & (ks < n)).all() and live[ks].all()
    sure = pd < pd[:, -1:] * (1 - RTOL)
    for i in range(b):
        assert set(ps[i][sure[i]].tolist()) <= set(ks[i].tolist()), i
        assert set(ks[i][kd[i] < pd[i, -1] * (1 - RTOL)].tolist()) <= set(ps[i].tolist()), i

    # the whole search, k = 10, against the plain route's
    got_d, got_i = idx.search(q, k)
    want_d, want_i = (t.cpu().numpy() for t in _sq8r_search(
        q, idx.m_codes, idx.m_gcid, idx.m_norms, idx.m_valid, idx.m_ext,
        idx.d_codes, idx.d_cid, idx.d_norms, idx.d_valid, idx.d_ext,
        idx.centers, idx.lo, idx.hi, None, k, Metric.L2, False, True, True, idx.device))
    np.testing.assert_allclose(got_d, want_d, rtol=RTOL, atol=0)
    assert live[got_i].all()
    apart = np.diff(want_d, axis=1) > RTOL * want_d[:, 1:]
    untied = np.ones(want_d.shape, bool)
    untied[:, 1:] &= apart
    untied[:, :-1] &= apart
    np.testing.assert_array_equal(got_i[untied], want_i[untied])
