"""longbow_tpu_torch.index.graph_build against longbow_tpu.index.graph_build
on the CPU, stage by stage and whole.

Lattice rows (small integers, exact f32 arithmetic, many ties) must give
EQUAL integer outputs: adjacency, counts, long-range targets, kNN lists.
Random draws are JAX's own, made from the same keys and handed to the
port. The builds whose draws differ by construction (bulk_build_rp,
bulk_build_clustered) are held by the recall of their graph. No result
may depend on a chunk size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longbow_tpu.index import graph_build as jb
from longbow_tpu.index.hnsw import HNSWConfig as JaxConfig
from longbow_tpu.index.hnsw import HNSWIndex as JaxHNSW
from longbow_tpu_torch.index import graph as tgraph
from longbow_tpu_torch.index import graph_build as tb
from test_torch_graph import gaussian, lattice, to_torch_state

N, D, M, M_MAX, KNN = 1500, 16, 8, 16, 16
N_PAD = 2048


def tt(a):
    return torch.from_numpy(np.array(a))


def same(j, t, msg=""):
    np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=msg)


def jax_state(data, dtype=jnp.float32, cap=N_PAD, m2=M_MAX):
    """An unlinked JAX state holding `data` in its first rows."""
    n = len(data)
    from longbow_tpu.index.graph import graph_init

    s = graph_init(cap, data.shape[1], m2, dtype)
    v = jnp.zeros((cap, data.shape[1]), dtype).at[:n].set(jnp.asarray(data).astype(dtype))
    vf = v.astype(jnp.float32)
    return s._replace(
        vectors=v, norms_sq=jnp.sum(vf * vf, axis=1),
        valid=jnp.zeros((cap,), bool).at[:n].set(True),
    )


@pytest.fixture(scope="module")
def lat():
    """Lattice rows: the JAX state, the torch state, JAX's kNN lists and
    pruned forward edges."""
    js = jax_state(lattice(N, D, 10))
    knn_d, knn_i = jb._chunked_self_knn(js.vectors, js.norms_sq, js.valid, N, KNN, 1024)
    fwd_r, fwd_d = jb._prune_forward_all(js, knn_d, knn_i, M, 1024)
    return dict(js=js, ts=to_torch_state(js), knn_d=knn_d, knn_i=knn_i,
                fwd_r=fwd_r, fwd_d=fwd_d)


def test_chunked_self_knn_matches_jax(lat):
    ts = lat["ts"]
    d, i = tb._chunked_self_knn(ts.vectors, ts.norms_sq, ts.valid, N, KNN, 1024)
    same(lat["knn_d"], d)
    same(lat["knn_i"], i)
    # the pad granularity only adds rows; the chunk changes nothing
    d2, i2 = tb._chunked_self_knn(ts.vectors, ts.norms_sq, ts.valid, N, KNN, 100)
    assert torch.equal(d[:N], d2) and torch.equal(i[:N], i2)


def _cands(seed, n=300, c=24, d=D, lat_=True):
    rng = np.random.default_rng(seed)
    vecs = (lattice(n * c, d, seed) if lat_ else gaussian(n * c, d, seed)).reshape(n, c, d)
    q = lattice(n, d, seed + 1) if lat_ else gaussian(n, d, seed + 1)
    dist = ((vecs - q[:, None, :]) ** 2).sum(-1).astype(np.float32)
    order = np.argsort(dist, axis=1, kind="stable")
    dist = np.take_along_axis(dist, order, 1)
    vecs = np.take_along_axis(vecs, order[:, :, None], 1)
    rows = rng.permuted(np.tile(np.arange(c * 3), (n, 1)), axis=1)[:, :c].astype(np.int32)
    rows[:, -3:] = -1
    dist[:, -3:] = 3.0e38
    prot = rng.random((n, c)) < 0.1
    return rows, dist, vecs, prot


@pytest.mark.parametrize("lat_", [True, False], ids=["lattice", "gauss"])
@pytest.mark.parametrize("mode", ["plain", "protected", "fill", "protected_fill"])
def test_select_neighbors_heuristic(mode, lat_):
    rows, dist, vecs, prot = _cands(20, lat_=lat_)
    kw = dict(fill="fill" in mode)
    jkw = dict(kw, protected=jnp.asarray(prot)) if "protected" in mode else kw
    tkw = dict(kw, protected=tt(prot)) if "protected" in mode else kw
    jr, jd = jb.select_neighbors_heuristic(
        jnp.asarray(rows), jnp.asarray(dist), jnp.asarray(vecs), M, **jkw)
    tr, td = tb.select_neighbors_heuristic(tt(rows), tt(dist), tt(vecs), M, **tkw)
    same(jr, tr)
    same(jd, td)


def test_prune_forward_all_and_chunks(lat):
    r, d = tb._prune_forward_all(lat["ts"], tt(lat["knn_d"]), tt(lat["knn_i"]), M)
    same(lat["fwd_r"], r)
    same(lat["fwd_d"], d)
    r2, d2 = tb._prune_forward_all(lat["ts"], tt(lat["knn_d"]), tt(lat["knn_i"]), M, chunk=100)
    assert torch.equal(r, r2) and torch.equal(d, d2)


def test_symm_edges_select_store(lat):
    js, ts = lat["js"], lat["ts"]
    j_inc = jb._symm_edges(lat["fwd_r"], lat["fwd_d"], jnp.int32(N), m_max=M_MAX)
    t_inc = tb._symm_edges(tt(lat["fwd_r"]), tt(lat["fwd_d"]), N, m_max=M_MAX)
    for j, t, name in zip(j_inc, t_inc, ("inc_src", "inc_d", "inc_prot")):
        same(j, t, name)
    for diversify in (False, True):
        j_sel = jb._symm_select_seg(
            js, lat["fwd_r"], lat["fwd_d"], *j_inc, jnp.int32(0),
            seg_rows=N_PAD, m_max=M_MAX, diversify=diversify)
        t_sel = tb._symm_select_seg(
            ts, tt(lat["fwd_r"]), tt(lat["fwd_d"]), *t_inc, 0,
            seg_rows=N_PAD, m_max=M_MAX, diversify=diversify)
        for j, t, name in zip(j_sel, t_sel, ("sel_i", "sel_d", "cnt")):
            same(j, t, f"{name} diversify={diversify}")
        # two segments and small prune chunks give the same rows
        parts = [tb._symm_select_seg(
            ts, tt(lat["fwd_r"]), tt(lat["fwd_d"]), *t_inc, off,
            seg_rows=min(700, N_PAD - off), m_max=M_MAX, diversify=diversify,
            prune_chunk=300) for off in range(0, N_PAD, 700)]
        for whole, pieces in zip(t_sel, zip(*parts)):
            assert torch.equal(whole, torch.cat(pieces))
    # the store, into a wider adjacency than the selection
    wide_j = jax_state(lattice(N, D, 10), m2=M_MAX + 4)
    wide_t = to_torch_state(wide_j)
    out_j = jb._symm_store(wide_j, *j_sel, N, m_max=M_MAX)
    out_t = tb._symm_store(wide_t, *t_sel, N, m_max=M_MAX)
    for name in ("nbrs", "nbr_dists", "nbr_count"):
        same(getattr(out_j, name), getattr(out_t, name), name)


@pytest.mark.parametrize("n", [1500, 1_000_003])
def test_long_range_targets_wrap_like_uint32(n):
    rows = np.concatenate([np.arange(64), np.arange(n - 64, n)])
    for j in (0, 1):
        jr = jnp.asarray(rows, jnp.int32)
        want = ((jr.astype(jnp.uint32) * jnp.uint32(2654435761 + j * 40503)
                 + jnp.uint32(12345 + j)) % jnp.uint32(n)).astype(jnp.int32)
        want = jnp.where(want == jr, (want + 1) % n, want)
        same(want, tb.long_range_targets(tt(rows), n, j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bulk_build_edges_whole(dtype):
    js = jax_state(lattice(N, D, 11), jnp.dtype(dtype))
    ts = to_torch_state(js)
    out_j = jb.bulk_build_edges(js, N, m=M, m_max=M_MAX, knn_k=KNN)
    out_t = tb.bulk_build_edges(ts, N, m=M, m_max=M_MAX, knn_k=KNN)
    assert out_t.nbrs is ts.nbrs  # written in place
    for name in ("nbrs", "nbr_dists", "nbr_count"):
        same(getattr(out_j, name), getattr(out_t, name), name)
    # no edge to a dead row, no duplicate neighbour (long-range slots aside)
    nb = out_t.nbrs[:N, :M_MAX - 2]
    assert int(nb.max()) < N
    srt = torch.sort(nb, dim=1).values
    assert not ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()


def test_bulk_build_edges_sq8_state_keeps_codes():
    data = gaussian(N, D, 12)
    ji = JaxHNSW(D, "l2", JaxConfig(m=M, m_max=M_MAX), storage="sq8")
    ji.add(data)
    fresh = ji.state._replace(
        nbrs=jnp.full_like(ji.state.nbrs, -1),
        nbr_dists=jnp.full_like(ji.state.nbr_dists, 3.0e38),
        nbr_count=jnp.zeros_like(ji.state.nbr_count))
    ts = to_torch_state(fresh)
    want = jb.bulk_build_edges(fresh, N, m=M, m_max=M_MAX, knn_k=KNN)
    out = tb.bulk_build_edges(ts, N, m=M, m_max=M_MAX, knn_k=KNN)
    assert out.vectors.dtype == torch.uint8 and out.scale is not None
    assert out.vectors is ts.vectors
    # Gaussian rows: a near-tie may fall the other way, nothing more
    assert (out.nbrs.numpy() == np.asarray(want.nbrs)).mean() > 0.995


def _linked(seed, n0=1024, extra=300, dtype=jnp.float32):
    data = lattice(n0 + extra, D, seed)
    js = jax_state(data[:n0], dtype)
    js = jb.bulk_build_edges(js, n0, m=M, m_max=M_MAX, knn_k=KNN)
    v = js.vectors.at[n0:n0 + extra].set(jnp.asarray(data[n0:]).astype(dtype))
    vf = v.astype(jnp.float32)
    return js._replace(vectors=v, norms_sq=jnp.sum(vf * vf, axis=1),
                       valid=js.valid.at[n0:n0 + extra].set(True)), n0, extra


@pytest.mark.parametrize("ex,passes", [(1, 8), (4, 4)])
def test_insert_batch_with_padded_tail(ex, passes):
    js, n0, extra = _linked(13)
    ts = to_torch_state(js)
    sample = np.linspace(0, n0 + extra - 1, 256, dtype=np.int32)
    bs = 256
    rows = np.arange(n0, n0 + extra, dtype=np.int32)
    for off in range(0, extra, bs):
        chunk = rows[off:off + bs]
        if len(chunk) < bs:  # the tail batch repeats its last row
            chunk = np.pad(chunk, (0, bs - len(chunk)), mode="edge")
        kw = dict(ef_construction=32, m=M, cand_cap=16, reverse_passes=passes,
                  expand_per_iter=ex)
        js = jb.insert_batch(js, jnp.asarray(chunk), jnp.asarray(sample), **kw)
        out = tb.insert_batch(ts, tt(chunk), tt(sample), **kw)
        assert out.nbrs is ts.nbrs
    for name in ("nbrs", "nbr_dists", "nbr_count"):
        same(getattr(js, name), getattr(ts, name), name)
    new = ts.nbrs[n0:n0 + extra]
    assert not (new == torch.arange(n0, n0 + extra)[:, None]).any()  # no self-loops
    assert (ts.nbr_count[n0:n0 + extra] > 0).all()


def test_insert_batch_bf16_edges():
    js, n0, extra = _linked(14, extra=256, dtype=jnp.bfloat16)
    js = js._replace(nbr_dists=js.nbr_dists.astype(jnp.bfloat16))
    ts = to_torch_state(js)
    sample = np.linspace(0, n0 + extra - 1, 256, dtype=np.int32)
    rows = np.arange(n0, n0 + extra, dtype=np.int32)
    kw = dict(ef_construction=32, m=M, cand_cap=16, reverse_passes=4, expand_per_iter=4)
    js = jb.insert_batch(js, jnp.asarray(rows), jnp.asarray(sample), **kw)
    tb.insert_batch(ts, tt(rows), tt(sample), **kw)
    same(js.nbrs, ts.nbrs)
    same(js.nbr_count, ts.nbr_count)
    same(js.nbr_dists.astype(jnp.float32), ts.nbr_dists.float())


def test_reverse_lists(lat):
    j = jb._reverse_lists(lat["knn_i"], lat["knn_d"], N_PAD, 12)
    t = tb._reverse_lists(tt(lat["knn_i"]), tt(lat["knn_d"]), N_PAD, 12)
    same(j, t)


def test_rp_round_with_jax_draws(lat):
    js, ts = lat["js"], lat["ts"]
    block, kb, k_run = 512, 8, 12
    kd = jnp.full((N_PAD, k_run), 3.0e38, jnp.float32)
    ki = jnp.full((N_PAD, k_run), -1, jnp.int32)
    tkd, tki = tt(kd), tt(ki).long()
    root = jax.random.PRNGKey(3)
    for r in range(2):
        rkey = jax.random.fold_in(root, r)
        dirs = jax.random.normal(rkey, (D,), jnp.float32)
        order_j = jb._rp_order(js.vectors, js.valid, rkey, N, n_pad=N_PAD)
        order_t = tb._rp_order(ts.vectors, ts.valid, tt(dirs), N, n_pad=N_PAD)
        same(order_j, order_t, "order")
        kd, ki = jb._rp_round(js.vectors, js.norms_sq, js.valid, kd, ki, rkey, N, block, kb)
        tkd, tki = tb._rp_round(ts.vectors, ts.norms_sq, ts.valid, tkd, tki, tt(dirs),
                                N, block, kb, blocks_per_step=3)
        same(kd, tkd, f"round {r} dists")
        same(ki, tki, f"round {r} ids")
    again = tb._rp_round(ts.vectors, ts.norms_sq, ts.valid, tt(jnp.full_like(kd, 3.0e38)),
                         tt(jnp.full_like(ki, -1)).long(), tt(dirs), N, block, kb)
    one = tb._rp_round(ts.vectors, ts.norms_sq, ts.valid, tt(jnp.full_like(kd, 3.0e38)),
                       tt(jnp.full_like(ki, -1)).long(), tt(dirs), N, block, kb,
                       blocks_per_step=1)
    assert torch.equal(again[0], one[0]) and torch.equal(again[1], one[1])


@pytest.mark.parametrize("sampled", [False, True])
def test_nn_descent_round_with_jax_draws(lat, sampled):
    js, ts = lat["js"], lat["ts"]
    kd, ki = lat["knn_d"][:, :12], lat["knn_i"][:, :12]
    # a poor estimate to refine: shuffle each row's tail in
    ki = ki.at[:, 6:].set(jnp.roll(ki[:, 6:], 5, axis=0))
    kd = kd.at[:, 6:].set(3.0e37)
    expand, rev_slots = 4, 8
    fcols = rcols = None
    rkey = None
    if sampled:
        rkey = jax.random.PRNGKey(9)
        seg_key = jax.random.fold_in(rkey, 77_000)
        fcols = tt(jax.random.randint(jax.random.fold_in(seg_key, 1), (N_PAD, expand), 0, 12))
        rcols = tt(jax.random.randint(jax.random.fold_in(seg_key, 2),
                                      (N_PAD, max(expand // 2, 2)), 0, rev_slots))
    jd, ji = jb._nn_descent_round(js.vectors, js.norms_sq, js.valid, kd, ki, N, rkey,
                                  expand=expand, rev_slots=rev_slots, chunk=1024)
    args = (ts.vectors, ts.norms_sq, ts.valid, tt(kd), tt(ki).long(), N, fcols, rcols)
    td, ti = tb._nn_descent_round(*args, expand=expand, rev_slots=rev_slots)
    same(jd, td)
    same(ji, ti)
    td2, ti2 = tb._nn_descent_round(*args, expand=expand, rev_slots=rev_slots, chunk=300)
    assert torch.equal(td, td2) and torch.equal(ti, ti2)


def test_assign_clusters_matches_jax():
    data = gaussian(3000, D, 15)
    js = jax_state(data, cap=3000)
    cent = gaussian(20, D, 16)
    want = jb._assign_clusters(js.vectors, js.norms_sq, jnp.asarray(cent), 3000, chunk=1024)
    ts = to_torch_state(js)
    got = tb._assign_clusters(ts.vectors, ts.norms_sq, tt(cent), 3000, chunk=1000)
    np.testing.assert_array_equal(want, got.numpy())


def _graph_recall(state, data, n, k=10, ef=48):
    """recall@k of a beam search over the built graph (the port's search,
    whoever built the adjacency) against exact search, 256 queries."""
    if not isinstance(state.nbrs, torch.Tensor):
        state = to_torch_state(state)
    q = torch.from_numpy(gaussian(256, D, 99))
    truth = torch.cdist(q, torch.from_numpy(data[:n])).topk(k, largest=False).indices
    sample = torch.arange(0, n, max(1, n // 128))
    _, got = tgraph.beam_search(state, q, sample, k, ef)
    return float((truth[:, :, None] == got.long()[:, None, :]).any(2).float().mean())


@pytest.mark.parametrize("route", ["rp", "clustered"])
def test_bulk_builds_by_graph_recall(route):
    n = 4096
    data = gaussian(n, D, 17)
    js = jax_state(data, cap=4096, m2=M_MAX)
    ts = to_torch_state(js)
    if route == "rp":
        kw = dict(m=M, m_max=M_MAX, knn_k=16, rounds=4, block=512, nn_rounds=2)
        out_j = jb.bulk_build_rp(js, n, **kw)
        out_t = tb.bulk_build_rp(ts, n, **kw)
    else:
        kw = dict(m=M, m_max=M_MAX, knn_k=16)
        out_j = jb.bulk_build_clustered(js, n, **kw)
        out_t = tb.bulk_build_clustered(ts, n, **kw)
    rj, rt = _graph_recall(out_j, data, n), _graph_recall(out_t, data, n)
    assert rt > 0.8, (rj, rt)
    assert rt > rj - 0.03, (rj, rt)
    assert (out_t.nbr_count[:n] > 0).all()
    assert int(out_t.nbrs.max()) < n


def test_rp_build_with_capacity_below_block_padding():
    n = 1100  # n_pad = 2048 at block 1024, capacity 1536
    data = gaussian(n, D, 18)
    ts = to_torch_state(jax_state(data, cap=1536))
    out = tb.bulk_build_rp(ts, n, m=M, m_max=M_MAX, knn_k=16, rounds=3, block=1024)
    assert _graph_recall(out, data, n) > 0.8
    assert int(out.nbrs.max()) < n


def test_rp_build_is_seeded():
    data = gaussian(1024, D, 19)
    outs = [tb.bulk_build_rp(to_torch_state(jax_state(data, cap=1024)), 1024, m=M,
                             m_max=M_MAX, knn_k=16, rounds=2, block=256, seed=s).nbrs
            for s in (0, 0, 1)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_build_stage_timer(monkeypatch, capsys):
    assert tb.build_stage_timer(10)("x") is None
    monkeypatch.setenv("LONGBOW_BUILD_DEBUG", "1")
    tb.stage_log.clear()
    tb.build_stage_timer(10, tag="t")("stage one", torch.zeros(2))
    assert tb.stage_log[0][:3] == ("t", 10, "stage one")
    assert "[t 10] stage one" in capsys.readouterr().err


@pytest.mark.cuda
def test_self_knn_through_the_fused_scan_on_card():
    """On a card a bf16 block's self-kNN is kernel K1: its launch count
    rises by one per 4,096 query rows, and the lists agree with the plain
    route's on the same rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from longbow_tpu_torch.ops import _kernels

    n = 9000
    ts = to_torch_state(jax_state(gaussian(n, 32, 21), jnp.bfloat16, cap=16384))
    on_card = tgraph.GraphState(*(t.cuda() if t is not None else None for t in ts))
    before = _kernels.FUSED_SCAN.launches
    d, i = tb._chunked_self_knn(on_card.vectors, on_card.norms_sq, on_card.valid, n, 16)
    assert _kernels.FUSED_SCAN.launches - before == 3  # 9,216 padded rows
    pd, pi = tb._chunked_self_knn(ts.vectors, ts.norms_sq, ts.valid, n, 16)
    torch.testing.assert_close(d.cpu()[:n], pd[:n], rtol=1e-3, atol=1e-2)
    assert (i.cpu()[:n] == pi[:n]).float().mean() > 0.99
