"""The graph loop's spans and counters (index/graph.py, index/hnsw.py):
the spans' names, order and attributes; the counters against the loop's
own counts (its iterations and its real neighbour distances, the
nbr_ok slots), on a chain whose counts are known and on seeded random
rows; and the same answers with the recorder on and off."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import longbow_tpu_torch.metrics.registry as registry
from longbow_tpu_torch.index.graph import beam_search, graph_init
from longbow_tpu_torch.index.hnsw import HNSWConfig, HNSWIndex
from longbow_tpu_torch.parallel.mesh import make_mesh
from longbow_tpu_torch.parallel.sharded_graph import ShardedGraphIndex
from longbow_tpu_torch.utils import tracing
from test_torch_graph import gaussian

D = 16
CFG = dict(m=8, m_max=16, ef_construction=32, ef_search=32, insert_batch_size=256)
COUNTERS = ("longbow_hnsw_searches_total", "longbow_hnsw_queries_total",
            "longbow_hnsw_beam_iterations_total", "longbow_hnsw_distance_calculations_total")


@pytest.fixture
def fresh_registry(monkeypatch):
    monkeypatch.setattr(registry, "_global", registry.MetricsRegistry())


def counts() -> dict:
    reg = registry.get_registry()
    return {name: reg.counter(name).samples()[0][2] for name in COUNTERS}


def built(n=3000, seed=0, **cfg) -> HNSWIndex:
    idx = HNSWIndex(D, "l2", HNSWConfig(**dict(CFG, **cfg)), device="cpu")
    idx.add(gaussian(n, D, seed))
    return idx


def under_filled() -> tuple:
    """An index of ef_search 10 and a filter that admits fewer rows than
    k: a search retries at ef 50, then 250."""
    idx = built(1000, ef_search=10)
    mask = np.zeros(idx.capacity, bool)
    mask[:6] = True
    return idx, mask


def traced(fn):
    tracing.start()
    try:
        out = fn()
    finally:
        trace = tracing.stop()
    return out, trace.records


def named(records, name) -> list:
    return [r for r in records if r[0] == name]


def test_spans_of_a_search_in_order_with_their_attributes():
    idx = built()
    q = gaussian(8, D, 1)
    _, recs = traced(lambda: idx.search(q, 10))
    (entry,), (beam,), (extract,), (host,) = (
        named(recs, f"longbow.{n}") for n in ("hnsw.entry", "hnsw.beam", "hnsw.extract",
                                               "index.to_host"))
    assert entry[3] <= beam[2] <= beam[3] <= extract[2] <= extract[3] <= host[2]
    assert len({r[1] for r in (entry, beam, extract, host)}) == 1  # the caller's thread
    assert beam[4] == {"B": 8, "ef": 32, "iterations": idx.last_search_iters}
    assert idx.last_search_iters > 0
    assert not named(recs, "longbow.hnsw.retry")


def test_a_filtered_search_extracts_in_the_loop_and_retries_under_its_span():
    idx, mask = under_filled()
    _, recs = traced(lambda: idx.search(gaussian(4, D, 2), 10, filter_mask=mask))
    assert not named(recs, "longbow.hnsw.extract")  # results tracked inside the loop
    retries = named(recs, "longbow.hnsw.retry")
    beams = named(recs, "longbow.hnsw.beam")
    assert [r[4] for r in retries] == [{"ef": 50}, {"ef": 250}]
    assert [b[4]["ef"] for b in beams] == [10, 50, 250]
    for r, b in zip(retries, beams[1:]):
        assert r[2] <= b[2] and b[3] <= r[3]
    assert beams[-1][4]["iterations"] == idx.last_search_iters


def test_counters_count_a_chain_walk_exactly(fresh_registry):
    """A chain 0 - 1 - ... - 49 entered at 0, a query past 49, one node
    expanded an iteration and a beam wider than the chain: each node is
    expanded once and every neighbour but the one behind it is new, so
    the loop runs 50 iterations and computes 49 distances."""
    n = 50
    s = graph_init(64, 2, 2, device="cpu")
    s.vectors[:n, 0] = torch.arange(n, dtype=torch.float32)
    s.norms_sq[:n] = s.vectors[:n, 0] ** 2
    s.valid[:n] = True
    i = torch.arange(n, dtype=torch.int32)
    s.nbrs[:n, 0] = i - 1
    s.nbrs[:n, 1] = torch.where(i + 1 < n, i + 1, -1)
    s.nbr_count[:n] = 2
    stats: dict = {}
    d, r = beam_search(s, torch.tensor([[60.0, 0.0]]), torch.tensor([0]), 3, 64,
                       expand_per_iter=1, stats=stats)
    assert r[0].tolist() == [49, 48, 47]
    assert stats["iters"] == n and int(stats["distances"]) == n - 1


def test_counters_equal_the_loops_own_counts(fresh_registry):
    idx = built(seed=3)
    idx.delete_rows(np.arange(0, 3000, 50))
    q = gaussian(16, D, 4)
    before = counts()
    idx.search(q, 10)
    after = counts()
    delta = {k: after[k] - before[k] for k in COUNTERS}
    stats: dict = {}  # the same call, as HNSWIndex.search makes it
    beam_search(idx.state, torch.from_numpy(q), idx._sample_rows, 10, 32,
                track_results=False, expand_per_iter=4, stats=stats)
    assert delta == {"longbow_hnsw_searches_total": 1, "longbow_hnsw_queries_total": 16,
                     "longbow_hnsw_beam_iterations_total": idx.last_search_iters,
                     "longbow_hnsw_distance_calculations_total": int(stats["distances"])}
    assert stats["iters"] == idx.last_search_iters
    # each distance came from an expanded node's edge
    assert 0 < int(stats["distances"]) <= 16 * 4 * CFG["m_max"] * stats["iters"]


def test_retries_and_shards_count_each_beam_search_call(fresh_registry):
    idx, mask = under_filled()
    before = counts()
    idx.search(gaussian(4, D, 2), 10, filter_mask=mask)  # two ef retries
    after = counts()
    assert after["longbow_hnsw_searches_total"] - before["longbow_hnsw_searches_total"] == 3
    assert after["longbow_hnsw_queries_total"] - before["longbow_hnsw_queries_total"] == 12
    sharded = ShardedGraphIndex(D, make_mesh(4, device="cpu"), config=HNSWConfig(**CFG))
    sharded.add(gaussian(2000, D, 5))
    sharded.build()
    before = counts()
    sharded.search(gaussian(8, D, 6), 10)
    after = counts()
    assert after["longbow_hnsw_searches_total"] - before["longbow_hnsw_searches_total"] == 4
    assert after["longbow_hnsw_queries_total"] - before["longbow_hnsw_queries_total"] == 32
    iters = "longbow_hnsw_beam_iterations_total"
    assert after[iters] > before[iters]


@pytest.mark.parametrize("filtered", [False, True])
def test_answers_are_the_same_with_the_recorder_on_and_off(filtered):
    idx = built(seed=7)
    idx.delete_rows(np.arange(1, 3000, 13))
    q = gaussian(32, D, 8)
    mask = (np.arange(idx.capacity) % 3 == 0) if filtered else None
    off = idx.search(q, 10, filter_mask=mask)
    iters_off = idx.last_search_iters
    on, recs = traced(lambda: idx.search(q, 10, filter_mask=mask))
    np.testing.assert_array_equal(off[0], on[0])
    np.testing.assert_array_equal(off[1], on[1])
    assert idx.last_search_iters == iters_off
    assert named(recs, "longbow.hnsw.beam")[0][4]["iterations"] == iters_off
