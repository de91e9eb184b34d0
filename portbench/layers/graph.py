"""Graph loop (index/graph.py beam_search, through index/hnsw.py): the
loop's own counters in the server's process (index/graph.py
count_searches, the metrics registry), read after the run. Ratios of
counters, so the warm-up's and the late searches, which run the same
loop at the same sizes, weigh as much as they are searches.

- graph.iters.<suffix>: loop iterations a beam_search call
  (longbow_hnsw_beam_iterations_total over longbow_hnsw_searches_total);
  each iteration is one host read.
- graph.loop_roofline.<suffix>: the least time of the window's store
  searches (the harness's store spans: their queries) over the device's
  busy time in the window, in %. A query's least time is the larger of
  its bytes at the memory bandwidth and its operations at the dense bf16
  rate (roofline.py's peaks): loop_bytes and loop_ops below, from the
  distances computed a query (longbow_hnsw_distance_calculations_total
  over longbow_hnsw_queries_total) and the loop's iterations.

Nothing where the program keeps no such counters (before they were
added), where no graph search ran, or, for the share, without a card.
"""
from __future__ import annotations

from roofline import peaks

NORM_BYTES = 4  # a row's f32 squared norm
ID_BYTES = 4    # an int32 neighbour id


def counters() -> dict:
    """{counter name: value} of the process's registry, or {} where the
    program has no registry."""
    try:
        from longbow_tpu_torch.metrics import get_registry
    except ImportError:
        return {}
    out = {}
    for m in get_registry().registry.collect():
        if m.kind == "counter" and not m.labelnames:
            out[m.name] = m.samples()[0][2]
    return out


def loop_bytes(distances: float, iters: float, dim: int, row_bytes: int, expand: int,
               m_max: int) -> float:
    """Bytes one query's search must move: each neighbour whose distance
    it computes read once (its row, norm and id), and the adjacency row
    of each node it expands (expand a query and iteration)."""
    return distances * (dim * row_bytes + NORM_BYTES + ID_BYTES) + iters * expand * m_max * ID_BYTES


def loop_ops(distances: float, dim: int) -> float:
    """Operations one query's search must do: 2 * D a distance."""
    return 2.0 * dim * distances


def read(ctx: dict, metric: str):
    c = counters()
    calls, iters = c.get("longbow_hnsw_searches_total"), c.get("longbow_hnsw_beam_iterations_total")
    queries = c.get("longbow_hnsw_queries_total")
    if not calls or iters is None or not queries:
        return None
    per_call = iters / calls
    if metric.startswith("graph.iters"):
        return per_call
    tr, spans = ctx.get("trace"), ctx.get("spans")
    if not tr or not spans or tr["busy_s"] <= 0 or "device_name" not in ctx:
        return None
    cfg, sec = ctx["config"], ctx["seconds"]
    server = cfg.get("server", {})
    dist = c["longbow_hnsw_distance_calculations_total"] / queries
    bw, flops = peaks(ctx["device_name"])
    q_bytes = loop_bytes(dist, per_call, cfg["dim"], cfg["row_bytes"],
                         int(server.get("hnsw_search_expand", 4)), int(server["hnsw_m_max"]))
    least_q = max(q_bytes / bw, loop_ops(dist, cfg["dim"]) / flops)
    n = sum(b for b, t0, _ in spans["store"] if 0 <= t0 <= sec)
    return 100.0 * n * least_q / tr["busy_s"]
