"""sq8r's delta counters and the coalescer's overlap over a benchmark
cell's traced window: portbench/spansplit.py's run, unchanged, with
longbow_sq8r_delta_scans_total{route}, longbow_sq8r_delta_views_total,
longbow_coalescer_overlapped_dispatches_total and the count and sum of
longbow_search_coalesce_batch_size (the coalescer's store searches and
their queries) read from the port's registry as the device trace starts
and stops.

    python3 -m longbow_tpu_torch.tools.sq8r_delta_counts [--bench portbench] \\
        -- --workload <cell> --seed <n> --seconds <s>

from a checkout's root, on a card (the arguments after `--` are
spansplit's). The cell's server runs in this process, so its registry is
this one. Prints spansplit's line, then one line {"counters": ...,
"coalescer": ...}: each sample at the trace's start and stop, the
difference between them (the window's scans by route, views, overlapped
dispatches and store searches) and the samples at the end; then the
window's store searches through the coalescer, the share of them that
overlapped another dispatch's wait and their mean batch in queries.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from longbow_tpu_torch.metrics.registry import PORT_METRICS, get_registry

NAMES = ("longbow_sq8r_delta_scans_total", "longbow_sq8r_delta_views_total",
         "longbow_coalescer_overlapped_dispatches_total")
BATCH = "longbow_search_coalesce_batch_size"  # a histogram: one sample a store search


def readings() -> dict:
    """{sample name and labels: value} of the counters, and of the batch
    histogram's count and sum, now."""
    reg = get_registry()
    rows = [row for name in NAMES for row in reg.counter(name, PORT_METRICS[name][1]).samples()
            if row[0].endswith("_total")]
    rows += [row for row in reg.histogram(BATCH).samples() if row[0].endswith(("_count", "_sum"))]
    return {sample + json.dumps(dict(pairs), sort_keys=True): value
            for sample, pairs, value in rows}


def coalescer(window: dict) -> dict:
    """The window's store searches through the coalescer, the share of
    them that overlapped, and their mean batch (queries); {} where none."""
    n = window.get(BATCH + "_count{}", 0.0)
    if not n:
        return {}
    return {"dispatches": n,
            "overlapped_share": window.get(NAMES[2] + "{}", 0.0) / n,
            "mean_batch": window.get(BATCH + "_sum{}", 0.0) / n}


def window(start: dict, stop: dict) -> dict:
    """Each sample's growth from start to stop (a sample first written in
    between grew from 0)."""
    return {key: value - start.get(key, 0.0) for key, value in stop.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bench", default="portbench")
    ap.add_argument("spansplit_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    bench = Path(args.bench).resolve()
    sys.path[:0] = [str(bench)]
    import devtrace
    import spansplit

    snap: dict = {}
    start, stop = devtrace.DeviceTrace.start, devtrace.DeviceTrace.stop

    def start_read(self):
        snap["trace_start"] = readings()
        return start(self)

    def stop_read(self):
        snap["trace_stop"] = readings()
        return stop(self)

    devtrace.DeviceTrace.start, devtrace.DeviceTrace.stop = start_read, stop_read
    try:
        rest = [a for a in args.spansplit_args if a != "--"]
        rc = spansplit.main(rest, bench=bench)
    finally:
        devtrace.DeviceTrace.start, devtrace.DeviceTrace.stop = start, stop
    snap["end"] = readings()
    out = {"counters": snap}
    if "trace_start" in snap and "trace_stop" in snap:
        snap["window"] = window(snap["trace_start"], snap["trace_stop"])
        out["coalescer"] = coalescer(snap["window"])
    print(json.dumps(out), flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
