"""sq8r's delta counters over a benchmark cell's traced window:
portbench/spansplit.py's run, unchanged, with
longbow_sq8r_delta_scans_total{route}, longbow_sq8r_delta_views_total and
longbow_dataset_row_ids_rebuilds_total{dataset} (the store's row -> id
mirror built from its row map) read from the port's registry as the
device trace starts and stops.

    python3 -m longbow_tpu_torch.tools.sq8r_delta_counts [--bench portbench] \\
        -- --workload <cell> --seed <n> --seconds <s>

from a checkout's root, on a card (the arguments after `--` are
spansplit's). The cell's server runs in this process, so its registry is
this one. Prints spansplit's line, then one line {"counters": ...} with
each counter's samples at the trace's start and stop, the difference
between them (the window's scans by route, views and mirror builds) and the
samples at the end.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from longbow_tpu_torch.metrics.registry import PORT_METRICS, get_registry

NAMES = ("longbow_sq8r_delta_scans_total", "longbow_sq8r_delta_views_total",
         "longbow_dataset_row_ids_rebuilds_total")


def readings() -> dict:
    """{sample name and labels: value} of the counters now."""
    out = {}
    for name in NAMES:
        for sample, pairs, value in get_registry().counter(name, PORT_METRICS[name][1]).samples():
            if sample.endswith("_total"):
                out[sample + json.dumps(dict(pairs), sort_keys=True)] = value
    return out


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
    if "trace_start" in snap and "trace_stop" in snap:
        snap["window"] = window(snap["trace_start"], snap["trace_stop"])
    print(json.dumps({"counters": snap}), flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
