"""Where a graph search's time goes in a benchmark cell's traced window:
portbench/spansplit.py's run (the program's span recorder on inside the
harness's profiler), read by the graph loop's spans and counters.

    python3 -m longbow_tpu_torch.tools.graph_split [--bench portbench] \\
        --workload <cell> --seed <n> --seconds <s> [--out <name>]

from a checkout's root, on a card (--device cpu for a test). The cell's
server runs in this process, so its registry is this one. Prints one
JSON line: spansplit's readings ("split"), and under "graph" the device
seconds launched inside each graph span and the host ms a span, the
device operations launched a loop iteration, the loop's iterations and
batch a call, the card's idle by where the dispatch thread was, and the
four graph counters' growth over the trace (index/graph.py
count_searches). With --out it also writes the line to
chiprun_out/<name>.json.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from longbow_tpu_torch.metrics.registry import get_registry

COUNTERS = ("longbow_hnsw_searches_total", "longbow_hnsw_queries_total",
            "longbow_hnsw_beam_iterations_total", "longbow_hnsw_distance_calculations_total")
BEAM = "longbow.hnsw.beam"
SPANS = ("longbow.hnsw.entry", BEAM, "longbow.hnsw.extract", "longbow.hnsw.retry",
         "longbow.index.to_host", "longbow.dataset.answer", "longbow.store.search")


def counter_values() -> dict:
    reg = get_registry()
    return {name: reg.counter(name).samples()[0][2] for name in COUNTERS}


def graph_readings(state: dict, spansplit) -> dict:
    """The graph loop's split of a window that spansplit's
    recorder_in_trace watched."""
    ev, prog = state["events"], state["program"]
    (win,) = [e for e in ev if e.cpu and e.name == "portbench.window"]
    (clock,) = [e for e in ev if e.cpu and e.name == "longbow.clock"]
    lo, hi = win.t0, win.t1
    spans = spansplit.on_profiler_clock(prog.records, prog.anchor_ns, clock.t1)
    launched = spansplit.launches(ev, prog.threads, lo, hi)
    under = spansplit.device_under(launched, spans, SPANS)
    beams = spansplit.begun_in(spans, BEAM, lo, hi)
    in_beam = spansplit._index(spans, BEAM)
    beam_ops = sum(1 for _, _, _, tid, at in launched if spansplit._inside(in_beam, tid, at))
    iters = sum(b[4]["iterations"] for b in beams)
    n_search = len(spansplit.begun_in(spans, spansplit.STORE, lo, hi))
    disp = spansplit.dispatch_thread(spans, lo, hi)
    idle_ns, idle_split = spansplit.idle_by_span(launched, spans, disp, lo, hi,
                                                 (spansplit.IDLE,) + SPANS)

    def mean_ms(name):
        v = [s[3] - s[2] for s in spansplit.begun_in(spans, name, lo, hi)]
        return 1e-6 * sum(v) / len(v) if v else None

    return {
        "store_searches": n_search,
        "beam_calls": len(beams),
        "iterations_a_call": iters / len(beams) if beams else None,
        "queries_a_call": sum(b[4]["B"] for b in beams) / len(beams) if beams else None,
        "device_ops_a_iteration": beam_ops / iters if iters else None,
        "host_ms": {n: mean_ms(n) for n in SPANS},
        "device_ms_a_search": {n: 1e3 * v / n_search for n, v in under.items()}
        if n_search else None,
        "idle": idle_ns / (hi - lo),
        "idle_s_while_dispatch_inside": {n: v * 1e-9 for n, v in idle_split.items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bench", default="portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    bench = Path(args.bench).resolve()
    sys.path[:0] = [str(bench), str(bench.parent)]
    import devtrace
    import run
    import spansplit

    snap: dict = {}
    start, stop = devtrace.DeviceTrace.start, devtrace.DeviceTrace.stop

    def start_read(self):
        snap["start"] = counter_values()
        return start(self)

    def stop_read(self):
        snap["stop"] = counter_values()
        return stop(self)

    devtrace.DeviceTrace.start, devtrace.DeviceTrace.stop = start_read, stop_read
    state: dict = {}
    try:
        c = run.load_cell(args.workload, bench)
        with spansplit.recorder_in_trace(state):
            res = run.run_cell(c, args.seed, args.seconds, True, args.device, bench)
    finally:
        devtrace.DeviceTrace.start, devtrace.DeviceTrace.stop = start, stop
    harness = {k: v["value"] for k, v in res["metrics"].items()}
    out = {"workload": args.workload, "seed": args.seed, "seconds": args.seconds,
           "correct": res["correct"], "harness": harness, "device": res["device"],
           "split": spansplit.analyse(state, args.seconds, harness),
           "graph": graph_readings(state, spansplit),
           "counters": {k: snap["stop"][k] - snap["start"][k] for k in COUNTERS}}
    line = json.dumps(out, default=float)
    print(line, flush=True)
    if args.out:
        d = Path("chiprun_out")
        d.mkdir(exist_ok=True)
        (d / f"{args.out}.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
