"""The program's own spans in a traced run of a cell: a store search's
device time and the card's idle, split by the port's span recorder
(longbow_tpu_torch/utils/tracing.py). run.py does not start the recorder,
so no per-layer metric reads these spans; this tool runs one cell as
run.py's --trace 1 does, with the recorder on inside the harness's
profiler, and prints one JSON line of readings.

    python3 portbench/spansplit.py --workload <cell> --seed <n> --seconds <s> [--out <name>]

from the root of a checkout, on a card (--device cpu for a test). With
--out it also writes the line to chiprun_out/<name>.json.

It changes nothing in the benchmark's files: in its own process it wraps
DeviceTrace.start and .stop (the recorder started just after the
profiler and stopped just before it; the profiler's raw events kept),
Spans.install (the harness's own store spans kept) and run.merge (the
callers' records kept), and undoes the wraps when the run ends. What it
reads from them is the pure functions below, over the recorder's spans
on the profiler's clock and the profiler's events.

The join: a device interval counts under a span when the CUDA runtime
call that launched it (the same correlation id) began inside that span,
on that span's thread. The runtime call names a thread that the profiler
did not start on by the low 32 bits of threading.get_ident(), which the
recorder's thread table maps to the native id that its spans carry.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import numpy as np  # noqa: E402

from measure import idle_gaps  # noqa: E402

STORE = "longbow.store.search"
IDLE = "longbow.coalescer.idle"
QUEUE = "longbow.coalescer.queue"
# the dispatch thread's spans: device time is counted under each by its
# launch, and idle time by where the dispatch thread was
DISPATCH = ("longbow.sq8r.prep", "longbow.sq8r.main", "longbow.sq8r.delta",
            "longbow.sq8r.merge", "longbow.index.to_host", "longbow.dataset.answer", STORE)
EDGE = ("longbow.edge.exchange", "longbow.edge.decode", "longbow.edge.encode")
RUNTIME = ("cuda_runtime", "cuda_driver")
CHECK = "portbench.spansplit.check"


class Event(NamedTuple):
    """A profiler event on its clock (ns). resource: a runtime call's
    thread, a kernel's stream; kind: kineto's activity type."""

    name: str
    cpu: bool
    t0: int
    t1: int
    corr: int
    linked: int
    resource: int
    kind: str


def events_of(prof) -> list:
    """A stopped torch.profiler's raw events as Events."""
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.activity_type() if hasattr(e, "activity_type") else "")
        out.append(Event(e.name(), e.device_type().name == "CPU", e.start_ns(),
                         e.start_ns() + e.duration_ns(), e.correlation_id(),
                         e.linked_correlation_id(), e.device_resource_id(),
                         kind.rsplit(".", 1)[-1].lower()))
    return out


def on_profiler_clock(records: list, anchor_ns: int, clock_end_ns: int) -> list:
    """The recorder's (name, thread, t0_ns, t1_ns, attrs) moved onto the
    profiler's clock, given the end of its longbow.clock range there."""
    off = clock_end_ns - anchor_ns
    return [(n, tid, a + off, b + off, at) for n, tid, a, b, at in records]


def begun_in(spans: list, name: str, lo: int, hi: int) -> list:
    """The spans named `name` that begin inside [lo, hi]."""
    return [s for s in spans if s[0] == name and lo <= s[2] <= hi]


def dispatch_thread(spans: list, lo: int, hi: int):
    """The thread that ran most of the window's store searches (the
    dataset's dispatch thread; the other shards' threads idle)."""
    by: dict = {}
    for s in begun_in(spans, STORE, lo, hi):
        by[s[1]] = by.get(s[1], 0) + 1
    return max(by, key=by.get) if by else None


def launches(events: list, threads: dict, lo: int, hi: int) -> list:
    """Each device interval that overlaps [lo, hi], clipped to it:
    (name, t0, t1, launching thread's native id, the call's start), the
    last two None where no runtime call of a recorded thread is joined."""
    # a runtime call names its thread by its ident's low 32 bits, or by the
    # system id where the profiler saw the thread record CPU ops
    by_ident = {ident & 0xFFFFFFFF: nid for nid, (ident, _) in threads.items()}
    by_ident.update({nid: nid for nid in threads})
    calls: dict = {}
    for e in events:
        if e.cpu and (e.kind in RUNTIME or (not e.kind and e.name.startswith("cu"))):
            calls.setdefault(e.corr, e)
    out = []
    for e in events:
        if e.cpu or e.t1 <= lo or e.t0 >= hi:
            continue
        call = calls.get(e.corr) or calls.get(e.linked)
        tid = None if call is None else by_ident.get(call.resource & 0xFFFFFFFF)
        out.append((e.name, max(e.t0, lo), min(e.t1, hi), tid,
                    None if tid is None else call.t0))
    return out


def _index(spans: list, name: str) -> dict:
    """{thread: (sorted starts, their ends)} of the spans named `name`."""
    by: dict = {}
    for n, tid, a, b, _ in spans:
        if n == name:
            by.setdefault(tid, []).append((a, b))
    return {t: (np.array([a for a, _ in sorted(v)]), np.array([b for _, b in sorted(v)]))
            for t, v in by.items()}


def _inside(index: dict, tid, t) -> bool:
    iv = index.get(tid)
    if iv is None or t is None:
        return False
    i = int(np.searchsorted(iv[0], t, side="right")) - 1
    return i >= 0 and t <= iv[1][i]


def device_under(launched: list, spans: list, names=DISPATCH) -> dict:
    """Device seconds by the span each interval's launch began inside
    (a nested launch counts under every enclosing name), and under none
    of them ("outside")."""
    idx = {n: _index(spans, n) for n in names}
    out = {n: 0.0 for n in names}
    out["outside"] = 0.0
    for _, t0, t1, tid, at in launched:
        d = (t1 - t0) * 1e-9
        hit = False
        for n in names:
            if _inside(idx[n], tid, at):
                out[n] += d
                hit = True
        if not hit:
            out["outside"] += d
    return out


def merged(iv: list) -> list:
    """A set of intervals as disjoint sorted ones."""
    out: list = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def overlap(a: list, b: list) -> float:
    """Length of the intersection of two sets of disjoint sorted intervals."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle_by_span(launched: list, spans: list, thread, lo: int, hi: int,
                 names=(IDLE,) + DISPATCH) -> tuple:
    """(the window's idle ns, {name: idle ns while `thread` was inside a
    span of that name}); the idle is what no device interval covers."""
    iv = np.array([(t0, t1) for _, t0, t1, _, _ in launched], float).reshape(-1, 2)
    gaps = [tuple(g) for g in idle_gaps(iv, float(lo), float(hi))]
    split = {}
    for n in names:
        mine = merged([(max(s[2], lo), min(s[3], hi)) for s in spans
                       if s[0] == n and s[1] == thread and s[3] > lo and s[2] < hi])
        split[n] = overlap(gaps, mine)
    return sum(b - a for a, b in gaps), split


def readings(spans: list, launched: list, lo: int, hi: int, is_k2=None) -> dict:
    """The readings of one window [lo, hi] (profiler ns): the six that a
    per-layer reader would report (the device ones None where no device
    interval was joined to a span's thread), and the split behind them."""
    win_s = (hi - lo) * 1e-9
    n_search = len(begun_in(spans, STORE, lo, hi))
    disp = dispatch_thread(spans, lo, hi)

    def mean_ms(name, per=None):
        v = [s[3] - s[2] for s in begun_in(spans, name, lo, hi)]
        n = len(v) if per is None else per
        return 1e-6 * sum(v) / n if v and n else None

    under = device_under(launched, spans)
    idle_ns, idle_split = idle_by_span(launched, spans, disp, lo, hi)
    joined = sum(1 for x in launched if x[3] is not None)
    per_search = bool(joined and n_search)
    o = {
        "coalescer.wait_ms": mean_ms(QUEUE),
        "store.answer_ms": mean_ms("longbow.dataset.answer", per=n_search),
        "edge.encode_ms": mean_ms("longbow.edge.encode"),
        "store.main_device_ms":
            1e3 * under["longbow.sq8r.main"] / n_search if per_search else None,
        "store.delta_device_ms":
            1e3 * under["longbow.sq8r.delta"] / n_search if per_search else None,
        "device.idle_starved": idle_split[IDLE] * 1e-9 / win_s if joined else None,
        "device.idle": idle_ns * 1e-9 / win_s,
        "window_s": win_s,
        "busy_s": win_s - idle_ns * 1e-9,
        "store_searches": n_search,
        "dispatch_thread": disp,
        "host_ms": {n: mean_ms(n) for n in DISPATCH + EDGE + (QUEUE,)},
        "device_s_under": under,
        "idle_s_while_dispatch_inside": {n: v * 1e-9 for n, v in idle_split.items()},
        "joined": joined,
        "device_intervals": len(launched),
    }
    if is_k2 is not None:
        k2 = [x for x in launched if is_k2(x[0])]
        main = _index(spans, "longbow.sq8r.main")
        k2_s = sum(t1 - t0 for _, t0, t1, _, _ in k2) * 1e-9
        k2_main = sum(t1 - t0 for _, t0, t1, tid, at in k2 if _inside(main, tid, at)) * 1e-9
        o["k2_s"] = k2_s
        o["k2_share_under_main"] = k2_main / k2_s if k2_s else None
    return o


def agreement(program: list, harness: list) -> dict:
    """The program's store spans (perf_counter ns, before any mapping)
    against the harness's wraps of VectorStore.search (perf_counter s),
    matched in order: counts, sums, and how many lie inside their wrap."""
    p = sorted((a, b) for n, _, a, b, _ in program if n == STORE)
    h = sorted((int(t0 * 1e9), int(t1 * 1e9)) for _, t0, t1 in harness)
    return {"program_n": len(p), "harness_n": len(h),
            "program_s": sum(b - a for a, b in p) * 1e-9,
            "harness_s": sum(b - a for a, b in h) * 1e-9,
            "inside": sum(1 for (a, b), (c, d) in zip(p, h) if c <= a and b <= d)}


def _is_k2():
    """is_k2 of layers/k2_roofline.py: the kernel names that reader counts."""
    path = HERE / "layers" / "k2_roofline.py"
    spec = importlib.util.spec_from_file_location("portbench_layer_k2_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.is_k2


@contextlib.contextmanager
def recorder_in_trace(state: dict):
    """run.py's traced run with the program's recorder on inside its
    profiler, in this process: what the wraps keep goes into `state`."""
    import devtrace
    import run
    from torch.profiler import record_function

    from longbow_tpu_torch.utils import tracing

    saved = [(devtrace.Spans, "install"), (devtrace.DeviceTrace, "start"),
             (devtrace.DeviceTrace, "stop"), (run, "merge")]
    orig = {(o, a): getattr(o, a) for o, a in saved}

    def install(self, handlers, store):
        state["spans"] = self
        return orig[(devtrace.Spans, "install")](self, handlers, store)

    def start(self):
        orig[(devtrace.DeviceTrace, "start")](self)
        tracing.start()

    def stop(self):
        with record_function(CHECK):  # the anchor's drift over the run
            state["check_ns"] = time.perf_counter_ns()
        state["program"] = tracing.stop()
        self.prof.stop()
        state["events"] = events_of(self.prof)
        self.prof.stop = lambda: None  # the original stop reads the stopped profiler
        return orig[(devtrace.DeviceTrace, "stop")](self)

    def merge(parts):
        state["client"] = got = orig[(run, "merge")](parts)
        return got

    for (o, a), f in zip(saved, (install, start, stop, merge)):
        setattr(o, a, f)
    try:
        yield
    finally:
        for (o, a), f in orig.items():
            setattr(o, a, f)
        if tracing.recording():
            tracing.stop()


def analyse(state: dict, seconds: float, harness: dict) -> dict:
    """The readings of a run that recorder_in_trace watched."""
    ev, prog = state["events"], state["program"]
    (win,) = [e for e in ev if e.cpu and e.name == "portbench.window"]
    (clock,) = [e for e in ev if e.cpu and e.name == "longbow.clock"]
    lo, hi = win.t0, win.t1
    spans = on_profiler_clock(prog.records, prog.anchor_ns, clock.t1)
    launched = launches(ev, prog.threads, lo, hi)
    o = readings(spans, launched, lo, hi, _is_k2())
    check = [e for e in ev if e.cpu and e.name == CHECK]
    o["anchor_drift_us"] = ((state["check_ns"] + clock.t1 - prog.anchor_ns - check[0].t1) / 1e3
                            if check else None)
    o.update(records=len(prog.records), dropped=prog.dropped,
             threads={str(k): [v[0] & 0xFFFFFFFF, v[1]] for k, v in prog.threads.items()},
             agree=agreement(prog.records, state["spans"].store))
    got = state["client"]
    sel = got["ok"] & (got["send"] >= 0) & (got["send"] <= seconds)
    req = 1e3 * float(np.mean(got["done"][sel] - got["send"][sel])) if sel.any() else None
    parts = [o["coalescer.wait_ms"], harness.get("store.search_ms.sq8r"),
             harness.get("edge.added_ms.sq8r")]
    o["request_ms"] = {"callers": req, "wait+store+edge":
                       sum(parts) if req and None not in parts else None}
    return o


def main(argv=None, bench: Path = HERE) -> int:
    """The command; bench is for tests (a copy of the benchmark elsewhere)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import run

    c = run.load_cell(args.workload, bench)
    state: dict = {}
    with recorder_in_trace(state):
        res = run.run_cell(c, args.seed, args.seconds, True, args.device, bench)
    harness = {k: v["value"] for k, v in res["metrics"].items()}
    out = {"workload": args.workload, "seed": args.seed, "seconds": args.seconds,
           "correct": res["correct"], "harness": harness, "device": res["device"]}
    out.update(analyse(state, args.seconds, harness))
    line = json.dumps(out, default=float)
    print(line, flush=True)
    if args.out:
        d = Path("chiprun_out")
        d.mkdir(exist_ok=True)
        (d / f"{args.out}.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
