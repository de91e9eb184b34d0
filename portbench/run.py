"""The benchmark of the PyTorch/CUDA port (longbow_tpu_torch).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. A cell of BENCHMARK.json names a
configuration (portbench/configs/<name>.json) and a traffic mix
(portbench/mixes/<traffic>.json, with portbench/mixes/<traffic>/<config>.json
over it where there is one); each per-layer metric is read by
portbench/layers/<metric>.py, or by the file of its longest dotted
prefix. This process builds the port's serving process (build_runtime
and its Flight listeners on free loopback ports), fills it from the seed
on the card, and starts the load generator's callers (loadgen.py), each
a process of its own, which drive the window through the port's client
(BENCHMARK.json's mixes are closed loops of batch callers). After the
window it stops the server, frees its memory and holds a seeded sample of
what the client received against the plain reference (reference.py).

The last line of standard output is the result: {"correct", "attempted",
"failed", "metrics", "device"[, "breakdown"], "checks"}; the numbers
compared, each beside its limit, are also the last lines of standard
error. Without a card, with fewer cards than the cell asks for, or with
jax, jaxlib, flax or longbow_tpu loaded once the window has closed, it
prints no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

T_MAIN = time.monotonic()
HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import numpy as np  # noqa: E402

import measure  # noqa: E402
from recipe import STREAM_WINDOW, centres, queries  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "longbow_tpu")
READY_WAIT_S = 600.0
DONE_WAIT_S = 150.0  # past the window: the late answers' wait and the writing


class BenchError(RuntimeError):
    """A run that cannot give a result."""


# -- finding things by name ---------------------------------------------------

def load_cell(name: str, bench: Path = HERE) -> dict:
    """The cell `name` of BENCHMARK.json beside `bench`, with its
    configuration, mix and metrics resolved by name."""
    root = bench.parent
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg = json.loads((root / configs[cell["config"]]["file"]).read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"cell": cell, "config": cfg, "mix": load_mix(bench, cell["traffic"], cell["config"]),
            "end_to_end": mine(spec["end_to_end"]), "per_layer": mine(spec["per_layer"])}


def load_mix(bench: Path, traffic: str, config: str) -> dict:
    mix = json.loads((bench / "mixes" / f"{traffic}.json").read_text())
    over = bench / "mixes" / traffic / f"{config}.json"
    if over.exists():
        mix.update(json.loads(over.read_text()))
    return mix


def find_reader(metric: str, bench: Path = HERE):
    """read(ctx, metric) of layers/<metric>.py, or of the file of the
    metric's longest dotted prefix."""
    parts = metric.split(".")
    for i in range(len(parts), 0, -1):
        path = bench / "layers" / (".".join(parts[:i]) + ".py")
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                "portbench_layer_" + ".".join(parts[:i]).replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise BenchError(f"no reader for per-layer metric {metric!r}")


# -- the run ------------------------------------------------------------------

def process_age() -> float:
    """Seconds since this process started (from /proc), else since main's import."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - T_MAIN


def start_callers(bench: Path, n: int, client_cores: int) -> list:
    """The load generator: n caller processes (loadgen.py) on the last
    client_cores of this process's cores, and this process (the server)
    on the rest, as clients on machines of their own would be. Sharing
    cores, the server's and the clients' threads took turns on them."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(bench.parent)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    cores = sorted(os.sched_getaffinity(0))
    client = set(cores[-client_cores:]) if len(cores) >= 2 * client_cores else set(cores)
    if client != set(cores):
        os.sched_setaffinity(0, set(cores) - client)  # stop_callers gives them back
    procs = [subprocess.Popen([sys.executable, str(bench / "loadgen.py")], cwd=str(bench.parent),
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env,
                              preexec_fn=lambda: os.sched_setaffinity(0, client))
             for _ in range(n)]
    for p in procs:
        p.cores = cores
    return procs


def tell(procs: list, line: str) -> None:
    for p in procs:
        p.stdin.write(line + "\n")
        p.stdin.flush()


def read_line(proc: subprocess.Popen, key: str, timeout: float) -> dict:
    """A caller's next JSON line that holds `key`."""
    import select

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if not ready:
            if proc.poll() is not None:
                break
            continue
        line = proc.stdout.readline()
        if not line:
            break
        try:
            msg = json.loads(line)
        except json.JSONDecodeError:
            continue
        if key in msg:
            return msg
    raise BenchError(f"a caller gave no {key!r} (rc {proc.poll()})")


def stop_callers(procs: list) -> None:
    if procs:
        os.sched_setaffinity(0, procs[0].cores)
    for p in procs:
        if p.poll() is None:
            try:
                p.stdin.close()
            except OSError:
                pass
    for p in procs:
        try:
            p.wait(timeout=20)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=20)


def merge(parts: list) -> dict:
    """The callers' records as one: every request, the answers to judge
    with their queries' positions in the window's stream, and what the
    callers spent between an answer and their next send."""
    b = int(parts[0]["queries_per_request"])
    got = {key: np.concatenate([p[key] for p in parts])
           for key in ("request", "send", "done", "ok", "check_request", "check_ids",
                       "check_scores", "errors")}
    got["queries_per_request"] = b
    got["check_query"] = (got["check_request"][:, None] * b + np.arange(b)[None, :]).reshape(-1)
    turn = [p["send"][1:] - p["done"][:-1] for p in parts if len(p["send"]) > 1]
    turn = np.concatenate(turn) if turn else np.zeros(0)
    got["turnaround_ms"] = {"mean": 1e3 * float(turn.mean()) if len(turn) else None,
                            "max": 1e3 * float(turn.max()) if len(turn) else None}
    got["client_cpu_s"] = [float(p["cpu_s"]) for p in parts]
    return got


def plan(server, mix: dict, seed: int, seconds: float, caller: int, out: str) -> dict:
    """What a caller is told: where to send, what, how long, and where to
    write what it received."""
    cfg = server.cfg
    return {"host": "127.0.0.1", "port": server.data.port, "meta_port": server.meta.port,
            "dataset": server.name, "dim": cfg["dim"], "seed": seed, "seconds": seconds,
            "mix": dict(mix, k=cfg["k"]), "caller": caller, "out": out}


def run_cell(c: dict, seed: int, seconds: float, trace: bool, device: str,
             bench: Path = HERE) -> dict:
    """One run of a cell -> the result object (without its printing)."""
    from reference import exact_topk, judge, true_distances
    from server import Server

    cfg, mix = c["config"], c["mix"]
    n_callers = int(mix["callers"])
    callers = start_callers(bench, n_callers, int(mix["client_cores"]))
    server = Server(cfg, seed, device)
    ctx: dict = {"cell": c["cell"]["name"], "config": cfg, "mix": mix, "seconds": seconds}
    out_dir = tempfile.mkdtemp(prefix="portbench-")
    try:
        t = process_age()
        server.build()
        server.fill()
        server.listen()
        server.warm([mix["batch"] * i for i in range(1, n_callers + 1)])
        outs = [os.path.join(out_dir, f"caller{i}.npz") for i in range(n_callers)]
        t_plan = time.perf_counter()
        for i, (p, out) in enumerate(zip(callers, outs)):
            tell([p], json.dumps(plan(server, mix, seed, seconds, i, out)))
        for p in callers:
            read_line(p, "ready", READY_WAIT_S)
        server.parts["warm_flight_s"] = time.perf_counter() - t_plan
        server.parts["before_runtime_s"] = t
        spans = dtrace = None
        if trace:
            from devtrace import DeviceTrace, Spans

            spans = Spans()
            spans.install(server.rt.handlers, server.store)
            dtrace = DeviceTrace(device != "cpu")
            dtrace.start()
        setup_s = process_age()
        cpu0 = time.process_time()
        tell(callers, "go")
        t_go = time.perf_counter()
        if trace:
            with dtrace.mark():
                time.sleep(max(seconds - (time.perf_counter() - t_go), 0.0))
        for p in callers:
            read_line(p, "done", seconds + DONE_WAIT_S)
        server_cpu_s = time.process_time() - cpu0
        if trace:
            spans.remove()
            ctx["trace"] = dtrace.stop()
            ctx["spans"] = {"handler": [(n, a - t_go, b - t_go) for n, a, b in spans.handler],
                            "store": [(n, a - t_go, b - t_go) for n, a, b in spans.store]}
        ctx["scan"] = {"rows": server.scan_rows, "dim": cfg["dim"], "pool": cfg["pool"],
                       "row_bytes": cfg["row_bytes"], "groups": server.scan_groups}
        memory_peak = 0
        if device != "cpu":
            import torch

            memory_peak = int(torch.cuda.max_memory_allocated())
            ctx["device_name"] = torch.cuda.get_device_name(0)
        deleted = server.deleted
        parts = ctx["setup_parts"] = dict(server.parts, setup_s=setup_s)
        server.stop()
        loaded = []
        for out in outs:
            with np.load(out) as z:
                loaded.append({k: z[k] for k in z.files})
        got = merge(loaded)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        stop_callers(callers)
        if getattr(server, "rt", None) is not None:
            server.stop()
    ctx["client"] = got
    b = got["queries_per_request"]
    attempted, failed = len(got["ok"]), int((~got["ok"]).sum())

    # the comparison, once the server's state is freed
    k = cfg["k"]
    qs = queries(seed, STREAM_WINDOW, got["check_query"], centres(seed, cfg["dim"]))
    ref_ids, ref_d = exact_topk(seed, cfg, qs, deleted, k, device)
    true_d = true_distances(seed, cfg, qs, got["check_ids"], device)
    numbers = judge(got["check_ids"], got["check_scores"], ref_ids, ref_d, true_d, deleted,
                    cfg["rows"])
    numbers["unanswered"] = failed
    limits = cfg["limits"]
    checks = {n: {"value": numbers[n], "limit": limits[n]} for n in limits}
    correct = all(v["value"] <= v["limit"] for v in checks.values())

    e2e = {
        "setup_s": lambda: setup_s,
        "search_qps": lambda: measure.window_rate(got["done"], got["ok"], b, seconds),
        "recall_at_10": lambda: numbers["recall_at_10"],
    }
    metrics = {}
    if trace:
        for m in c["per_layer"]:
            v = find_reader(m["name"], bench)(ctx, m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in c["end_to_end"]:  # by the name before its first dot
            metrics[m["name"]] = {"value": e2e[m["name"].split(".")[0]](), "unit": m["unit"]}
    res = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": {}, "setup_parts": parts,
           "queries_by_second": measure.per_second(got["done"][got["ok"]], seconds, b),
           "host": {"server_cpu_s": server_cpu_s, "client_cpu_s": got["client_cpu_s"],
                    "turnaround_ms": got["turnaround_ms"]}}
    if trace:
        tr = ctx["trace"]
        res["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        res["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    res["device"]["memory_peak_bytes"] = memory_peak
    res["readings"] = numbers
    res["checks"] = checks
    return res


def main(argv=None, device: str | None = None, bench: Path = HERE) -> int:
    """The command. device and bench are for tests: a run on the CPU
    ("cpu") of the benchmark in another directory."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("LONGBOW_LOG_LEVEL", "warning")
    try:
        c = load_cell(args.workload, bench)
    except (BenchError, OSError, KeyError, json.JSONDecodeError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    chips = int(c["cell"]["chips"])
    device_info = {"platform": "cpu", "kind": "cpu", "count": 0}
    if device is None:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
        device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    try:
        res = run_cell(c, args.seed, args.seconds, bool(args.trace), device, bench)
    except BenchError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"portbench: modules loaded that the port must not use: {loaded}",
              file=sys.stderr)
        return 3
    if device == "cuda":
        from roofline import power_limit

        device_info["power"] = power_limit()
    res["device"] = dict(device_info, **res["device"])
    print(json.dumps({k: v for k, v in res.items() if k not in ("checks",)}
                     | {"note": "checks follow"}), file=sys.stderr)
    for name, v in res["checks"].items():
        print(f"check {name} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
