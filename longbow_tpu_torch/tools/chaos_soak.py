"""Chaos soak, the port's twin of scripts/chaos_soak.py: a 3-node
replicated cluster of `python -m longbow_tpu_torch.serve` processes takes
writes through node 0 and searches through node 2; node 1 is killed
(SIGKILL) at 25% of the run and restarted on its WAL at 55%; the run
passes when the cluster kept serving and anti-entropy healed node 1.

  python -m longbow_tpu_torch.tools.chaos_soak [--duration 60] [--device cpu]
      [--dim 16] [--batch 200] [--seed-rows 0]

The nodes run on the CUDA card; --device cpu (or LONGBOW_FORCE_CPU=1 in the
environment) runs them on the CPU. --seed-rows N puts N rows of bench.py's
clustered recipe (1,024 Gaussian clusters, seed 0) through node 0 before
the load starts. Each node gets the reference's environment: async
replication, anti-entropy every 5 s, probes every 0.5 s, a data directory
(so a WAL) each, and here a metrics port each.

Printed: "cluster up", the kill and the restart, the rows written, reads
and errors, each node's live rows, then the reference's gate: HEALED when
every node holds rows and node 1 holds at least 90% of node 0's, else NOT
HEALED. Then one line with node 1's seconds from its readiness to a Merkle
root equal to node 0's, the rows its anti-entropy synced and its delta
pulls, and a last JSON line with every count, including whether all three
nodes hold every acknowledged row with equal roots. Exit 0 when HEALED and
a read answered, else 1.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
VICTIM = 1
READY_S = 90.0        # the longest wait for the cluster to come up
RESTART_S = 60.0      # for the restarted node to answer again
CONVERGE_S = 60.0     # for its live rows to reach 98% of node 0's
ROOTS_S = 300.0       # for its Merkle root to equal node 0's
SEED_BATCH = 65_536
KERNELS = ("fused_scan", "fused_codes_scan")  # longbow_kernel_launches_total{kernel}
LOG_TAIL = 30


def free_ports(n: int) -> list:
    """Ports for node processes that must name each other before they start
    (a static peer list): bound to 0 and released here."""
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def node_env(i: int, ports: list, specs: str, root: Path, device: str | None) -> dict:
    """Node i's environment: the caller's, with the reference's settings."""
    env = dict(os.environ)
    env.update(
        LONGBOW_DATA_PORT=str(ports[3 * i]),
        LONGBOW_META_PORT=str(ports[3 * i + 1]),
        LONGBOW_METRICS_PORT=str(ports[3 * i + 2]),
        LONGBOW_DATA_DIR=str(root / f"node{i}"),
        LONGBOW_NODE_ID=f"127.0.0.1:{ports[3 * i]}",
        LONGBOW_PEERS=specs,
        LONGBOW_REPLICATION="async",
        LONGBOW_SYNC_INTERVAL_S="5",
        LONGBOW_PROBE_INTERVAL_S="0.5",
        PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
    )
    if device == "cpu":
        env["LONGBOW_FORCE_CPU"] = "1"
    return env


def spawn(i, ports, specs, root, device):
    with open(root / f"node{i}.log", "ab") as logf:
        return subprocess.Popen(
            [sys.executable, "-m", "longbow_tpu_torch.serve"],
            env=node_env(i, ports, specs, root, device), cwd=REPO,
            stdout=logf, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
        )


def metric_total(port: int, name: str, **labels) -> float:
    """The sum of a metric's samples on a node's metrics port, over the
    samples that carry every given label."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        text = r.read().decode()
    want = [f'{k}="{v}"' for k, v in labels.items()]
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith(name) and ln[len(name)] in " {"
               and all(w in ln for w in want))


def print_tails(root: Path) -> None:
    """The nodes' last log lines, on standard error, for whoever reads a failure."""
    for i in range(3):
        log = root / f"node{i}.log"
        lines = log.read_text(errors="replace").splitlines() if log.exists() else []
        print(f"--- node{i}, last {LOG_TAIL} lines", *lines[-LOG_TAIL:], sep="\n",
              file=sys.stderr)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--batch", type=int, default=200, help="rows a write")
    ap.add_argument("--seed-rows", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from longbow_tpu_torch.serving.client import LongbowClient

    root = Path(tempfile.mkdtemp(prefix="longbow-chaos-"))
    ports = free_ports(9)
    specs = ",".join(f"127.0.0.1:{ports[3 * i]}:{ports[3 * i + 1]}" for i in range(3))
    procs = {i: spawn(i, ports, specs, root, args.device) for i in range(3)}
    clients = {i: LongbowClient("127.0.0.1", ports[3 * i], ports[3 * i + 1]) for i in range(3)}

    def live_rows(i):
        return clients[i].cluster_status()["datasets"]["soak"]["live_rows"]

    def root_of(i):
        return clients[i]._action("merkle-state", {"dataset": "soak"})["root"]

    try:
        t0 = time.time()
        while time.time() - t0 < READY_S:
            try:
                for c in clients.values():
                    c.check_readiness()
                break
            except Exception:
                time.sleep(0.5)
        else:
            print("FAIL: cluster never became ready")
            return 1
        print("cluster up", flush=True)

        ready_at: list = []

        def await_restart():
            # the restarted node's readiness, timed while the load runs
            t = time.time()
            while time.time() - t < RESTART_S:
                c = LongbowClient("127.0.0.1", ports[3 * VICTIM], ports[3 * VICTIM + 1])
                try:
                    c.check_readiness()
                    ready_at.append(time.time())
                    return
                except Exception:
                    time.sleep(0.2)
                finally:
                    c.close()

        restarter = threading.Thread(target=await_restart, daemon=True)
        next_id = 0
        if args.seed_rows:
            from longbow_tpu_torch.tools.persist_child import make_corpus

            corpus = make_corpus(args.seed_rows, args.dim)
            for s in range(0, args.seed_rows, SEED_BATCH):
                e = min(s + SEED_BATCH, args.seed_rows)
                clients[0].write("soak", np.arange(s, e), corpus[s:e])
            next_id = args.seed_rows
            del corpus
            print(f"seeded {args.seed_rows} rows", flush=True)

        rng = np.random.default_rng(0)
        checked = errors = 0
        kill_at = time.time() + args.duration * 0.25
        restart_at = time.time() + args.duration * 0.55
        end_at = time.time() + args.duration
        killed = restarted = False
        while time.time() < end_at:
            v = rng.standard_normal((args.batch, args.dim)).astype(np.float32)
            ids = np.arange(next_id, next_id + args.batch)
            try:
                clients[0].write("soak", ids, v)
                next_id += args.batch
            except Exception:
                errors += 1
            # read from a live node with global fan-out
            try:
                if clients[2].search("soak", v[0], k=1).num_rows:
                    checked += 1
            except Exception:
                errors += 1
            if not killed and time.time() > kill_at:
                procs[VICTIM].kill()
                print(f"killed node{VICTIM}", flush=True)
                killed = True
            if killed and not restarted and time.time() > restart_at:
                procs[VICTIM] = spawn(VICTIM, ports, specs, root, args.device)
                print(f"restarted node{VICTIM}", flush=True)
                restarted = True
                restarter.start()
            time.sleep(0.2)
        if not restarted:
            print("FAIL: the run ended before the restart")
            return 1

        # the restarted node answers again, then anti-entropy converges it
        restarter.join(timeout=RESTART_S)
        t0 = time.time()
        while time.time() - t0 < CONVERGE_S:
            try:
                if live_rows(VICTIM) >= 0.98 * live_rows(0):
                    break
            except Exception:
                pass
            time.sleep(2.0)
        counts = {}
        for i in (0, 2, VICTIM):
            try:
                counts[i] = live_rows(i)
            except Exception as e:
                counts[i] = f"error: {e}"
        print(f"rows written={next_id} reads_ok={checked} errors={errors}")
        print("per-node live rows:", counts)
        healthy = all(isinstance(c, int) and c > 0 for c in counts.values())
        if isinstance(counts.get(VICTIM), int) and isinstance(counts.get(0), int):
            healed = counts[VICTIM] >= 0.9 * counts[0]
        else:
            healed = False
        print("HEALED" if healed and healthy else "NOT HEALED", flush=True)

        # the heal, measured: node 1's root against node 0's from its
        # readiness, then all three roots equal
        heal_s = roots = None
        t0 = time.time()
        while ready_at and time.time() - t0 < ROOTS_S:
            try:
                roots = [root_of(i) for i in range(3)]
            except Exception:
                roots = None
            if roots and roots[VICTIM] == roots[0] and heal_s is None:
                heal_s = time.time() - ready_at[0]
            if roots and len(set(roots)) == 1:
                break
            time.sleep(0.5)
        synced = clients[VICTIM].cluster_status()["anti_entropy"]["synced_rows"]
        pulls = metric_total(ports[3 * VICTIM + 2], "longbow_mesh_sync_deltas_total")
        heal = "not reached" if heal_s is None else f"{heal_s:.3f} s"
        print(f"heal: node{VICTIM} root equal to node0's {heal} after its readiness; "
              f"{synced} rows synced; {pulls:.0f} delta pulls", flush=True)
        final = [live_rows(i) for i in range(3)]
        launches = [{k: metric_total(ports[3 * i + 2], "longbow_kernel_launches_total",
                                     kernel=k) for k in KERNELS} for i in range(3)]
        every_row = final == [next_id] * 3 and roots is not None and len(set(roots)) == 1
        ok = healed and healthy and checked > 0
        print(json.dumps({
            "rows_acked": next_id, "reads_ok": checked, "errors": errors,
            "live_rows": final, "roots": roots, "every_row_on_every_node": every_row,
            "healed": healed and healthy, "heal_s": heal_s, "synced_rows": synced,
            "delta_pulls": pulls, "kernel_launches_by_node": launches, "ok": ok,
        }), flush=True)
        if not ok:
            print_tails(root)
        return 0 if ok else 1
    except BaseException:
        print_tails(root)
        raise
    finally:
        for c in clients.values():
            c.close()
        for p in procs.values():
            p.terminate()
        for p in procs.values():
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
