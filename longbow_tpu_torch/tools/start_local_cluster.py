"""A local 3-node REPLICATED cluster of longbow_tpu_torch nodes, the port's
twin of scripts/start_local_cluster.sh (the reference's
scripts/start_local_cluster.sh): three `python -m longbow_tpu_torch.serve`
processes on ports 3000/3010/3020 (meta 3001/3011/3021, metrics
9090-9092) with static peers, async replication and anti-entropy between
them, each with a data directory under DATA_ROOT and a log beside it.

  python -m longbow_tpu_torch.tools.start_local_cluster [DATA_ROOT] [--device cpu]

DATA_ROOT defaults to /tmp/longbow-cluster. LONGBOW_REPLICATION (default
async) and LONGBOW_SYNC_INTERVAL_S (default 10) pass through from the
environment. The nodes run on the CUDA card; --device cpu (or
LONGBOW_FORCE_CPU=1 in the environment) runs them on the CPU. The nodes
keep running after this returns; their pids are in DATA_ROOT/pids.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
NODES = 3
ALL = "127.0.0.1:3000:3001,127.0.0.1:3010:3011,127.0.0.1:3020:3021"


def node_env(i: int, root, environ) -> dict:
    """The LONGBOW_* settings of node i, as the shell script sets them;
    `environ` supplies the two that pass through."""
    data_port = 3000 + i * 10
    return {
        "LONGBOW_DATA_PORT": str(data_port),
        "LONGBOW_META_PORT": str(3001 + i * 10),
        "LONGBOW_METRICS_PORT": str(9090 + i),
        "LONGBOW_DATA_DIR": f"{root}/node{i}",
        "LONGBOW_NODE_ID": f"127.0.0.1:{data_port}",
        "LONGBOW_PEERS": ALL,
        "LONGBOW_REPLICATION": environ.get("LONGBOW_REPLICATION") or "async",
        "LONGBOW_SYNC_INTERVAL_S": environ.get("LONGBOW_SYNC_INTERVAL_S") or "10",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("root", nargs="?", default="/tmp/longbow-cluster")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    root = Path(args.root)
    pids = []
    for i in range(NODES):
        (root / f"node{i}").mkdir(parents=True, exist_ok=True)
        mine = node_env(i, args.root, os.environ)
        env = dict(os.environ, **mine)
        env["PYTHONPATH"] = str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")
        if args.device == "cpu":
            env["LONGBOW_FORCE_CPU"] = "1"
        with open(root / f"node{i}.log", "wb") as log:
            p = subprocess.Popen([sys.executable, "-m", "longbow_tpu_torch.serve"], env=env,
                                 cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                                 stdin=subprocess.DEVNULL, start_new_session=True)
        pids.append(p.pid)
        print(f"node{i}: data :{mine['LONGBOW_DATA_PORT']} meta :{mine['LONGBOW_META_PORT']} "
              f"metrics :{mine['LONGBOW_METRICS_PORT']} pid {p.pid}", flush=True)
    (root / "pids").write_text(" ".join(map(str, pids)) + "\n")
    print(f"cluster up; stop with: kill $(cat {args.root}/pids)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
