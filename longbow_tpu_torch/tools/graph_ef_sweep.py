"""recall@10 and queries/s of a graph cell over ef_search, through the
served path: portbench/run.py's untraced run of the cell, once a value,
with the configuration's server setting hnsw_ef_search replaced.

    python3 -m longbow_tpu_torch.tools.graph_ef_sweep [--bench portbench] \\
        --workload <cell> --seed <n> --seconds <s> [--ef 50,100,150,200,300]

from a checkout's root, on a card (--device cpu for a test). Prints one
JSON line a value: ef, search_qps, recall_at_10, correct, the readings
compared and setup_s. Each value builds the cell's server again.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bench", default="portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--ef", default="50,100,150,200,300")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = Path(args.bench).resolve()
    sys.path[:0] = [str(bench), str(bench.parent)]
    import run

    cell = run.load_cell(args.workload, bench)
    for ef in (int(x) for x in args.ef.split(",")):
        c = copy.deepcopy(cell)
        c["config"]["server"] = dict(c["config"].get("server", {}), hnsw_ef_search=ef)
        res = run.run_cell(c, args.seed, args.seconds, False, args.device, bench)
        # the queries answered in the window over its length (run.py's rate)
        qps = sum(res["queries_by_second"]) / args.seconds
        print(json.dumps({"ef": ef, "search_qps": qps,
                          "recall_at_10": res["readings"]["recall_at_10"],
                          "correct": res["correct"], "readings": res["readings"],
                          "setup_s": res["metrics"]["setup_s"]["value"],
                          "memory_peak_bytes": res["device"]["memory_peak_bytes"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
