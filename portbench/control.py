"""The control of a cell's comparison, on the chip at the cell's size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

puts the reference in the program's place in the precision below the
one the configuration states (reference.control_answers: its "control"
entry) and holds its answers to the window's first check_queries queries
against the reference, as run.py holds the program's: one JSON line a
seed with the numbers compared and the configuration's limits. Every
limit is set between the program's readings and these.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import numpy as np  # noqa: E402

from recipe import STREAM_WINDOW, centres, deleted_ids, queries  # noqa: E402
from reference import control_answers, exact_topk, judge, true_distances  # noqa: E402


def readings(cfg: dict, mix: dict, seed: int, device: str) -> dict:
    k = cfg["k"]
    qs = queries(seed, STREAM_WINDOW, np.arange(mix["check_queries"]), centres(seed, cfg["dim"]))
    deleted = deleted_ids(seed, cfg["rows"], cfg["deleted_share"])
    ids, scores = control_answers(seed, cfg, qs, deleted, k, device)
    ref_ids, ref_d = exact_topk(seed, cfg, qs, deleted, k, device)
    true_d = true_distances(seed, cfg, qs, ids, device)
    return judge(ids, scores, ref_ids, ref_d, true_d, deleted, cfg["rows"])


def main(argv=None, device: str = "cuda") -> int:
    import run

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    c = run.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = readings(c["config"], c["mix"], seed, device)
        r.update(workload=args.workload, seed=seed, seconds=time.perf_counter() - t,
                 limits=c["config"]["limits"])
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
