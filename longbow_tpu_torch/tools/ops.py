"""Operator CLI against a running longbow_tpu_torch node (or any node that
speaks the same Flight protocol), the port's twin of tools/ops.py. Each
command prints one JSON line.

  python -m longbow_tpu_torch.tools.ops put --dataset d --rows 1000 --dim 128
  python -m longbow_tpu_torch.tools.ops get --dataset d [--limit 10] [--filter price<10]
  python -m longbow_tpu_torch.tools.ops search --dataset d --k 10 [--text "hybrid query"]
  python -m longbow_tpu_torch.tools.ops delete --dataset d --ids 1,2,3
  python -m longbow_tpu_torch.tools.ops ns-create --dataset d2 --dim 64 --index sq8
  python -m longbow_tpu_torch.tools.ops ns-list | drop | snapshot | status | mesh | health
  python -m longbow_tpu_torch.tools.ops edge --dataset d --src 1 --dst 2
  python -m longbow_tpu_torch.tools.ops traverse --dataset d --src 1 --dst 3

`put` writes rows drawn from numpy's default_rng(--seed) with ids 0..rows-1;
`search` draws its query from the same generator, so a reader can recompute
both. The CLI is a client: it touches no device itself.
"""
from __future__ import annotations

import argparse
import json
import re
import sys

import numpy as np

COMMANDS = (
    "put", "get", "search", "delete", "drop", "ns-create", "ns-list",
    "snapshot", "status", "mesh", "health", "readiness", "edge",
    "traverse", "info",
)


def _parse_filter(expr: str) -> dict:
    """"price<10" / "cat=a" / "n>=5" -> a wire filter object."""
    for op in ("<=", ">=", "!=", "=", "<", ">"):
        if op in expr:
            field, val = expr.split(op, 1)
            return {"field": field.strip(), "op": op, "value": val.strip()}
    raise SystemExit(f"cannot parse filter {expr!r} (use field<op>value)")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("cmd", choices=COMMANDS)
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--data-port", type=int, default=3000)
    ap.add_argument("--meta-port", type=int, default=3001)
    ap.add_argument("--api-key", default=None)
    ap.add_argument("--dataset", default="ops_test")
    ap.add_argument("--rows", type=int, default=1000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--ids", default="", help="comma-separated ids")
    ap.add_argument("--filter", action="append", default=[],
                    help="field<op>value, repeatable")
    ap.add_argument("--text", default="", help="hybrid text query")
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--index", default="", help="ns-create index kind")
    ap.add_argument("--src", type=int, default=0)
    ap.add_argument("--dst", type=int, default=-1)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from longbow_tpu_torch.serving.client import LongbowClient

    c = LongbowClient(
        args.host, args.data_port, args.meta_port, api_key=args.api_key
    ).connect()
    filters = [_parse_filter(f) for f in args.filter] or None
    rng = np.random.default_rng(args.seed)

    def out(obj) -> int:
        print(json.dumps(obj, default=str), flush=True)
        return 0

    try:
        if args.cmd == "put":
            v = rng.standard_normal((args.rows, args.dim), dtype=np.float32)
            c.write(args.dataset, np.arange(args.rows), v)
            return out({
                "written": args.rows,
                "ack": c.last_put_status or "ok",
            })
        if args.cmd == "get":
            t = c.scan(args.dataset, limit=args.limit, filters=filters)
            return out({
                "rows": t.num_rows,
                "columns": t.column_names,
                "first_ids": t.column("id").to_pylist()[:10],
            })
        if args.cmd == "search":
            try:  # search with the dataset's real dimensionality
                m = re.search(r"\[(\d+)\]", c.get_info(args.dataset)["schema"])
                dim = int(m.group(1)) if m else args.dim
            except Exception:
                dim = args.dim
            q = rng.standard_normal((dim,), dtype=np.float32)
            if args.text and args.alpha < 1.0:
                return out(c.hybrid_search(
                    args.dataset, vector=q, text_query=args.text,
                    k=args.k, alpha=args.alpha, filters=filters,
                ))
            t = c.search(args.dataset, q, k=args.k, filters=filters)
            return out({
                "ids": t.column("id").to_pylist(),
                "scores": t.column("score").to_pylist(),
            })
        if args.cmd == "delete":
            ids = [
                int(x) if x.lstrip("-").isdigit() else x
                for x in args.ids.split(",") if x
            ]
            return out({"deleted": c.delete(args.dataset, ids)})
        if args.cmd == "drop":
            return out({"dropped": c.delete_namespace(args.dataset)})
        if args.cmd == "ns-create":
            body = {"name": args.dataset}
            if args.index:
                body.update({"dim": args.dim, "index": args.index})
            return out(c._action("CreateNamespace", body))
        if args.cmd == "ns-list":
            return out(c.list_namespaces())
        if args.cmd == "snapshot":
            return out(c.snapshot())
        if args.cmd == "status":
            return out(c.cluster_status())
        if args.cmd == "mesh":
            return out(c._action("MeshStatus", {}))
        if args.cmd == "health":
            return out(c._action("health", {}))
        if args.cmd == "readiness":
            return out(c.check_readiness())
        if args.cmd == "info":
            return out(c.get_info(args.dataset))
        if args.cmd == "edge":
            c.add_edge(args.dataset, args.src, args.dst)
            return out({"edge": [args.src, args.dst]})
        if args.cmd == "traverse":
            dst = args.dst if args.dst >= 0 else None
            return out({"path": c.traverse_graph(args.dataset, args.src, dst)})
        raise SystemExit(f"unhandled command {args.cmd}")
    finally:
        c.close()


if __name__ == "__main__":
    sys.exit(main())
