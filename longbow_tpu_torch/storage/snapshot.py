"""Snapshots: npz index state plus JSON sidecars, swapped in atomically.

Counterpart of longbow_tpu/storage/snapshot.py for its version 2 layout,
file for file: <root>/snapshot/MANIFEST.json and, per dataset,
index.npz (uncompressed), index_meta.json, aux.npz, state.json,
bm25.json, graph.json and meta.json. A snapshot is written to
snapshot.tmp.<us> and renamed into place; a crash between the two
renames leaves snapshot.old.* or snapshot.tmp.*, and read_snapshot
recovers the newest complete one.

Version 1 snapshots keep their rows in a data.parquet, which needs
pyarrow: read_snapshot raises ValueError on one.
"""
from __future__ import annotations

import json
import logging
import shutil
import time
from pathlib import Path
from typing import Optional

import numpy as np


def write_snapshot(root: str | Path, datasets: dict) -> Path:
    """datasets: {name: {"index_state": dict, "aux": {str: ndarray} or
    None, "json": dict or None, "bm25": dict or None, "graph": dict or
    None, "meta": dict}}. Arrays of index_state go to index.npz, its
    other values to index_meta.json. Returns the snapshot directory."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / f"snapshot.tmp.{int(time.time() * 1e6)}"
    tmp.mkdir()
    manifest = {"version": 2, "ts": time.time(), "datasets": []}
    for name, blob in datasets.items():
        safe = name.replace("/", "__")
        ddir = tmp / safe
        ddir.mkdir()
        arrays, scalars = {}, {}
        for k, v in (blob.get("index_state") or {}).items():
            if isinstance(v, np.ndarray):
                arrays[k] = v
            elif v is not None:
                scalars[k] = v
        # uncompressed: rows and codes are high-entropy, and zlib costs
        # 10-20x the CPU for a few per cent
        np.savez(ddir / "index.npz", **arrays)
        (ddir / "index_meta.json").write_text(json.dumps(scalars))
        if blob.get("aux"):
            np.savez(ddir / "aux.npz", **blob["aux"])
        for key, fname in (("json", "state.json"), ("bm25", "bm25.json"),
                           ("graph", "graph.json")):
            if blob.get(key):
                (ddir / fname).write_text(json.dumps(blob[key]))
        (ddir / "meta.json").write_text(json.dumps(blob.get("meta", {})))
        manifest["datasets"].append({"name": name, "dir": safe})
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest))

    final = root / "snapshot"
    old = root / f"snapshot.old.{int(time.time() * 1e6)}"
    if final.exists():
        final.rename(old)
    tmp.rename(final)
    if old.exists():
        shutil.rmtree(old, ignore_errors=True)
    return final


def read_snapshot(root: str | Path) -> Optional[dict]:
    """-> {name: {"table": None, "index_state", "aux", "json", "bm25",
    "graph", "meta"}}, or None when there is no snapshot. Where a crash
    between write_snapshot's renames left only snapshot.old.* or
    snapshot.tmp.*, the newest complete one (with its MANIFEST) is
    renamed into place and read."""
    root = Path(root)
    final = root / "snapshot"
    mf = final / "MANIFEST.json"
    if not mf.exists():
        candidates = sorted(
            (
                d
                for pat in ("snapshot.old.*", "snapshot.tmp.*")
                for d in root.glob(pat)
                if (d / "MANIFEST.json").exists()
            ),
            key=lambda d: d.name.rsplit(".", 1)[-1],
            reverse=True,
        )
        if not candidates:
            return None
        logging.getLogger("longbow.storage").warning(
            "snapshot dir missing; recovering from %s (crash mid-swap)", candidates[0]
        )
        candidates[0].rename(final)
    manifest = json.loads(mf.read_text())
    out = {}
    for entry in manifest["datasets"]:
        ddir = final / entry["dir"]
        if (ddir / "data.parquet").exists():
            raise ValueError(
                f"snapshot {ddir} is a version 1 snapshot (data.parquet); "
                "longbow_tpu_torch reads version 2 snapshots only"
            )
        with np.load(ddir / "index.npz", allow_pickle=False) as z:
            state = {k: z[k] for k in z.files}
        state.update(json.loads((ddir / "index_meta.json").read_text()))
        blob = {
            "table": None,
            "index_state": state,
            "meta": json.loads((ddir / "meta.json").read_text()),
            "aux": None, "json": None, "bm25": None, "graph": None,
        }
        if (ddir / "aux.npz").exists():
            with np.load(ddir / "aux.npz", allow_pickle=False) as z:
                blob["aux"] = {k: z[k] for k in z.files}
        for key, fname in (("json", "state.json"), ("bm25", "bm25.json"),
                           ("graph", "graph.json")):
            if (ddir / fname).exists():
                blob[key] = json.loads((ddir / fname).read_text())
        out[entry["name"]] = blob
    return out
