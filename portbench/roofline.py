"""The scan kernels' least time, from shapes, against published peaks.

A frozen copy of chip_smoke.py's bound arithmetic: operations 2 * B * N * D;
bytes the stored rows read once (2 bytes a dim for bf16 rows, 1 for int8
codes) with their f32 norms and validity bytes, K2's per-query group
term (bf16), the f32 queries read once and the candidate pool (id and distance,
8 bytes each) written once. B, N and D are the request's shape, however
the kernel tiles or pads it. The least time is the larger of operations
over the dense bf16 rate and bytes over the memory bandwidth.

Imports nothing of the program.
"""
from __future__ import annotations

import subprocess

# (name fragment, bytes/s, dense bf16 FLOP/s) from NVIDIA's data sheets,
# at the full power limit; the first fragment found in the card's name
# is used
PEAKS = (
    ("H100 PCIe", 2.0e12, 756e12),
    ("H100 NVL", 3.9e12, 835e12),
    ("H100", 3.35e12, 989e12),  # SXM
    ("H200", 4.8e12, 989e12),
)


def peaks(device_name: str) -> tuple[float, float]:
    """(bytes/s, FLOP/s) of the card; KeyError where none is known."""
    for frag, bw, flops in PEAKS:
        if frag in device_name:
            return bw, flops
    raise KeyError(f"no published peaks for {device_name!r}")


def scan_bytes(b: int, n: int, d: int, pool: int, row_bytes: int, groups: int = 0) -> int:
    """Bytes a scan of b queries over n stored rows of d dims must move;
    groups: K2's bf16 cluster term a query and row group."""
    rows = n * d * row_bytes + n * 4 + n   # rows, norms, validity
    return rows + b * groups * 2 + b * d * 4 + b * pool * 8


def scan_ops(b: int, n: int, d: int) -> int:
    return 2 * b * n * d


def least_seconds(b: int, n: int, d: int, pool: int, row_bytes: int, bw: float,
                  flops: float, groups: int = 0) -> tuple[float, str]:
    """(least seconds, "bytes" | "operations": the bound that sets it)."""
    t_bytes = scan_bytes(b, n, d, pool, row_bytes, groups) / bw
    t_ops = scan_ops(b, n, d) / flops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def power_limit() -> str:
    """nvidia-smi's name and power limit of the first card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else f"nvidia-smi rc {out.returncode}"


def kernel_share(ctx: dict, named) -> float | None:
    """A scan kernel's share of its roofline over a traced window, in %:
    the least time of every store search that began in the window, over
    the summed device time of the kernels `named(name)` picks out there.
    None where the run traced no such kernel."""
    tr, spans = ctx.get("trace"), ctx.get("spans")
    if not tr or not spans or "device_name" not in ctx:
        return None
    kernel_s = sum(e - s for n, s, e in tr["kernels"] if named(n))
    if kernel_s <= 0:
        return None
    bw, flops = peaks(ctx["device_name"])
    sc, sec = ctx["scan"], ctx["seconds"]
    least = sum(least_seconds(b, sc["rows"], sc["dim"], sc["pool"], sc["row_bytes"], bw, flops,
                              sc["groups"])[0]
                for b, t0, _ in spans["store"] if 0 <= t0 <= sec)
    return 100.0 * least / kernel_s
