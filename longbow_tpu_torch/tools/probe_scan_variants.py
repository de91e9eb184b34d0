"""Both variants of kernels K1 and K2 at the shapes the main paths give
them, beside the bound and torch.matmul + torch.topk on the same inputs.

    python3 -m longbow_tpu_torch.tools.probe_scan_variants [--grid] [--dims] [--profile]
    python3 -m longbow_tpu_torch.tools.probe_scan_variants --chunked-narrow

For each shape it times the mma.sync variant and, where `wgmma_takes`
allows, the wgmma variant (each forced), through the public wrapper
(`ms`: what a caller pays, the mask fold and the split merge included) and
through the launch function alone on prepared inputs (`launch_ms`),
CUDA events, median of 20 launches after a warm-up, and the kernel
alone (`kernel_ms`: the launcher's go(), which does no host work but the
launch, 20 times back to back, the median of the device time between
the events around each). Beside them: the
variant `scan_variant` picks, the wgmma query-block width, the bound (the
larger of the bytes over 3.35 TB/s and 2 B N D over 989 TFLOP/s on an
H100 SXM) and the yardstick. The default list is the main paths' shapes
(K1 on 1M x 128 at B 1 to 128 and at B = 1,000 over 32,768 to 262,144
rows; K2 on 10,240,000 x 96 with a bf16 group term at B 1 and 16 and at
1,000 x 131,072 x 128); --grid adds the batch grid the variant choice is
read from. --dims times the wide shapes instead (DIM_SHAPES: K1 and K2 at
D = 129 to 1,024 over 1,048,576 rows at B 1, 48 and 1,000, and the dot
graph's self-kNN launch, 4,096 x 131,072 at D = 129 and padded to 144);
with --grid as well, the batch x rows grid of the wide crossovers
(DIM_GRID). --chunked-narrow times the wgmma kernel at the whole-tile
widths' served shapes (NARROW_SHAPES) as built and forced through the
chunked loop (chunked_narrow). --profile also traces 10 wrapper calls of
each variant with torch.profiler: device time by kernel name, device-busy
time and host time a call. Needs one CUDA card and nvcc; prints the card's name and
power limit, then one JSON object per shape. chip_smoke.py runs `sweep`.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys

import torch

PEAK_BYTES_PER_S, PEAK_BF16_FLOPS = 3.35e12, 989e12   # H100 SXM, NVIDIA's data sheet
REPS = 20

# (kernel: "fused_scan" K1 or "fused_codes_scan" K2, B, N, D, k, group
# term): the main paths' shapes
SHAPES = (
    [("fused_scan", b, 1_048_576, 128, 64, None) for b in (1, 4, 16, 17, 48, 57, 128)]
    + [("fused_scan", 1000, n, 128, 64, None) for n in (32_768, 131_072, 262_144)]
    + [("fused_codes_scan", b, 10_240_000, 96, 64, "bf16") for b in (1, 16)]
    + [("fused_codes_scan", 1000, 131_072, 128, 64, None)]
)
# the grid the variant choice (ops/scan.py WGMMA_FROM) is read from
GRID = (
    [("fused_scan", b, n, 128, 64, None) for n in (32_768, 131_072, 1_048_576)
     for b in (1, 2, 8, 32, 33, 64, 65, 129, 256, 512)]
    + [("fused_codes_scan", b, n, 128, 64, None) for n in (131_072, 1_048_576)
       for b in (1, 16, 17, 48, 128, 256)]
    + [(kernel, b, n, 128, 64, None) for kernel in ("fused_scan", "fused_codes_scan")
       for n in (262_144, 524_288, 1_048_576 - 77) for b in (1, 2, 8, 16, 48, 64, 128)]
    + [("fused_scan", 1000, 1_048_576, 128, 64, None),
       ("fused_codes_scan", 1000, 10_240_000, 96, 64, "bf16")]
)

# the wide shapes: every width past the D <= 128 ring up to 1,024, and the
# dot graph's self-kNN (a MIPS column makes D = 129; SELF_KNN_QUERIES
# queries a launch over a 131,072-row build, k + 1 = 65 -> 64)
DIMS = (129, 144, 256, 384, 768, 960, 1024)
DIM_SHAPES = (
    [(kernel, b, 1_048_576, d, 64, None) for kernel in ("fused_scan", "fused_codes_scan")
     for d in DIMS for b in (1, 48, 1000)]
    + [("fused_scan", 4096, 131_072, 129, 64, None), ("fused_scan", 4096, 131_072, 144, 64, None)]
)
# the grid the wide crossovers are read from
DIM_GRID = [(kernel, b, n, d, 64, None) for kernel, d in (("fused_scan", 960),
                                                          ("fused_scan", 144),
                                                          ("fused_codes_scan", 768))
            for n in (32_768, 131_072, 262_144) for b in (1, 16, 64, 256)]


def time_ms(fn, reps: int = REPS) -> float:
    """Median device time of fn() over `reps` calls, CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def kernel_ms(go, reps: int = REPS) -> float:
    """A kernel's time: `reps` launches of go() (a launcher's, which does
    no host work but the launch) back to back after a warm-up, the median
    of the device time between the events recorded around each, so that
    the card and not the host sets the pace and one slow launch does not
    move it."""
    go()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    ev[0].record()
    for i in range(reps):
        go()
        ev[i + 1].record()
    ev[-1].synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1]) for i in range(reps))


def bound(kernel, b, n, d, k, gt, bw=PEAK_BYTES_PER_S, flops=PEAK_BF16_FLOPS) -> tuple:
    """(ms, "bytes" or "operations"): each input read once, each output
    written once (rows, row term, mask, group term, queries, results)."""
    elem = 2 if kernel == "fused_scan" else 1
    gt_bytes = 0 if gt is None else b * (n // 128) * (2 if gt == "bf16" else 4)
    moved = n * d * elem + n * 4 + n + gt_bytes + b * d * 4 + b * 4 + b * k * 8
    by = "bytes" if moved / bw >= 2 * b * n * d / flops else "operations"
    return 1e3 * max(moved / bw, 2 * b * n * d / flops), by


class _Data:
    """Rows made once per (kernel, N, D) and reused across batches."""

    def __init__(self, dev):
        self.dev = dev
        self.g = torch.Generator(device=dev).manual_seed(0)
        self.rows = {}

    def get(self, kernel, n, d):
        key = (kernel, n, d)
        if key not in self.rows:
            self.rows.clear()   # one corpus at a time: 10M x 96 and its bf16 copy are 3 GB
            torch.cuda.empty_cache()
            if kernel == "fused_scan":
                c = torch.randn((n, d), generator=self.g, device=self.dev).to(torch.bfloat16)
                cf = c.float()
                self.rows[key] = (c, (cf * cf).sum(dim=1), c)
            else:
                c = torch.randint(-128, 128, (n, d), generator=self.g, device=self.dev,
                                  dtype=torch.int8)
                vn = torch.rand((n,), generator=self.g, device=self.dev) * 100.0
                self.rows[key] = (c, vn, c.to(torch.bfloat16))
        return self.rows[key]


def profile(fn, calls: int = 10) -> dict:
    """Device time by kernel name (us a call, from torch.profiler's CUDA
    activity), the device-busy sum and the host time a call of fn()."""
    import time

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    fn()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if ev.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            by_kernel[ev.key[:60]] = dev_us / calls
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])
    return {"device_us_by_kernel": top, "device_busy_us": sum(by_kernel.values()),
            "host_us_a_call": 1e6 * host_s / calls}


def sweep(shapes=SHAPES, bw=PEAK_BYTES_PER_S, flops=PEAK_BF16_FLOPS, reps=REPS, emit=None,
          traced=False):
    """Time every shape (and with `traced` profile it); returns one dict a
    shape (and passes each to `emit` as it is made)."""
    from longbow_tpu_torch.ops import scan

    dev = torch.device("cuda")
    data = _Data(dev)
    out = []
    for kernel, b, n, d, k, gt_kind in shapes:
        rows, vn, rows16 = data.get(kernel, n, d)
        valid = torch.rand((n,), generator=data.g, device=dev) > 0.01
        q = torch.randn((b, d), generator=data.g, device=dev)
        row = {"kernel": kernel, "b": b, "n": n, "d": d, "k": k, "gt": gt_kind,
               "chosen": scan.scan_variant(b, n, d, k, True, kernel),
               "nq": scan.wgmma_width(b, d, 2 if kernel == "fused_scan" else 1)}
        if kernel == "fused_scan":
            call = lambda v: scan.fused_flat_search(q, rows, vn, valid, k, variant=v)  # noqa: E731
            _, qc, qn, vnm, l2 = scan._prepare(q, rows, vn, valid, k, "l2", None, False, dev)
            launches = {"mma": lambda: scan.launch_flat_mma(scan.FUSED_SCAN, rows, qc, qn, vnm,
                                                            k, l2),
                        "wgmma": lambda: scan.launch_flat_wgmma(scan.FUSED_SCAN, rows, qc, qn,
                                                                vnm, k, l2)}
            launcher = lambda v: scan.flat_launcher(  # noqa: E731
                scan.FUSED_SCAN, v, rows, qc, qn, vnm, k, l2)[0]
            qy = qc
        else:
            qs = q * 0.03
            qn0 = torch.rand((b,), generator=data.g, device=dev)
            gt = None
            if gt_kind:
                gt = torch.randn((b, n // 128), generator=data.g, device=dev).to(torch.bfloat16)
            call = lambda v: scan.fused_codes_search(  # noqa: E731
                qs, qn0, rows, vn, valid, k, group_term=gt, variant=v)
            _, qsb, qnp, vnm, gtp = scan._prepare_codes(qs, qn0, rows, vn, valid, k, gt, None,
                                                        dev)
            launches = {"mma": lambda: scan.launch_codes_mma(scan.FUSED_CODES_SCAN, rows, qsb,
                                                             qnp, vnm, gtp, k),
                        "wgmma": lambda: scan.launch_codes_wgmma(scan.FUSED_CODES_SCAN, rows,
                                                                 qsb, qnp, vnm, gtp, k)}
            launcher = lambda v: scan.codes_launcher(  # noqa: E731
                scan.FUSED_CODES_SCAN, v, rows, qsb, qnp, vnm, gtp, k)[0]
            qy = qsb
        variants = ["mma"] + (["wgmma"] if scan.wgmma_takes(b, d, k, True) else [])
        for v in variants:
            row[f"{v}_ms"] = time_ms(lambda: call(v), reps)
            row[f"{v}_launch_ms"] = time_ms(launches[v], reps)
            row[f"{v}_kernel_ms"] = kernel_ms(launcher(v), reps)
            if traced:
                row[f"{v}_profile"] = profile(lambda: call(v))
        row["matmul_topk_ms"] = time_ms(
            lambda: torch.topk(torch.matmul(qy, rows16.T), k, dim=1), reps)
        row["bound_ms"], row["bound_by"] = bound(kernel, b, n, d, k, gt_kind, bw, flops)
        out.append(row)
        if emit:
            emit(row)
    return out


# the whole-tile widths' served shapes, where --chunked-narrow times the
# ring as built beside the same ring forced through its chunked loop
NARROW_SHAPES = (
    [("fused_scan", b, 1_048_576, 128, 64, None) for b in (1, 48, 1000)]
    + [("fused_codes_scan", b, 10_240_000, 96, 64, "bf16") for b in (1, 1000)]
)


@contextlib.contextmanager
def _chunked_layout():
    """ops/scan.py's host-side layout of the chunked loop at every width
    (the queries padded and ordered chunk by chunk), for a build with
    LONGBOW_PROBE_CHUNKED."""
    from longbow_tpu_torch.ops import scan

    real = scan.wgmma_chunked
    scan.wgmma_chunked = lambda d: True
    scan._K_ORDER.clear()
    try:
        yield
    finally:
        scan.wgmma_chunked = real
        scan._K_ORDER.clear()


def chunked_narrow(shapes=NARROW_SHAPES, reps=REPS, emit=None):
    """The wgmma kernel alone (kernel_ms) at the whole-tile widths, as
    built (whole 128-row tiles of all D columns a stage) and forced
    through the chunked loop (a build with LONGBOW_PROBE_CHUNKED: stages
    of 128 rows x 128 bytes), on the same inputs, with the largest
    difference of their merged distances; one dict a shape."""
    from concurrent.futures import ThreadPoolExecutor

    from longbow_tpu_torch.ops import _kernels, scan

    probes = {
        "fused_scan": _kernels.Kernel("fused_scan_chunked", "csrc/fused_scan.cu",
                                      _kernels._bind_fused_scan, ("LONGBOW_PROBE_CHUNKED",)),
        "fused_codes_scan": _kernels.Kernel("fused_codes_scan_chunked",
                                            "csrc/fused_codes_scan.cu",
                                            _kernels._bind_fused_codes_scan,
                                            ("LONGBOW_PROBE_CHUNKED",)),
    }
    with ThreadPoolExecutor(4) as ex:
        list(ex.map(_kernels.Kernel.lib, list(probes.values()) + list(_kernels.KERNELS)))
    dev = torch.device("cuda")
    data = _Data(dev)
    out = []
    for kernel, b, n, d, k, gt_kind in shapes:
        rows, vn, _ = data.get(kernel, n, d)
        valid = torch.rand((n,), generator=data.g, device=dev) > 0.01
        q = torch.randn((b, d), generator=data.g, device=dev)
        if kernel == "fused_scan":
            _, qc, qn, vnm, l2 = scan._prepare(q, rows, vn, valid, k, "l2", None, False, dev)
            launcher = lambda kern: scan.flat_launcher(  # noqa: E731
                kern, "wgmma", rows, qc, qn, vnm, k, l2)
        else:
            gt = None
            if gt_kind:
                gt = torch.randn((b, n // 128), generator=data.g, device=dev).to(torch.bfloat16)
            qn0 = torch.rand((b,), generator=data.g, device=dev)
            _, qsb, qnp, vnm, gtp = scan._prepare_codes(q * 0.03, qn0, rows, vn, valid, k, gt,
                                                        None, dev)
            l2 = True
            launcher = lambda kern: scan.codes_launcher(  # noqa: E731
                kern, "wgmma", rows, qsb, qnp, vnm, gtp, k)
        go, od, oi = launcher(getattr(scan, kernel.upper()))
        with _chunked_layout():
            go_c, od_c, oi_c = launcher(probes[kernel])
            nq_c = scan.wgmma_width(b, d, 2 if kernel == "fused_scan" else 1)
        go()
        go_c()
        whole_d, _ = scan._merge_splits(od, oi, k, l2)
        chunk_d, _ = scan._merge_splits(od_c, oi_c, k, l2)
        row = {"kernel": kernel, "b": b, "n": n, "d": d, "k": k, "gt": gt_kind,
               "nq": scan.wgmma_width(b, d, 2 if kernel == "fused_scan" else 1), "nq_chunked": nq_c,
               "whole_tile_kernel_ms": kernel_ms(go, reps),
               "chunked_kernel_ms": kernel_ms(go_c, reps),
               "max_abs_diff": float((whole_d - chunk_d).abs().max())}
        row["chunked_over_whole"] = row["chunked_kernel_ms"] / row["whole_tile_kernel_ms"]
        out.append(row)
        if emit:
            emit(row)
    return out


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if "--chunked-narrow" in sys.argv:
        chunked_narrow(emit=lambda r: print(json.dumps(dict(r, card=card)), flush=True))
        return
    grid, dims = "--grid" in sys.argv, "--dims" in sys.argv
    shapes = (SHAPES + (GRID if grid else []) if not dims
              else DIM_SHAPES + (DIM_GRID if grid else []))
    sweep(shapes, emit=lambda r: print(json.dumps(dict(r, card=card)), flush=True),
          traced="--profile" in sys.argv)


if __name__ == "__main__":
    main()
