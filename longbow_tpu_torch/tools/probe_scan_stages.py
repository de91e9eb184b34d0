"""Where a tile's time goes in both variants of kernel K2, and in K1's
mma.sync variant at small batches.

    python3 -m longbow_tpu_torch.tools.probe_scan_stages [--wgmma-only | --k1 [--dim D]
        [--batches 1,48] | --k1-ring]

Builds `csrc/fused_codes_scan.cu` several times, each with one or more
LONGBOW_PROBE_* names set that compile a stage of the per-tile loop out
(the outputs of such a build are meaningless), or with another number of
consumer warpgroups or candidate slots (LONGBOW_WGROUPS, LONGBOW_WCAP),
and times the launch alone (CUDA events, median of 10), the wrappers'
host-side steps included, at two shapes over 10,240,000 x 96 int8
codes: the served batch (B = 1,000, k = 64, bf16 group term) and B = 128
with all rows but 20 masked, where nothing is selected. The differences
between the builds give the per-tile split: copy wait, conversion, mma,
scoring, threshold tests, appends and sorts, barriers. The wgmma builds
come first; with --wgmma-only the mma.sync builds are left out. With
--k1 it builds `csrc/fused_scan.cu` instead (K1_BUILDS, K1_WGMMA_BUILDS)
and splits both of its loops into copy, product, scoring and selection
at B = 1 and B = 48 over 1,048,576 x 128 bf16 rows, k = 64, 1%
tombstones: the single query and a Flight ticket group (--dim and
--batches change the width and the batches; a variant that does not take
the width is left out). With --k1-ring
it times K1's wgmma kernel alone (device time from torch.profiler) in
builds without the warm start, with 2 consumer warpgroups and without
appends, and counts its appends and sorts a launch with and without the
warm start (LONGBOW_PROBE_COUNT), at B = 1 and 48 over 1M rows and
B = 1,000 over 131,072 and 1M. Needs one CUDA
card and nvcc; prints one JSON object per line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from longbow_tpu_torch.ops import _kernels, scan

N, D = 10_240_000, 96
BUILDS = {
    "as_is": (),
    "no_epilogue_no_sort": ("LONGBOW_PROBE_NO_EPILOGUE",),
    "no_epilogue_no_second_barrier": ("LONGBOW_PROBE_NO_EPILOGUE", "LONGBOW_PROBE_NO_BARRIER"),
    "no_convert_no_epilogue": ("LONGBOW_PROBE_NO_CONVERT", "LONGBOW_PROBE_NO_EPILOGUE"),
    "copies_only": ("LONGBOW_PROBE_NO_MMA", "LONGBOW_PROBE_NO_EPILOGUE"),
    "mma_only_tile_copied_once": ("LONGBOW_PROBE_NO_FETCH", "LONGBOW_PROBE_NO_EPILOGUE"),
    "mma_only_no_second_barrier": ("LONGBOW_PROBE_NO_FETCH", "LONGBOW_PROBE_NO_EPILOGUE",
                                   "LONGBOW_PROBE_NO_BARRIER"),
    "barriers_only": ("LONGBOW_PROBE_NO_FETCH", "LONGBOW_PROBE_NO_MMA",
                      "LONGBOW_PROBE_NO_EPILOGUE"),
}
WGMMA_BUILDS = {
    "as_is": (),
    "two_groups": ("LONGBOW_WGROUPS=2",),
    "cap_112": ("LONGBOW_WCAP=112",),
    "cap_96": ("LONGBOW_WCAP=96",),
    "threshold_tests_no_append": ("LONGBOW_PROBE_NO_APPEND",),
    "no_select": ("LONGBOW_PROBE_NO_SELECT",),
    "no_epilogue": ("LONGBOW_PROBE_NO_EPILOGUE", "LONGBOW_PROBE_NO_SELECT"),
    "no_convert_no_epilogue": ("LONGBOW_PROBE_NO_CONVERT", "LONGBOW_PROBE_NO_EPILOGUE",
                               "LONGBOW_PROBE_NO_SELECT"),
    "copies_and_loads_only": ("LONGBOW_PROBE_NO_MMA", "LONGBOW_PROBE_NO_CONVERT",
                              "LONGBOW_PROBE_NO_EPILOGUE", "LONGBOW_PROBE_NO_SELECT"),
}

K1_BUILDS = {
    "as_is": (),
    "no_select": ("LONGBOW_PROBE_NO_SELECT",),
    "no_epilogue": ("LONGBOW_PROBE_NO_EPILOGUE",),
    "copies_only": ("LONGBOW_PROBE_NO_MMA", "LONGBOW_PROBE_NO_EPILOGUE"),
    "mma_only_tile_copied_once": ("LONGBOW_PROBE_NO_FETCH", "LONGBOW_PROBE_NO_EPILOGUE"),
    "barriers_only": ("LONGBOW_PROBE_NO_FETCH", "LONGBOW_PROBE_NO_MMA",
                      "LONGBOW_PROBE_NO_EPILOGUE"),
}
K1_WGMMA_BUILDS = {
    "as_is": (),
    "threshold_tests_no_append": ("LONGBOW_PROBE_NO_APPEND",),
    "no_select": ("LONGBOW_PROBE_NO_SELECT",),
    "no_epilogue": ("LONGBOW_PROBE_NO_EPILOGUE", "LONGBOW_PROBE_NO_SELECT"),
    "copies_and_loads_only": ("LONGBOW_PROBE_NO_MMA", "LONGBOW_PROBE_NO_EPILOGUE",
                              "LONGBOW_PROBE_NO_SELECT"),
}
K1_RING_BUILDS = {
    "as_is": (),
    "no_warm_start": ("LONGBOW_PROBE_NO_WARM",),
    "two_groups": ("LONGBOW_WGROUPS=2",),
    "threshold_tests_no_append": ("LONGBOW_PROBE_NO_APPEND",),
    "counted": ("LONGBOW_PROBE_COUNT",),
    "counted_no_warm_start": ("LONGBOW_PROBE_COUNT", "LONGBOW_PROBE_NO_WARM"),
}
K1_N, K1_D = 1_048_576, 128


def time_ms(fn, reps=10):
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


def tiles_per_block_and_us_per_tile(out_d, ms: float) -> dict:
    """From a launch's out_d [B, S, k]: its S splits, the 128-row tiles a
    block walks, and the time per tile."""
    splits = out_d.shape[1]
    tiles = scan._ceil_div(scan._ceil_div(N, 128), splits)
    return {"splits": splits, "tiles_per_block": tiles, "as_is_us_per_tile": 1e3 * ms / tiles}


def k1_stages(card: str, d: int = K1_D, batches: tuple = (1, 48)) -> None:
    """K1's two loops split by stage at the small batches' shapes (or at
    width `d` and `batches`)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = torch.randn((K1_N, d), generator=g, device=dev).to(torch.bfloat16)
    norms = (rows.float() ** 2).sum(dim=1)
    valid = torch.rand((K1_N,), generator=g, device=dev) > 0.01
    variants = [v for v in ("mma", "wgmma")
                if v == "mma" or all(scan.wgmma_takes(b, d, 64, True) for b in batches)]
    builds = {(v, name): _kernels.Kernel(f"probe_k1_{v}_{name}", "csrc/fused_scan.cu",
                                         _kernels._bind_fused_scan, defines)
              for v, table in (("mma", K1_BUILDS), ("wgmma", K1_WGMMA_BUILDS)) if v in variants
              for name, defines in table.items()}
    with ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(_kernels.Kernel.lib, builds.values()))
    launch = {"mma": scan.launch_flat_mma, "wgmma": scan.launch_flat_wgmma}
    for b in batches:
        q = torch.randn((b, d), generator=g, device=dev)
        _, qc, qn, vn, l2 = scan._prepare(q, rows, norms, valid, 64, "l2", None, False, dev)
        for variant in variants:
            row = {"shape": f"k1_b{b}_k64_1m_x_{d}", "variant": variant, "card": card}
            if variant == "wgmma":
                row["nq"] = scan.wgmma_width(b, d)
            for (v, name), kern in builds.items():
                if v == variant:
                    row[name + "_ms"] = time_ms(
                        lambda: launch[v](kern, rows, qc, qn, vn, 64, l2), 20)
            out_d = launch[variant](builds[(variant, "as_is")], rows, qc, qn, vn, 64, l2)[0]
            splits = out_d.shape[1]
            tiles = scan._ceil_div(scan._ceil_div(K1_N, 128), splits)
            row.update({"splits": splits, "tiles_per_block": tiles,
                        "as_is_us_per_tile": 1e3 * row["as_is_ms"] / tiles})
            print(json.dumps(row), flush=True)


def k1_ring(card: str) -> None:
    """K1's wgmma kernel alone, by build, with its appends and sorts."""
    import ctypes

    from longbow_tpu_torch.tools.probe_scan_variants import profile

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = torch.randn((K1_N, K1_D), generator=g, device=dev).to(torch.bfloat16)
    norms = (rows.float() ** 2).sum(dim=1)
    valid = torch.rand((K1_N,), generator=g, device=dev) > 0.01
    builds = {name: _kernels.Kernel(f"probe_ring_{name}", "csrc/fused_scan.cu",
                                    _kernels._bind_fused_scan, defines)
              for name, defines in K1_RING_BUILDS.items()}
    with ThreadPoolExecutor(max_workers=len(builds)) as ex:
        list(ex.map(_kernels.Kernel.lib, builds.values()))
    for name in ("as_is", "no_warm_start"):
        for line in builds[name].build_log.splitlines():
            if "scan_wgmma_kernel" in line or "registers" in line or "spill" in line:
                print(f"[{name}] {line.strip()[-100:]}", flush=True)
    counts = (ctypes.c_ulonglong * 2)()
    for b, n in ((1, K1_N), (48, K1_N), (1000, 131_072), (1000, K1_N)):
        q = torch.randn((b, K1_D), generator=g, device=dev)
        _, qc, qn, vn, l2 = scan._prepare(q, rows[:n], norms[:n], valid[:n], 64, "l2", None,
                                          False, dev)
        row = {"shape": f"k1_wgmma_b{b}_k64_{n}_x_128", "nq": scan.wgmma_width(b), "card": card}
        for name, kern in builds.items():
            def call():
                return scan.launch_flat_wgmma(kern, rows[:n], qc, qn, vn, 64, l2)
            prof = profile(call, 10)
            row[name + "_us"] = next((v for key, v in prof["device_us_by_kernel"].items()
                                      if "scan_wgmma_kernel" in key), None)
        for name in ("counted", "counted_no_warm_start"):
            read = builds[name].lib().longbow_probe_counts
            read.argtypes = [ctypes.c_void_p]
            read(ctypes.addressof(counts))
            scan.launch_flat_wgmma(builds[name], rows[:n], qc, qn, vn, 64, l2)
            torch.cuda.synchronize()
            read(ctypes.addressof(counts))
            row[f"{name}_appends"], row[f"{name}_sorts"] = int(counts[0]), int(counts[1])
        print(json.dumps(row), flush=True)


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    if "--k1" in sys.argv:
        d = int(sys.argv[sys.argv.index("--dim") + 1]) if "--dim" in sys.argv else K1_D
        batches = ((1, 48) if "--batches" not in sys.argv else
                   tuple(int(x) for x in sys.argv[sys.argv.index("--batches") + 1].split(",")))
        return k1_stages(card, d, batches)
    if "--k1-ring" in sys.argv:
        return k1_ring(card)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    codes = torch.randint(-128, 128, (N, D), generator=g, device=dev, dtype=torch.int8)
    vn_all = torch.rand((N,), generator=g, device=dev) * 100.0
    tomb = torch.rand((N,), generator=g, device=dev) > 0.01
    few = torch.arange(N, device=dev) < 20
    shapes = {}
    for name, b, valid, with_gt in (("served_b1000_k64_gt_bf16", 1000, tomb, True),
                                    ("b128_k64_all_but_20_masked", 128, few, False)):
        qs = (torch.randn((b, D), generator=g, device=dev) * 0.03).to(torch.bfloat16)
        qn = torch.rand((b,), generator=g, device=dev)
        vn = torch.where(valid, vn_all, torch.full_like(vn_all, scan.MASKED))
        gt = (torch.randn((b, N // 128), generator=g, device=dev).to(torch.bfloat16)
              if with_gt else None)
        shapes[name] = (codes, qs, qn, vn, gt, 64)
    wkernels = {
        name: _kernels.Kernel(f"probe_wgmma_{name}", "csrc/fused_codes_scan.cu",
                              _kernels._bind_fused_codes_scan, defines)
        for name, defines in WGMMA_BUILDS.items()
    }
    with ThreadPoolExecutor(max_workers=len(wkernels)) as ex:
        list(ex.map(_kernels.Kernel.lib, wkernels.values()))
    for line in wkernels["as_is"].build_log.splitlines():
        if "Compiling" in line or "registers" in line or "spill" in line:
            print(line.strip()[-110:])
    for shape, args in shapes.items():
        row = {"shape": shape, "variant": "wgmma", "card": card}
        for name, kern in wkernels.items():
            row[name + "_ms"] = time_ms(lambda: scan.launch_codes_wgmma(kern, *args))
        row.update(tiles_per_block_and_us_per_tile(
            scan.launch_codes_wgmma(wkernels["as_is"], *args)[0], row["as_is_ms"]))
        print(json.dumps(row), flush=True)
    if "--wgmma-only" in sys.argv:
        return
    kernels = {
        name: _kernels.Kernel(f"probe_{name}", "csrc/fused_codes_scan.cu",
                              _kernels._bind_fused_codes_scan, defines)
        for name, defines in BUILDS.items()
    }
    with ThreadPoolExecutor(max_workers=len(kernels)) as ex:
        list(ex.map(_kernels.Kernel.lib, kernels.values()))
    for shape, args in shapes.items():
        row = {"shape": shape, "variant": "mma", "card": card}
        for name, kern in kernels.items():
            row[name + "_ms"] = time_ms(lambda: scan.launch_codes_mma(kern, *args))
        row.update(tiles_per_block_and_us_per_tile(
            scan.launch_codes_mma(kernels["as_is"], *args)[0], row["as_is_ms"]))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
