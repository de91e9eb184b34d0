"""Where a tile's time goes in both variants of kernel K2.

    python3 -m longbow_tpu_torch.tools.probe_scan_stages [--wgmma-only]

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
come first; with --wgmma-only the mma.sync builds are left out. Needs
one CUDA card and nvcc; prints one JSON object per line.
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


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
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
