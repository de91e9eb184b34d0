"""Kernel K2 (csrc/fused_codes_scan.cu, csrc/scan_wgmma.cuh through
ops/scan.py): its share of the roofline over the sq8r main region's rows,
in % (roofline.kernel_share). K2's launches are its mma.sync kernel and
the wgmma ring's int8 instantiations."""
from roofline import kernel_share


def is_k2(name: str) -> bool:
    return "fused_codes_kernel" in name or (
        "scan_wgmma_kernel" in name and "bfloat16" not in name)


def read(ctx: dict, metric: str):
    return kernel_share(ctx, is_k2)
