"""longbow_tpu_torch: the PyTorch/CUDA port of longbow_tpu.

The main path runs here: a `VectorStore` of flat bf16 indexes served by a
fused scan kernel written in CUDA C++ for Hopper (`csrc/fused_scan.cu`),
followed by an exact f32 re-rank of the candidate pool.

Importing the package loads torch and numpy only; kernels are compiled
with nvcc the first time a CUDA tensor reaches them.
"""
from longbow_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
