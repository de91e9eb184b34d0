"""longbow_tpu_torch: the PyTorch/CUDA port of longbow_tpu.

The main path runs here: a `VectorStore` of flat bf16 indexes served by a
fused scan kernel written in CUDA C++ for Hopper (`csrc/fused_scan.cu`),
followed by an exact f32 re-rank of the candidate pool.

Importing the package itself loads nothing: torch comes with the first
module that needs it, so that a pure client (serving/client.py and the
operator CLI in tools/ops.py) starts without it. Kernels are compiled
with nvcc the first time a CUDA tensor reaches them. The device rule is
`longbow_tpu_torch.device.resolve_device`.
"""
