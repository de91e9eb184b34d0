"""Build and bind the hand-written CUDA kernels.

Each kernel source under `csrc/` is compiled with nvcc for sm_90a into a
shared library with a plain C interface and loaded with ctypes. The
build happens at first use and lands in `.cuda_build/<hash>/` beside the
package, keyed by a hash of the source, every local header it includes
and the flags, so a changed source or header rebuilds and an unchanged
one loads at once. Nothing here runs
at import time: importing this module needs neither nvcc nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
BUILD_ROOT = _PKG.parent / ".cuda_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    # ptxas reports each kernel's registers, shared memory and spills
    "-Xptxas=-v",
    # each source holds a dozen kernel instantiations: compile them on 4
    # threads (build_all runs one nvcc a source at once)
    "--split-compile=4",
)
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


class KernelError(RuntimeError):
    """A hand-written kernel could not be built, loaded or launched."""


def source_closure(path: Path) -> list[Path]:
    """`path` and every file it includes with `#include "..."`, found
    beside the including file, transitively, each once, in first-seen
    order."""
    seen: list[Path] = []
    todo = [path.resolve()]
    while todo:
        p = todo.pop(0)
        if p in seen:
            continue
        seen.append(p)
        for name in _INCLUDE.findall(p.read_bytes()):
            todo.append((p.parent / name.decode()).resolve())
    return seen


def find_nvcc() -> str:
    """nvcc from PATH, CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise KernelError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


class Kernel:
    """One CUDA source file: its build, its ctypes handle and its launch
    count. `launches` goes up by one each time a wrapper launches the
    kernel, and nowhere else; `by_variant` splits that count by the
    variant launched ("mma" or "wgmma")."""

    def __init__(self, name: str, source: str, bind, defines: tuple[str, ...] = ()):
        self.name = name
        self.source = source  # relative to the package
        self._bind = bind     # sets argtypes/restype on the loaded library
        # preprocessor names set for this build (the timing probes of
        # tools/probe_scan_stages.py); part of the library's hash
        self.flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
        self._lib = None
        self._mu = threading.Lock()
        self.launches = 0
        self.by_variant: dict[str, int] = {}
        self.build_seconds = None
        self.build_log = ""  # nvcc's output of the last build ("" when cached)

    @property
    def path(self) -> Path:
        return _PKG / self.source

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for p in source_closure(self.path):
            h.update(p.name.encode())
            h.update(p.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_ROOT / h.hexdigest()[:16] / f"lib{self.name}.so"

    def build(self) -> Path:
        """Compile the source unless its hashed library already exists."""
        out = self.library_path()
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        try:
            proc = subprocess.run(
                [find_nvcc(), *self.flags, "-o", tmp, str(self.path)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise KernelError(
                    f"nvcc failed for {self.source}:\n{proc.stdout}{proc.stderr}"
                )
            self.build_log = proc.stdout + proc.stderr
            os.replace(tmp, out)  # atomic: concurrent builds agree
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out

    def lib(self):
        """The loaded library, built on first use."""
        with self._mu:
            if self._lib is None:
                t0 = time.perf_counter()
                path = self.build()
                self.build_seconds = time.perf_counter() - t0
                lib = ctypes.CDLL(str(path))
                self._bind(lib)
                self._lib = lib
            return self._lib

    def count_launch(self, variant: str | None = None) -> None:
        with self._mu:
            self.launches += 1
            if variant is not None:
                self.by_variant[variant] = self.by_variant.get(variant, 0) + 1
        # the same counts in the metrics registry, for a reader in another
        # process (a node's /metrics); a metric never fails a launch
        try:
            from longbow_tpu_torch.metrics import get_registry

            reg = get_registry()
            reg.inc("longbow_kernel_launches_total", kernel=self.name)
            if variant is not None:
                reg.inc("longbow_kernel_variant_launches_total", kernel=self.name,
                        variant=variant)
        except Exception:
            pass


def _bind_fused_scan(lib) -> None:
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.longbow_fused_scan_plan.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.longbow_fused_scan_plan.restype = i
    lib.longbow_fused_scan.argtypes = [
        i, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p, p, p,
    ]
    lib.longbow_fused_scan.restype = i
    lib.longbow_fused_scan_wgmma.argtypes = [
        i, p, p, p, p, i, i, i, i, i, i, i, i, p, p, p, p,
    ]
    lib.longbow_fused_scan_wgmma.restype = i


def _bind_fused_codes_scan(lib) -> None:
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.longbow_fused_codes_scan_plan.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.longbow_fused_codes_scan_plan.restype = i
    lib.longbow_fused_codes_scan.argtypes = [
        i, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, p, p, p,
    ]
    lib.longbow_fused_codes_scan.restype = i
    lib.longbow_fused_codes_scan_wgmma.argtypes = [
        i, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p, p, p, p,
    ]
    lib.longbow_fused_codes_scan_wgmma.restype = i


FUSED_SCAN = Kernel("fused_scan", "csrc/fused_scan.cu", _bind_fused_scan)
FUSED_CODES_SCAN = Kernel(
    "fused_codes_scan", "csrc/fused_codes_scan.cu", _bind_fused_codes_scan
)

KERNELS = (FUSED_SCAN, FUSED_CODES_SCAN)


def build_all() -> None:
    """Build and load every kernel, one nvcc per source, all at once."""
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as ex:
        for _ in ex.map(Kernel.lib, KERNELS):
            pass


def reset_launch_counts() -> None:
    for k in KERNELS:
        with k._mu:
            k.launches = 0
            k.by_variant = {}


def launch_counts() -> dict:
    """{"launches": {kernel: launches}, "launches_by_variant": {kernel:
    {variant: launches}}} since the last reset."""
    out: dict = {"launches": {}, "launches_by_variant": {}}
    for k in KERNELS:
        with k._mu:
            out["launches"][k.name] = k.launches
            out["launches_by_variant"][k.name] = dict(k.by_variant)
    return out
