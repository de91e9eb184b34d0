"""ctypes loader for the native runtime library (native_src/longbow_native.cpp).

Counterpart of longbow_tpu/storage/native.py, with its own copy of the
source. The library holds CRC32C, the WAL frame encode and scan, the
io_uring WAL backend, the JSON float parse and the bf16 converts of
the flat index's host scan mirror (index/flat.py). It is built at first use with `g++ -O3 -shared -fPIC -std=c++17` into
`.native_build/<hash>/` at the repository root, keyed by a hash of the
source and the flags, and loaded from there afterwards. Nothing is built
at import time.

There is no quiet fallback: where g++ is missing or the build fails,
`get_lib` raises NativeBuildError with the compiler's output. The
Python CRC32C (`_py_crc32c`) and the numpy bf16 rounding
(`_np_f32_to_bf16`) are the plain versions the tests hold the library
against; the WAL and the mirror never use them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native_src" / "longbow_native.cpp"
BUILD_ROOT = _PKG.parent / ".native_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """The native library could not be built or loaded."""


def library_path() -> Path:
    """Where the built library lives: keyed by the source and the flags."""
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "liblongbow_native.so"


def _build(so: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError(
            "g++ was not found on PATH; the native WAL library "
            f"({SOURCE}) cannot be built"
        )
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        res = subprocess.run(
            [gxx, *GXX_FLAGS, str(SOURCE), "-o", tmp],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise NativeBuildError(
                f"g++ failed on {SOURCE} (exit {res.returncode}):\n{res.stderr}"
            )
        os.replace(tmp, so)  # atomic: concurrent builds converge
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    sigs = {
        "lb_crc32c": (c.c_uint32, [c.c_char_p, c.c_uint64, c.c_uint32]),
        "lb_wal_frame_size": (c.c_uint64, [c.c_uint16, c.c_uint32]),
        "lb_wal_encode": (c.c_uint64, [
            c.c_char_p, c.c_uint64, c.c_double, c.c_char_p, c.c_uint16,
            c.c_uint8, c.c_char_p, c.c_uint32,
        ]),
        "lb_wal_scan": (c.c_int64, [
            c.c_char_p, c.c_uint64, c.POINTER(c.c_uint64), c.c_int64,
            c.POINTER(c.c_uint64),
        ]),
        # the io_uring WAL backend
        "lb_uring_open": (c.c_uint64, [c.c_char_p, c.c_uint32]),
        "lb_uring_write": (c.c_int64, [c.c_uint64, c.c_char_p, c.c_uint64]),
        "lb_uring_fsync": (c.c_int64, [c.c_uint64]),
        "lb_uring_truncate": (c.c_int64, [c.c_uint64]),
        "lb_uring_close": (None, [c.c_uint64]),
        # the query-vector span of a ticket (query/parser.py::_fast_parse)
        "lb_json_f32": (c.c_int64, [
            c.c_char_p, c.c_uint64, c.POINTER(c.c_float), c.c_int64,
            c.POINTER(c.c_int64), c.POINTER(c.c_uint64),
        ]),
        # the host scan mirror's bf16 bits (index/flat.py)
        "lb_f32_to_bf16": (None, [c.c_void_p, c.c_void_p, c.c_uint64]),
        "lb_bf16_to_f32": (None, [c.c_void_p, c.c_void_p, c.c_uint64]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at the first call. Raises
    NativeBuildError when it cannot be built or loaded."""
    global _lib
    with _LOCK:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _build(so)
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:
                raise NativeBuildError(f"cannot load {so}: {e}") from e
            _bind(lib)
            _lib = lib
        return _lib


_PY_TABLE: Optional[list] = None


def _py_crc32c(data: bytes, seed: int = 0) -> int:
    """CRC32C (Castagnoli) in Python, the plain version of lb_crc32c."""
    global _PY_TABLE
    if _PY_TABLE is None:
        poly = 0x82F63B78
        tbl = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            tbl.append(crc)
        _PY_TABLE = tbl
    crc = ~seed & 0xFFFFFFFF
    for b in data:
        crc = _PY_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return ~crc & 0xFFFFFFFF


def crc32c(data: bytes, seed: int = 0) -> int:
    return get_lib().lb_crc32c(data, len(data), seed)


def f32_to_bf16_bits(src: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """float32 -> bfloat16 bits in uint16, rounded to nearest even, a NaN
    made canonical (its sign | 0x7FC0); one native pass. out: a
    C-contiguous uint16 array of src's shape to write into."""
    src = np.ascontiguousarray(src, np.float32)
    if out is None:
        out = np.empty(src.shape, np.uint16)
    elif out.shape != src.shape or out.dtype != np.uint16 or not out.flags.c_contiguous:
        raise ValueError(f"out must be C-contiguous uint16 {src.shape}, got "
                         f"{out.dtype} {out.shape}")
    get_lib().lb_f32_to_bf16(src.ctypes.data, out.ctypes.data, src.size)
    return out


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bits in uint16 -> float32 (exact); one native pass."""
    src = np.ascontiguousarray(bits)
    if src.dtype != np.uint16:
        raise ValueError(f"expected uint16 bf16 bits, got {src.dtype}")
    out = np.empty(src.shape, np.float32)
    get_lib().lb_bf16_to_f32(src.ctypes.data, out.ctypes.data, src.size)
    return out


def _np_f32_to_bf16(src: np.ndarray) -> np.ndarray:
    """The plain version of lb_f32_to_bf16 in numpy (round to nearest
    even; a NaN becomes its sign | 0x7FC0)."""
    u = np.ascontiguousarray(src, np.float32).view(np.uint32)
    t = ((u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) >> np.uint32(16))
    nan = ((u & np.uint32(0x7F800000)) == np.uint32(0x7F800000)) & (
        (u & np.uint32(0x007FFFFF)) != 0)
    t = np.where(nan, ((u >> np.uint32(16)) & np.uint32(0x8000)) | np.uint32(0x7FC0), t)
    return t.astype(np.uint16)
