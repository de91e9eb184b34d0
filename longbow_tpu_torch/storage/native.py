"""ctypes loader for the native runtime library (native_src/longbow_native.cpp).

Counterpart of longbow_tpu/storage/native.py, with its own copy of the
source. The library holds CRC32C, the WAL frame encode and scan, the
io_uring WAL backend, the JSON float parse and the bf16 converts; all
but the bf16 converts (the Flight edge's scan mirror) are bound here. It
is built at first use with `g++ -O3 -shared -fPIC -std=c++17` into
`.native_build/<hash>/` at the repository root, keyed by a hash of the
source and the flags, and loaded from there afterwards. Nothing is built
at import time.

There is no quiet fallback: where g++ is missing or the build fails,
`get_lib` raises NativeBuildError with the compiler's output. The
Python CRC32C (`_py_crc32c`) is the plain version the tests hold the
library against; the WAL never uses it.
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
