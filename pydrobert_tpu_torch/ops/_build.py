"""Build the package's CUDA sources on first use and load them with ctypes.

The sources under ``pydrobert_tpu_torch/csrc/`` have a plain C interface
(no PyTorch headers), so ``nvcc`` compiles them into a shared library in
seconds. The library lands in ``pydrobert_tpu_torch/_build/``, named by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing file. A failed build raises with nvcc's
stderr; nothing falls back to the plain PyTorch versions.

Importing this module needs neither ``nvcc`` nor a card: both are looked
for only when a kernel is first launched.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

__all__ = ["build_log", "load_library"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("prologue.cu",)
HEADERS = ("select.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_log = {"seconds": None, "path": None, "stderr": ""}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME); the CUDA "
        "kernels of pydrobert_tpu_torch cannot be built"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(_CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.pydt_decode_prologue.argtypes = [
        p, i32, p, i64, i32, i32, p, p, p, p, p, p,
    ]
    lib.pydt_decode_prologue.restype = i32
    lib.pydt_top_m.argtypes = [p, i32, i64, i32, i32, p, p, p]
    lib.pydt_top_m.restype = i32
    lib.pydt_max_row_lanes.argtypes = []
    lib.pydt_max_row_lanes.restype = i32
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = os.path.join(_BUILD_DIR, f"libpydt_{_source_hash()}.so")
        if not os.path.isfile(path):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp] + [
                os.path.join(_CSRC_DIR, s) for s in SOURCES
            ]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            _log["seconds"] = time.perf_counter() - t0
            _log["stderr"] = proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stderr}"
                )
            os.replace(tmp, path)  # atomic: concurrent builders agree
        _log["path"] = path
        _lib = _declare(ctypes.CDLL(path))
        return _lib


def build_log() -> dict:
    """Seconds the last build took (None when the library was already
    built), the library's path, and nvcc's stderr (``-Xptxas -v`` prints
    each kernel's registers and shared memory there)."""
    return dict(_log)
