"""Build the package's CUDA sources on first use and load them with ctypes.

The sources under ``pydrobert_tpu_torch/csrc/`` have a plain C interface
(no PyTorch headers). One ``nvcc`` per source compiles them to objects, all
started together, and one more links the objects into a shared library;
the whole build takes seconds. The library lands in ``pydrobert_tpu_torch/_build/``, named by a
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
SOURCES = (
    "prologue.cu", "spec_augment.cu", "edit_distance.cu", "ctc_beam.cu", "depthwise_conv.cu",
)
HEADERS = ("select.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    lib.pydt_spec_augment_apply.argtypes = [
        p, i32, p, p, p, p, p, p, i32, i32, i32, i32, p, p,
    ]
    lib.pydt_spec_augment_apply.restype = i32
    f32 = ctypes.c_float
    lib.pydt_edit_distance.argtypes = [
        p, p, p, p, i32, i32, i32, f32, f32, f32, i32, p, p,
    ]
    lib.pydt_edit_distance.restype = i32
    lib.pydt_edit_distance_warp_words.argtypes = [i32]
    lib.pydt_edit_distance_warp_words.restype = i32
    lib.pydt_edit_distance_strip.argtypes = [i32]
    lib.pydt_edit_distance_strip.restype = i32
    lib.pydt_prologue_warp_words.argtypes = [i32, i32]
    lib.pydt_prologue_warp_words.restype = i64
    lib.pydt_max_warp_words.argtypes = []
    lib.pydt_max_warp_words.restype = i32
    lib.pydt_ctc_beam_search.argtypes = [
        p, p, p, p, p, i32, i32, i32, i32, i32, p, p, p, p,
    ]
    lib.pydt_ctc_beam_search.restype = i32
    lib.pydt_ctc_beam_search_renorm.argtypes = [
        p, p, p, i32, p, p, p, p, i32, i32, i32, i32, i32, p, p, p, p, p,
    ]
    lib.pydt_ctc_beam_search_renorm.restype = i32
    lib.pydt_ctc_beam_smem_bytes.argtypes = [i32, i32, i32]
    lib.pydt_ctc_beam_smem_bytes.restype = i64
    lib.pydt_depthwise_conv1d.argtypes = [p, i32, p, p, i32, i32, i32, i32, i32, i32, p, p]
    lib.pydt_depthwise_conv1d.restype = i32
    return lib


def _run_all(cmds) -> str:
    """Run the commands together; their stderr, or raise with it if any
    fails."""
    procs = [
        subprocess.Popen(
            c, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True
        )
        for c in cmds
    ]
    errs = [p.communicate()[1] for p in procs]
    for c, p, e in zip(cmds, procs, errs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(c)}\n{e}"
            )
    return "".join(errs)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = os.path.join(_BUILD_DIR, f"libpydt_{_source_hash()}.so")
        if not os.path.isfile(path):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            nvcc = _nvcc()
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as work:
                objs = [os.path.join(work, s + ".o") for s in SOURCES]
                stderr = _run_all([
                    [nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(_CSRC_DIR, s)]
                    for s, o in zip(SOURCES, objs)
                ])
                tmp = os.path.join(work, "lib.so")
                stderr += _run_all([
                    [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                     "-shared", "-o", tmp, *objs]
                ])
                os.replace(tmp, path)  # atomic: concurrent builds agree
            _log["seconds"] = time.perf_counter() - t0
            _log["stderr"] = stderr
        _log["path"] = path
        _lib = _declare(ctypes.CDLL(path))
        return _lib


def build_log() -> dict:
    """Seconds the last build took (None when the library was already
    built), the library's path, and nvcc's stderr (``-Xptxas -v`` prints
    each kernel's registers and shared memory there)."""
    return dict(_log)
