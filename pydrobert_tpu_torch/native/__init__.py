"""Native (C++) host-runtime components (counterpart of
:mod:`pydrobert_tpu.native`).

A threaded batch reader (:func:`read_batch`) fills CPU buffers straight
from ``.pt`` containers via ``pread`` with the GIL released (``io.cpp``,
this package's own copy). The loaders read each batch's files in one such
pass when the dataset offers ``native_batch_fetch``.

The shared library is built with ``g++`` on first use into
``pydrobert_tpu_torch/_build/``, named by a hash of the source, so an
edited source rebuilds and an unchanged one loads the existing file. It is
built to a temporary name and moved into place, so processes that race on
the first build each load a whole library. When the toolchain or the build
is missing, :func:`available` is False and callers read item by item.
``PYDROBERT_TPU_NATIVE_IO=0`` turns the reader off.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["available", "read_batch", "native_threads"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "io.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
_lock = threading.Lock()
_lib = None
_tried = False


class _PdtTask(ctypes.Structure):
    _fields_ = [
        ("path", ctypes.c_char_p),
        ("offset", ctypes.c_int64),
        ("nbytes", ctypes.c_int64),
        ("dst", ctypes.c_void_p),
    ]


def _build() -> Optional[str]:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(" ".join(_FLAGS).encode() + f.read()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so_path = os.path.join(_BUILD_DIR, f"pdt_io_{digest}.so")
    if os.path.exists(so_path):
        return so_path
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", *_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True, timeout=120
        )
        os.replace(tmp, so_path)
        return so_path
    except (OSError, subprocess.SubprocessError):  # no g++, a failed or timed-out build
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("PYDROBERT_TPU_NATIVE_IO", "1") == "0":
            return None
        so_path = _build()
        if so_path is None:
            return None
        try:
            lib = ctypes.CDLL(so_path)
            lib.pdt_read_batch.restype = ctypes.c_int64
            lib.pdt_read_batch.argtypes = [
                ctypes.POINTER(_PdtTask),
                ctypes.c_int64,
                ctypes.c_int32,
            ]
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    """True when the native reader built (or was built before) and loaded.

    The environment switch is read on every call, so
    ``PYDROBERT_TPU_NATIVE_IO=0`` takes effect after import too.
    """
    if os.environ.get("PYDROBERT_TPU_NATIVE_IO", "1") == "0":
        return False
    return _load() is not None


def native_threads() -> int:
    """Worker threads for batch reads (``PYDROBERT_TPU_NATIVE_IO_THREADS``,
    else the CPU count, at most 16)."""
    env = os.environ.get("PYDROBERT_TPU_NATIVE_IO_THREADS")
    if env:
        return max(1, int(env))
    return max(1, min(16, os.cpu_count() or 1))


def _buffer(out) -> Tuple[int, int]:
    """The address and byte size of a C-contiguous, writable CPU buffer."""
    if isinstance(out, torch.Tensor):
        if out.device.type != "cpu" or not out.is_contiguous():
            raise ValueError("output tensors must be contiguous CPU tensors")
        return out.data_ptr(), out.numel() * out.element_size()
    if not (out.flags["C_CONTIGUOUS"] and out.flags["WRITEABLE"]):
        raise ValueError("output arrays must be C-contiguous writable")
    return out.ctypes.data, out.nbytes


def read_batch(
    tasks: Sequence[Tuple[str, int, Union[np.ndarray, torch.Tensor]]],
    nthreads: Optional[int] = None,
) -> None:
    """Fill each task's buffer with bytes from its file, in parallel.

    `tasks` are ``(path, byte_offset, out)`` triples; ``out`` is a
    C-contiguous writable numpy array or a contiguous CPU tensor, and its
    whole size in bytes is read. Raises ``OSError`` naming the first
    failing file. Requires :func:`available`.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    n = len(tasks)
    if n == 0:
        return
    arr = (_PdtTask * n)()
    keep: List[bytes] = []
    for i, (path, offset, out) in enumerate(tasks):
        ptr, nbytes = _buffer(out)
        b = os.fsencode(path)
        keep.append(b)
        arr[i].path = b
        arr[i].offset = offset
        arr[i].nbytes = nbytes
        arr[i].dst = ptr
    rc = lib.pdt_read_batch(arr, n, nthreads or native_threads())
    if rc != 0:
        bad = tasks[int(rc) - 1][0]
        raise OSError(f"native batch read failed on {bad!r}")
