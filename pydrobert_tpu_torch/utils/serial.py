"""Tensor-file I/O (counterpart of :mod:`pydrobert_tpu.utils.serial`).

A SpectDataSet directory holds one ``torch.save`` file per utterance, and
so do the JAX package's: files written by either package load in the
other. :func:`save_tensor` writes a fresh contiguous copy, so a file holds
its own data and nothing else of a larger storage (``torch.save`` of a
view writes the whole storage it views, which a byte-range reader cannot
take). :func:`tensor_entry` reads only a file's header, to find the byte
range of its payload.
"""

import os
import pickle
import zipfile
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["load_tensor", "save_tensor", "tensor_entry", "TensorEntry"]

_STORAGE_TO_DTYPE = {
    "FloatStorage": np.dtype("<f4"),
    "DoubleStorage": np.dtype("<f8"),
    "HalfStorage": np.dtype("<f2"),
    "LongStorage": np.dtype("<i8"),
    "IntStorage": np.dtype("<i4"),
    "ShortStorage": np.dtype("<i2"),
    "CharStorage": np.dtype("i1"),
    "ByteStorage": np.dtype("u1"),
    "BoolStorage": np.dtype("?"),
}


def load_tensor(path, allow_object: bool = False) -> torch.Tensor:
    """Load a ``.pt`` file as a CPU tensor (``torch.load`` with
    ``weights_only`` unless ``allow_object``)."""
    return torch.load(path, map_location="cpu", weights_only=not allow_object)


def save_tensor(tensor, path) -> None:
    """Save a tensor (or anything ``torch.as_tensor`` takes) as a ``.pt``
    file, making its directory. The file holds a detached, contiguous CPU
    copy of just the tensor's elements."""
    if not isinstance(tensor, torch.Tensor):
        tensor = torch.as_tensor(np.asarray(tensor))
    d = os.path.dirname(str(path))
    if d:
        os.makedirs(d, exist_ok=True)
    torch.save(tensor.detach().cpu().contiguous().clone(), str(path))


class TensorEntry(NamedTuple):
    """Where a ``.pt`` file's tensor payload lives, for direct byte reads.

    ``payload_offset`` is the absolute byte offset of the C-contiguous,
    little-endian data within the file; ``nbytes`` bytes from there fill an
    ``np.empty(shape, dtype)`` buffer with exactly what :func:`load_tensor`
    returns. Produced by :func:`tensor_entry`.
    """

    payload_offset: int
    dtype: np.dtype
    shape: Tuple[int, ...]

    @property
    def nbytes(self) -> int:
        n = self.dtype.itemsize
        for s in self.shape:
            n *= s
        return n


class _StorageStub:
    def __init__(self, name: str):
        self.name = name


class _TensorDesc:
    def __init__(self, dtype, key, numel):
        self.dtype, self.key, self.numel = dtype, key, numel


class _HeaderUnpickler(pickle.Unpickler):
    """Unpickles a torch ``data.pkl`` without reading storage payloads."""

    def find_class(self, module, name):
        if name == "_rebuild_tensor_v2":
            return _header_rebuild
        if name.endswith("Storage"):
            return _StorageStub(name)
        if module == "collections":
            import collections

            return getattr(collections, name)
        raise pickle.UnpicklingError(f"header reader cannot resolve {module}.{name}")

    def persistent_load(self, pid):
        typename, storage_type, key, _location, numel = pid[:5]
        if typename != "storage":
            raise pickle.UnpicklingError(f"unexpected persistent id {typename!r}")
        if isinstance(storage_type, _StorageStub):
            dtype = _STORAGE_TO_DTYPE[storage_type.name]
        else:
            dtype = _STORAGE_TO_DTYPE[str(storage_type).split(".")[-1]]
        return _TensorDesc(dtype, key, numel)


def _header_rebuild(storage, offset, size, stride, *args):
    if not isinstance(storage, _TensorDesc):
        raise pickle.UnpicklingError("unexpected storage object")
    # only C-contiguous, zero-offset views are direct byte reads (empty
    # tensors read zero bytes, so any stride qualifies)
    expect, acc = [], 1
    for s in reversed(tuple(size)):
        expect.append(acc)
        acc *= s
    contiguous = (tuple(stride) == tuple(reversed(expect)) or acc == 0) and offset == 0
    return (storage, tuple(size), contiguous)


def tensor_entry(path_or_fileobj) -> Optional[TensorEntry]:
    """Header-only parse of a single-tensor ``.pt`` zip file.

    Takes a path or a seekable binary file object; offsets are relative to
    the object's byte 0. Returns where the raw payload lives
    (:class:`TensorEntry`), or ``None`` when the file cannot be read as one
    contiguous byte range (legacy format, compressed entries, strided or
    offset views, pickles of other objects): read those with
    :func:`load_tensor`.
    """
    try:
        if isinstance(path_or_fileobj, (str, os.PathLike)):
            with open(path_or_fileobj, "rb") as raw:
                return tensor_entry(raw)
        raw = path_or_fileobj
        with zipfile.ZipFile(raw) as zf:
            pkl = next((n for n in zf.namelist() if n.endswith("/data.pkl")), None)
            if pkl is None:
                return None
            prefix = pkl[: -len("/data.pkl")]
            with zf.open(pkl) as f:
                obj = _HeaderUnpickler(f).load()
            if not (isinstance(obj, tuple) and len(obj) == 3):
                return None
            desc, shape, contiguous = obj
            if not (isinstance(desc, _TensorDesc) and contiguous):
                return None
            numel = 1
            for s in shape:
                numel *= s
            if numel > desc.numel:
                return None
            info = zf.getinfo(f"{prefix}/data/{desc.key}")
            if info.compress_type != zipfile.ZIP_STORED:
                return None
        # the local header's name and extra lengths may differ from the
        # central directory's: read them to find where the payload starts
        raw.seek(info.header_offset)
        hdr = raw.read(30)
        if len(hdr) != 30 or hdr[:4] != b"PK\x03\x04":
            return None
        name_len = int.from_bytes(hdr[26:28], "little")
        extra_len = int.from_bytes(hdr[28:30], "little")
        return TensorEntry(
            info.header_offset + 30 + name_len + extra_len, desc.dtype, tuple(shape)
        )
    except Exception:
        return None
