"""Utilities (counterpart of :mod:`pydrobert_tpu.utils`): state helpers
and tensor-file I/O."""

from .pytree import (  # noqa: F401
    broadcast_shapes,
    extract_by_src,
    lengths_to_mask,
    mix_by_mask,
)
from .serial import load_tensor, save_tensor  # noqa: F401

__all__ = [
    "broadcast_shapes",
    "extract_by_src",
    "lengths_to_mask",
    "load_tensor",
    "mix_by_mask",
    "save_tensor",
]
