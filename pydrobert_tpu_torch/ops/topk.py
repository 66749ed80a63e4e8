"""Exact top-k with ``jax.lax.top_k``'s semantics (counterpart of
:mod:`pydrobert_tpu.ops.topk`).

``jax.lax.top_k`` is the semantic reference: values descending in the IEEE
total order (``+0.0`` above ``-0.0``), equal values lowest index first.
``torch.topk`` promises no tie order, so :func:`exact_top_k` sorts stably
on integer total-order keys instead.
"""

from typing import Tuple

import torch

__all__ = ["exact_top_k", "hoisted_top_k", "total_order_key"]

_FLIP = {torch.int32: 0x7FFFFFFF, torch.int64: 0x7FFFFFFFFFFFFFFF}


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """Signed-integer key of a float32 (int32) or float64 (int64) tensor
    that orders like the IEEE total order: a bigger key is a bigger float,
    ``-0.0`` sits below ``+0.0``. The map is its own inverse on the bits."""
    return _flip(x.view(torch.int32 if x.dtype == torch.float32 else torch.int64))


def _flip(i: torch.Tensor) -> torch.Tensor:
    return torch.where(i >= 0, i, i ^ _FLIP[i.dtype])


def exact_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exactly ``jax.lax.top_k(x, k)`` over the trailing axis.

    Returns ``(values, indices)``: values in ``x``'s dtype, descending in
    the IEEE total order; equal values lowest index first; indices int64.
    float16 and bfloat16 rank through an exact float32 upcast.
    """
    if not x.is_floating_point():
        raise TypeError(f"exact_top_k takes a floating tensor, got {x.dtype}")
    if not 0 <= k <= x.shape[-1]:
        raise ValueError(f"k must be in [0, {x.shape[-1]}], got {k}")
    wide = x if x.dtype in (torch.float32, torch.float64) else x.float()
    key = total_order_key(wide.contiguous())
    # ascending stable sort of ~key == descending key, ties in index order
    skey, idx = torch.sort(~key, dim=-1, stable=True)
    top = ~skey[..., :k]
    return _flip(top).view(wide.dtype).to(x.dtype), idx[..., :k]


def hoisted_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`exact_top_k` for the hoisted whole-``(T, N, V)`` calls of the
    decode prologues: float32 values, int32 indices, through
    :func:`pydrobert_tpu_torch.ops.kernels.top_m`. A CUDA tensor takes the
    Hopper kernel and a CPU tensor its plain version; either raises for a
    dtype (float32 and bfloat16 only) or ``k`` the kernel cannot take."""
    from .kernels import top_m

    return top_m(x, k)
