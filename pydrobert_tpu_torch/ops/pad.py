"""Padding and chunking (counterpart of :mod:`pydrobert_tpu.ops.pad`).

As in the JAX package, every output position computes its source index
and one batched gather makes the result: reflect and replicate padding are
index arithmetic (``g < 0 -> -g``; ``g >= len -> 2*len - 2 - g``;
clamping). Output lengths follow the JAX package's rules: an ``out_len``
given, or else the largest padded length, read from the inputs (a host
sync on a card).
"""

from typing import Optional, Tuple

import torch

from .. import config

__all__ = [
    "chunk_by_slices",
    "pad_masked_sequence",
    "pad_variable",
]

_PAD_MODES = ("constant", "reflect", "replicate")


def _map_index(g: torch.Tensor, lens: torch.Tensor, mode: str) -> torch.Tensor:
    """Map a (possibly out-of-range) gather index into ``[0, lens)``."""
    if mode == "reflect":
        src = torch.where(g < 0, -g, g)
        src = torch.where(src >= lens, 2 * lens - 2 - src, src)
    elif mode == "replicate":
        src = torch.minimum(torch.clamp(g, min=0), lens - 1)
    else:
        src = g
    return torch.clamp(src, min=0)


def _gather_time(x: torch.Tensor, src: torch.Tensor, valid: torch.Tensor, value) -> torch.Tensor:
    """``x (N, T, ...)`` at time indices ``src (N, T')`` where ``valid``,
    ``value`` elsewhere: ``(N, T', ...)``."""
    N, T = x.shape[:2]
    rest = x.shape[2:]
    x2 = x.reshape(N, T, -1)
    src = torch.clamp(src, 0, max(T - 1, 0)).long()
    gathered = torch.gather(x2, 1, src[..., None].expand(-1, -1, x2.shape[2]))
    fill = torch.tensor(value, device=x.device).to(x.dtype)
    out = torch.where(valid[..., None], gathered, fill)
    return out.reshape((N, src.shape[1]) + rest)


def pad_variable(
    x: torch.Tensor,
    lens: torch.Tensor,
    pad: torch.Tensor,
    mode: str = "constant",
    value: float = config.DEFT_PAD_VALUE,
    out_len: Optional[int] = None,
) -> torch.Tensor:
    """Pad variable-length sequences by variable amounts on each side.

    ``padded[n]`` is ``pad[0, n]`` padding values, then ``x[n, :lens[n]]``,
    then ``pad[1, n]`` padding values, right-filled with ``value`` up to
    ``out_len`` (default: the largest padded length). ``mode`` is
    ``"constant"`` (``value``), ``"reflect"`` or ``"replicate"``.
    """
    if x.dim() < 2:
        raise ValueError("Expected x to be at least two dimensional")
    N, T = x.shape[:2]
    lens = torch.as_tensor(lens, device=x.device)
    pad = torch.as_tensor(pad, device=x.device)
    if lens.shape != (N,):
        raise ValueError(
            f"For x of shape {x.shape}, lens should have shape ({N},) but got"
            f"{lens.shape}"
        )
    if pad.shape != (2, N):
        raise ValueError(
            f"For x of shape {x.shape}, pad should have shape (2, {N}), but "
            f"got {pad.shape}"
        )
    if mode not in _PAD_MODES:
        raise ValueError(
            f"mode must be one of 'constant', 'reflect', 'replicate', got "
            f"'{mode}'"
        )
    if mode == "reflect" and bool((pad >= lens[None]).any()):
        raise NotImplementedError(
            "For reflect padding, all padding lengths must be less than "
            "the sequence length"
        )
    if mode == "replicate" and bool((lens < 1).any()):
        raise RuntimeError("For replicate padding, all lens must be > 0")
    if out_len is None:
        out_len = int((lens + pad.sum(0)).max()) if N else 0
    lens = lens.to(torch.int32)[:, None]
    left, right = pad[0].to(torch.int32)[:, None], pad[1].to(torch.int32)[:, None]
    t = torch.arange(int(out_len), dtype=torch.int32, device=x.device)[None]
    g = t - left  # the source index into the sequence
    in_seq = t < lens + left + right
    if mode == "constant":
        valid = in_seq & (g >= 0) & (g < lens)
    else:
        valid = in_seq
    return _gather_time(x, _map_index(g, lens, mode), valid, float(value))


def pad_masked_sequence(
    x: torch.Tensor,
    mask: torch.Tensor,
    batch_first: bool = False,
    padding_value: float = config.DEFT_PAD_VALUE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left-pack the elements of ``x`` that ``mask`` selects, in order,
    into right-padded sequences of the same shape; also returns their
    counts ``(N,)`` int32. ``x`` is ``(T, N, ...)`` and ``mask (T, N)``
    (``(N, T, ...)`` and ``(N, T)`` with ``batch_first``)."""
    if x.dim() < 2:
        raise RuntimeError(
            f"expected x to be at least two-dimensional, got {x.dim()}"
        )
    if mask.dim() != 2:
        raise RuntimeError(f"expected mask to be two-dimensional, got {mask.dim()}")
    if not batch_first:
        x, mask = x.transpose(0, 1), mask.transpose(0, 1)
    mask = mask.to(x.device, torch.bool)
    N, T = mask.shape
    lens = mask.sum(1, dtype=torch.int32)
    # a stable sort that puts the selected elements first, in order
    order = torch.sort((~mask).to(torch.uint8), dim=1, stable=True).indices
    valid = torch.arange(T, device=x.device)[None] < lens[:, None]
    out = _gather_time(x, order, valid, float(padding_value))
    if not batch_first:
        out = out.transpose(0, 1)
    return out, lens


def chunk_by_slices(
    x: torch.Tensor,
    slices: torch.Tensor,
    lens: Optional[torch.Tensor] = None,
    mode: str = "constant",
    value: float = config.DEFT_PAD_VALUE,
    out_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sequence slices ``x[n, slices[n, 0]:slices[n, 1]]`` of ``x (N,
    T, ...)``, padded by ``mode`` where a slice leaves ``[0, lens[n])``,
    with their lengths ``(N,)`` int32.

    A negative start indexes padding left of the sequence (not Python's
    wraparound). The output has ``out_len`` frames, by default the largest
    of the slices' lengths and their left and right overhangs.
    """
    if x.dim() < 2:
        raise RuntimeError(f"Expected x to be at least 2-dimensional; got {x.dim()}")
    N, T = x.shape[:2]
    slices = torch.as_tensor(slices, device=x.device)
    if N * T == 0:
        return torch.empty_like(x), torch.zeros((N,), dtype=torch.int32, device=x.device)
    if lens is None:
        lens = torch.full((N,), T, dtype=torch.int32, device=x.device)
    else:
        lens = torch.as_tensor(lens, device=x.device)
        if lens.shape != (N,):
            raise RuntimeError(
                f"Expected lens to be of shape ({N},); got {lens.shape}"
            )
    if mode not in _PAD_MODES:
        raise ValueError(
            f"mode must be one of 'constant', 'reflect', 'replicate', got "
            f"'{mode}'"
        )
    start = slices[..., 0].to(torch.int32)
    end = slices[..., 1].to(torch.int32)
    lens = lens.to(torch.int32)
    chunk_lens = torch.clamp(end - start, min=0)
    if mode == "reflect":
        # reflection is single-fold: an overhang of at least the sequence's
        # length has no image
        over = (chunk_lens > 0) & (
            (torch.clamp(-start, min=0) >= lens) | (torch.clamp(end - lens, min=0) >= lens)
        )
        if bool(over.any()):
            raise NotImplementedError(
                "For reflect padding, all padding lengths must be less than "
                "the sequence length"
            )
    if out_len is None:
        empty = chunk_lens == 0
        left_pad = torch.where(empty, 0, torch.clamp(-start, min=0))
        right_pad = torch.where(empty, 0, torch.clamp(end - lens, min=0))
        out_len = int(torch.stack([left_pad, chunk_lens, right_pad]).max())
    t = torch.arange(int(out_len), dtype=torch.int32, device=x.device)[None]
    g = start[:, None] + t
    in_chunk = t < chunk_lens[:, None]
    if mode == "constant":
        valid = in_chunk & (g >= 0) & (g < lens[:, None])
    else:
        valid = in_chunk
    out = _gather_time(x, _map_index(g, lens[:, None], mode), valid, float(value))
    return out, chunk_lens
