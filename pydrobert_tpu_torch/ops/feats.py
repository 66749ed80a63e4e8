"""Feature transforms: normalization, deltas, slicing policies and token
chunking (counterpart of :mod:`pydrobert_tpu.ops.feats`).

:func:`feat_deltas` applies its filter bank as a sum of shifted slices of
the padded features, each weighted by one filter tap, in float32. The JAX
package runs the same filters as a convolution at ``Precision.HIGHEST``;
cuDNN's convolutions round float32 inputs to TF32 on Hopper unless the
caller turns that off globally, so the port takes no convolution, and its
deltas are true float32 on the card whatever the global flags say.

:func:`slice_spect_data` makes a data-dependent number of slices, so it is
a host op on numpy, as in the JAX package; its results come back as CPU
tensors.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from .. import config

__all__ = [
    "chunk_token_sequences_by_slices",
    "feat_delta_filters",
    "feat_deltas",
    "mean_var_norm",
    "slice_spect_data",
]


def mean_var_norm(
    x: torch.Tensor,
    dim: int = -1,
    mean: Optional[torch.Tensor] = None,
    std: Optional[torch.Tensor] = None,
    eps: float = config.TINY,
) -> torch.Tensor:
    """Normalize dimension ``dim`` of ``x`` by a given or the sample mean
    and (biased) standard deviation, the latter at least ``eps``."""
    D = x.dim()
    if dim < -D or dim > D - 1:
        raise IndexError(
            f"Dimension out of range (expected to be in the range of "
            f"[{-D},{D - 1}], got {dim})"
        )
    dim = (dim + D) % D
    dtype = x.dtype
    axes = tuple(a for a in range(D) if a != dim)
    shape = [1] * D
    shape[dim] = x.shape[dim]
    if mean is None:
        mean = x.mean(axes)
    x = x - torch.as_tensor(mean, device=x.device).to(dtype).reshape(shape)
    if std is None:
        std = torch.sqrt((x.float() ** 2).mean(axes))
    std = torch.clamp(torch.as_tensor(std, device=x.device).to(dtype).reshape(shape), min=eps)
    return (x / std).to(dtype)


def feat_delta_filters(order: int, width: int) -> np.ndarray:
    """The ``(order + 1, 1 + 2 * width * order)`` float32 delta filter
    bank: filter ``k`` is the regression kernel applied ``k`` times."""
    if order < 0:
        raise RuntimeError(f"order must be non-negative, got {order}")
    if width < 1:
        raise RuntimeError(f"width must be positive, got {width}")
    span = 1 + (2 * width) * order
    last = np.zeros(span, np.float32)
    last[width * order] = 1
    filts = [last]
    if order == 0:
        return np.stack(filts)
    kernel = np.arange(width, -width - 1, -1, dtype=np.float32)
    kernel /= np.square(kernel).sum()
    for _ in range(order):
        # 'same' correlation with the regression kernel
        last = np.convolve(last, kernel[::-1], mode="same")
        filts.append(last.astype(np.float32))
    return np.stack(filts)


def feat_deltas(
    x: torch.Tensor,
    dim: int = -1,
    time_dim: int = -2,
    concatenate: bool = True,
    order: int = 2,
    width: int = 2,
    pad_mode: str = "replicate",
    value: float = config.DEFT_PAD_VALUE,
) -> torch.Tensor:
    """Features and their deltas up to ``order`` along ``time_dim``, the
    edges padded by ``pad_mode`` (``"replicate"``, ``"constant"`` with
    ``value``, ``"reflect"`` or ``"circular"``). The orders lie along
    ``dim`` of a new axis or, with ``concatenate``, order-major within
    ``dim``."""
    D = x.dim()
    if time_dim < -D or time_dim >= D:
        raise RuntimeError(
            f"Expected dimension 'time_dim' to be in [{-D}, {D-1}], got "
            f"{time_dim}"
        )
    D_out = D if concatenate else D + 1
    if dim < -D_out or dim >= D_out:
        raise RuntimeError(
            f"Expected dimension 'dim' to be in [{-D_out}, {D_out-1}], got {dim}"
        )
    if pad_mode not in ("replicate", "constant", "reflect", "circular"):
        raise ValueError(f"unknown pad_mode '{pad_mode}'")
    filters = feat_delta_filters(order, width)
    time_dim = (time_dim + D) % D
    dim = (dim + D_out) % D_out
    dtype = x.dtype
    x = x.transpose(time_dim, -1)
    shape = x.shape
    T = shape[-1]
    flat = x.reshape(-1, T).to(torch.promote_types(dtype, torch.float32))
    p = width * order
    if p and T:
        # numpy's padding by index, as jnp.pad takes it (a reflection may
        # fold more than once)
        i = np.arange(-p, T + p)
        if pad_mode == "replicate":
            src = np.clip(i, 0, T - 1)
        elif pad_mode == "circular":
            src = i % T
        elif pad_mode == "reflect":
            period = max(2 * (T - 1), 1)
            src = i % period
            src = np.where(src < T, src, period - src)
        else:
            src = np.clip(i, 0, T - 1)
        flat = flat[:, torch.from_numpy(src).to(flat.device)]
        if pad_mode == "constant":
            flat[:, :p] = float(value)
            flat[:, T + p:] = float(value)
    outs = []
    for taps in filters:  # a correlation: tap j reads frame t + j
        # each tap rounded to the input's dtype, as the JAX package casts
        # its filters; the products and sums stay in float32
        if dtype.is_floating_point:
            taps = torch.tensor(taps).to(dtype).tolist()
        acc = flat[:, :T] * float(taps[0])
        for j in range(1, len(taps)):
            acc = acc + flat[:, j:j + T] * float(taps[j])
        outs.append(acc)
    out = torch.stack(outs, -1).to(dtype)  # (B, T, order + 1)
    out = out.reshape(shape + (order + 1,))  # (..., T, order + 1)
    out = out.transpose(time_dim, -2)  # the time axis back in place
    out = out.movedim(-1, dim)
    if concatenate:
        out = out.reshape(out.shape[:dim] + (-1,) + out.shape[dim + 2:])
    return out


def _host(x) -> Optional[np.ndarray]:
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def slice_spect_data(
    input: torch.Tensor,
    in_lens: Optional[torch.Tensor] = None,
    other_lens: Optional[torch.Tensor] = None,
    policy: str = "fixed",
    window_type: str = "symmetric",
    valid_only: bool = True,
    lobe_size: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slices of feature chunks under the ``"fixed"``, ``"ali"`` or
    ``"ref"`` policy: ``slices (M, 2)`` and ``sources (M,)``, int64 CPU
    tensors. A host op (numpy), since ``M`` depends on the data."""
    input = _host(input)
    if input.ndim < 2:
        raise RuntimeError(
            f"Expected input to be at least 2-dimensional; got {input.ndim}"
        )
    N, T = input.shape[:2]
    if not T:
        return _as_out(np.empty((0, 2), np.int64), np.empty((0,), np.int64))
    if lobe_size < 0:
        raise RuntimeError(f"Expected non-negative lobe_size, got {lobe_size}")
    if window_type not in ("symmetric", "causal", "future"):
        raise RuntimeError(
            "expected window_type to be one of 'symmetric', 'causal', or "
            f"'future', got '{window_type}'"
        )
    in_lens = _host(in_lens)
    if policy == "fixed":
        shift = lobe_size + 1
        if valid_only and window_type == "symmetric":
            window_size = 2 * lobe_size + 1
            starts = np.arange(0, max(T - window_size + 1, 0), shift)
            ends = starts + window_size
            mids = ends - 1
        elif window_type == "symmetric":
            window_size = 2 * lobe_size + 1
            half_shift = shift // 2
            TT = (T + half_shift) // shift
            mids = np.arange(TT) * shift + half_shift
            starts = mids - window_size // 2
            ends = starts + window_size
        elif valid_only:
            starts = np.arange(0, max(T - lobe_size, 0), shift)
            ends = starts + shift
            mids = ends - 1
        elif window_type == "causal":
            starts = np.arange(-lobe_size, T - lobe_size, shift)
            ends = starts + shift
            mids = ends - 1
        else:  # future
            starts = mids = np.arange(0, T, shift)
            ends = starts + shift
        TT = len(starts)
        slices = np.stack(
            [np.tile(starts, N), np.tile(ends, N)], 1
        ).reshape(N * TT, 2)
        sources = np.repeat(np.arange(N), TT)
        if in_lens is not None:
            if in_lens.shape != (N,):
                raise RuntimeError(
                    f"Expected in_lens to be of shape ({N},); got {in_lens.shape}"
                )
            mask = (in_lens[:, None] > mids[None]).flatten()
            slices, sources = slices[mask], sources[mask]
    elif policy == "ali":
        if input.ndim != 2:
            raise RuntimeError("expected tensor of dimension 2 with policy 'ali'")
        change = input[:, :-1] != input[:, 1:]
        arange = np.arange(T)
        if in_lens is not None:
            if in_lens.shape != (N,):
                raise RuntimeError(
                    f"Expected in_lens to be of shape ({N},); got {in_lens.shape}"
                )
            change = change & (in_lens[:, None] > arange[None, 1:])
        else:
            in_lens = np.full((N,), T)
        nonempty = (in_lens > 0)[:, None]
        start_mask = np.concatenate([nonempty, change], 1)
        starts_nz = np.argwhere(start_mask)
        # end markers live on a width-(T+1) grid so a segment may end at T
        end_mask = np.concatenate(
            [np.zeros_like(nonempty), change, np.zeros_like(nonempty)], 1
        )
        end_mask[nonempty[:, 0], in_lens[nonempty[:, 0]]] = True
        ends_nz = np.argwhere(end_mask)
        sources = starts_nz[:, 0]
        starts, ends = starts_nz[:, 1], ends_nz[:, 1]
        if lobe_size:
            NN = len(starts)
            do_left = window_type in ("symmetric", "causal")
            do_right = window_type in ("symmetric", "future")
            if valid_only:
                offs = (int(do_left) + int(do_right)) * lobe_size
                is_same = sources[: NN - offs] == sources[offs:] if NN - offs > 0 else np.zeros(0, bool)
                starts = starts[: NN - offs][is_same]
                ends = ends[offs:][is_same]
                sources = sources[: NN - offs][is_same]
            else:
                start_idx = np.arange(NN)
                end_idx = np.arange(NN)
                for n in range(1, lobe_size + 1):
                    offs = (sources[n:] == sources[: NN - n]).astype(np.int64)
                    if do_left:
                        start_idx[n:] -= offs
                    if do_right:
                        end_idx[: NN - n] += offs
                starts = starts[start_idx]
                ends = ends[end_idx]
        slices = np.stack([starts, ends], 1)
    elif policy == "ref":
        if input.ndim != 3:
            raise RuntimeError(
                f"Expected input to be 3-dimensional, got {input.ndim}"
            )
        if input.shape[2] != 3:
            raise RuntimeError(
                f"Expected 3rd dimension of input to be of size 3, got "
                f"{input.shape[2]}"
            )
        starts = input[..., 1].copy()
        ends = input[..., 2].copy()
        if in_lens is None:
            in_lens = np.full((N,), T)
        if other_lens is None:
            # default: the final valid segment's end time
            idx = np.clip(in_lens - 1, 0, None)
            other_lens = np.where(
                in_lens == 0, 0, ends[np.arange(N), idx]
            )
        else:
            other_lens = _host(other_lens)
            if other_lens.shape != (N,):
                raise RuntimeError(
                    f"Expected other_lens to have shape ({N},); got "
                    f"{other_lens.shape}"
                )
        mask = in_lens[:, None] > np.arange(T)[None]
        mask = mask & (input[..., 1:] >= 0).all(2)
        if window_type in ("symmetric", "causal"):
            starts = starts - lobe_size
        if window_type in ("symmetric", "future"):
            ends = ends + lobe_size
        if valid_only:
            mask = mask & (starts >= 0) & (ends <= other_lens[:, None])
        else:
            mask = mask & (ends > 0) & (starts < other_lens[:, None])
        mask = mask & (starts < ends)
        mask = mask.flatten()
        sources = np.repeat(np.arange(N), T)[mask]
        slices = np.stack([starts.flatten()[mask], ends.flatten()[mask]], 1)
    else:
        raise RuntimeError(
            f"Expected policy to be one of 'fixed', 'ali', or 'ref'; got "
            f"'{policy}'"
        )
    return _as_out(slices, sources)


def _as_out(slices: np.ndarray, sources: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.from_numpy(np.ascontiguousarray(slices, np.int64)),
        torch.from_numpy(np.ascontiguousarray(sources, np.int64)),
    )


def chunk_token_sequences_by_slices(
    refs: torch.Tensor,
    slices: torch.Tensor,
    ref_lens: Optional[torch.Tensor] = None,
    partial: bool = False,
    retain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the token segments ``refs (N, R, 3)`` (token, start, end) that
    lie within (``partial``: overlap) each sequence's slice ``slices (N,
    2)``, left-packed, with their counts ``(N,)`` int32. Unless ``retain``,
    kept boundaries are shifted by the slice start, added as the JAX
    package (and its reference) adds it; positions past the count are
    zero."""
    if refs.dim() == 2:
        return (
            refs.new_empty((0, refs.shape[1])),
            torch.empty((0,), dtype=torch.int32, device=refs.device),
        )
    if refs.dim() != 3 or refs.shape[2] != 3:
        raise RuntimeError(
            "Expected refs to be 2-dimensional or 3-dimensional with final "
            f"dimension size 3. Got shape '{tuple(refs.shape)}'"
        )
    N, R = refs.shape[:2]
    slices = torch.as_tensor(slices, device=refs.device)
    if slices.shape != (N, 2):
        raise RuntimeError(
            f"Expected slices to be a tensor of shape ({N}, 2), got "
            f"{tuple(slices.shape)}"
        )
    if ref_lens is None:
        ref_lens = torch.full((N,), R, dtype=torch.int32, device=refs.device)
    else:
        ref_lens = torch.as_tensor(ref_lens, device=refs.device)
        if ref_lens.shape != (N,):
            raise RuntimeError(
                f"Expected ref_lens to be a tensor of shape ({N},), got "
                f"{tuple(ref_lens.shape)}"
            )
    arange = torch.arange(R, device=refs.device)
    mask = ref_lens[:, None] > arange[None]
    mask = mask & (refs[..., 1:] >= 0).all(2) & (refs[..., 2] >= refs[..., 1])
    if partial:
        mask = mask & (slices[..., :1] < refs[..., 2]) & (slices[..., 1:] > refs[..., 1])
    else:
        mask = mask & (slices[..., :1] <= refs[..., 1]) & (slices[..., 1:] >= refs[..., 2])
    chunked_lens = mask.sum(1, dtype=torch.int32)
    order = torch.sort((~mask).to(torch.uint8), dim=1, stable=True).indices
    chunked = torch.gather(refs, 1, order[..., None].expand(N, R, 3))
    valid = (chunked_lens[:, None] > arange[None])[..., None]
    chunked = torch.where(valid, chunked, 0)
    if not retain:
        s0 = slices[..., :1].to(refs.dtype)
        shift = torch.cat([torch.zeros_like(s0), s0, s0], 1)
        chunked = torch.where(valid, chunked + shift[:, None, :], chunked)
    return chunked, chunked_lens
