"""SpecAugment and the warps under it (counterpart of the SpecAugment subset
of :mod:`pydrobert_tpu.ops.img`).

Ported: the polyharmonic spline, ``warp_1d_grid``, the separable per-axis
warp, and SpecAugment's draw, apply and whole. The apply takes the JAX
package's routing: with no frequency warp (the park2020 default) the time
warp and both masks are one pass of the ``spec_augment_apply`` kernel
(:mod:`pydrobert_tpu_torch.ops.kernels`); with a frequency warp the JAX
package itself runs its separable XLA warp, and so does the port.

Masks write ``+0.0``, as the JAX package's XLA path does (``jnp.where``),
not the ``-0.0`` or NaN that its TPU kernel's multiply by ``keep`` would
leave for a masked ``-x``, ``inf`` or NaN.

Randomness comes from a :class:`torch.Generator` on the features' device;
its numbers differ from ``jax.random``'s, so the two are compared by the
distribution of the draw and by applying the same drawn parameters. The
spline's solves use ``torch.linalg.solve_ex``, which does not synchronize
with the host, so a training step stays free of host syncs here.

:func:`grid_sample` is the JAX package's gather form of torch's
``grid_sample`` (``align_corners=False``): the same coordinate arithmetic
op for op, so that ``nearest`` rounds half-pixel coordinates as the JAX
package does. :func:`dense_image_warp` and :func:`sparse_image_warp` are
built on it and on the spline. :func:`random_shift` draws its pads from a
:class:`torch.Generator`; :func:`random_shift_pads` turns given uniforms
into pads and :func:`random_shift_apply` pads by given amounts through
:func:`~pydrobert_tpu_torch.ops.pad.pad_variable`.
"""

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import default_device
from . import kernels
from .pad import pad_variable

__all__ = [
    "dense_image_warp",
    "grid_sample",
    "polyharmonic_spline",
    "random_shift",
    "random_shift_apply",
    "random_shift_pads",
    "sparse_image_warp",
    "spec_augment",
    "spec_augment_apply_parameters",
    "spec_augment_draw_parameters",
    "warp_1d_grid",
]

_F32_EPS = float(np.finfo(np.float32).eps)


def _phi(s: torch.Tensor, k: int) -> torch.Tensor:
    """Order-k polyharmonic radial basis of the squared distances ``s``."""
    r = torch.sqrt(s)
    if k % 2:
        return r**k
    return s ** (k // 2) * torch.log(torch.clamp(r, min=_F32_EPS))


def _basis(a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    """The order-k basis at the pairwise distances of ``a (N, P, I)`` and
    ``b (N, Q, I)``: ``(N, P, Q)`` float32, evaluated in float64 and
    rounded once. The spline's weights are ill-conditioned and amplify the
    basis' rounding: evaluated in float32 (XLA simplifies the JAX
    package's compiled basis in ways eager PyTorch does not), the port's
    sparse warps lay farther than the JAX package's from a float64
    solve."""
    diff = a.double()[:, :, None, :] - b.double()[:, None, :, :]
    return _phi((diff * diff).sum(-1), k).float()


def polyharmonic_spline(
    train_points: torch.Tensor,
    train_values: torch.Tensor,
    query_points: torch.Tensor,
    order: int,
    regularization_weight: float = 0.0,
    full_matrix: bool = True,
) -> torch.Tensor:
    """Interpolate query values from knots with a polyharmonic spline.

    ``train_points (N, T, I)``, ``train_values (N, T, D)`` and
    ``query_points (N, Q, I)`` give ``(N, Q, D)``, all float32. The
    full-matrix solve takes two steps of iterative refinement, as the JAX
    package's does.
    """
    c = train_points.float()
    f = train_values.float()
    x = query_points.float()
    order = int(order)
    A = _basis(c, c, order)  # (N, T, T)
    if regularization_weight > 0.0:
        A = A + torch.eye(A.shape[1], dtype=A.dtype, device=A.device)[None] * float(
            regularization_weight
        )
    B = torch.cat([c, torch.ones_like(c[..., :1])], 2)  # (N, T, I+1)
    if full_matrix:
        ABt = torch.cat([A, B.transpose(1, 2)], 1)
        zeros = B.new_zeros((B.shape[0], B.shape[2], B.shape[2]))
        B0 = torch.cat([B, zeros], 1)
        lhs = torch.cat([ABt, B0], 2)  # (N, T+I+1, T+I+1)
        rhs = torch.cat([f, f.new_zeros((B.shape[0], B.shape[2], f.shape[2]))], 1)
        wv = torch.linalg.solve_ex(lhs, rhs).result
        for _ in range(2):
            resid = rhs - torch.matmul(lhs, wv)
            wv = wv + torch.linalg.solve_ex(lhs, resid).result
        w, v = wv[:, : B.shape[1]], wv[:, B.shape[1]:]
    else:
        Ainv = torch.linalg.inv_ex(A).inverse
        Ainv_f = torch.matmul(Ainv, f)
        Ainv_B = torch.matmul(Ainv, B)
        Bt = B.transpose(1, 2)
        v = torch.linalg.solve_ex(
            torch.matmul(Bt, Ainv_B), torch.matmul(Bt, Ainv_f)
        ).result
        w = Ainv_f - torch.matmul(Ainv_B, v)
    phi_r = _basis(x, c, order)  # (N, Q, T)
    x1 = torch.cat([x, torch.ones_like(x[..., :1])], 2)
    return torch.matmul(phi_r, w) + torch.matmul(x1, v)


def warp_1d_grid(
    src: torch.Tensor,
    flow: torch.Tensor,
    lengths: torch.Tensor,
    max_length: Optional[int] = None,
    interpolation_order: int = 1,
) -> torch.Tensor:
    """Grid values warping one dimension: ``src[n] -> src[n] + flow[n]``.

    Returns ``(N, max_length)`` normalized coordinates in ``[-1, 1]``.
    Without ``max_length`` it is read from ``lengths`` (a host sync on a
    card).
    """
    src = torch.as_tensor(src).float()
    flow = torch.as_tensor(flow, device=src.device).float()
    lens = torch.as_tensor(lengths, device=src.device).float()
    N = src.shape[0]
    if max_length is None:
        T = int(math.ceil(float(lens.max()))) if lens.numel() else 0
    else:
        T = int(max_length)
    eps = _F32_EPS
    src = torch.clamp(torch.minimum(src, lens - 1), min=0)
    dst = torch.clamp(torch.minimum(src + flow, lens - 1), min=0)
    src = (2.0 * src + 1.0) / T - 1.0
    dst = (2.0 * dst + 1.0) / T - 1.0
    lowers = torch.full((N,), 1 / T - 1 - eps, dtype=torch.float32, device=src.device)
    uppers = (2 * lens - 1) / T - 1.0 + eps
    # a separation floor keeps the 5x5 system well conditioned when the
    # warped knot clamps onto a boundary (the JAX package's 1e-3)
    sep = 1e-3
    dst = torch.clamp(dst, lowers + sep, torch.maximum(uppers - sep, lowers + sep))
    src3 = torch.stack([lowers, src, uppers], 1)  # (N, 3)
    dst3 = torch.stack([lowers, dst, uppers], 1)
    t = (2.0 * torch.arange(T, dtype=torch.float32, device=src.device) + 1.0) / T - 1.0
    return polyharmonic_spline(
        dst3[..., None],
        src3[..., None],
        t[None].expand(N, T)[..., None],
        interpolation_order,
    )[..., 0]


def _reflect_coord(x: torch.Tensor, size: int) -> torch.Tensor:
    """Reflect continuous pixel coordinates into ``[-0.5, size - 0.5]``."""
    lo, hi = -0.5, size - 0.5
    rng = hi - lo
    r = torch.remainder(x - lo, 2 * rng)
    return lo + rng - torch.abs(r - rng)


def grid_sample(
    image: torch.Tensor,
    grid: torch.Tensor,
    mode: str = "bilinear",
    padding_mode: str = "zeros",
) -> torch.Tensor:
    """torch's ``grid_sample`` with ``align_corners=False``, as gathers and
    lerps. ``image`` is ``(N, C, H, W)``; ``grid`` is ``(N, H', W', 2)``,
    ``grid[..., 0]`` the width (x) and ``grid[..., 1]`` the height (y)
    coordinate in ``[-1, 1]``. ``mode`` is ``"bilinear"`` or
    ``"nearest"`` (half-way coordinates round to even), ``padding_mode``
    ``"zeros"``, ``"border"`` or ``"reflection"``."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unsupported mode '{mode}'")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"unsupported padding_mode '{padding_mode}'")
    N, C, H, W = image.shape
    grid = grid.to(image.device)
    ix = ((grid[..., 0] + 1) * W - 1) / 2
    iy = ((grid[..., 1] + 1) * H - 1) / 2
    if padding_mode == "reflection":
        ix = _reflect_coord(ix, W)
        iy = _reflect_coord(iy, H)
    flat = image.reshape(N, C, H * W)

    def gather(yi, xi):
        """``image[n, :, yi[n], xi[n]]`` at clamped indices."""
        lin = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(N, 1, -1)
        out = torch.gather(flat, 2, lin.expand(N, C, lin.shape[2]))
        return out.reshape((N, C) + yi.shape[1:])

    def inside(yi, xi):
        return (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)

    if mode == "nearest":
        xr = torch.round(ix).long()
        yr = torch.round(iy).long()
        out = gather(yr, xr)
        if padding_mode == "zeros":
            out = out * inside(yr, xr)[:, None].to(out.dtype)
        return out
    x0 = torch.floor(ix).long()
    y0 = torch.floor(iy).long()
    x1, y1 = x0 + 1, y0 + 1
    wx1 = ix - x0
    wy1 = iy - y0
    wx0, wy0 = 1 - wx1, 1 - wy1
    vals = []
    for yi, wy in ((y0, wy0), (y1, wy1)):
        for xi, wx in ((x0, wx0), (x1, wx1)):
            v = gather(yi, xi)
            w_ = wy * wx
            if padding_mode == "zeros":
                w_ = w_ * inside(yi, xi).to(w_.dtype)
            vals.append(v * w_[:, None].to(v.dtype))
    return vals[0] + vals[1] + vals[2] + vals[3]


def dense_image_warp(
    image: torch.Tensor,
    flow: torch.Tensor,
    indexing: str = "hw",
    mode: str = "bilinear",
    padding_mode: str = "border",
) -> torch.Tensor:
    """Warp ``image (N, C, H, W)`` by a per-pixel ``flow (N, H, W, 2)``:
    ``out[h, w] = image[h - flow_h, w - flow_w]``, the flow's last axis in
    ``indexing`` order (``"hw"`` or ``"wh"``), sampled by
    :func:`grid_sample`."""
    flow = flow.to(image.device).float()
    N, C, H, W = image.shape
    if indexing == "hw":
        flow = flow.flip(-1)
    elif indexing != "wh":
        raise ValueError("Invalid indexing! must be one of 'wh' or 'hw'")
    hg, wg = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=image.device),
        torch.arange(W, dtype=torch.float32, device=image.device),
        indexing="ij",
    )
    hw = torch.stack([wg, hg], 2)[None]  # (1, H, W, 2), (x=w, y=h)
    WH = torch.tensor([W, H], dtype=torch.float32, device=image.device).reshape(1, 1, 1, 2)
    grid = (2 * hw - 2 * flow + 1.0) / WH - 1.0
    return grid_sample(image, grid, mode=mode, padding_mode=padding_mode)


def _pinned_points(k: int, WH: torch.Tensor) -> torch.Tensor:
    """``4k`` control points along the image's boundary, ``(N, 4k, 2)`` as
    (w, h)."""
    N = WH.shape[0]
    w_max = (WH[:, :1] - 1).expand(N, k + 1)
    h_max = (WH[:, 1:] - 1).expand(N, k + 1)
    range_ = torch.linspace(0.0, 1.0, k + 1, device=WH.device)
    w_range = w_max * range_
    h_range = h_max * range_
    zeros = torch.zeros_like(w_range)
    bottom = torch.stack([w_range, zeros], 2)
    left = torch.stack([zeros[:, 1:-1], h_range[:, 1:-1]], 2)
    top = torch.stack([w_range, h_max], 2)
    right = torch.stack([w_max[:, 1:-1], h_range[:, 1:-1]], 2)
    return torch.cat([bottom, left, top, right], 1)


def sparse_image_warp(
    image: torch.Tensor,
    source_points: torch.Tensor,
    dest_points: torch.Tensor,
    indexing: str = "hw",
    field_interpolation_order: int = 2,
    field_regularization_weight: float = 0.0,
    field_full_matrix: bool = True,
    pinned_boundary_points: int = 0,
    dense_interpolation_mode: str = "bilinear",
    dense_padding_mode: str = "border",
    include_flow: bool = True,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Warp ``image (N, C, H, W)`` so that the control points
    ``source_points (N, M, 2)`` move to ``dest_points`` (``indexing``
    order), the dense flow interpolated by a polyharmonic spline, with
    ``pinned_boundary_points`` fixed points along each side.

    With ``include_flow`` returns ``(warped, flow)``, the flow ``(N, H, W,
    2)`` through :func:`dense_image_warp`; without it the spline
    interpolates ``grid_sample``'s grid directly and only the warped image
    comes back.
    """
    source_points = source_points.to(image.device).float()
    dest_points = dest_points.to(image.device).float()
    if indexing not in ("hw", "wh"):
        raise ValueError("Invalid indexing! must be one of 'wh' or 'hw'")
    if indexing == "hw":
        source_points = source_points.flip(-1)
        dest_points = dest_points.flip(-1)
    N, C, H, W = image.shape
    M = source_points.shape[1]
    if not M:
        flow = torch.zeros((N, H, W, 2), dtype=torch.float32, device=image.device)
        return (image, flow) if include_flow else image
    WH = torch.tensor([W, H], dtype=torch.float32, device=image.device).expand(N, 2)
    if pinned_boundary_points > 0:
        pinned = _pinned_points(pinned_boundary_points, WH)
        source_points = torch.cat([source_points, pinned], 1)
        dest_points = torch.cat([dest_points, pinned], 1)
    hg, wg = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=image.device),
        torch.arange(W, dtype=torch.float32, device=image.device),
        indexing="ij",
    )
    query = torch.stack([wg.reshape(-1), hg.reshape(-1)], 1)[None].expand(N, H * W, 2)
    if include_flow:
        flow = polyharmonic_spline(
            dest_points, dest_points - source_points, query,
            field_interpolation_order,
            regularization_weight=field_regularization_weight,
            full_matrix=field_full_matrix,
        ).reshape(N, H, W, 2)
        warped = dense_image_warp(
            image, flow, indexing="wh", mode=dense_interpolation_mode,
            padding_mode=dense_padding_mode,
        )
        if indexing == "hw":
            flow = flow.flip(-1)
        return warped, flow
    train_values = (2.0 * source_points + 1.0) / WH[:, None] - 1.0
    grid = polyharmonic_spline(
        dest_points, train_values, query, field_interpolation_order,
        regularization_weight=field_regularization_weight,
        full_matrix=field_full_matrix,
    ).reshape(N, H, W, 2)
    return grid_sample(
        image, grid, mode=dense_interpolation_mode, padding_mode=dense_padding_mode,
    )


def random_shift_pads(
    in_lens: torch.Tensor, prop: Sequence[float], u: torch.Tensor
) -> torch.Tensor:
    """The ``(2, N)`` int32 left and right pads of :func:`random_shift`
    from uniforms ``u (2, N)`` in ``[0, 1)``: each side's share ``prop``
    of the length, times its uniform, truncated."""
    lens_f = in_lens.float()
    bound = torch.stack([prop[0] * lens_f, prop[1] * lens_f])
    return (bound * u.to(bound.device, torch.float32)).to(torch.int32)


def random_shift_apply(
    input: torch.Tensor,
    in_lens: torch.Tensor,
    pad: torch.Tensor,
    mode: str = "reflect",
    value: float = 0.0,
    out_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad each sequence of ``input (N, T, ...)`` by the given ``pad (2,
    N)``: the padded sequences (``out_len`` frames, by default the longest)
    and their lengths."""
    out_lens = in_lens + pad.sum(0).to(in_lens.dtype)
    if out_len is None:
        out_len = int(out_lens.max()) if out_lens.numel() else 0
    return pad_variable(input, in_lens, pad, mode, value, out_len=int(out_len)), out_lens


def random_shift(
    input: torch.Tensor,
    in_lens: torch.Tensor,
    prop: Sequence[float],
    mode: str = "reflect",
    value: float = 0.0,
    training: bool = True,
    out_len: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad each sequence left and right by random amounts, up to
    ``prop[0]`` and ``prop[1]`` of its length; the uniforms come from
    ``generator`` (on ``input``'s device). Returns the padded sequences and
    their lengths; ``input`` and ``in_lens`` unchanged when not
    ``training``."""
    if input.dim() < 2:
        raise RuntimeError("input must be at least 2 dimensional")
    in_lens = torch.as_tensor(in_lens, device=input.device)
    if in_lens.dim() != 1 or in_lens.shape[0] != input.shape[0]:
        raise RuntimeError(
            f"For input of shape {tuple(input.shape)}, expected in_lens to be of "
            f"shape ({input.shape[0]},), got {tuple(in_lens.shape)}"
        )
    if not training:
        return input, in_lens
    u = torch.rand((2, in_lens.shape[0]), generator=generator, device=input.device)
    pad = random_shift_pads(in_lens, prop, u)
    return random_shift_apply(input, in_lens, pad, mode, value, out_len)


def _check_spec_augment_input(feats, lengths):
    if feats.dim() != 3:
        raise RuntimeError(
            f"Expected feats to have three dimensions, got {feats.dim()}"
        )
    N = feats.shape[0]
    if lengths is not None:
        if lengths.dim() != 1:
            raise RuntimeError(
                f"Expected lengths to be one dimensional, got {lengths.dim()}"
            )
        if lengths.shape[0] != N:
            raise RuntimeError(
                f"Batch dimension of feats ({N}) and lengths "
                f"({lengths.shape[0]}) do not match"
            )


def _axis_lerp_weights(grid: torch.Tensor, size: int):
    """Indices and weights of a border-padded linear interpolation along one
    axis from a normalized grid: ``(x0, x1, w0, w1)``."""
    i = ((grid + 1) * size - 1) / 2
    x0 = torch.floor(i).to(torch.int32)
    w1 = i - x0
    w0 = 1 - w1
    x0c = torch.clamp(x0, 0, size - 1)
    x1c = torch.clamp(x0 + 1, 0, size - 1)
    return x0c, x1c, w0, w1


def _separable_warp(
    feats: torch.Tensor,
    time_grid: Optional[torch.Tensor],
    freq_grid: Optional[torch.Tensor],
) -> torch.Tensor:
    """Linear, border-padded warp of ``(N, T, F)`` feats by independent
    per-axis grids: a row gather and lerp over time, an ``(F, F)``
    interpolation product over frequency. bfloat16 feats round back to
    bfloat16 after each axis; the arithmetic is float32 (the products of
    the bf16 frequency matmul are exact in float32)."""
    N, T, F = feats.shape
    bf16 = feats.dtype == torch.bfloat16
    out = feats
    if time_grid is not None:
        t0, t1, w0, w1 = _axis_lerp_weights(time_grid, T)
        g0 = torch.gather(out, 1, t0.long()[..., None].expand(N, T, F))
        g1 = torch.gather(out, 1, t1.long()[..., None].expand(N, T, F))
        out = w0[..., None] * g0.float() + w1[..., None] * g1.float()
        if bf16:
            out = out.to(torch.bfloat16)
    if freq_grid is not None:
        f0, f1, w0, w1 = _axis_lerp_weights(freq_grid, F)
        cols = torch.arange(F, dtype=torch.int32, device=feats.device)
        Wf = w0[..., None] * (f0[..., None] == cols) + w1[..., None] * (
            f1[..., None] == cols
        )  # (N, F_out, F_in)
        if bf16:
            out = torch.einsum(
                "nof,ntf->nto",
                Wf.to(torch.bfloat16).float(),
                out.to(torch.bfloat16).float(),
            ).to(torch.bfloat16)
        else:
            out = torch.einsum("nof,ntf->nto", Wf, out.float())
    return out


def _span_mask(starts: torch.Tensor, widths: torch.Tensor, size: int) -> torch.Tensor:
    """``(N, size)`` bool: positions inside any ``[start, start + width)``."""
    r = torch.arange(size, device=starts.device)[None, :, None]
    return ((r >= starts[:, None]) & (r < (starts + widths)[:, None])).any(2)


def spec_augment_draw_parameters(
    generator: Optional[torch.Generator],
    feats: torch.Tensor,
    max_time_warp: float,
    max_freq_warp: float,
    max_time_mask: int,
    max_freq_mask: int,
    max_time_mask_proportion: float,
    num_time_mask: int,
    num_time_mask_proportion: float,
    num_freq_mask: int,
    lengths: Optional[torch.Tensor] = None,
):
    """Draw the SpecAugment warp and mask parameters ``(w_0, w, v_0, v,
    t_0, t, f_0, f)`` (None for disabled steps) on ``feats``' device from
    ``generator`` (that device's default generator when None).

    Warp positions before shifts, mask widths before positions, and time
    masks capped by a proportion of each length, all from one uniform draw
    of ``(N, columns)``, as the JAX package does.
    """
    _check_spec_augment_input(feats, lengths)
    N, T, F = feats.shape
    dev = feats.device
    if lengths is None:
        lengths = torch.full((N,), T, dtype=torch.float32, device=dev)
    else:
        lengths = lengths.to(dev, torch.float32)
    eps = _F32_EPS
    omeps = 1 - eps
    do_tm = bool(
        max_time_mask
        and max_time_mask_proportion
        and num_time_mask
        and num_time_mask_proportion
    )
    do_fm = bool(max_freq_mask and num_freq_mask)
    cols = (
        (2 if max_time_warp else 0)
        + (2 if max_freq_warp else 0)
        + (2 * num_time_mask if do_tm else 0)
        + (2 * num_freq_mask if do_fm else 0)
    )
    u = torch.rand((N, max(cols, 1)), generator=generator, device=dev)
    c = 0
    w_0 = w = v_0 = v = t_0 = t = f_0 = f = None
    if max_time_warp:
        Wc = torch.clamp(lengths / 2 - eps, 0, max_time_warp)
        w_0 = u[:, c] * (lengths - 2 * Wc) + Wc
        w = u[:, c + 1] * (2 * Wc) - Wc
        c += 2
    if max_freq_warp:
        V = min(max(F / 2 - eps, 0), max_freq_warp)
        v_0 = u[:, c] * (F - 2 * V) + V
        v = u[:, c + 1] * (2 * V) - V
        c += 2
    if do_tm:
        max_ = torch.floor(
            torch.clamp(lengths * max_time_mask_proportion, max=max_time_mask)
        )
        nums_ = torch.floor(
            torch.clamp(lengths * num_time_mask_proportion, max=num_time_mask)
        )
        t = (u[:, c : c + num_time_mask] * (max_ + omeps)[:, None]).to(torch.int32)
        slot = torch.arange(num_time_mask, dtype=torch.float32, device=dev)[None]
        t = torch.where(nums_[:, None] <= slot, 0, t)
        t_0 = (
            u[:, c + num_time_mask : c + 2 * num_time_mask]
            * (lengths[:, None] - t + omeps)
        ).to(torch.int32)
        c += 2 * num_time_mask
    if do_fm:
        max_ = min(max_freq_mask, F)
        f = (u[:, c : c + num_freq_mask] * (max_ + omeps)).to(torch.int32)
        f_0 = (
            u[:, c + num_freq_mask : c + 2 * num_freq_mask] * (F - f + omeps)
        ).to(torch.int32)
    return w_0, w, v_0, v, t_0, t, f_0, f


def spec_augment_apply_parameters(
    feats: torch.Tensor,
    params,
    interpolation_order: int = 1,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Apply drawn SpecAugment parameters: warp, then mask. Disabled steps
    may be None or empty. The result has ``feats``' shape and dtype, except
    that a warp of feats other than bfloat16 returns float32, as the JAX
    package's XLA route does."""
    _check_spec_augment_input(feats, lengths)
    N, T, F = feats.shape
    dev = feats.device
    if lengths is None:
        lengths = torch.full((N,), T, dtype=torch.float32, device=dev)
    else:
        lengths = lengths.to(dev, torch.float32)
    w_0, w, v_0, v, t_0, t, f_0, f = (
        None if p is None or p.numel() == 0 else torch.as_tensor(p, device=dev)
        for p in params
    )
    time_grid = freq_grid = None
    if w_0 is not None and w is not None:
        time_grid = warp_1d_grid(w_0, w, lengths, T, interpolation_order)
    if v_0 is not None and v is not None:
        freq_grid = warp_1d_grid(
            v_0,
            v,
            torch.full((N,), F, dtype=torch.float32, device=dev),
            F,
            interpolation_order,
        )
    tmask = None if t_0 is None or t is None else _span_mask(t_0, t, T)
    fmask = None if f_0 is None or f is None else _span_mask(f_0, f, F)
    if freq_grid is None:
        # the JAX package's fused route (img.py:596-635): time warp and both
        # masks in one kernel pass
        t0 = t1 = w0 = w1 = None
        if time_grid is not None:
            t0, t1, w0, w1 = _axis_lerp_weights(time_grid, T)
        return kernels.spec_augment_apply(feats, t0, t1, w0, w1, tmask, fmask)
    # with a frequency warp the JAX package runs its separable XLA warp
    new_feats = _separable_warp(feats, time_grid, freq_grid)
    mask = None
    if tmask is not None:
        mask = tmask[:, :, None]
    if fmask is not None:
        mask = fmask[:, None, :] if mask is None else mask | fmask[:, None, :]
    if mask is not None:
        new_feats = torch.where(mask, 0.0, new_feats)
    return new_feats


def spec_augment(
    generator: Optional[torch.Generator],
    feats: torch.Tensor,
    max_time_warp: float = 80.0,
    max_freq_warp: float = 0.0,
    max_time_mask: int = 100,
    max_freq_mask: int = 27,
    max_time_mask_proportion: float = 0.04,
    num_time_mask: int = 20,
    num_time_mask_proportion: float = 0.04,
    num_freq_mask: int = 2,
    interpolation_order: int = 1,
    lengths: Optional[torch.Tensor] = None,
    training: bool = True,
) -> torch.Tensor:
    """SpecAugment: random time/frequency warps and masks of filterbank
    features ``(N, T, F)``, with the park2020 defaults.

    The parameters are drawn from ``generator`` on ``feats``' device;
    features that are not a tensor go to ``cuda``.
    """
    if not isinstance(feats, torch.Tensor):
        feats = torch.as_tensor(feats, device=default_device())
    _check_spec_augment_input(feats, lengths)
    if not training:
        return feats
    params = spec_augment_draw_parameters(
        generator, feats, max_time_warp, max_freq_warp, max_time_mask,
        max_freq_mask, max_time_mask_proportion, num_time_mask,
        num_time_mask_proportion, num_freq_mask, lengths,
    )
    return spec_augment_apply_parameters(feats, params, interpolation_order, lengths)
