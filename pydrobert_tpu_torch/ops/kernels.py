"""Wrappers of the Hopper kernels in ``csrc/prologue.cu`` and their plain
PyTorch versions (counterparts of ``decode_prologue_pallas`` and
``top_m_pallas`` in :mod:`pydrobert_tpu.ops.pallas`).

A wrapper given a CPU tensor runs the plain version. Given a CUDA tensor it
checks dtype, shape and contiguity, launches the kernel on the current
stream and adds one to its entry of :data:`LAUNCHES`, or raises: it never
falls back to the plain version.
"""

import ctypes
from typing import Optional, Tuple

import torch

from ._build import load_library
from .topk import exact_top_k

__all__ = [
    "LAUNCHES",
    "decode_prologue",
    "decode_prologue_reference",
    "reset_launches",
    "top_m",
    "top_m_reference",
]

LAUNCHES = {"decode_prologue": 0, "top_m": 0}
"""Kernel launches per wrapper since the last :func:`reset_launches`."""

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_LANES = {}  # device index -> longest row one warp can stage


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_m(m: int, V: int) -> int:
    m = int(m)
    if not 0 < m <= V:
        raise ValueError(f"m must be in [1, {V}], got {m}")
    return m


def _check_input(x: torch.Tensor, name: str) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")


def _launch_args(x: torch.Tensor, lanes: int, name: str):
    """The library, checked for a CUDA tensor the kernel can take."""
    if not x.is_contiguous():
        raise ValueError(f"{name}: the input must be contiguous")
    lib = load_library()
    dev = x.device.index
    if dev not in _MAX_LANES:
        with torch.cuda.device(dev):
            _MAX_LANES[dev] = lib.pydt_max_row_lanes()
    max_lanes = _MAX_LANES[dev]
    if lanes > max_lanes:
        raise ValueError(
            f"{name}: a row of {lanes} lanes does not fit in shared memory "
            f"({max_lanes} lanes at most)"
        )
    return lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def decode_prologue_reference(
    logits: torch.Tensor, m: int, g_bias: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, ...]:
    """Plain version of :func:`decode_prologue` (the XLA branch of the JAX
    package's ``_decode_prologue``): f32 math on the upcast logits."""
    V = logits.shape[-1] - 1
    x = logits.float()
    sm_max = x.amax(-1)
    sm_den = torch.exp(x - sm_max[..., None]).sum(-1)
    g = x[..., :V] if g_bias is None else x[..., :V] + g_bias.float()
    top_lgts, top_inds = exact_top_k(g, m)
    return top_lgts, top_inds.int(), sm_max, sm_den, x[..., V]


def decode_prologue(
    logits: torch.Tensor, m: int, g_bias: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, ...]:
    """The CTC decode prologue in one pass over ``logits (T, N, V + 1)``.

    Returns ``(top_lgts (T, N, m) f32, top_inds (T, N, m) int32,
    sm_max (T, N), sm_den (T, N), blank_lgt (T, N))``: the exact top-``m``
    of ``logits[..., :V] (+ g_bias)`` with ``jax.lax.top_k``'s values,
    indices and tie order, and the softmax max and denominator over all
    ``V + 1`` lanes with the raw blank logit. ``g_bias`` ``(V,)`` is added
    only when given, so ``-0.0`` logits keep their sign in the ranking.
    ``sm_den`` may differ from the plain version in the last ulps (another
    summation order).
    """
    if logits.dim() != 3:
        raise ValueError("logits must be (T, N, V + 1)")
    _check_input(logits, "decode_prologue")
    T, N, Vp1 = logits.shape
    V = Vp1 - 1
    m = _check_m(m, V)
    if g_bias is not None and g_bias.shape != (V,):
        raise ValueError(f"g_bias must have shape ({V},), got {g_bias.shape}")
    if not logits.is_cuda:
        return decode_prologue_reference(logits, m, g_bias)
    lib = _launch_args(logits, Vp1, "decode_prologue")
    if g_bias is not None:
        if (
            g_bias.dtype != torch.float32
            or g_bias.device != logits.device
            or not g_bias.is_contiguous()
        ):
            raise ValueError(
                "g_bias must be a contiguous float32 tensor on the logits' "
                "device"
            )
    dev = logits.device
    vals = torch.empty((T, N, m), dtype=torch.float32, device=dev)
    idx = torch.empty((T, N, m), dtype=torch.int32, device=dev)
    stats = torch.empty((3, T, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pydt_decode_prologue(
            ctypes.c_void_p(logits.data_ptr()),
            _DTYPE_CODE[logits.dtype],
            None if g_bias is None else ctypes.c_void_p(g_bias.data_ptr()),
            T * N,
            V,
            m,
            ctypes.c_void_p(vals.data_ptr()),
            ctypes.c_void_p(idx.data_ptr()),
            ctypes.c_void_p(stats[0].data_ptr()),
            ctypes.c_void_p(stats[1].data_ptr()),
            ctypes.c_void_p(stats[2].data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    _raise_on(err, "decode_prologue")
    LAUNCHES["decode_prologue"] += 1
    return vals, idx, stats[0], stats[1], stats[2]


def top_m_reference(x: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`top_m`: :func:`exact_top_k` on the upcast
    input."""
    vals, idx = exact_top_k(x.float(), m)
    return vals, idx.int()


def top_m(x: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k(x, m)`` over the trailing axis: float32 values and
    int32 indices, exact values, indices and tie order. ``x`` is float32 or
    bfloat16 of any rank."""
    _check_input(x, "top_m")
    if x.dim() == 0:
        raise ValueError("top_m needs at least one axis")
    V = x.shape[-1]
    m = _check_m(m, V)
    if not x.is_cuda:
        return top_m_reference(x, m)
    lib = _launch_args(x, V, "top_m")
    lead = x.shape[:-1]
    dev = x.device
    vals = torch.empty(lead + (m,), dtype=torch.float32, device=dev)
    idx = torch.empty(lead + (m,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pydt_top_m(
            ctypes.c_void_p(x.data_ptr()),
            _DTYPE_CODE[x.dtype],
            x.numel() // V,
            V,
            m,
            ctypes.c_void_p(vals.data_ptr()),
            ctypes.c_void_p(idx.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    _raise_on(err, "top_m")
    LAUNCHES["top_m"] += 1
    return vals, idx
