"""Wrappers of the Hopper kernels under ``csrc/`` and their plain PyTorch
versions (counterparts of the kernels in :mod:`pydrobert_tpu.ops.pallas`):

- :func:`decode_prologue` and :func:`top_m` (``csrc/prologue.cu``):
  ``decode_prologue_pallas`` and ``top_m_pallas``;
- :func:`spec_augment_apply` (``csrc/spec_augment.cu``):
  ``spec_augment_apply_kernel``;
- :func:`edit_distance` (``csrc/edit_distance.cu``): ``edit_distance_kernel``;
- :func:`ctc_beam_search` (``csrc/ctc_beam.cu``): ``ctc_beam_search_pallas``,
  and :func:`ctc_beam_search_renorm`, its renormalizing variant, which the
  JAX package does not have (its searches with ``DECODE_RENORM`` on never
  take its kernel);
- :func:`depthwise_conv1d` (``csrc/depthwise_conv.cu``): no TPU kernel (the
  JAX package's Conformer runs its depthwise convolution as a loop of
  shifted multiply-adds, which XLA fuses; this is that loop's kernel).

A wrapper given a CPU tensor runs the plain version. Given a CUDA tensor it
checks dtype, shape and contiguity, launches the kernel on the current
stream and adds one to its entry of :data:`LAUNCHES`, or raises: it never
falls back to the plain version.

Each kernel is also a :mod:`torch.library` operator in the
``pydrobert_tpu_torch`` namespace (``torch.ops.pydrobert_tpu_torch.
decode_prologue``, ``top_m``, ``spec_augment_apply``, ``edit_distance``,
``ctc_beam_search``, ``ctc_beam_search_renorm``, ``depthwise_conv1d``): its
CUDA implementation is the launch above, its CPU implementation the plain
version, and a fake implementation gives the output shapes. Importing this module registers the operators. An eager
wrapper calls the launch or the plain version directly, without the
dispatcher; a wrapper traced by :func:`torch.export.export` (or
:func:`torch.compile`) records its operator whatever the device, so an
exported program runs the plain versions on the CPU and launches the
kernels on the card. A wrapper refuses a
:class:`~torch.distributed.tensor.DTensor`: the kernels take local tensors.
"""

import ctypes
import math
from typing import Optional, Tuple

import torch

from ._build import load_library
from ._ctc_scan import prefix_scan
from .topk import exact_top_k

__all__ = [
    "LAUNCHES",
    "ctc_beam_search",
    "ctc_beam_search_fits",
    "ctc_beam_search_reference",
    "ctc_beam_search_renorm",
    "ctc_beam_search_renorm_reference",
    "decode_prologue",
    "decode_prologue_reference",
    "depthwise_conv1d",
    "depthwise_conv1d_reference",
    "edit_distance",
    "edit_distance_reference",
    "reset_launches",
    "spec_augment_apply",
    "spec_augment_apply_reference",
    "top_m",
    "top_m_reference",
]

LAUNCHES = {
    "decode_prologue": 0,
    "top_m": 0,
    "spec_augment_apply": 0,
    "edit_distance": 0,
    "ctc_beam_search": 0,
    "ctc_beam_search_renorm": 0,
    "depthwise_conv1d": 0,
}
"""Kernel launches per wrapper since the last :func:`reset_launches`."""

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_WORDS = {}  # device index -> shared words one warp can take


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_NS = "pydrobert_tpu_torch"


def _traced() -> bool:
    """Whether a wrapper runs under :func:`torch.export.export` or
    :func:`torch.compile`: it then records its operator, on any device."""
    return torch.compiler.is_compiling()


def _check_local(name: str, *xs) -> None:
    for x in xs:
        if x is None or type(x) in (torch.Tensor, torch.nn.Parameter):
            continue
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            raise TypeError(
                f"{name} takes local tensors, got a DTensor: gather it (or "
                "take its local shard) before the kernel"
            )


def _check_m(m: int, V: int) -> int:
    m = int(m)
    if not 0 < m <= V:
        raise ValueError(f"m must be in [1, {V}], got {m}")
    return m


def _check_input(x: torch.Tensor, name: str) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")


def _launch_args(x: torch.Tensor, words: int, name: str):
    """The library, checked for a CUDA tensor the kernel can take: ``words``
    of shared memory for one warp."""
    if not x.is_contiguous():
        raise ValueError(f"{name}: the input must be contiguous")
    lib = load_library()
    dev = x.device.index
    if dev not in _MAX_WORDS:
        with torch.cuda.device(dev):
            _MAX_WORDS[dev] = lib.pydt_max_warp_words()
    if words > _MAX_WORDS[dev]:
        raise ValueError(
            f"{name}: a row needs {words} words of shared memory, more than "
            f"the {_MAX_WORDS[dev]} one warp can take"
        )
    return lib


def _prologue_args(x: torch.Tensor, lanes: int, m: int, name: str):
    """:func:`_launch_args` for ``csrc/prologue.cu``, whose warp takes the
    shared words ``pydt_prologue_warp_words`` gives for a row of ``lanes``
    and a top-``m``."""
    return _launch_args(x, load_library().pydt_prologue_warp_words(lanes, m), name)


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
    _check_local("decode_prologue", logits, g_bias)
    if _traced():
        vals, idx, stats = torch.ops.pydrobert_tpu_torch.decode_prologue(logits, m, g_bias)
    elif not logits.is_cuda:
        return decode_prologue_reference(logits, m, g_bias)
    else:
        vals, idx, stats = _decode_prologue_launch(logits, m, g_bias)
    return vals, idx, stats[0], stats[1], stats[2]


def _decode_prologue_launch(
    logits: torch.Tensor, m: int, g_bias: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel: ``(top values, top indices, stats (3, T, N))``, the three
    stats rows one buffer (an operator's outputs may not alias each
    other; the wrapper splits it)."""
    T, N, Vp1 = logits.shape
    V = Vp1 - 1
    if g_bias is not None and (
        g_bias.dtype != torch.float32
        or g_bias.device != logits.device
        or not g_bias.is_contiguous()
    ):
        raise ValueError("g_bias must be a contiguous float32 tensor on the logits' device")
    lib = _prologue_args(logits, Vp1, m, "decode_prologue")
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
    return vals, idx, stats


_decode_prologue_op = torch.library.custom_op(
    f"{_NS}::decode_prologue", _decode_prologue_launch, mutates_args=(), device_types="cuda"
)


@_decode_prologue_op.register_kernel("cpu")
def _(logits, m, g_bias):
    vals, idx, sm_max, sm_den, blank = decode_prologue_reference(logits, m, g_bias)
    return vals, idx, torch.stack([sm_max, sm_den, blank])


@_decode_prologue_op.register_fake
def _(logits, m, g_bias):
    T, N, _ = logits.shape
    return (
        logits.new_empty((T, N, m), dtype=torch.float32),
        logits.new_empty((T, N, m), dtype=torch.int32),
        logits.new_empty((3, T, N), dtype=torch.float32),
    )


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
    _check_local("top_m", x)
    if _traced():
        return torch.ops.pydrobert_tpu_torch.top_m(x, m)
    if not x.is_cuda:
        return top_m_reference(x, m)
    return _top_m_launch(x, m)


def _top_m_launch(x: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    V = x.shape[-1]
    lib = _prologue_args(x, V, m, "top_m")
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


_top_m_op = torch.library.custom_op(
    f"{_NS}::top_m", _top_m_launch, mutates_args=(), device_types="cuda"
)


@_top_m_op.register_kernel("cpu")
def _(x, m):
    return top_m_reference(x, m)


@_top_m_op.register_fake
def _(x, m):
    shape = x.shape[:-1] + (m,)
    return x.new_empty(shape, dtype=torch.float32), x.new_empty(shape, dtype=torch.int32)


def _sa_io_dtype(feats: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if feats.dtype == torch.bfloat16 else torch.float32


def _sa_out_dtype(feats: torch.Tensor, warp: bool) -> torch.dtype:
    """The JAX package's XLA route: a time warp's lerp is float32 and only
    bfloat16 is cast back (``img.py:452-457``); masks keep the dtype."""
    return _sa_io_dtype(feats) if warp else feats.dtype


def _check_sa_args(feats, t0, t1, w0, w1, tmask, fmask):
    if feats.dim() != 3:
        raise ValueError("feats must be (N, T, F)")
    if not feats.is_floating_point():
        raise TypeError(f"feats must be floating point, got {feats.dtype}")
    N, T, F = feats.shape
    warp = (t0, t1, w0, w1)
    if any(a is None for a in warp) and any(a is not None for a in warp):
        raise ValueError("t0, t1, w0 and w1 are given together or not at all")
    for name, a, shape in (
        ("t0", t0, (N, T)), ("t1", t1, (N, T)), ("w0", w0, (N, T)),
        ("w1", w1, (N, T)), ("tmask", tmask, (N, T)), ("fmask", fmask, (N, F)),
    ):
        if a is not None and tuple(a.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(a.shape)}")
        if a is not None and a.device != feats.device:
            raise ValueError(f"{name} must be on feats' device ({feats.device})")
    for name, a in (("tmask", tmask), ("fmask", fmask)):
        if a is not None and a.dtype != torch.bool:
            raise TypeError(f"{name} must be bool, got {a.dtype}")


def spec_augment_apply_reference(
    feats: torch.Tensor,
    t0: Optional[torch.Tensor],
    t1: Optional[torch.Tensor],
    w0: Optional[torch.Tensor],
    w1: Optional[torch.Tensor],
    tmask: Optional[torch.Tensor],
    fmask: Optional[torch.Tensor],
) -> torch.Tensor:
    """Plain version of :func:`spec_augment_apply` (the JAX package's XLA
    route: a row gather and lerp, then ``where(mask, 0, x)``)."""
    _check_sa_args(feats, t0, t1, w0, w1, tmask, fmask)
    io = _sa_io_dtype(feats)
    x = feats.to(io)
    if t0 is None:
        out = x.float()
    else:
        N, T, F = x.shape
        g0 = torch.gather(x, 1, t0.long()[..., None].expand(N, T, F)).float()
        g1 = torch.gather(x, 1, t1.long()[..., None].expand(N, T, F)).float()
        out = w0.float()[..., None] * g0 + w1.float()[..., None] * g1
    mask = None
    if tmask is not None:
        mask = tmask[:, :, None]
    if fmask is not None:
        mask = fmask[:, None, :] if mask is None else mask | fmask[:, None, :]
    if mask is not None:
        out = torch.where(mask, 0.0, out)
    return out.to(io).to(_sa_out_dtype(feats, t0 is not None))


def spec_augment_apply(
    feats: torch.Tensor,
    t0: Optional[torch.Tensor],
    t1: Optional[torch.Tensor],
    w0: Optional[torch.Tensor],
    w1: Optional[torch.Tensor],
    tmask: Optional[torch.Tensor],
    fmask: Optional[torch.Tensor],
) -> torch.Tensor:
    """SpecAugment's time warp and masks in one pass over ``feats (N, T, F)``.

    ``out[n, t] = w0[n, t] * feats[n, t0[n, t]] + w1[n, t] *
    feats[n, t1[n, t]]``, then ``+0.0`` wherever ``tmask[n, t]`` or
    ``fmask[n, f]`` is set. ``t0, t1 (N, T)`` are integer indices in
    ``[0, T)`` and ``w0, w1 (N, T)`` float weights, all four None for no
    warp; ``tmask (N, T)`` and ``fmask (N, F)`` are bool or None. The
    arithmetic is float32 on bfloat16 or float32 I/O (bfloat16 feats stay
    bfloat16, anything else goes through float32). The result has
    ``feats``' dtype, but float32 for feats other than bfloat16 when there
    is a warp, as the JAX package's XLA route returns.
    """
    _check_sa_args(feats, t0, t1, w0, w1, tmask, fmask)
    _check_local("spec_augment_apply", feats, t0, t1, w0, w1, tmask, fmask)
    args = (feats, t0, t1, w0, w1, tmask, fmask)
    if _traced():
        return torch.ops.pydrobert_tpu_torch.spec_augment_apply(*args)
    if not feats.is_cuda:
        return spec_augment_apply_reference(*args)
    return _spec_augment_apply_launch(*args)


def _spec_augment_apply_launch(
    feats: torch.Tensor,
    t0: Optional[torch.Tensor],
    t1: Optional[torch.Tensor],
    w0: Optional[torch.Tensor],
    w1: Optional[torch.Tensor],
    tmask: Optional[torch.Tensor],
    fmask: Optional[torch.Tensor],
) -> torch.Tensor:
    N, T, F = feats.shape
    io = _sa_io_dtype(feats)
    x = feats.to(io).contiguous()
    out = torch.empty_like(x)
    warp = None
    if t0 is not None:
        warp = (
            t0.to(torch.int32).contiguous(), t1.to(torch.int32).contiguous(),
            w0.to(torch.float32).contiguous(), w1.to(torch.float32).contiguous(),
        )
    masks = tuple(
        None if m is None else m.contiguous() for m in (tmask, fmask)
    )
    vec = 16 // x.element_size()
    if F % vec or x.data_ptr() % 16 or out.data_ptr() % 16:
        vec = 1
    lib = load_library()

    def ptr(a):
        return None if a is None else ctypes.c_void_p(a.data_ptr())

    with torch.cuda.device(x.device):
        err = lib.pydt_spec_augment_apply(
            ptr(x),
            _DTYPE_CODE[io],
            *(ptr(a) for a in (warp or (None,) * 4)),
            *(ptr(m) for m in masks),
            N,
            T,
            F,
            vec,
            ptr(out),
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
        )
    _raise_on(err, "spec_augment_apply")
    LAUNCHES["spec_augment_apply"] += 1
    return out.to(_sa_out_dtype(feats, t0 is not None))


_spec_augment_apply_op = torch.library.custom_op(
    f"{_NS}::spec_augment_apply", _spec_augment_apply_launch, mutates_args=(),
    device_types="cuda",
)


@_spec_augment_apply_op.register_kernel("cpu")
def _(feats, t0, t1, w0, w1, tmask, fmask):
    out = spec_augment_apply_reference(feats, t0, t1, w0, w1, tmask, fmask)
    # no warp and no mask hands back feats itself; an operator's output may
    # not alias its input
    return out.clone() if out is feats else out


@_spec_augment_apply_op.register_fake
def _(feats, t0, t1, w0, w1, tmask, fmask):
    return feats.new_empty(feats.shape, dtype=_sa_out_dtype(feats, t0 is not None))


def _check_ed_args(ref, hyp, ref_lens, hyp_lens):
    if ref.dim() != 2 or hyp.dim() != 2:
        raise ValueError("ref and hyp must be time-major (R, N) and (H, N)")
    N = ref.shape[1]
    if hyp.shape[1] != N or ref_lens.shape != (N,) or hyp_lens.shape != (N,):
        raise ValueError(
            f"batch sizes differ: ref {tuple(ref.shape)}, hyp {tuple(hyp.shape)}, "
            f"ref_lens {tuple(ref_lens.shape)}, hyp_lens {tuple(hyp_lens.shape)}"
        )
    for name, a in (
        ("ref", ref), ("hyp", hyp), ("ref_lens", ref_lens), ("hyp_lens", hyp_lens)
    ):
        if a.is_floating_point() or a.is_complex() or a.dtype == torch.bool:
            raise TypeError(f"{name} must hold integers, got {a.dtype}")
        if a.device != ref.device:
            raise ValueError(f"{name} must be on ref's device ({ref.device})")


def edit_distance_reference(
    ref: torch.Tensor,
    hyp: torch.Tensor,
    ref_lens: torch.Tensor,
    hyp_lens: torch.Tensor,
    ins_cost: float,
    del_cost: float,
    sub_cost: float,
    exclude_last: bool = False,
) -> torch.Tensor:
    """Plain version of :func:`edit_distance`: the distance-only DP of the
    JAX package's ``_string_matching_jit``, one hypothesis step at a time,
    with the deletions relaxed as ``cummin(row - i*del) + i*del``."""
    _check_ed_args(ref, hyp, ref_lens, hyp_lens)
    R, N = ref.shape
    H = hyp.shape[0]
    off = 0 if exclude_last else 1
    dev = ref.device
    hyp_lens = hyp_lens.to(torch.int32)
    rrange = torch.arange(R + 1, dtype=torch.float32, device=dev)[:, None]
    shift = rrange * float(del_cost)
    row = shift.expand(R + 1, N)
    for t in range(1, H + off):
        not_done = (t - off) < hyp_lens
        ins_mask = (hyp_lens >= t).float()
        up = row + float(ins_cost) * ins_mask[None]
        # a match adds exactly 0, also at sub_cost=inf: XLA compiles the
        # JAX package's sub_cost * neq as a select
        sub = row[:-1] + torch.where(ref != hyp[t - 1][None], float(sub_cost), 0.0)
        new = torch.cat([up[:1], torch.minimum(up[1:], sub)], 0)
        new = torch.cummin(new - shift, 0).values + shift
        row = torch.where(not_done[None], new, row)
    idx = ref_lens.long().clamp(0, R)[None]
    return torch.gather(row, 0, idx)[0]


def edit_distance(
    ref: torch.Tensor,
    hyp: torch.Tensor,
    ref_lens: torch.Tensor,
    hyp_lens: torch.Tensor,
    ins_cost: float,
    del_cost: float,
    sub_cost: float,
    exclude_last: bool = False,
) -> torch.Tensor:
    """Batched weighted Levenshtein distances ``(N,)`` float32 from
    time-major integer ``ref (R, N)`` and ``hyp (H, N)`` with lengths
    ``ref_lens, hyp_lens (N,)``. ``exclude_last`` drops the last hypothesis
    token of each sequence. A ``ref_lens`` entry above ``R`` reads row
    ``R``."""
    _check_ed_args(ref, hyp, ref_lens, hyp_lens)
    _check_local("edit_distance", ref, hyp, ref_lens, hyp_lens)
    args = (
        ref, hyp, ref_lens, hyp_lens, float(ins_cost), float(del_cost), float(sub_cost),
        bool(exclude_last),
    )
    if _traced():
        return torch.ops.pydrobert_tpu_torch.edit_distance(*args)
    if not ref.is_cuda:
        return edit_distance_reference(*args)
    return _edit_distance_launch(*args)


def _edit_distance_launch(
    ref: torch.Tensor,
    hyp: torch.Tensor,
    ref_lens: torch.Tensor,
    hyp_lens: torch.Tensor,
    ins_cost: float,
    del_cost: float,
    sub_cost: float,
    exclude_last: bool,
) -> torch.Tensor:
    R, N = ref.shape
    H = hyp.shape[0]
    args = [
        a.to(torch.int32).contiguous() for a in (ref, hyp, ref_lens, hyp_lens)
    ]
    # one sequence's shared memory: none while a lane's strip of the row
    # fits its registers, else the strips, their reference tokens and the
    # hypothesis tokens' ring
    lib = _launch_args(
        args[0], load_library().pydt_edit_distance_warp_words(R), "edit_distance"
    )
    out = torch.empty((N,), dtype=torch.float32, device=ref.device)
    with torch.cuda.device(ref.device):
        err = lib.pydt_edit_distance(
            *(ctypes.c_void_p(a.data_ptr()) for a in args),
            R,
            H,
            N,
            float(ins_cost),
            float(del_cost),
            float(sub_cost),
            int(bool(exclude_last)),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(ref.device).cuda_stream),
        )
    _raise_on(err, "edit_distance")
    LAUNCHES["edit_distance"] += 1
    return out


_edit_distance_op = torch.library.custom_op(
    f"{_NS}::edit_distance", _edit_distance_launch, mutates_args=(), device_types="cuda"
)


@_edit_distance_op.register_kernel("cpu")
def _(ref, hyp, ref_lens, hyp_lens, ins_cost, del_cost, sub_cost, exclude_last):
    return edit_distance_reference(
        ref, hyp, ref_lens, hyp_lens, ins_cost, del_cost, sub_cost, exclude_last
    )


@_edit_distance_op.register_fake
def _(ref, hyp, ref_lens, hyp_lens, ins_cost, del_cost, sub_cost, exclude_last):
    return ref.new_empty((ref.shape[1],), dtype=torch.float32)


# whole-loop CTC prefix beam search

_BEAM_DUMMY = -1.0e30  # mass of the placeholder beams at t = 0
_BEAM_SMEM_LIMIT = 232_448  # an H100 block's opt-in shared memory


def _beam_smem_bytes(T: int, W: int, M: int) -> int:
    """Shared memory of one block of ``csrc/ctc_beam.cu`` (its layout, in
    4-byte words: two (W, T) path buffers, T rounded up to a multiple of 4,
    the (W, pad) top-W keys, ``pad`` being W rounded up to a power of two of
    at least 8, three (W, W) matrices, three M-rows, 14 W-rows and the
    blank)."""
    pad = max(8, 1 << max(int(W) - 1, 0).bit_length())
    stride = -(-int(T) // 4) * 4
    return 4 * (2 * W * stride + 3 * W * W + W * pad + 3 * M + 14 * W + 1)


def ctc_beam_search_fits(T: int, N: int, V: int, width: int) -> bool:
    """Whether :func:`ctc_beam_search`'s kernel takes this shape: its beam
    state, candidate grid and two ``(width, T)`` path buffers fit one
    block's 232,448 bytes of shared memory (counterpart of the JAX
    package's ``ctc_beam_search_vmem_ok``; ``N`` does not matter, one block
    runs each batch row)."""
    return _beam_smem_bytes(int(T), int(width), min(int(V), 2 * int(width))) <= (
        _BEAM_SMEM_LIMIT
    )


def _check_beam_args(nonext_probs, blank_probs, lens, width, top):
    if nonext_probs.dim() != 3:
        raise ValueError("nonext_probs must be (T, N, V)")
    T, N, V = nonext_probs.shape
    W = int(width)
    if not 1 <= W <= min(32, V):
        raise ValueError(f"width must be in [1, min(32, V) = {min(32, V)}], got {W}")
    M = min(V, 2 * W)
    if nonext_probs.dtype != torch.float32 or blank_probs.dtype != torch.float32:
        raise TypeError("nonext_probs and blank_probs must be float32")
    if tuple(blank_probs.shape) != (T, N) or tuple(lens.shape) != (N,):
        raise ValueError(
            f"blank_probs must be ({T}, {N}) and lens ({N},), got "
            f"{tuple(blank_probs.shape)} and {tuple(lens.shape)}"
        )
    if lens.is_floating_point() or lens.dtype == torch.bool:
        raise TypeError(f"lens must hold integers, got {lens.dtype}")
    if top is not None:
        tv, ti = top
        if tuple(tv.shape) != (T, N, M) or tuple(ti.shape) != (T, N, M):
            raise ValueError(f"top must be two ({T}, {N}, {M}) tensors")
        if tv.dtype != torch.float32 or ti.dtype != torch.int32:
            raise TypeError("top must be (float32 values, int32 indices)")
    for name, a in (("blank_probs", blank_probs), ("lens", lens)) + (
        () if top is None else (("top values", top[0]), ("top indices", top[1]))
    ):
        if a.device != nonext_probs.device:
            raise ValueError(f"{name} must be on nonext_probs' device")
    return T, N, V, W, M


def ctc_beam_search_reference(
    nonext_probs: torch.Tensor,
    blank_probs: torch.Tensor,
    lens: torch.Tensor,
    width: int,
    top: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`ctc_beam_search`: the JAX package's kernel
    simulator (``ctc_beam_search_reference`` over ``_ctc_beam_step_math``)
    in flat form, one frame at a time, with gathers where it has one-hot
    sums.

    The one-hot sums pick one term and add zeros, so a picked ``-0.0``
    comes out ``+0.0``; the gathers here add ``0.0`` to match. Candidates
    rank by value descending with ``-0.0 == +0.0`` (float comparison, as
    ``_rank_top_w`` does) and ties to the lowest flat index ``k * S + s``.
    """
    T, N, V, W, M = _check_beam_args(nonext_probs, blank_probs, lens, width, top)
    if top is None:
        top = top_m_reference(nonext_probs, M)
    tv_all, ti_all = top[0], top[1].long()
    dev = nonext_probs.device
    S = M + 2
    lens = lens.long()
    beam = torch.arange(W, device=dev)
    nb = torch.where(beam == 0, 0.0, _BEAM_DUMMY).expand(N, W).contiguous()
    b = torch.where(beam == 0, 1.0, _BEAM_DUMMY).expand(N, W).contiguous()
    y_lens = torch.zeros((N, W), dtype=torch.long, device=dev)
    last = torch.zeros((N, W), dtype=torch.long, device=dev)
    ip = torch.eye(W, dtype=torch.bool, device=dev).expand(N, W, W)
    ybuf = torch.zeros((N, W, T), dtype=torch.long, device=dev)
    t_pos = torch.arange(T, device=dev)
    for t in range(T):
        valid = (t < lens)[:, None]  # (N, 1)
        tv, ti = tv_all[t], ti_all[t]  # (N, M)
        p_last = torch.gather(nonext_probs[t], 1, last)  # (N, W)
        tot = nb + b
        shared_is_last = ti[:, None, :] == last[:, :, None]  # (N, W, M)
        shared = torch.where(shared_is_last, b[..., None], tot[..., None]) * tv[:, None]
        last_sc = torch.where(shared_is_last.any(2), -math.inf, b * p_last)
        b_ne = tot * blank_probs[t][:, None]
        # exact[n, k, j]: beam j is beam k extended by one token
        exact = ((y_lens + 1)[:, :, None] == y_lens[:, None, :]) & ip
        tm = torch.where(
            last[:, None, :] == last[:, :, None], b[:, :, None], tot[:, :, None]
        )
        absorbed = torch.where(exact, tm * p_last[:, None, :], 0.0).sum(1)
        nb_ne = nb * p_last + absorbed
        cand_tok = torch.cat([ti[:, None].expand(N, W, M), last[..., None]], 2)
        removed = (
            exact[:, :, None, :] & (cand_tok[..., None] == last[:, None, None, :])
        ).any(3)
        ext = torch.where(removed, -math.inf, torch.cat([shared, last_sc[..., None]], 2))
        scores = torch.cat([ext, (nb_ne + b_ne)[..., None]], 2) + 0.0  # (N, W, S)
        val, ind = exact_top_k(scores.reshape(N, W * S), W)

        slot, src = ind % S, ind // S
        is_ne = slot == S - 1
        last_src = torch.gather(last, 1, src)
        ext_tok = torch.where(
            slot < M, torch.gather(ti, 1, slot.clamp(max=M - 1)), last_src
        )
        q = torch.gather(y_lens, 1, src)
        nb_n = torch.where(is_ne, torch.gather(nb_ne, 1, src) + 0.0, val)
        b_n = torch.where(is_ne, torch.gather(b_ne, 1, src) + 0.0, 0.0)
        lens_n = q + (~is_ne)
        # ip2[n, k, j] = ip[n, src_k, src_j]
        ip2 = torch.gather(
            torch.gather(ip, 1, src[..., None].expand(N, W, W)), 2,
            src[:, None, :].expand(N, W, W),
        )
        p = (lens_n - 1).clamp(min=0)
        src_eff = torch.where(valid, src, beam[None])
        pos_eff = torch.where(valid & ~is_ne, q, -1)
        cols = torch.gather(ybuf, 1, src_eff[..., None].expand(N, W, T))
        ybuf_n = torch.where(t_pos == pos_eff[..., None], ext_tok[..., None], cols)
        # old_val[n, k, j]: new beam j's token at position p[n, k]
        old_val = torch.gather(ybuf_n, 2, p[:, None, :].expand(N, W, W)).transpose(1, 2)
        to_match = torch.where(
            p[:, :, None] == q[:, None, :], ext_tok[:, None, :], old_val
        )
        ip_n = (
            ip2
            & (lens_n[:, :, None] <= lens_n[:, None, :])
            & (is_ne[:, :, None] | (to_match == ext_tok[:, :, None]))
        )
        nb = torch.where(valid, nb_n, nb)
        b = torch.where(valid, b_n, b)
        y_lens = torch.where(valid, lens_n, y_lens)
        last = torch.where(valid, ext_tok, last)
        ip = torch.where(valid[..., None], ip_n, ip)
        ybuf = ybuf_n
    y_probs = nb + b
    y_probs = torch.where((lens == 0)[:, None] & (beam > 0), -math.inf, y_probs)
    return ybuf.permute(2, 0, 1), y_lens, y_probs


def ctc_beam_search(
    nonext_probs: torch.Tensor,
    blank_probs: torch.Tensor,
    lens: torch.Tensor,
    width: int,
    top: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole no-LM CTC prefix beam search over ``T`` frames in one
    launch.

    ``nonext_probs (T, N, V)`` and ``blank_probs (T, N)`` are float32
    probabilities (the blank's apart), ``lens (N,)`` the valid frames of
    each row and ``width`` the number of beams, at most ``min(32, V)``.
    ``top`` is the exact top-``M`` (``M = min(V, 2 * width)``) of
    ``nonext_probs`` as :func:`top_m` gives it, taken here when None.
    Returns ``(y (T, N, W) long, y_lens (N, W) long, y_probs (N, W)
    float32)``: paths, lengths and raw (not renormalized) masses of the
    beams, best first; rows with ``lens == 0`` give the empty prefix at
    probability 1 and the other beams at ``-inf``. Tokens past a beam's
    length are unspecified.
    """
    T, N, V, W, M = _check_beam_args(nonext_probs, blank_probs, lens, width, top)
    _check_local("ctc_beam_search", nonext_probs, blank_probs, lens, *(top or ()))
    if top is None:
        top = top_m(nonext_probs, M)
    if _traced():
        return torch.ops.pydrobert_tpu_torch.ctc_beam_search(
            nonext_probs, blank_probs, lens, W, top[0], top[1]
        )
    if not nonext_probs.is_cuda:
        return ctc_beam_search_reference(nonext_probs, blank_probs, lens, W, top)
    return _ctc_beam_search_launch(nonext_probs, blank_probs, lens, W, top[0], top[1])


def _ctc_beam_search_launch(
    nonext_probs: torch.Tensor,
    blank_probs: torch.Tensor,
    lens: torch.Tensor,
    width: int,
    top_vals: torch.Tensor,
    top_inds: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    T, N, V = nonext_probs.shape
    W, M = width, top_vals.shape[-1]
    if not ctc_beam_search_fits(T, N, V, W):
        raise ValueError(
            f"ctc_beam_search: T={T}, width={W} needs "
            f"{_beam_smem_bytes(T, W, M)} bytes of shared memory, more than "
            f"{_BEAM_SMEM_LIMIT}"
        )
    args = [nonext_probs, blank_probs, top_vals, top_inds]
    if not all(a.is_contiguous() for a in args):
        raise ValueError("ctc_beam_search: the inputs must be contiguous")
    dev = nonext_probs.device
    lens32 = lens.to(torch.int32).contiguous()
    y = torch.empty((T, N, W), dtype=torch.long, device=dev)
    y_lens = torch.empty((N, W), dtype=torch.long, device=dev)
    y_probs = torch.empty((N, W), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.pydt_ctc_beam_search(
            *(ctypes.c_void_p(a.data_ptr()) for a in (top_vals, top_inds, nonext_probs)),
            ctypes.c_void_p(blank_probs.data_ptr()),
            ctypes.c_void_p(lens32.data_ptr()),
            T,
            N,
            V,
            W,
            M,
            ctypes.c_void_p(y.data_ptr()),
            ctypes.c_void_p(y_lens.data_ptr()),
            ctypes.c_void_p(y_probs.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    _raise_on(err, "ctc_beam_search")
    LAUNCHES["ctc_beam_search"] += 1
    return y, y_lens, y_probs


_ctc_beam_search_op = torch.library.custom_op(
    f"{_NS}::ctc_beam_search", _ctc_beam_search_launch, mutates_args=(), device_types="cuda"
)


@_ctc_beam_search_op.register_kernel("cpu")
def _(nonext_probs, blank_probs, lens, width, top_vals, top_inds):
    y, y_lens, y_probs = ctc_beam_search_reference(
        nonext_probs, blank_probs, lens, width, (top_vals, top_inds)
    )
    return y.contiguous(), y_lens, y_probs  # the kernel's layout


@_ctc_beam_search_op.register_fake
def _(nonext_probs, blank_probs, lens, width, top_vals, top_inds):
    # the outputs' shapes depend on T, N and the width only
    T, N, _ = nonext_probs.shape
    return (
        nonext_probs.new_empty((T, N, width), dtype=torch.long),
        nonext_probs.new_empty((N, width), dtype=torch.long),
        nonext_probs.new_empty((N, width), dtype=torch.float32),
    )


def _check_renorm_args(logits, top_vals, top_inds, sm_max, sm_den, blank_probs, lens, width):
    if logits.dim() != 3:
        raise ValueError("logits must be (T, N, V + 1)")
    _check_input(logits, "ctc_beam_search_renorm")
    T, N, Vp1 = logits.shape
    V = Vp1 - 1
    W = int(width)
    if not 1 <= W <= min(32, V):
        raise ValueError(f"width must be in [1, min(32, V) = {min(32, V)}], got {W}")
    M = min(V, 2 * W)
    if tuple(top_vals.shape) != (T, N, M) or tuple(top_inds.shape) != (T, N, M):
        raise ValueError(f"the top values and indices must be ({T}, {N}, {M})")
    if top_vals.dtype != torch.float32 or top_inds.dtype != torch.int32:
        raise TypeError("the top values must be float32 and the indices int32")
    for name, a in (("sm_max", sm_max), ("sm_den", sm_den), ("blank_probs", blank_probs)):
        if tuple(a.shape) != (T, N) or a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 ({T}, {N}), got {a.dtype} {tuple(a.shape)}")
    if tuple(lens.shape) != (N,):
        raise ValueError(f"lens must be ({N},), got {tuple(lens.shape)}")
    if lens.is_floating_point() or lens.dtype == torch.bool:
        raise TypeError(f"lens must hold integers, got {lens.dtype}")
    for a in (top_vals, top_inds, sm_max, sm_den, blank_probs, lens):
        if a.device != logits.device:
            raise ValueError("every input must be on the logits' device")
    return T, N, V, W, M


def ctc_beam_search_renorm_reference(
    logits: torch.Tensor,
    top_vals: torch.Tensor,
    top_inds: torch.Tensor,
    sm_max: torch.Tensor,
    sm_den: torch.Tensor,
    blank_probs: torch.Tensor,
    lens: torch.Tensor,
    width: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`ctc_beam_search_renorm`: the prefix search's
    own per-frame scan with its rescales
    (:func:`pydrobert_tpu_torch.ops._ctc_scan.prefix_scan`, no LM), over
    the same prologue outputs."""
    _check_renorm_args(logits, top_vals, top_inds, sm_max, sm_den, blank_probs, lens, width)
    frames = (top_vals, top_inds.long(), logits, sm_max, sm_den, blank_probs)
    return prefix_scan(frames, lens.long(), int(width), logits.shape[2] - 1, True)


def ctc_beam_search_renorm(
    logits: torch.Tensor,
    top_vals: torch.Tensor,
    top_inds: torch.Tensor,
    sm_max: torch.Tensor,
    sm_den: torch.Tensor,
    blank_probs: torch.Tensor,
    lens: torch.Tensor,
    width: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The no-LM CTC prefix search with ``DECODE_RENORM`` on in one launch.

    Takes what the search's decode prologue gives for ``logits (T, N, V +
    1)`` (float32 or bfloat16, blank last): the exact top-``M`` (``M =
    min(V, 2 * width)``) values ``exp(top_lgts - sm_max) / sm_den`` float32
    and indices int32 ``(T, N, M)``, the softmax's ``sm_max`` and ``sm_den``
    and the blank's probabilities ``(T, N)`` float32, and ``lens (N,)``.
    Every row is rescaled by a power of two after each frame from the
    second, as the scan does. Returns ``(y (T, N, W) long, y_lens (N, W)
    long, mass (N, W) float32, ls (N,) int32)``: paths, lengths, the raw
    masses ``nb + b`` (negative for a placeholder beam) and each row's
    summed exponent, so that the probabilities are ``mass * 2**ls``. Equal
    to the scan bit for bit, tokens past a beam's length aside.
    """
    T, N, V, W, M = _check_renorm_args(
        logits, top_vals, top_inds, sm_max, sm_den, blank_probs, lens, width
    )
    args = (logits, top_vals, top_inds, sm_max, sm_den, blank_probs, lens)
    _check_local("ctc_beam_search_renorm", *args)
    if _traced():
        return torch.ops.pydrobert_tpu_torch.ctc_beam_search_renorm(*args, W)
    if not logits.is_cuda:
        return ctc_beam_search_renorm_reference(*args, W)
    return _ctc_beam_search_renorm_launch(*args, W)


def _ctc_beam_search_renorm_launch(
    logits: torch.Tensor,
    top_vals: torch.Tensor,
    top_inds: torch.Tensor,
    sm_max: torch.Tensor,
    sm_den: torch.Tensor,
    blank_probs: torch.Tensor,
    lens: torch.Tensor,
    width: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    T, N, Vp1 = logits.shape
    V, W, M = Vp1 - 1, width, top_vals.shape[-1]
    if not ctc_beam_search_fits(T, N, V, W):
        raise ValueError(
            f"ctc_beam_search_renorm: T={T}, width={W} needs "
            f"{_beam_smem_bytes(T, W, M)} bytes of shared memory, more than "
            f"{_BEAM_SMEM_LIMIT}"
        )
    args = [top_vals, top_inds, logits, sm_max, sm_den, blank_probs]
    if not all(a.is_contiguous() for a in args):
        raise ValueError("ctc_beam_search_renorm: the inputs must be contiguous")
    dev = logits.device
    lens32 = lens.to(torch.int32).contiguous()
    y = torch.empty((T, N, W), dtype=torch.long, device=dev)
    y_lens = torch.empty((N, W), dtype=torch.long, device=dev)
    mass = torch.empty((N, W), dtype=torch.float32, device=dev)
    ls = torch.empty((N,), dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.pydt_ctc_beam_search_renorm(
            *(ctypes.c_void_p(a.data_ptr()) for a in (top_vals, top_inds, logits)),
            _DTYPE_CODE[logits.dtype],
            *(ctypes.c_void_p(a.data_ptr()) for a in (sm_max, sm_den, blank_probs, lens32)),
            T,
            N,
            V,
            W,
            M,
            *(ctypes.c_void_p(a.data_ptr()) for a in (y, y_lens, mass, ls)),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    _raise_on(err, "ctc_beam_search_renorm")
    LAUNCHES["ctc_beam_search_renorm"] += 1
    return y, y_lens, mass, ls


_ctc_beam_search_renorm_op = torch.library.custom_op(
    f"{_NS}::ctc_beam_search_renorm",
    _ctc_beam_search_renorm_launch,
    mutates_args=(),
    device_types="cuda",
)


@_ctc_beam_search_renorm_op.register_kernel("cpu")
def _(logits, top_vals, top_inds, sm_max, sm_den, blank_probs, lens, width):
    y, y_lens, mass, ls = ctc_beam_search_renorm_reference(
        logits, top_vals, top_inds, sm_max, sm_den, blank_probs, lens, width
    )
    return y.contiguous(), y_lens, mass, ls  # the kernel's layout


@_ctc_beam_search_renorm_op.register_fake
def _(logits, top_vals, top_inds, sm_max, sm_den, blank_probs, lens, width):
    T, N, _ = logits.shape
    return (
        logits.new_empty((T, N, width), dtype=torch.long),
        logits.new_empty((N, width), dtype=torch.long),
        logits.new_empty((N, width), dtype=torch.float32),
        logits.new_empty((N,), dtype=torch.int32),
    )


def _check_dw_args(y, kernel, bias, left):
    if y.dim() != 3:
        raise ValueError("y must be (N, T, C)")
    if kernel.dim() != 2 or kernel.shape[0] < 1 or kernel.shape[1] != y.shape[2]:
        raise ValueError(f"kernel must be (K, {y.shape[2]}) with K >= 1, got {tuple(kernel.shape)}")
    if tuple(bias.shape) != (y.shape[2],):
        raise ValueError(f"bias must have shape ({y.shape[2]},), got {tuple(bias.shape)}")
    if not 0 <= left < kernel.shape[0]:
        raise ValueError(f"left must be in [0, {kernel.shape[0]}), got {left}")
    for name, a in (("kernel", kernel), ("bias", bias)):
        if a.device != y.device:
            raise ValueError(f"{name} must be on y's device ({y.device})")


def depthwise_conv1d_reference(
    y: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, left: int
) -> torch.Tensor:
    """Plain version of :func:`depthwise_conv1d`: the JAX package's K shifted
    multiply-adds in ``y``'s dtype, each product and sum rounded to it, from
    the bias in order of the taps (2K elementwise launches on the card)."""
    K, T = kernel.shape[0], y.shape[1]
    w = kernel.to(y.dtype)
    yp = torch.nn.functional.pad(y, (0, 0, left, K - 1 - left))
    out = bias.to(y.dtype)
    for k in range(K):
        out = out + yp[:, k : k + T] * w[k]
    return out


def depthwise_conv1d(
    y: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, left: int
) -> torch.Tensor:
    """A depthwise convolution over time in one pass: ``out[n, t, c] =
    bias[c] + sum_k y[n, t + k - left, c] * kernel[k, c]`` for ``y (N, T,
    C)``, ``kernel (K, C)`` and ``bias (C,)``, rows outside ``[0, T)`` zero.
    It computes in ``y``'s dtype (float32 or bfloat16 on the card) from
    float32 or bfloat16 parameters, rounding each product and each sum to
    that dtype in the order of the taps, so it equals
    :func:`depthwise_conv1d_reference` bit for bit.
    """
    _check_dw_args(y, kernel, bias, left)
    _check_local("depthwise_conv1d", y, kernel, bias)
    if _traced():
        return torch.ops.pydrobert_tpu_torch.depthwise_conv1d(y, kernel, bias, left)
    if not y.is_cuda:
        return depthwise_conv1d_reference(y, kernel, bias, left)
    return _depthwise_conv1d_launch(y, kernel, bias, left)


def _depthwise_conv1d_launch(
    y: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, left: int
) -> torch.Tensor:
    _check_input(y, "depthwise_conv1d")
    for name, a in (("kernel", kernel), ("bias", bias)):
        if a.dtype not in _DTYPE_CODE:
            raise TypeError(f"depthwise_conv1d takes a float32 or bfloat16 {name}, got {a.dtype}")
    N, T, C = y.shape
    K = kernel.shape[0]
    x = y.contiguous()
    # the kernel reads float32 parameters; a bfloat16 one widens exactly
    w, b = kernel.float().contiguous(), bias.float().contiguous()
    out = torch.empty_like(x)
    vec = 16 // x.element_size()
    if C % vec or x.data_ptr() % 16 or out.data_ptr() % 16:
        vec = 1
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.pydt_depthwise_conv1d(
            ctypes.c_void_p(x.data_ptr()), _DTYPE_CODE[x.dtype],
            ctypes.c_void_p(w.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            N, T, C, K, left, vec, ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
        )
    _raise_on(err, "depthwise_conv1d")
    LAUNCHES["depthwise_conv1d"] += 1
    return out


_depthwise_conv1d_op = torch.library.custom_op(
    f"{_NS}::depthwise_conv1d", _depthwise_conv1d_launch, mutates_args=(),
    device_types="cuda",
)


@_depthwise_conv1d_op.register_kernel("cpu")
def _(y, kernel, bias, left):
    return depthwise_conv1d_reference(y, kernel, bias, left)


@_depthwise_conv1d_op.register_fake
def _(y, kernel, bias, left):
    return y.new_empty(y.shape)
