"""Edit distances, error rates, prefix error rates, optimal completion and
the losses built on them (counterpart of :mod:`pydrobert_tpu.ops.string`).

The DP takes the JAX package's routing: the ``edit_distance`` kernel
(:mod:`pydrobert_tpu_torch.ops.kernels`) for a distance (or an error rate
at uniform costs) whenever the reference is non-empty and there is at least
one hypothesis step; the plain DP of the JAX package's
``_string_matching_jit`` otherwise, and always for mistake counts
(an error rate at non-uniform costs), prefix distances and the optimal
completion mask, as in the JAX package (its kernel takes none of them).

The plain DP advances one hypothesis token at a time and relaxes the
deletions in closed form, ``cummin(row - i*del) + i*del``. Counting
mistakes also needs the index of the last minimum of that scan (ties go to
"no deletion"); :func:`_cummin_last_argmin` reads it off two library
scans, the values of ``torch.cummin`` and then a ``torch.cummax`` over the
positions where a value equals its running minimum, so it depends on no
tie order of ``torch.cummin``'s indices.

The warnings read device data (``bool()`` on a CUDA tensor is a host
sync); pass ``warn=False`` where a call must not wait on the card.
"""

import warnings
from typing import Optional, Tuple

import torch

from .. import config, default_device
from . import kernels
from ._softmax import log_softmax, softmax

__all__ = [
    "edit_distance",
    "error_rate",
    "fill_after_eos",
    "hard_optimal_completion_distillation_loss",
    "minimum_error_rate_loss",
    "optimal_completion",
    "prefix_edit_distances",
    "prefix_error_rates",
]


def _maybe_warn(cond, msg: str, warn: bool) -> None:
    if warn and bool(cond):
        warnings.warn(msg)


def fill_after_eos(
    tokens: torch.Tensor,
    eos: int,
    axis: int = 0,
    fill: Optional[float] = None,
    value: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``value`` (``tokens`` when None; broadcast against it) with every
    position after the first ``eos`` along ``axis`` of ``tokens`` set to
    ``fill`` (``eos`` when None)."""
    out = tokens if value is None else value
    fill_ = eos if fill is None else fill
    hit = (tokens == eos).to(torch.int32)
    fill_mask = torch.cumsum(hit, axis).clamp(max=1).cumsum(axis) > 1
    out, fill_mask = torch.broadcast_tensors(out, fill_mask)
    return torch.where(
        fill_mask, torch.tensor(fill_, dtype=out.dtype, device=out.device), out
    )


def _lens_from_eos(tok: torch.Tensor, eos: int, axis: int) -> torch.Tensor:
    """Index of the first ``eos`` along ``axis``, or the axis' length if
    there is none."""
    if tok.shape[axis] == 0:
        shape = list(tok.shape)
        del shape[axis]
        return torch.zeros(shape, dtype=torch.int32, device=tok.device)
    mask = tok == eos
    arg = torch.argmax(mask.to(torch.uint8), dim=axis)  # the first on ties
    return torch.where(mask.any(axis), arg, tok.shape[axis]).to(torch.int32)


def _as_tensor(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    dev = default_device() if like is None else like.device
    return torch.as_tensor(x, device=dev)


def _cummin_last_argmin(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cumulative (min, index of the last min) along dim 0, ties to the
    later index, as the JAX package's associative scan. Only the values of
    the library scans are read, so their own tie order never matters: the
    last ``j <= i`` where ``u[j]`` is its running minimum holds ``umin[i]``.
    Where no such ``j`` is (NaN from the start, as at ``del_cost=inf``) the
    index is 0, as the JAX package's combine keeps the left operand."""
    umin = torch.cummin(u, 0).values
    arange = torch.arange(u.shape[0], device=u.device)[:, None]
    jstar = torch.cummax(torch.where(u == umin, arange, 0), 0).values
    return umin, jstar


def _string_matching_dp(
    ref, hyp, ref_lens, hyp_lens, ins_cost, del_cost, sub_cost, norm,
    return_mask, return_prf_dsts, exclude_last, padding, return_mistakes,
    batch_first, mult,
):
    """The plain DP of the JAX package's ``_string_matching_jit`` over
    time-major ``ref (R, N)`` and ``hyp (H, N)``, step for step."""
    R, N = ref.shape
    H = hyp.shape[0]
    dev = ref.device
    f32 = torch.float32
    off = 0 if exclude_last else 1
    hyp_lens = hyp_lens.to(torch.int32)
    ref_lens = ref_lens.to(torch.int32)
    rrange = torch.arange(R + 1, dtype=f32, device=dev)[:, None]  # (R+1, 1)
    del_shift = rrange * del_cost
    row = del_shift.expand(R + 1, N)
    mistakes = rrange.expand(R + 1, N)
    outs = []
    for t in range(1, H + off):
        not_done = ((t - off) < hyp_lens)[None]
        ins_mask = (hyp_lens >= t).to(f32)
        neq = ref != hyp[t - 1][None]
        up = row + ins_cost * ins_mask[None]
        # a match adds exactly 0, also at sub_cost=inf: XLA compiles the JAX
        # package's sub_cost * neq as a select
        sub = row[:-1] + torch.where(neq, sub_cost, 0.0)
        if return_mistakes:
            # substitutions beat insertions on ties
            pick_sub = up[1:] >= sub
            new = torch.cat([up[:1], torch.where(pick_sub, sub, up[1:])], 0)
            mup = mistakes + ins_mask[None]
            msub = mistakes[:-1] + neq.to(f32)
            new_m = torch.cat([mup[:1], torch.where(pick_sub, msub, mup[1:])], 0)
            umin, jstar = _cummin_last_argmin(new - del_shift)
            new = umin + del_shift
            new_m = torch.gather(new_m, 0, jstar) + (rrange - jstar.to(f32))
            mistakes = torch.where(not_done, new_m, mistakes)
        else:
            new = torch.cat([up[:1], torch.minimum(up[1:], sub)], 0)
            new = torch.cummin(new - del_shift, 0).values + del_shift
        row = torch.where(not_done, new, row)
        if return_mask:
            # the minima of the row within each reference mark the optimal
            # next reference positions
            masked = torch.where(rrange > ref_lens[None], torch.inf, row)
            mins = masked.amin(0, keepdim=True)
            outs.append((masked[:-1] == mins) & not_done)
        elif return_prf_dsts:
            src = mistakes if return_mistakes else row
            outs.append(torch.gather(src, 0, ref_lens.long()[None])[0])

    if return_mask:
        first = torch.zeros((R, N), dtype=torch.bool, device=dev)
        if R:
            first[0] = ref_lens > 0
        mask = torch.stack([first] + outs, 0)
        valid_ref = torch.arange(R, device=dev)[:, None] < ref_lens[None]
        return mask & valid_ref[None]

    if return_prf_dsts:
        first = ref_lens.to(f32) * (1.0 if return_mistakes else del_cost)
        prefix = torch.stack([first] + outs, 0) * mult
        if norm:
            safe = ref_lens.clamp(min=1).to(f32)
            fallback = (torch.arange(prefix.shape[0], device=dev) > 0).to(f32)[:, None]
            prefix = torch.where((ref_lens == 0)[None], fallback, prefix / safe[None])
        P = prefix.shape[0]
        pad_mask = torch.arange(P, device=dev)[:, None] >= (hyp_lens[None] + off)
        prefix = torch.where(pad_mask, torch.tensor(float(padding), dtype=f32, device=dev), prefix)
        return prefix.T if batch_first else prefix

    src = mistakes if return_mistakes else row
    return torch.gather(src, 0, ref_lens.long().clamp(0, R)[None])[0]


def _string_matching(
    ref,
    hyp,
    eos,
    include_eos,
    batch_first,
    ins_cost,
    del_cost,
    sub_cost,
    warn,
    norm=False,
    return_mask=False,
    return_prf_dsts=False,
    exclude_last=False,
    padding=config.INDEX_PAD_VALUE,
    return_mistakes=False,
):
    """Validation, eos handling and the uniform-cost shortcut around the
    DP, routed as the JAX package's ``_string_matching`` routes it."""
    assert not return_mask or not return_prf_dsts
    ref = _as_tensor(ref)
    hyp = _as_tensor(hyp, ref)
    if ref.dim() != 2 or hyp.dim() != 2:
        raise RuntimeError("ref and hyp must be 2 dimensional")
    mult = 1.0
    ins_cost = float(ins_cost)
    del_cost = float(del_cost)
    sub_cost = float(sub_cost)
    if ins_cost == del_cost == sub_cost > 0.0:
        # the uniform-cost shortcut: distances in unit steps, scaled after
        if not return_mistakes:
            mult = ins_cost
        ins_cost = del_cost = sub_cost = 1.0
        return_mistakes = False
    else:
        _maybe_warn(
            return_mistakes,
            "The behaviour for non-uniform error rates differs from edit "
            "distances. Set warn=False to suppress this warning",
            warn,
        )
    if batch_first:
        ref, hyp = ref.T, hyp.T
    R, N = ref.shape
    H, N_ = hyp.shape
    if N != N_:
        raise RuntimeError(f"ref has batch size {N}, but hyp has {N_}")
    if eos is not None:
        ref_lens = _lens_from_eos(ref, eos, 0)
        hyp_lens = _lens_from_eos(hyp, eos, 0)
        if include_eos:
            ref_eq = ref_lens == R
            _maybe_warn(
                ref_eq.any(),
                f"include_eos=True, but a transcription in ref did not contain "
                f"the eos symbol ({eos}). To suppress this warning, set "
                f"warn=False",
                warn,
            )
            ref_lens = ref_lens + 1 - ref_eq.to(ref_lens.dtype)
            hyp_eq = hyp_lens == H
            _maybe_warn(
                hyp_eq.any(),
                f"include_eos=True, but a transcription in hyp did not contain "
                f"the eos symbol ({eos}). To suppress this warning, set "
                f"warn=False",
                warn,
            )
            hyp_lens = hyp_lens + 1 - hyp_eq.to(hyp_lens.dtype)
    else:
        ref_lens = torch.full((N,), R, dtype=torch.int32, device=ref.device)
        hyp_lens = torch.full((N,), H, dtype=torch.int32, device=ref.device)
    if norm:
        _maybe_warn(
            (ref_lens == 0).any(),
            "ref contains empty transcripts. Error rates will be 0 for "
            "prefixes of length 0, 1 otherwise. To suppress this warning, set "
            "warn=False",
            warn,
        )
    if (
        not (return_mask or return_prf_dsts or return_mistakes)
        and R > 0
        and H + (0 if exclude_last else 1) > 1
    ):
        er = kernels.edit_distance(
            ref, hyp, ref_lens, hyp_lens, ins_cost, del_cost, sub_cost, exclude_last
        )
    else:
        # the JAX package runs its XLA DP for these (string.py:144-149), and
        # so does the port
        er = _string_matching_dp(
            ref, hyp, ref_lens, hyp_lens, ins_cost, del_cost, sub_cost, norm,
            return_mask, return_prf_dsts, exclude_last, padding,
            return_mistakes, batch_first, mult,
        )
        if return_mask or return_prf_dsts:
            return er
    er = er * mult
    if norm:
        safe = torch.clamp(ref_lens, min=1).float()
        er = torch.where(ref_lens == 0, (hyp_lens > 0).float(), er / safe)
    return er


def error_rate(
    ref: torch.Tensor,
    hyp: torch.Tensor,
    eos: Optional[int] = None,
    include_eos: bool = False,
    norm: bool = True,
    batch_first: bool = False,
    ins_cost: float = config.DEFT_INS_COST,
    del_cost: float = config.DEFT_DEL_COST,
    sub_cost: float = config.DEFT_SUB_COST,
    warn: bool = True,
) -> torch.Tensor:
    """Error rates ``(N,)`` between references and hypotheses.

    Counts the insertions, deletions and substitutions along the
    cost-minimizing alignment, divided by the reference length when
    ``norm``. ``ref (R, N)`` and ``hyp (H, N)`` are integer tokens
    (``(N, R)``, ``(N, H)`` with ``batch_first``), each cut at its first
    ``eos`` when one is given. At non-uniform costs the mistakes are
    counted along the cheapest alignment (ties: substitution over
    insertion over deletion) by the plain DP, never the kernel.
    """
    return _string_matching(
        ref, hyp, eos, include_eos, batch_first, ins_cost, del_cost, sub_cost,
        warn, norm=norm, return_mistakes=True,
    )


def edit_distance(
    ref: torch.Tensor,
    hyp: torch.Tensor,
    eos: Optional[int] = None,
    include_eos: bool = False,
    norm: bool = False,
    batch_first: bool = False,
    ins_cost: float = config.DEFT_INS_COST,
    del_cost: float = config.DEFT_DEL_COST,
    sub_cost: float = config.DEFT_SUB_COST,
    warn: bool = True,
) -> torch.Tensor:
    """Weighted Levenshtein distances ``(N,)`` between references and
    hypotheses; arguments as :func:`error_rate`."""
    return _string_matching(
        ref, hyp, eos, include_eos, batch_first, ins_cost, del_cost, sub_cost,
        warn, norm=norm,
    )


def prefix_error_rates(
    ref: torch.Tensor,
    hyp: torch.Tensor,
    eos: Optional[int] = None,
    include_eos: bool = True,
    norm: bool = True,
    batch_first: bool = False,
    ins_cost: float = config.DEFT_INS_COST,
    del_cost: float = config.DEFT_DEL_COST,
    sub_cost: float = config.DEFT_SUB_COST,
    padding: int = config.INDEX_PAD_VALUE,
    exclude_last: bool = False,
    warn: bool = True,
) -> torch.Tensor:
    """Error rates between each reference and every prefix of its
    hypothesis: ``(H + 1, N)`` (``(N, H + 1)`` with ``batch_first``; one
    prefix fewer with ``exclude_last``), ``padding`` past each hypothesis'
    length; other arguments as :func:`error_rate`."""
    return _string_matching(
        ref, hyp, eos, include_eos, batch_first, ins_cost, del_cost, sub_cost,
        warn, norm=norm, return_prf_dsts=True, exclude_last=exclude_last,
        padding=padding, return_mistakes=True,
    )


def prefix_edit_distances(
    ref: torch.Tensor,
    hyp: torch.Tensor,
    eos: Optional[int] = None,
    include_eos: bool = True,
    norm: bool = False,
    batch_first: bool = False,
    ins_cost: float = config.DEFT_INS_COST,
    del_cost: float = config.DEFT_DEL_COST,
    sub_cost: float = config.DEFT_SUB_COST,
    padding: int = config.INDEX_PAD_VALUE,
    exclude_last: bool = False,
    warn: bool = True,
) -> torch.Tensor:
    """Edit distances between each reference and every prefix of its
    hypothesis; shapes as :func:`prefix_error_rates`."""
    return _string_matching(
        ref, hyp, eos, include_eos, batch_first, ins_cost, del_cost, sub_cost,
        warn, norm=norm, return_prf_dsts=True, exclude_last=exclude_last,
        padding=padding, return_mistakes=False,
    )


def optimal_completion(
    ref: torch.Tensor,
    hyp: torch.Tensor,
    eos: Optional[int] = None,
    include_eos: bool = True,
    batch_first: bool = False,
    ins_cost: float = config.DEFT_INS_COST,
    del_cost: float = config.DEFT_DEL_COST,
    sub_cost: float = config.DEFT_SUB_COST,
    padding: int = config.INDEX_PAD_VALUE,
    exclude_last: bool = False,
    warn: bool = True,
) -> torch.Tensor:
    """The tokens that extend each hypothesis prefix optimally (for OCD).

    Returns ``(H', N, C)`` (``(N, H', C)`` with ``batch_first``): entry
    ``[h, n]`` lists, in ascending order, the distinct reference tokens
    whose continuation minimizes the future edit distance, right-padded
    with ``padding``. As in the JAX package, ``C`` is the reference length
    ``R`` and the result is always padded to it.
    """
    mask = _string_matching(
        ref, hyp, eos, include_eos, batch_first, ins_cost, del_cost, sub_cost,
        warn, return_mask=True, exclude_last=exclude_last,
    )
    ref = _as_tensor(ref, mask)
    if not batch_first:
        ref = ref.T
    targets = _mask_to_unique_targets(mask, ref, padding)
    return targets.transpose(0, 1) if batch_first else targets


def _mask_to_unique_targets(mask: torch.Tensor, ref: torch.Tensor, padding: int) -> torch.Tensor:
    """``(H, R, N)`` optimal-position mask and ``(N, R)`` references to
    ``(H, N, R)`` token sets: each optimal position marks every copy of its
    token, one copy of each is kept, and the kept tokens are left-packed,
    all with sorts and gathers. The JAX package marks the copies with an
    int32 ``einsum``; CUDA has no integer matmul, so the port takes the
    same counts as a float32 product (small integers, so exact)."""
    H, R, N = mask.shape
    mask = mask.transpose(1, 2)  # (H, N, R)
    eq = ref[:, :, None] == ref[:, None, :]  # (N, R, R)
    mask = torch.einsum("hnr,npr->hnp", mask.float(), eq.float()) > 0  # (H, N, R)
    ref_sorted, order = torch.sort(ref, dim=1, stable=True)
    mask = torch.gather(mask, 2, order[None].expand(H, N, R))
    # keep only the last of each run of equal tokens
    not_dup = torch.cat(
        [ref_sorted[:, :-1] != ref_sorted[:, 1:],
         torch.ones((N, min(R, 1)), dtype=torch.bool, device=ref.device)], 1
    )
    mask = mask & not_dup[None]
    # left-pack: a stable sort on "not selected" puts the selected first
    pack = torch.sort((~mask).to(torch.uint8), dim=2, stable=True).indices
    tokens = torch.gather(ref_sorted[None].expand(H, N, R), 2, pack)
    selected = torch.gather(mask, 2, pack)
    return torch.where(selected, tokens, torch.tensor(padding, dtype=tokens.dtype,
                                                       device=tokens.device))


def hard_optimal_completion_distillation_loss(
    logits: torch.Tensor,
    ref: torch.Tensor,
    hyp: torch.Tensor,
    eos: Optional[int] = None,
    include_eos: bool = True,
    batch_first: bool = False,
    ins_cost: float = config.DEFT_INS_COST,
    del_cost: float = config.DEFT_DEL_COST,
    sub_cost: float = config.DEFT_SUB_COST,
    weight: Optional[torch.Tensor] = None,
    reduction: str = "mean",
    ignore_index: int = -2,
    warn: bool = True,
) -> torch.Tensor:
    """Cross-entropy of each step's ``logits (H, N, V)`` (``(N, H, V)``
    with ``batch_first``) against the optimal completions of the
    hypothesis prefix before it (:func:`optimal_completion` with
    ``exclude_last``), averaged over each step's targets; ``weight (V,)``
    weighs the classes. ``reduction`` is ``"mean"`` (over each sequence's
    steps that have a target, then over sequences), ``"sum"`` or
    ``"none"``."""
    if logits.dim() != 3:
        raise RuntimeError("logits must be 3 dimensional")
    if logits.shape[:-1] != _as_tensor(hyp, logits).shape:
        raise RuntimeError("first two dims of logits must match hyp shape")
    if include_eos and eos is not None:
        if eos < 0 or eos >= logits.shape[-1]:
            raise RuntimeError(
                f"If include_eos=True, eos ({eos}) must be a class idx"
            )
        if eos == ignore_index:
            raise RuntimeError(
                f"If include_eos=True, eos cannot equal ignore_index ({eos})"
            )
    optimals = optimal_completion(
        ref, hyp, eos=eos, include_eos=include_eos, batch_first=batch_first,
        ins_cost=ins_cost, del_cost=del_cost, sub_cost=sub_cost,
        padding=ignore_index, exclude_last=True, warn=warn,
    ).long()  # (H, N, C) or (N, H, C)
    log_probs = log_softmax(logits, -1)
    pad_mask = optimals == ignore_index
    idx = torch.where(pad_mask, 0, optimals)
    gathered = torch.gather(log_probs, -1, idx)
    nll = -torch.where(pad_mask, 0.0, gathered)
    if weight is not None:
        w = _as_tensor(weight, logits)[idx]
        nll = nll * torch.where(pad_mask, 0.0, w)
    loss = nll.sum(-1) / (~pad_mask).sum(-1).clamp(min=1)
    if reduction == "mean":
        seq_axis = 1 if batch_first else 0
        denom = (~pad_mask).any(-1).sum(seq_axis).clamp(min=1)
        loss = (loss.sum(seq_axis) / denom).mean()
    elif reduction == "sum":
        loss = loss.sum()
    elif reduction != "none":
        raise RuntimeError(f"'{reduction}' is not a valid value for reduction")
    return loss


def minimum_error_rate_loss(
    log_probs: torch.Tensor,
    ref: torch.Tensor,
    hyp: torch.Tensor,
    eos: Optional[int] = None,
    include_eos: bool = True,
    sub_avg: bool = True,
    batch_first: bool = False,
    norm: bool = True,
    ins_cost: float = config.DEFT_INS_COST,
    del_cost: float = config.DEFT_DEL_COST,
    sub_cost: float = config.DEFT_SUB_COST,
    reduction: str = "mean",
    warn: bool = True,
) -> torch.Tensor:
    """The expected error rate over samples, weighted by the softmax of
    their path log probabilities ``log_probs (N, M)``.

    ``hyp`` is ``(H, N, M)`` (``(N, M, H)`` with ``batch_first``) and
    ``ref`` ``(R, N)`` or ``(R, N, M)`` (``(N, R)`` or ``(N, M, R)``). The
    error rates come from :func:`error_rate` (on the card, the
    edit-distance kernel) and carry no gradient; with ``sub_avg`` each
    utterance's mean rate is subtracted first. Pass ``warn=False`` where
    the call must not wait on the card."""
    if log_probs.dim() != 2:
        raise RuntimeError("log_probs must be 2 dimensional")
    if hyp.dim() != 3:
        raise RuntimeError("hyp must be 3 dimensional")
    if ref.dim() not in (2, 3):
        raise RuntimeError("ref must be 2 or 3 dimensional")
    if batch_first:
        batch_size, samples, max_hyp = hyp.shape
        if ref.dim() == 2:
            ref = ref[:, None].repeat_interleave(samples, 1)
        if ref.shape[:2] != (batch_size, samples) or ref.shape[:2] != log_probs.shape:
            raise RuntimeError("ref and hyp batch_size and sample dimensions must match")
        ref = ref.reshape(-1, ref.shape[-1])
        hyp = hyp.reshape(-1, max_hyp)
    else:
        max_hyp, batch_size, samples = hyp.shape
        if ref.dim() == 2:
            ref = ref[..., None].repeat_interleave(samples, -1)
        if ref.shape[1:] != (batch_size, samples) or ref.shape[1:] != log_probs.shape:
            raise RuntimeError("ref and hyp batch_size and sample dimensions must match")
        ref = ref.reshape(ref.shape[0], -1)
        hyp = hyp.reshape(max_hyp, -1)
    if samples < 2:
        raise RuntimeError(f"Batch must have at least two samples, got {samples}")
    er = error_rate(
        ref, hyp, eos=eos, include_eos=include_eos, norm=norm,
        batch_first=batch_first, ins_cost=ins_cost, del_cost=del_cost,
        sub_cost=sub_cost, warn=warn,
    ).reshape(batch_size, samples)
    if sub_avg:
        er = er - er.mean(1, keepdim=True)
    loss = er * softmax(log_probs, 1)
    if reduction == "mean":
        loss = loss.mean()
    elif reduction == "sum":
        loss = loss.sum()
    elif reduction != "none":
        raise RuntimeError(f"'{reduction}' is not a valid value for reduction")
    return loss
