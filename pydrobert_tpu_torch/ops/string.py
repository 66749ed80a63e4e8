"""Edit distances, error rates and the minimum-error-rate loss
(counterpart of part of :mod:`pydrobert_tpu.ops.string`).

Ported: :func:`edit_distance` and :func:`error_rate` with eos handling,
``include_eos``, ``norm``, ``batch_first`` and the uniform-cost shortcut;
:func:`fill_after_eos`; :func:`minimum_error_rate_loss`.
The DP takes the JAX package's routing: the ``edit_distance`` kernel
(:mod:`pydrobert_tpu_torch.ops.kernels`) whenever the reference is
non-empty and there is at least one hypothesis step, the JAX package's
plain DP otherwise (its kernel takes neither shape either).

An error rate with non-uniform costs counts the mistakes along the
cheapest alignment; that is not ported yet and raises
``NotImplementedError``, and the prefix variants, optimal completion and
the OCD loss are not ported yet.

The warnings read device data (``bool()`` on a CUDA tensor is a host
sync); pass ``warn=False`` where a call must not wait on the card.
"""

import warnings
from typing import Optional

import torch

from .. import config, default_device
from . import kernels

__all__ = ["edit_distance", "error_rate", "fill_after_eos", "minimum_error_rate_loss"]


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
    return_mistakes=False,
):
    """Validation, eos handling and the uniform-cost shortcut around the
    distance DP."""
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
    elif return_mistakes:
        raise NotImplementedError(
            "error rates with non-uniform costs (mistake counting along the "
            "cheapest alignment) are not ported yet"
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
    if R > 0 and H > 0:  # at least one hypothesis step (exclude_last is off)
        er = kernels.edit_distance(
            ref, hyp, ref_lens, hyp_lens, ins_cost, del_cost, sub_cost
        )
    else:
        # the JAX package runs its XLA DP for these shapes
        # (string.py:144-149), and so does the port
        er = kernels.edit_distance_reference(
            ref, hyp, ref_lens, hyp_lens, ins_cost, del_cost, sub_cost
        )
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
    ``eos`` when one is given. Only uniform costs are ported.
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
    loss = er * torch.softmax(log_probs, 1)
    if reduction == "mean":
        loss = loss.mean()
    elif reduction == "sum":
        loss = loss.sum()
    elif reduction != "none":
        raise RuntimeError(f"'{reduction}' is not a valid value for reduction")
    return loss
