"""CTC greedy and prefix beam search (counterpart of
:mod:`pydrobert_tpu.ops.decoding`, without language models so far).

:class:`CTCPrefixSearch` follows the JAX package's no-LM search step for
step: one hoisted decode prologue over the whole ``(T, N, V + 1)`` logits
(:func:`pydrobert_tpu_torch.ops.kernels.decode_prologue`, a Hopper kernel
on the card), then one factored advance per frame, in a Python loop, over
the shared top-``M`` tokens, each beam's last token and its
non-extension. Every candidate selection is an exact top-k in the IEEE
total order with ties lowest index first, so hypotheses, lengths and beam
order match the JAX search exactly.

The JAX package's TPU layout devices (the rank-compaction top-K, one-hot
contractions in place of gathers, the float16 path buffer, the packed
per-frame row) give results identical to the flat forms by construction
and have no counterpart here. Where those contractions turn a picked
``-0.0`` into ``+0.0`` the port adds ``0.0`` to the gathered value, so the
total-order ranking of zero masses agrees.
"""

from typing import Optional, Tuple

import torch

from .. import argcheck, config
from .kernels import decode_prologue
from .topk import exact_top_k

__all__ = [
    "CTCGreedySearch",
    "CTCPrefixSearch",
    "ctc_greedy_search",
    "ctc_prefix_search_advance_factored",
]

NEG_INF = -float("inf")
# beam-mass sentinel for width-padded beams: masses stay finite (an -inf
# mass times a zero one-hot would be NaN, which outranks every candidate);
# real masses are >= 0, so a negative mass marks a dummy beam and outputs
# turn it back into -inf
MASS_PAD = -1.0e30


def _decode_prologue(logits: torch.Tensor, M: int, g_bias=None):
    """``(top_lgts, top_inds, sm_max, sm_den, blank_probs)`` from time-major
    ``logits (T, N, V + 1)``: the top-``M`` of ``logits[..., :V]
    (+ g_bias)``, the softmax stats over all ``V + 1`` lanes, and the blank
    probability ``exp(blank - max) / den``."""
    tl, ti, mx, den, blank = decode_prologue(logits, M, g_bias)
    return tl, ti, mx, den, torch.exp(blank - mx) / den


def ctc_greedy_search(
    logits: torch.Tensor,
    in_lens: Optional[torch.Tensor] = None,
    blank_idx: int = -1,
    batch_first: bool = False,
    is_probs: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CTC greedy decode: argmax, collapse repeats, drop blanks.

    Returns ``(max_, paths, out_lens)``; positions of ``paths`` past
    ``out_lens`` are zero. Same semantics as the JAX package's
    ``ctc_greedy_search``.
    """
    if logits.dim() != 3:
        raise RuntimeError("logits must be 3-dimensional")
    V = logits.shape[2]
    if blank_idx < -V or blank_idx > (V - 1):
        raise RuntimeError(
            "Blank index out of range (expected to be in the range of "
            f"[-{V},{V-1}], but got {blank_idx})"
        )
    blank_idx = (blank_idx + V) % V
    if logits.dtype in (torch.bfloat16, torch.float16):
        logits = logits.float()
    if not batch_first:
        logits = logits.transpose(0, 1)
    if not is_probs:
        logits = torch.log_softmax(logits, 2)
    max_, argmax = logits.amax(2), logits.argmax(2)  # first max on ties
    keep = argmax != blank_idx
    keep[:, 1:] &= argmax[:, 1:] != argmax[:, :-1]
    Tm = argmax.shape[1]
    if in_lens is not None:
        in_lens = in_lens.to(logits.device)
        valid = torch.arange(Tm, device=logits.device)[None] < in_lens[:, None]
        keep &= valid
        max_ = torch.where(valid, max_, 1.0 if is_probs else 0.0)
    out_lens = keep.sum(1)
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    paths = torch.gather(argmax, 1, order)
    out_valid = torch.arange(Tm, device=logits.device)[None] < out_lens[:, None]
    paths = torch.where(out_valid, paths, 0)
    max_ = max_.prod(1) if is_probs else max_.sum(1)
    if not batch_first:
        paths = paths.T
    return max_, paths, out_lens


class CTCGreedySearch(torch.nn.Module):
    """Module wrapper for :func:`ctc_greedy_search`."""

    def __init__(
        self, blank_idx: int = -1, batch_first: bool = False, is_probs: bool = False
    ):
        super().__init__()
        self.blank_idx = argcheck.is_int(blank_idx, "blank_idx")
        self.batch_first = argcheck.is_bool(batch_first, "batch_first")
        self.is_probs = argcheck.is_bool(is_probs, "is_probs")

    def forward(self, logits, in_lens=None):
        return ctc_greedy_search(
            logits, in_lens, self.blank_idx, self.batch_first, self.is_probs
        )


def _pick(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``x[n, src[n, k]]`` for ``x (N, Kp, ...)`` and ``src (N, K)``."""
    idx = src.reshape(src.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(src.shape + x.shape[2:]))


def ctc_prefix_search_advance_factored(
    top_probs_t: Tuple[torch.Tensor, torch.Tensor],
    blank_probs_t: torch.Tensor,
    p_last: torch.Tensor,
    width: int,
    probs_prev: Tuple[torch.Tensor, torch.Tensor],
    y_prev: torch.Tensor,
    y_prev_last: torch.Tensor,
    y_prev_lens: torch.Tensor,
    prev_is_prefix: torch.Tensor,
    vocab_size: int,
    valid: Optional[torch.Tensor] = None,
):
    """One frame of CTC prefix search when extension probabilities factor as
    ``ext[n, k, v] = p_t[n, v]`` (no per-beam LM fusion).

    Each beam's picks come from the frame's shared top-``M`` tokens
    ``top_probs_t = (values (N, M), indices (N, M))`` (``M >= width + Kp``
    or ``V``), its last token, whose probability ``p_last (N, Kp)`` the
    caller supplies, and its non-extension. ``probs_prev = (nb, b)`` are
    the ``(N, Kp)`` non-blank and blank masses; ``y_prev (N, Kp, T)`` is
    the batch-major path buffer; ``y_prev_last``, ``y_prev_lens`` and the
    prefix matrix ``prev_is_prefix (N, Kp, Kp)`` describe the beams.

    With ``valid (N, 1)`` bool, rows where it is False keep their buffer
    (identity permutation, no token write); their other outputs are junk
    that the caller masks or never reads again.

    Returns ``(y_next (N, W, T), y_next_last, y_next_lens, (nb, b),
    next_is_prefix)``, padded to ``width`` beams of mass :data:`MASS_PAD`
    when fewer candidates exist.
    """
    top_vals, top_inds = top_probs_t
    nb_prev, b_prev = probs_prev
    N, Kp = nb_prev.shape
    V = vocab_size
    T = y_prev.shape[2]
    dev = nb_prev.device
    M = top_inds.shape[1]
    if M < min(width + Kp, V):
        raise RuntimeError(f"M ({M}) must be at least width + Kp or V")
    K = min(width, Kp * (V + 1))
    S = M + 2  # per-beam slots: M shared + last token + non-extension

    tot_prev = nb_prev + b_prev
    y_prev_last = y_prev_last.clamp(0, V - 1)

    # shared-token extension scores; a beam's own last token only carries
    # the blank mass (CTC repeat rule)
    shared_is_last = top_inds[:, None, :] == y_prev_last[:, :, None]
    coeff = torch.where(shared_is_last, b_prev[:, :, None], tot_prev[:, :, None])
    shared_scores = coeff * top_vals[:, None, :]  # (N, Kp, M)
    # dedicated last-token slot, off when the token is already shared
    last_scores = torch.where(
        shared_is_last.any(-1), NEG_INF, b_prev * p_last
    )
    b_nonext = tot_prev * blank_probs_t[:, None]
    nb_nonext = nb_prev * p_last

    # extensions of beam k that equal beam j are absorbed into j's
    # non-extension mass (they are the same prefix)
    ext_is_exact = (
        (y_prev_lens + 1)[:, :, None] == y_prev_lens[:, None, :]
    ) & prev_is_prefix  # (N, k, j)
    same_last = y_prev_last[:, None, :] == y_prev_last[:, :, None]
    tm_coeff = torch.where(same_last, b_prev[:, :, None], tot_prev[:, :, None])
    absorbed = torch.where(
        ext_is_exact, tm_coeff * p_last[:, None, :], 0.0
    ).sum(1) + 0.0
    nb_nonext = nb_nonext + absorbed

    # removed[n, k, s]: the candidate token of slot s extends beam k into an
    # existing beam j
    removed_shared = (
        ext_is_exact[:, :, None, :]
        & (top_inds[:, None, :, None] == y_prev_last[:, None, None, :])
    ).any(-1)  # (N, Kp, M)
    removed_last = (ext_is_exact & same_last).any(-1)
    ext_scores = torch.cat([shared_scores, last_scores[:, :, None]], 2)
    removed = torch.cat([removed_shared, removed_last[:, :, None]], 2)
    ext_scores = torch.where(removed, NEG_INF, ext_scores)
    cand = torch.cat([ext_scores, (nb_nonext + b_nonext)[:, :, None]], 2)
    sel_vals, next_ind = exact_top_k(cand.reshape(N, Kp * S), K)

    slot = next_ind % S
    next_src = next_ind // S
    next_is_nonext = slot == (S - 1)
    ext_src_cat = torch.cat([top_inds, y_prev_last], 1)  # (N, M + Kp)
    ext_idx = torch.where(slot < M, slot, M + next_src)
    next_ext = torch.gather(ext_src_cat, 1, ext_idx)

    # ---- bookkeeping after selection ----
    if valid is None:
        src = next_src
    else:
        src = torch.where(valid, next_src, torch.arange(K, device=dev)[None])
    prefix_lens = _pick(y_prev_lens, src)
    y_next_lens = prefix_lens + (~next_is_nonext)
    nb_next = torch.where(
        next_is_nonext, _pick(nb_nonext, src) + 0.0, sel_vals
    )
    b_next = (_pick(b_nonext, src) + 0.0) * next_is_nonext
    y_next_last = torch.where(next_is_nonext, _pick(y_prev_last, src), next_ext)
    ip_rows = _pick(prev_is_prefix, src)  # (N, K, Kp) = ip[n, src_k, :]
    # next_prefix_is_prefix[n, k, k'] = ip[n, src_k, src_k']
    next_prefix_is_prefix = torch.gather(
        ip_rows, 2, src[:, None, :].expand(N, K, K)
    )
    next_len_leq = y_next_lens[:, :, None] <= y_next_lens[:, None, :]

    # permute the buffer, write each new token at its prefix length, and
    # read the new buffer at each beam's last position:
    # next_to_match[n, k, k'] = y_next[n, k', lens_k - 1]
    cols = _pick(y_prev, src)  # (N, K, T)
    pos = prefix_lens if valid is None else torch.where(valid, prefix_lens, T)
    wmask = torch.arange(T, device=dev)[None, None] == pos[:, :, None]
    y_next = torch.where(wmask, next_ext[:, :, None], cols)
    p = (y_next_lens - 1).clamp(0, T - 1)
    next_to_match = torch.gather(
        y_next, 2, p[:, None, :].expand(N, K, K)
    ).transpose(1, 2)
    next_ext_matches = next_to_match == next_ext[:, :, None]
    next_is_prefix = (
        next_prefix_is_prefix
        & next_len_leq
        & (next_is_nonext[:, :, None] | next_ext_matches)
    )

    if K < width:
        rem = width - K

        def pad(x, value, dim=1):
            shape = list(x.shape)
            shape[dim] = rem
            return torch.cat([x, x.new_full(shape, value)], dim)

        y_next = pad(y_next, 0)
        y_next_last = pad(y_next_last, 0)
        y_next_lens = pad(y_next_lens, 0)
        nb_next = pad(nb_next, MASS_PAD)
        b_next = pad(b_next, MASS_PAD)
        next_is_prefix = pad(pad(next_is_prefix, False, 2), False, 1)

    return y_next, y_next_last, y_next_lens, (nb_next, b_next), next_is_prefix


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``2 ** e`` for int ``e`` in [-149, 127]."""
    return torch.pow(2.0, e.double()).float()


def _ldexp(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``x * 2 ** e`` rounded once, as ``jnp.ldexp``: no overflow of
    ``2 ** e`` on its own (the product is taken in float64, exact for f32
    ``x`` and any ``e`` whose power fits a double), and results below the
    normal f32 floor flush to zero as they do in the JAX package."""
    y = (x.double() * torch.pow(2.0, e.double())).float()
    y = torch.where(y.abs() < config.TINY, torch.zeros_like(y).copysign(y), y)
    return torch.where(torch.isinf(x) | (x == 0), x, y)


class CTCPrefixSearch(torch.nn.Module):
    """Batched CTC prefix beam search.

    Call: ``search(logits, lens=None)`` with time-major ``logits
    (T, N, V + 1)`` (blank last) on any device; returns ``(y (T, N, W),
    y_lens (N, W), y_probs (N, W))`` with beams in descending order of
    probability and dummy beams (when fewer than ``W`` prefixes exist) at
    probability ``-inf``. Rows with ``lens == 0`` return the empty prefix.

    Language-model fusion (``lm``) is not ported yet and raises
    :class:`NotImplementedError`. ``beta`` is the LM's weight, kept for the
    JAX package's signature: with no LM it has no effect on the search.
    """

    def __init__(self, width: int, beta: float = 0.2, lm=None):
        super().__init__()
        self.width = argcheck.is_posi(width, "width")
        self.beta = argcheck.is_float(beta, "beta")  # unread until LM fusion
        if lm is not None:
            raise NotImplementedError(
                "shallow LM fusion is not ported to pydrobert_tpu_torch yet"
            )

    def forward(
        self, logits: torch.Tensor, lens: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if logits.dim() != 3:
            raise RuntimeError("logits must be 3 dimensional")
        T, N, Vp1 = logits.shape
        V = Vp1 - 1
        W = self.width
        dev = logits.device
        if lens is None:
            lens = torch.full((N,), T, dtype=torch.long, device=dev)
        else:
            if lens.dim() != 1:
                raise RuntimeError("lens must be 1 dimensional")
            if lens.shape[0] != N:
                raise RuntimeError(
                    f"expected dim 0 of lens to be {N}, got {lens.shape[0]}"
                )
            lens = lens.to(dev, torch.long)

        if T == 0:
            y = torch.zeros((0, N, W), dtype=torch.long, device=dev)
            y_lens = torch.zeros((N, W), dtype=torch.long, device=dev)
            y_probs = torch.full((N, W), NEG_INF, dtype=torch.float32, device=dev)
            y_probs[:, 0] = 1.0
            return y, y_lens, y_probs

        # probabilities are only needed at the hoisted top-M tokens, the
        # blank and each beam's last token: normalize those from the raw
        # logits instead of materializing the (T, N, V) softmax
        M = min(V, 2 * W)
        top_lgts, top_inds, sm_max, sm_den, blank_probs = _decode_prologue(
            logits.contiguous(), M
        )
        top_vals = torch.exp(top_lgts - sm_max[..., None]) / sm_den[..., None]
        top_inds = top_inds.long()

        def p_last_at(t, y_last):
            """Acoustic probability of each beam's last token at frame t."""
            tok = y_last.clamp(0, V - 1)
            raw = torch.gather(logits[t], 1, tok).float().clamp_min(-1e30)
            return torch.exp(raw - sm_max[t][:, None]) / sm_den[t][:, None]

        # ---- t = 0 (prefix width 1 -> W) ----
        nb0 = torch.zeros((N, 1), dtype=torch.float32, device=dev)
        b0 = torch.ones((N, 1), dtype=torch.float32, device=dev)
        zeros_i = torch.zeros((N, 1), dtype=torch.long, device=dev)
        is_prefix0 = torch.ones((N, 1, 1), dtype=torch.bool, device=dev)
        buf0 = torch.zeros((N, 1, T), dtype=torch.long, device=dev)
        y_buf, y_last, y_lens, (nb, b), is_prefix = (
            ctc_prefix_search_advance_factored(
                (top_vals[0], top_inds[0]),
                blank_probs[0],
                p_last_at(0, zeros_i),
                W,
                (nb0, b0),
                buf0,
                zeros_i,
                zeros_i,
                is_prefix0,
                V,
            )
        )
        # rows with lens == 0 keep the empty prefix
        valid0 = (lens > 0)[:, None]
        y_lens = torch.where(valid0, y_lens, 0)
        pad = torch.full((N, W - 1), MASS_PAD, dtype=torch.float32, device=dev)
        nb = torch.where(valid0, nb, torch.cat([nb0, pad], 1))
        b = torch.where(valid0, b, torch.cat([b0, pad], 1))

        # int32 accumulator of the power-of-two rescales (config.DECODE_RENORM)
        ls = torch.zeros((N,), dtype=torch.int32, device=dev)
        for t in range(1, T):
            valid = (t < lens)[:, None]
            (
                y_buf, y_next_last, y_next_lens, (nb_next, b_next),
                next_is_prefix,
            ) = ctc_prefix_search_advance_factored(
                (top_vals[t], top_inds[t]),
                blank_probs[t],
                p_last_at(t, y_last),
                W,
                (nb, b),
                y_buf,
                y_last,
                y_lens,
                is_prefix,
                V,
                valid=valid,
            )
            y_lens = torch.where(valid, y_next_lens, y_lens)
            nb = torch.where(valid, nb_next, nb)
            b = torch.where(valid, b_next, b)
            if config.DECODE_RENORM:
                # rescale each row by 2**-e, e the exponent of beam 0's
                # total mass (beams come out sorted, so within a factor
                # W + 1 of the row's best). Exact; the clamps keep dummy
                # masses finite and the factor in range.
                best = nb[:, 0] + b[:, 0]
                e = torch.frexp(torch.where(best > 0, best, 1.0)).exponent
                e = e.clamp_min(-126)
                fac = _pow2(-e)[:, None]
                nb = (nb * fac).clamp_min(MASS_PAD)
                b = (b * fac).clamp_min(MASS_PAD)
                ls = ls + e
            # frozen rows carry junk here; they are never advanced again
            y_last = y_next_last
            is_prefix = next_is_prefix

        y = y_buf.permute(2, 0, 1)  # (T, N, W)
        y_probs = nb + b
        # dummy-beam masses are negative; the sign test runs on the raw
        # masses before the rescales fold back in
        if config.DECODE_RENORM:
            y_probs = torch.where(
                y_probs < 0, NEG_INF, _ldexp(y_probs, ls[:, None])
            )
        else:
            y_probs = torch.where(y_probs < 0, NEG_INF, y_probs)
        return y, y_lens, y_probs
