"""The CTC prefix search's per-frame scan (counterpart of the advances and
the ``lax.scan`` body of :mod:`pydrobert_tpu.ops.decoding`'s
``CTCPrefixSearch``): the dense, factored and sparse advances, the
bookkeeping tail they share, the frame loop with its power-of-two
rescales, and the epilogue that folds them back in.

:class:`pydrobert_tpu_torch.ops.decoding.CTCPrefixSearch` runs it, and so
does :func:`pydrobert_tpu_torch.ops.kernels.ctc_beam_search_renorm_reference`,
the plain version of the renormalizing whole-loop kernel, which is this
loop in one launch. It imports no model and no LM: an LM reaches it as an
object.
"""

from functools import partial
from typing import Optional, Tuple

import torch

from .. import config
from ..utils import pytree as _pytree
from ._loops import frame_loop
from .topk import exact_top_k

NEG_INF = -float("inf")
# beam-mass sentinel for width-padded beams: masses stay finite (an -inf
# mass times a zero one-hot would be NaN, which outranks every candidate);
# real masses are >= 0, so a negative mass marks a dummy beam and outputs
# turn it back into -inf
MASS_PAD = -1.0e30


def _pick(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``x[n, src[n, k]]`` for ``x (N, Kp, ...)`` and ``src (N, K)``."""
    idx = src.reshape(src.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(src.shape + x.shape[2:]))


def _exact_ext(y_prev_lens: torch.Tensor, prev_is_prefix: torch.Tensor) -> torch.Tensor:
    """``ext_is_exact[n, k, j]``: beam ``k`` extended by one token is beam
    ``j``'s prefix, so the extension that equals ``j`` is absorbed into
    ``j``'s non-extension mass."""
    return ((y_prev_lens + 1)[:, :, None] == y_prev_lens[:, None, :]) & prev_is_prefix


def _ctc_advance_tail(
    y_prev, y_prev_last, y_prev_lens, prev_is_prefix,
    next_src, next_ext, next_is_nonext, nb_ext_sel,
    nb_nonext, b_nonext, width, K, valid=None,
):
    """The bookkeeping every advance shares once its ``K`` candidates are
    selected: masses, lengths, the path buffer and the prefix matrix.

    ``y_prev (N, Kp, T)`` is the batch-major path buffer; ``next_src``,
    ``next_ext`` and ``next_is_nonext`` ``(N, K)`` say which beam each new
    one extends, by which token, or whether it is the beam's
    non-extension, whose masses ``nb_nonext`` and ``b_nonext`` ``(N, Kp)``
    carries; ``nb_ext_sel`` are the selected candidates' scores. With
    ``valid (N, 1)`` bool, rows where it is False keep their buffer
    (identity permutation, no token write); their other outputs are junk
    that the caller masks or never reads again.

    Returns ``(y_next (N, W, T), y_next_last, y_next_lens, (nb, b),
    next_is_prefix, next_src, next_ext, next_is_nonext)``, padded to
    ``width`` beams of mass :data:`MASS_PAD` when ``K < width``.
    """
    N, Kp, T = y_prev.shape
    dev = y_prev.device
    if valid is None:
        src = next_src
    else:
        src = torch.where(valid, next_src, torch.arange(K, device=dev)[None])
    prefix_lens = _pick(y_prev_lens, src)
    y_next_lens = prefix_lens + (~next_is_nonext)
    nb_next = torch.where(next_is_nonext, _pick(nb_nonext, src) + 0.0, nb_ext_sel)
    b_next = (_pick(b_nonext, src) + 0.0) * next_is_nonext
    y_next_last = torch.where(next_is_nonext, _pick(y_prev_last, src), next_ext)
    ip_rows = _pick(prev_is_prefix, src)  # (N, K, Kp) = ip[n, src_k, :]
    # next_prefix_is_prefix[n, k, k'] = ip[n, src_k, src_k']
    next_prefix_is_prefix = torch.gather(ip_rows, 2, src[:, None, :].expand(N, K, K))
    next_len_leq = y_next_lens[:, :, None] <= y_next_lens[:, None, :]

    # permute the buffer, write each new token at its prefix length, and
    # read the new buffer at each beam's last position:
    # next_to_match[n, k, k'] = y_next[n, k', lens_k - 1]
    cols = _pick(y_prev, src)  # (N, K, T)
    pos = prefix_lens if valid is None else torch.where(valid, prefix_lens, T)
    wmask = torch.arange(T, device=dev)[None, None] == pos[:, :, None]
    y_next = torch.where(wmask, next_ext[:, :, None], cols)
    p = (y_next_lens - 1).clamp(0, T - 1)
    next_to_match = torch.gather(y_next, 2, p[:, None, :].expand(N, K, K)).transpose(1, 2)
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
        next_src = pad(next_src, 0)
        next_ext = pad(next_ext, 0)
        next_is_nonext = pad(next_is_nonext, False)

    return (
        y_next, y_next_last, y_next_lens, (nb_next, b_next), next_is_prefix,
        next_src, next_ext, next_is_nonext,
    )


def ctc_prefix_search_advance(
    probs_t: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    width: int,
    probs_prev: Tuple[torch.Tensor, torch.Tensor],
    y_prev: torch.Tensor,
    y_prev_last: torch.Tensor,
    y_prev_lens: torch.Tensor,
    prev_is_prefix: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
):
    """One frame of CTC prefix search over every extension of every beam
    (the dense advance, which LM fusion with a full ``(N, Kp, V)``
    extension distribution takes).

    ``probs_t = (ext (N, Kp, V), nonext (N, V), blank (N,))`` are the
    frame's extension probabilities per beam, its plain token
    probabilities and its blank probability; the other arguments and the
    return value are :func:`_ctc_advance_tail`'s.
    """
    ext_probs_t, nonext_probs_t, blank_probs_t = probs_t
    if width < 1:
        raise RuntimeError("width must be positive")
    if ext_probs_t.dim() != 3:
        raise RuntimeError("ext_probs_t must be 3 dimensional")
    nb_prev, b_prev = probs_prev
    N, Kp, V = ext_probs_t.shape
    K = min(width, Kp * (V + 1))

    tot_prev = nb_prev + b_prev
    y_prev_last = y_prev_last.clamp(0, V - 1)
    last_onehot = torch.nn.functional.one_hot(y_prev_last, V).to(ext_probs_t.dtype)
    # a beam's own last token only carries its blank mass (the repeat rule)
    nb_ext = (nb_prev[..., None] * (1 - last_onehot) + b_prev[..., None]) * ext_probs_t
    b_nonext = tot_prev * blank_probs_t[:, None]
    nb_nonext = nb_prev * torch.gather(nonext_probs_t, 1, y_prev_last)

    ext_is_exact = _exact_ext(y_prev_lens, prev_is_prefix)  # (N, k, j)
    # the extension of k by j's last token is j itself
    to_match = y_prev_last[:, None, :].expand(N, Kp, Kp)
    absorbed = torch.where(ext_is_exact, torch.gather(nb_ext, 2, to_match), 0.0).sum(1)
    nb_nonext = nb_nonext + (absorbed + 0.0)
    # has_match[n, k, v]: some j with ext_is_exact[n, k, j] ends in v
    hit = torch.where(ext_is_exact, to_match, V)
    has_match = torch.zeros((N, Kp, V + 1), dtype=torch.bool, device=y_prev.device)
    has_match = has_match.scatter_(2, hit, True)[..., :V]
    nb_ext = torch.where(has_match, NEG_INF, nb_ext)

    cand = torch.cat([nb_ext.reshape(N, Kp * V), nb_nonext + b_nonext], 1)
    sel_vals, next_ind = exact_top_k(cand, K)
    next_is_nonext = next_ind >= Kp * V
    next_src = torch.where(next_is_nonext, next_ind - Kp * V, next_ind // V)
    next_ext = next_ind % V
    return _ctc_advance_tail(
        y_prev, y_prev_last, y_prev_lens, prev_is_prefix,
        next_src, next_ext, next_is_nonext, sel_vals,
        nb_nonext, b_nonext, width, K, valid,
    )


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
    p_last_ext: Optional[torch.Tensor] = None,
):
    """One frame of CTC prefix search when extension probabilities factor as
    ``ext[n, k, v] = p_t[n, v]`` (no LM, or one that weights every beam
    alike: a unigram LM).

    Each beam's picks come from the frame's shared top-``M`` tokens
    ``top_probs_t = (values (N, M), indices (N, M))`` (``M >= width + Kp``
    or ``V``), its last token, whose probability ``p_last (N, Kp)`` the
    caller supplies, and its non-extension. With a unigram LM the shared
    values carry the LM's weight and ``p_last_ext`` is the last token's
    weighted extension probability (``p_last`` its plain continuation
    one). ``probs_prev = (nb, b)`` are the ``(N, Kp)`` non-blank and blank
    masses; ``y_prev (N, Kp, T)`` is the batch-major path buffer;
    ``y_prev_last``, ``y_prev_lens`` and the prefix matrix
    ``prev_is_prefix (N, Kp, Kp)`` describe the beams. ``valid`` and the
    return value are :func:`_ctc_advance_tail`'s.
    """
    top_vals, top_inds = top_probs_t
    nb_prev, b_prev = probs_prev
    N, Kp = nb_prev.shape
    V = vocab_size
    M = top_inds.shape[1]
    if M < min(width + Kp, V):
        raise RuntimeError(f"M ({M}) must be at least width + Kp or V")
    if p_last_ext is None:
        p_last_ext = p_last
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
    last_scores = torch.where(shared_is_last.any(-1), NEG_INF, b_prev * p_last_ext)
    b_nonext = tot_prev * blank_probs_t[:, None]
    nb_nonext = nb_prev * p_last

    ext_is_exact = _exact_ext(y_prev_lens, prev_is_prefix)  # (N, k, j)
    same_last = y_prev_last[:, None, :] == y_prev_last[:, :, None]
    tm_coeff = torch.where(same_last, b_prev[:, :, None], tot_prev[:, :, None])
    absorbed = torch.where(
        ext_is_exact, tm_coeff * p_last_ext[:, None, :], 0.0
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
    return _ctc_advance_tail(
        y_prev, y_prev_last, y_prev_lens, prev_is_prefix,
        next_src, next_ext, next_is_nonext, sel_vals,
        nb_nonext, b_nonext, width, K, valid,
    )


def _ctc_prefix_search_advance_sparse(
    top_g: Tuple[torch.Tensor, torch.Tensor],
    am_at,
    uni_at,
    blank_probs_t: torch.Tensor,
    beta: float,
    sparse: Tuple,
    width: int,
    probs_prev: Tuple[torch.Tensor, torch.Tensor],
    y_prev: torch.Tensor,
    y_prev_last: torch.Tensor,
    y_prev_lens: torch.Tensor,
    prev_is_prefix: torch.Tensor,
    vocab_size: int,
    valid: Optional[torch.Tensor] = None,
    bi: Optional[torch.Tensor] = None,
    c1: Optional[torch.Tensor] = None,
):
    """One frame of CTC prefix search with a backoff n-gram LM shallow-fused
    (``lm_probs**beta * am``), scoring only candidate slots.

    Beam ``k``'s LM conditional is ``uni[v] + base_k`` except on its
    stored n-gram tokens (:meth:`pydrobert_tpu_torch.lm.LookupLanguageModel.
    sparse_corrections_ext`, whose output ``sparse`` is, with ``(N, Kp)``
    leading dims). ``base_k`` and the normalizer are per-beam constants
    that keep the within-beam order, so each beam's top extensions come
    from the frame's shared top-``M`` of ``g[v] = am[v] * exp(beta *
    uni[v])`` (``top_g``, ``M >= 2 * width + C``), its ``C`` corrected
    tokens, its last token and its non-extension.

    ``am_at`` maps token ids ``(N, Q)`` to the frame's acoustic
    probabilities and ``uni_at`` to unigram log-probs clamped at -1e30.
    ``valid`` and the return value are :func:`_ctc_advance_tail`'s.

    With ``bi``, the flat bigram table of :meth:`~pydrobert_tpu_torch.lm.
    LookupLanguageModel.order2_values` on the search's device, and ``c1
    (N, Kp)``, each beam's most recent context token, the order-2 slots'
    membership and values come from one gather of ``bi[c1 * V + v]``
    (``config.SPARSE_MEMBERSHIP_GATHER``; ``decoding.py:1226-1269`` of the
    JAX package) and only the order >= 3 slots are compared. ``c1`` is a
    token in ``[0, V)`` or the LM's ``sos``, both below the table's
    ``base``, so every index lies in the table.
    """
    top_vals, top_inds = top_g
    nb_prev, b_prev = probs_prev
    N, Kp = nb_prev.shape
    M = top_inds.shape[1]
    V = vocab_size
    base, ctoks, cvals, cvalid, logZ, logb, bounds = sparse
    ctoks = ctoks.long()
    C = ctoks.shape[2]
    K = min(width, Kp * (V + 1))
    L = M + C + 1  # ext slots per beam; the non-extension slot follows

    tot_prev = nb_prev + b_prev
    y_prev_last = y_prev_last.clamp(0, V - 1)
    scal = torch.exp(beta * (base - logZ))  # (N, Kp)

    am_all = am_at(torch.cat([ctoks.reshape(N, Kp * C), y_prev_last], 1))
    am_corr = am_all[:, : Kp * C].reshape(N, Kp, C)
    am_last = am_all[:, Kp * C:]  # (N, Kp) plain acoustic prob
    uni_last = uni_at(y_prev_last)

    # the corrected value and match flag of every (beam k, candidate token)
    # pair, the candidates being the other beams' last tokens and the
    # shared top-M tokens
    cand2 = torch.cat([y_prev_last, top_inds], 1)  # (N, Kp + M)
    if bi is not None:
        # the highest stored order wins: the unigram backoff, overridden by
        # the bigram table's value, overridden by a match among the order
        # >= 3 slots [hi0, C). +inf marks an absent pair; the inner where
        # keeps it out of the sum.
        hi0 = int(bounds[1])
        big = torch.take(bi, c1[:, :, None] * V + cand2[:, None, :])  # (N, Kp, Kp + M)
        biq = big[..., :Kp]
        found_tm = torch.isfinite(biq)
        pen2 = logb[..., 1:].sum(-1)  # (N, Kp): backoffs of the orders above 2
        lm_tm = torch.where(
            found_tm,
            pen2[:, :, None] + torch.where(found_tm, biq, 0.0),
            base[:, :, None] + uni_last[:, None, :],
        )
        shared_in_corr = torch.isfinite(big[..., Kp:])  # (N, Kp, M)
        if C > hi0:
            mhi = (
                ctoks[:, :, None, hi0:] == cand2[:, None, :, None]
            ) & cvalid[:, :, None, hi0:]  # (N, Kp, Kp + M, C - hi0)
            anyhi = mhi.any(3)
            any3 = anyhi[..., :Kp]
            lm_tm = torch.where(
                any3,
                torch.where(mhi[..., :Kp, :], cvals[:, :, None, hi0:], 0.0).sum(3),
                lm_tm,
            )
            found_tm = found_tm | any3
            shared_in_corr = shared_in_corr | anyhi[..., Kp:]
    else:
        # corrections are unique per context, so each sum has at most one
        # nonzero term
        eqm = (ctoks[:, :, None, :] == cand2[:, None, :, None]) & cvalid[:, :, None, :]
        val_sum = torch.where(eqm, cvals[:, :, None, :], 0.0).sum(3)
        found_all = eqm.any(3)  # (N, Kp, Kp + M)
        found_tm = found_all[..., :Kp]
        shared_in_corr = found_all[..., Kp:]  # (N, Kp, M)
        lm_tm = val_sum[..., :Kp] + torch.where(
            found_tm, 0.0, base[:, :, None] + uni_last[:, None, :]
        )
    # fused ext prob of beam j's last token under beam k's context; a
    # beam's own last token is the diagonal
    p_tm = am_last[:, None, :] * torch.exp(beta * (lm_tm - logZ[:, :, None]))
    last_in_corr_any = torch.diagonal(found_tm, dim1=1, dim2=2)
    p_last_ext = torch.diagonal(p_tm, dim1=1, dim2=2) + 0.0

    # shared slots
    shared_is_last = top_inds[:, None, :] == y_prev_last[:, :, None]
    coeff_sh = torch.where(shared_is_last, b_prev[:, :, None], tot_prev[:, :, None])
    shared_scores = coeff_sh * scal[:, :, None] * top_vals[:, None, :]
    shared_scores = torch.where(shared_in_corr, NEG_INF, shared_scores)

    # correction slots
    corr_is_last = ctoks == y_prev_last[:, :, None]
    coeff_c = torch.where(corr_is_last, b_prev[:, :, None], tot_prev[:, :, None])
    corr_scores = coeff_c * am_corr * torch.exp(beta * (cvals - logZ[:, :, None]))
    corr_scores = torch.where(cvalid, corr_scores, NEG_INF)

    # dedicated last-token slot (off when covered by a shared or a
    # correction slot)
    last_scores = torch.where(
        shared_is_last.any(2) | last_in_corr_any, NEG_INF, b_prev * p_last_ext
    )

    # non-extension masses; absorption takes the fused ext prob of every
    # other beam's last token under this beam's context
    b_nonext = tot_prev * blank_probs_t[:, None]
    ext_is_exact = _exact_ext(y_prev_lens, prev_is_prefix)
    tm_coeff = torch.where(
        y_prev_last[:, None, :] == y_prev_last[:, :, None],
        b_prev[:, :, None],
        tot_prev[:, :, None],
    )
    absorbed = torch.where(ext_is_exact, tm_coeff * p_tm, 0.0).sum(1) + 0.0
    nb_nonext = nb_prev * am_last + absorbed

    # slots: [0, M) shared | [M, M + C) corrections | M + C last token
    slot_toks = torch.cat(
        [top_inds[:, None, :].expand(N, Kp, M), ctoks, y_prev_last[:, :, None]], 2
    )  # (N, Kp, L)
    removed = (
        ext_is_exact[:, :, None, :]
        & (slot_toks[:, :, :, None] == y_prev_last[:, None, None, :])
    ).any(3)
    ext_scores = torch.cat([shared_scores, corr_scores, last_scores[:, :, None]], 2)
    ext_scores = torch.where(removed, NEG_INF, ext_scores)
    S = L + 1
    cand = torch.cat([ext_scores, (nb_nonext + b_nonext)[:, :, None]], 2)
    sel_vals, next_ind = exact_top_k(cand.reshape(N, Kp * S), K)

    slot = next_ind % S
    next_src = next_ind // S
    next_is_nonext = slot == (S - 1)
    ext_idx = next_src * L + slot.clamp_max(L - 1)
    next_ext = torch.gather(slot_toks.reshape(N, Kp * L), 1, ext_idx)
    return _ctc_advance_tail(
        y_prev, y_prev_last, y_prev_lens, prev_is_prefix,
        next_src, next_ext, next_is_nonext, sel_vals,
        nb_nonext, b_nonext, width, K, valid,
    )


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``2 ** e`` for int ``e`` in [-149, 127]."""
    return torch.pow(2.0, e.double()).float()


def beam_probs(mass: torch.Tensor, ls: torch.Tensor, renorm: bool) -> torch.Tensor:
    """A search's output probabilities from the raw masses ``nb + b (N,
    W)`` and, with ``renorm``, each row's summed rescale exponents ``ls
    (N,)``. Placeholder-beam masses are negative; the sign test runs on the
    raw masses before the rescales fold back in."""
    if renorm:
        return torch.where(mass < 0, NEG_INF, _ldexp(mass, ls[:, None]))
    return torch.where(mass < 0, NEG_INF, mass)


def _ldexp(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``x * 2 ** e`` rounded once, as ``jnp.ldexp``: no overflow of
    ``2 ** e`` on its own (the product is taken in float64, exact for f32
    ``x`` and any ``e`` whose power fits a double), and results below the
    normal f32 floor flush to zero as they do in the JAX package."""
    y = (x.double() * torch.pow(2.0, e.double())).float()
    y = torch.where(y.abs() < config.TINY, torch.zeros_like(y).copysign(y), y)
    return torch.where(torch.isinf(x) | (x == 0), x, y)


def prefix_scan(
    frames: Tuple[torch.Tensor, ...],
    lens: torch.Tensor,
    width: int,
    V: int,
    renorm: bool,
    route: Optional[str] = None,
    lm=None,
    beta: float = 0.0,
    valid_mixture: bool = False,
    initial_state: Optional[dict] = None,
    bi: Optional[torch.Tensor] = None,
    log_z: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CTC prefix search's per-frame scan over ``frames``, the
    advances' inputs frame-major: the dense route's ``(nonext_probs (T, N,
    V), blank_probs (T, N))``, the others' ``(top_vals (T, N, M), top_inds
    long, logits (T, N, V + 1), sm_max, sm_den, blank_probs)``, over ``T >=
    1`` frames of ``lens (N,)`` long.

    ``route`` is :meth:`~pydrobert_tpu_torch.ops.decoding.CTCPrefixSearch.
    lm_route`'s (None without fusion), fusing ``lm`` at ``beta`` (with
    ``valid_mixture``) from ``initial_state``; ``bi`` is the sparse route's
    bigram table (``config.SPARSE_MEMBERSHIP_GATHER``) and ``log_z`` the
    unigram route's log normalizer. With ``renorm`` every row is rescaled
    by a power of two after each frame from the second.

    Returns ``(y (T, N, W), y_lens (N, W), mass (N, W), ls (N,))``: the raw
    masses ``nb + b`` and each row's int32 sum of the rescales' exponents
    (zeros without ``renorm``), for :func:`beam_probs`.
    """
    T, N = frames[-1].shape
    W = width
    dev = frames[-1].device
    prev = {} if initial_state is None else initial_state
    if lm is not None:
        prev = lm.update_input(prev, torch.zeros((0, N), dtype=torch.long, device=dev))
    if route in ("sparse", "uni"):
        uni_cl = lm._uni_t.clamp_min(-1e30)

    def am_at(fr, toks):
        """Acoustic probabilities of tokens ``(N, Q)`` at frame ``fr``."""
        _, _, lg_t, mx_t, den_t, _ = fr
        tok = toks.clamp(0, V - 1)
        raw = torch.gather(lg_t, 1, tok).float().clamp_min(-1e30)
        return torch.exp(raw - mx_t[:, None]) / den_t[:, None]

    def uni_at(toks):
        return uni_cl[toks.clamp(0, V - 1)]

    def lm_ext_probs(fr, y_buf, y_lens_flat, state, Kp):
        """Dense route: fused extension probabilities ``(N, Kp, V)``."""
        nonext_t, blank_t = fr
        hist = y_buf.permute(2, 0, 1).reshape(T, N * Kp)
        lm_lp, in_next = lm.calc_idx_log_probs(hist, state, y_lens_flat)
        if valid_mixture:
            lm_probs = (
                beta
                * torch.softmax(lm_lp, -1).reshape(N, Kp, V)
                * (1 - blank_t.reshape(N, 1, 1))
            )
            ext = (1.0 - beta) * nonext_t[:, None] + lm_probs
        else:
            lm_probs = torch.exp(beta * torch.log_softmax(lm_lp, -1)).reshape(N, Kp, V)
            ext = lm_probs * nonext_t[:, None]
        return ext, in_next

    def advance(fr, nb, b, y_buf, y_last, y_lens, is_prefix, state, ctx, valid):
        """One frame on this search's route; returns the tail's outputs
        and the LM's next-state candidate."""
        Kp = nb.shape[1]
        if route == "dense":
            ext, in_next = lm_ext_probs(fr, y_buf, y_lens.reshape(-1), state, Kp)
            return ctc_prefix_search_advance(
                (ext, fr[0], fr[1]), W, (nb, b),
                y_buf, y_last, y_lens, is_prefix, valid,
            ), in_next
        top_vals_t, top_inds_t, blank_t = fr[0], fr[1], fr[5]
        if route == "sparse":
            return _ctc_prefix_search_advance_sparse(
                (top_vals_t, top_inds_t), partial(am_at, fr), uni_at,
                blank_t, beta, lm.sparse_corrections_ext(ctx), W,
                (nb, b), y_buf, y_last, y_lens, is_prefix, V, valid,
                bi, ctx[0],
            ), state
        p_last = am_at(fr, y_last)
        p_last_ext = None
        if route == "uni":
            p_last_ext = p_last * torch.exp(beta * (uni_at(y_last) - log_z))
        return ctc_prefix_search_advance_factored(
            (top_vals_t, top_inds_t), blank_t, p_last, W,
            (nb, b), y_buf, y_last, y_lens, is_prefix, V, valid, p_last_ext,
        ), state

    def fuse_state(state, in_next, next_src, next_is_nonext, Kp):
        if route is None:
            return state
        flat_src = (torch.arange(N, device=dev)[:, None] * Kp + next_src).reshape(-1)
        state = lm.extract_by_src(state, flat_src)
        in_next = lm.extract_by_src(in_next, flat_src)
        return lm.mix_by_mask(state, in_next, next_is_nonext.reshape(-1))

    def next_ctx(ctx, next_src, next_ext, next_is_nonext):
        """Sparse route: each new beam's context, most recent first."""
        ctx_src = torch.gather(ctx, 2, next_src[None].expand(ctx.shape[0], N, W))
        shifted = torch.cat([next_ext[None], ctx_src[:-1]], 0)
        return torch.where(next_is_nonext[None], ctx_src, shifted)

    # ---- t = 0 (prefix width 1 -> W) ----
    nb0 = torch.zeros((N, 1), dtype=torch.float32, device=dev)
    b0 = torch.ones((N, 1), dtype=torch.float32, device=dev)
    zeros_i = torch.zeros((N, 1), dtype=torch.long, device=dev)
    is_prefix0 = torch.ones((N, 1, 1), dtype=torch.bool, device=dev)
    buf0 = torch.zeros((N, 1, T), dtype=torch.long, device=dev)
    ctx = None
    if route == "sparse":
        ctx = torch.full((lm.max_ngram - 1, N, 1), lm.sos, dtype=torch.long, device=dev)
    (
        (y_buf, y_last, y_lens, (nb, b), is_prefix, next_src, next_ext, next_is_nonext),
        in_next,
    ) = advance(
        tuple(f[0] for f in frames), nb0, b0, buf0, zeros_i, zeros_i, is_prefix0,
        prev, ctx, None,
    )
    state = fuse_state(prev, in_next, next_src, next_is_nonext, 1)
    # rows with lens == 0 keep the empty prefix
    valid0 = (lens > 0)[:, None]
    y_lens = torch.where(valid0, y_lens, 0)
    pad = torch.full((N, W - 1), MASS_PAD, dtype=torch.float32, device=dev)
    nb = torch.where(valid0, nb, torch.cat([nb0, pad], 1))
    b = torch.where(valid0, b, torch.cat([b0, pad], 1))
    if route == "sparse":
        ctx = torch.where(
            valid0[None], next_ctx(ctx, next_src, next_ext, next_is_nonext), lm.sos
        )

    def frame(carry, fr, t):
        """Frames 1 .. T - 1: the search's loop body (``t`` an int, or
        a 0-d tensor inside the exported scan)."""
        y_buf, y_last, y_lens, nb, b, is_prefix, ls, state, ctx = carry
        valid = (t < lens)[:, None]
        (
            (y_buf, y_next_last, y_next_lens, (nb_next, b_next), next_is_prefix,
             next_src, next_ext, next_is_nonext),
            in_next,
        ) = advance(fr, nb, b, y_buf, y_last, y_lens, is_prefix, state, ctx, valid)
        state_next = fuse_state(state, in_next, next_src, next_is_nonext, W)
        y_lens = torch.where(valid, y_next_lens, y_lens)
        nb = torch.where(valid, nb_next, nb)
        b = torch.where(valid, b_next, b)
        if renorm:
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
        if route == "sparse":
            ctx = torch.where(
                valid[None], next_ctx(ctx, next_src, next_ext, next_is_nonext), ctx
            )
        if route == "dense":
            # frozen rows keep their state
            vm = valid[:, 0].repeat_interleave(W)

            def keep(new, old):
                if new.dim() and new.shape[0] == N * W:
                    return torch.where(vm.reshape((N * W,) + (1,) * (new.dim() - 1)), new, old)
                return new

            state = _pytree.tree_map(keep, state_next, state)
        else:
            state = state_next
        # frozen rows carry junk in y_last and is_prefix; they are never
        # advanced again
        return y_buf, y_next_last, y_lens, nb, b, next_is_prefix, ls, state, ctx

    # int32 accumulator of the power-of-two rescales (renorm)
    ls = torch.zeros((N,), dtype=torch.int32, device=dev)
    carry = (y_buf, y_last, y_lens, nb, b, is_prefix, ls, state, ctx)
    carry = frame_loop(frame, carry, frames, 1, T, "ctc_prefix_search")
    y_buf, _, y_lens, nb, b, _, ls, _, _ = carry
    return y_buf.permute(2, 0, 1), y_lens, nb + b, ls
