"""CTC greedy and prefix beam search with shallow LM fusion, beam search
and random walks over a sequential LM, and sequence log-probabilities
(counterpart of :mod:`pydrobert_tpu.ops.decoding`).

:class:`CTCPrefixSearch` follows the JAX package's search step for step:
one hoisted decode prologue over the whole ``(T, N, V + 1)`` logits
(:func:`pydrobert_tpu_torch.ops.kernels.decode_prologue`, a Hopper kernel
on the card; biased by the LM's unigram weights on the n-gram fusion
routes), then one advance per frame, in a Python loop
(:func:`pydrobert_tpu_torch.ops._ctc_scan.prefix_scan`): the factored
advance over the shared top-``M`` tokens, each beam's last token and its
non-extension; the sparse advance, which adds each beam's stored n-gram
corrections; or the dense advance over every extension. All three end in
one shared bookkeeping tail. Every candidate selection is an exact top-k
in the IEEE total order with ties lowest index first, so hypotheses,
lengths and beam order match the JAX search exactly. While
:func:`torch.export.export` traces a search, its frame loop is one
``scan`` over the same body (:func:`~pydrobert_tpu_torch.ops._loops.
frame_loop`), as the JAX package's is a ``lax.scan``.

The JAX package's TPU layout devices (the rank-compaction top-K, one-hot
contractions and where-reduces in place of gathers, the float16 path
buffer, the packed per-frame row) give results identical to the flat
forms by construction and have no counterpart here. Where those
contractions turn a picked ``-0.0`` into ``+0.0`` the port adds ``0.0`` to
the gathered value, so the total-order ranking of zero masses agrees.

:func:`compress_blank_frames` shortens the logits before a search by
collapsing each run of blank-dominated frames to its first frame.

A search with no LM whose shape the whole-loop kernel takes runs its
frame loop as one launch: with :data:`~pydrobert_tpu_torch.config.
DECODE_RENORM` on (the default), :func:`~pydrobert_tpu_torch.ops.kernels.
ctc_beam_search_renorm` over the decode prologue's outputs, the scan's own
loop with its rescales; with it off, the JAX package's whole-loop route:
the softmax, the exact top-``M`` of the non-blank probabilities
(:func:`~pydrobert_tpu_torch.ops.topk.hoisted_top_k`) and one
:func:`~pydrobert_tpu_torch.ops.kernels.ctc_beam_search` over every frame,
which carries raw masses. :data:`pydrobert_tpu_torch.config.
USE_BEAM_KERNEL` ``"0"`` keeps the scan.
"""

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import argcheck, config, default_device
from ..lm import (
    ExtractableSequentialLanguageModel,
    LookupLanguageModel,
    MixableSequentialLanguageModel,
    SequentialLanguageModel,
)
from ..utils import pytree as _pytree
from ..utils.profiling import loop_trip, span
from ._ctc_scan import (
    NEG_INF,
    beam_probs,
    ctc_prefix_search_advance,
    ctc_prefix_search_advance_factored,
    prefix_scan,
)
from ._softmax import log_softmax
from .kernels import (
    ctc_beam_search,
    ctc_beam_search_fits,
    ctc_beam_search_renorm,
    decode_prologue,
)
from .topk import exact_top_k, hoisted_top_k

__all__ = [
    "BeamSearch",
    "CTCForcedAligner",
    "CTCGreedySearch",
    "CTCPrefixSearch",
    "RandomWalk",
    "SequenceLogProbabilities",
    "SequentialLanguageModelDistribution",
    "TokenSequenceConstraint",
    "beam_search_advance",
    "compress_blank_frames",
    "ctc_forced_align",
    "ctc_greedy_search",
    "ctc_prefix_search_advance",
    "ctc_prefix_search_advance_factored",
    "random_walk_advance",
    "sequence_log_probs",
]

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
    if logits.dtype == torch.bfloat16:
        # only bfloat16 is upcast; float16 stays float16, as in the JAX
        # package, whose float16 rounding can tie tokens that float32 parts
        logits = logits.float()
    if not batch_first:
        logits = logits.transpose(0, 1)
    if not is_probs:
        logits = log_softmax(logits, 2)
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


def _lm_bias(uni: torch.Tensor, beta: float) -> torch.Tensor:
    """The prologue's bias ``beta * uni``, rounded as the JAX package
    rounds it: ``beta`` cast to float32, one float32 product. Rounding the
    product in float64 and then casting can differ in the last bit, and
    move a token across a tie in the top-M."""
    return (uni.float() * torch.tensor(beta, dtype=torch.float32, device=uni.device)).contiguous()


class CTCPrefixSearch(torch.nn.Module):
    """Batched CTC prefix beam search with optional shallow LM fusion.

    Call: ``search(logits, lens=None, initial_state=None)`` with time-major
    ``logits (T, N, V + 1)`` (blank last) on any device; returns ``(y (T,
    N, W), y_lens (N, W), y_probs (N, W))`` with beams in descending order
    of probability and dummy beams (when fewer than ``W`` prefixes exist)
    at probability ``-inf``. Rows with ``lens == 0`` return the empty
    prefix. float32 and bfloat16 logits are read as they are; any other
    float dtype is upcast to float32 first, as the JAX package's prologue
    does.

    ``lm`` (a :class:`~pydrobert_tpu_torch.lm.MixableSequentialLanguageModel`
    over the same ``V``, on the logits' device) is fused at weight
    ``beta``: extension probabilities are ``lm**beta * am``, or with
    ``valid_mixture`` the mixture ``(1 - beta) * am + beta * lm * (1 -
    blank)``. ``initial_state`` is the LM's starting state. The route
    follows the JAX package:

    - a :class:`~pydrobert_tpu_torch.lm.LookupLanguageModel` of order 2 or
      more with at most :data:`pydrobert_tpu_torch.config.
      SPARSE_FUSION_MAX_CORRECTIONS` corrections takes the sparse advance:
      the prologue's top-``M`` (``M = 2W + max_corrections``) of the logits
      biased by ``beta * uni``, then per beam only those tokens, its stored
      n-gram corrections, its last token and its non-extension;
    - a unigram lookup LM takes the factored advance with the same bias;
    - any other LM, ``valid_mixture``, or more corrections take the dense
      advance over the full softmax, which runs no kernel.

    With no LM (or ``beta == 0``), no ``initial_state``, ``T >= 2``, ``1 <
    W <= min(32, V)`` and a shape that :func:`~pydrobert_tpu_torch.ops.
    kernels.ctc_beam_search_fits` takes (unless :data:`pydrobert_tpu_torch.
    config.USE_BEAM_KERNEL` is ``"0"``), the frame loop is one launch of a
    Hopper kernel on the card. With :data:`~pydrobert_tpu_torch.config.
    DECODE_RENORM` on (the default) it is
    :func:`~pydrobert_tpu_torch.ops.kernels.ctc_beam_search_renorm` after
    the decode prologue, the scan's own loop bit for bit (its plain version
    is the scan). With it off it is the JAX package's whole-loop route:
    the softmax, the top-``M`` and
    :func:`~pydrobert_tpu_torch.ops.kernels.ctc_beam_search` over raw
    masses, whose probabilities can differ from the unrenormalized scan's
    in the last ulps (the softmax is summed in another order).
    """

    def __init__(
        self,
        width: int,
        beta: float = 0.2,
        lm: Optional[MixableSequentialLanguageModel] = None,
        valid_mixture: bool = False,
    ):
        super().__init__()
        self.width = argcheck.is_posi(width, "width")
        self.beta = argcheck.is_float(beta, "beta")
        self.valid_mixture = argcheck.is_bool(valid_mixture, "valid_mixture")
        if lm is not None and not isinstance(lm, MixableSequentialLanguageModel):
            raise TypeError(
                "lm must be a MixableSequentialLanguageModel, got "
                f"{type(lm).__name__}"
            )
        self.lm = lm

    def _takes_beam_route(self, T: int, N: int, V: int) -> bool:
        """Whether a no-LM search of this shape takes the whole-loop route:
        it depends on the config and the shape, never on the device."""
        W = self.width
        return (
            str(config.USE_BEAM_KERNEL) != "0"
            and T >= 2
            and 1 < W <= min(32, V)
            and ctc_beam_search_fits(T, N, V, W)
        )

    def lm_route(self) -> Optional[str]:
        """``"sparse"``, ``"uni"`` or ``"dense"``: the advance the LM
        fusion takes (``decoding.py:1869-1893`` of the JAX package); None
        without fusion."""
        lm = self.lm
        if lm is None or self.beta == 0:
            return None
        if self.valid_mixture or not isinstance(lm, LookupLanguageModel):
            return "dense"
        if lm.max_ngram == 1:
            return "uni"
        if lm.max_corrections <= config.SPARSE_FUSION_MAX_CORRECTIONS:
            return "sparse"
        return "dense"

    def forward(
        self,
        logits: torch.Tensor,
        lens: Optional[torch.Tensor] = None,
        initial_state: Optional[dict] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        with span("search/ctc_prefix"):
            return self._search(logits, lens, initial_state)

    def _search(self, logits, lens, initial_state):
        if logits.dim() != 3:
            raise RuntimeError("logits must be 3 dimensional")
        if logits.dtype not in (torch.float32, torch.bfloat16):
            # the JAX package's prologue upcasts them (decoding.py:103)
            logits = logits.float()
        T, N, Vp1 = logits.shape
        V = Vp1 - 1
        W = self.width
        dev = logits.device
        lm, beta = self.lm, self.beta
        if lm is not None and lm.vocab_size != V:
            raise RuntimeError(
                f"Expected dim 2 of logits to be {lm.vocab_size + 1}, got {Vp1}"
            )
        if isinstance(lm, LookupLanguageModel) and lm.device != dev:
            raise RuntimeError(
                f"the LM's tables are on {lm.device}, the logits on {dev}"
            )
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
        route = self.lm_route()
        beam = route is None and initial_state is None and self._takes_beam_route(T, N, V)
        if beam and not config.DECODE_RENORM:
            # the JAX package's whole-loop route (decoding.py:1912-1930)
            lg32 = logits.float()
            sm_max = lg32.amax(2)
            sm_den = torch.exp(lg32 - sm_max[..., None]).sum(2)
            blank_probs = torch.exp(lg32[..., V] - sm_max) / sm_den
            nonext_probs = torch.exp(lg32[..., :V] - sm_max[..., None]) / sm_den[
                ..., None
            ]
            top = hoisted_top_k(nonext_probs, min(V, 2 * W))
            return ctc_beam_search(nonext_probs, blank_probs, lens, W, top)

        if T == 0:
            y = torch.zeros((0, N, W), dtype=torch.long, device=dev)
            y_lens = torch.zeros((N, W), dtype=torch.long, device=dev)
            y_probs = torch.full((N, W), NEG_INF, dtype=torch.float32, device=dev)
            y_probs[:, 0] = 1.0
            return y, y_lens, y_probs

        if route == "dense":
            probs = torch.softmax(logits.float(), 2)
            # the per-frame slices each advance reads, frame-major
            frames = (probs[..., :V], probs[..., V])
        else:
            # probabilities are only needed at the hoisted top-M tokens, the
            # blank and each beam's last token: normalize those from the
            # raw logits instead of materializing the (T, N, V) softmax. An
            # n-gram LM's unigram weight biases the top-M: g = am * exp(beta
            # * uni) orders like logits + beta * uni.
            g_bias = None if route is None else _lm_bias(lm._uni_t, beta)
            C = lm.max_corrections if route == "sparse" else 0
            M = min(V, 2 * W + C)
            logits = logits.contiguous()
            top_lgts, top_inds, sm_max, sm_den, blank_probs = _decode_prologue(
                logits, M, g_bias
            )
            top_vals = torch.exp(top_lgts - sm_max[..., None]) / sm_den[..., None]
            if route == "uni":
                log_z = float(np.log(lm._sum_u)) if lm._sum_u > 0 else 0.0
                top_vals = top_vals * float(np.exp(-beta * log_z))
            if beam:
                # the scan's frame loop in one launch (csrc/ctc_beam.cu)
                y, y_lens, mass, ls = ctc_beam_search_renorm(
                    logits, top_vals, top_inds, sm_max, sm_den, blank_probs, lens, W
                )
                return y, y_lens, beam_probs(mass, ls, True)
            frames = (top_vals, top_inds.long(), logits, sm_max, sm_den, blank_probs)
        renorm = config.DECODE_RENORM
        y, y_lens, mass, ls = prefix_scan(
            frames, lens, W, V, renorm, route, lm, beta, self.valid_mixture, initial_state,
            # the bigram table of the membership gather, on the LM's device;
            # None (the compare path) when the LM has none
            lm._order2_table() if route == "sparse" and config.SPARSE_MEMBERSHIP_GATHER else None,
            log_z if route == "uni" else 0.0,
        )
        return y, y_lens, beam_probs(mass, ls, renorm)

# ---- beam search and random walks over a sequential LM ----


def _search_device(lm, state) -> torch.device:
    """The device a search over ``lm`` from ``state`` runs on: the first
    tensor of the state, else the LM's tables' device, else ``cuda``."""
    found = []
    _pytree.tree_map(
        lambda leaf: found.append(leaf.device) if isinstance(leaf, torch.Tensor) else None,
        state,
    )
    if found:
        return found[0]
    return default_device(getattr(lm, "device", None))


def _scatter_token_rows(y_ext, lens, y_t):
    """Write ``y_t (1, N, K)`` into ``y_ext (S1, N, K)`` at row ``lens[n, k]``."""
    S1 = y_ext.shape[0]
    pos = torch.arange(S1, device=y_ext.device).reshape(S1, 1, 1)
    return torch.where(pos == lens[None], y_t, y_ext)


def beam_search_advance(
    log_probs_t: torch.Tensor,
    width: int,
    log_probs_prev: torch.Tensor,
    y_prev: torch.Tensor,
    y_prev_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One beam search step: extend every path ``(N, Kp)`` by every token
    of ``log_probs_t (N, Kp, V)`` and keep the best ``width``.

    Returns ``(y_next (S + 1, N, width), y_next_lens, log_probs_next,
    next_src)``; ``y_next`` always gains a row. Missing beams (``Kp * V <
    width``) have log probability ``-inf``. The selection is
    :func:`~pydrobert_tpu_torch.ops.topk.exact_top_k`, ties lowest index
    first, as ``jax.lax.top_k``.
    """
    if log_probs_t.dim() != 3:
        raise RuntimeError("log_probs_t must be 3 dimensional")
    N, Kp, V = log_probs_t.shape
    if width < 1:
        raise RuntimeError(f"Expected width to be >= 1, got {width}")
    if tuple(log_probs_prev.shape) != (N, Kp):
        raise RuntimeError(
            f"Expected log_probs_prev to be of shape {(N, Kp)}, got "
            f"{tuple(log_probs_prev.shape)}"
        )
    if y_prev.dim() != 3:
        raise RuntimeError("y_prev must be 3 dimensional")
    if tuple(y_prev.shape[1:]) != (N, Kp):
        raise RuntimeError(
            f"Expected the last two dimensions of y_prev to be {(N, Kp)}, "
            f"got {tuple(y_prev.shape[1:])}"
        )
    tm1 = y_prev.shape[0]
    if y_prev_lens is not None and tuple(y_prev_lens.shape) != (N, Kp):
        raise RuntimeError(
            f"Expected y_prev_lens to have shape {(N, Kp)}, got "
            f"{tuple(y_prev_lens.shape)}"
        )
    dev = log_probs_t.device
    K = min(width, Kp * V)
    cand = (log_probs_prev[..., None] + log_probs_t).reshape(N, Kp * V)
    log_probs_next, next_ind = exact_top_k(cand, K)
    next_src = next_ind // V
    y_t = (next_ind % V)[None].to(y_prev.dtype)  # (1, N, K)
    if tm1:
        y_next = torch.gather(y_prev, 2, next_src[None].expand(tm1, N, K))
        y_next = torch.cat([y_next, torch.zeros_like(y_t)], 0)
        if y_prev_lens is None:
            y_next[tm1] = y_t[0]
            y_next_lens = torch.full((N, K), tm1 + 1, dtype=torch.long, device=dev)
        else:
            lens_prefix = torch.gather(y_prev_lens.long(), 1, next_src)
            y_next = _scatter_token_rows(y_next, lens_prefix, y_t)
            y_next_lens = lens_prefix + 1
    else:
        if y_prev_lens is not None and bool((y_prev_lens != 0).any()):
            raise RuntimeError("Invalid lengths for t=0")
        y_next = y_t
        y_next_lens = torch.ones((N, K), dtype=torch.long, device=dev)
    if K < width:
        rem = width - K
        y_next = torch.cat([y_next, y_next.new_zeros((y_next.shape[0], N, rem))], 2)
        log_probs_next = torch.cat(
            [log_probs_next, log_probs_next.new_full((N, rem), NEG_INF)], 1
        )
        zeros = torch.zeros((N, rem), dtype=torch.long, device=dev)
        y_next_lens = torch.cat([y_next_lens, zeros], 1)
        next_src = torch.cat([next_src, zeros], 1)
    return y_next, y_next_lens, log_probs_next, next_src


class BeamSearch:
    """Batched beam search over an
    :class:`~pydrobert_tpu_torch.lm.ExtractableSequentialLanguageModel`.

    Per-path eos freezing (a finished path continues only by eos, at log
    probability 0), ``finish_all_paths`` (a batch element is done when
    every path is finished, else when its best is) and ``pad_value`` past
    each path's length, as the JAX package's ``BeamSearch``. Call with
    ``(initial_state=None, batch_size=None, max_iters)``; ``max_iters`` is
    required. Returns ``(y (max_iters, N, width), y_lens (N, width),
    y_log_probs (N, width))``, without the batch axis when ``batch_size``
    is None. The search runs on the initial state's device, else the LM's
    (``cuda`` by default).

    While a profiler runs, a call is one ``pydt.search/beam`` span, each
    step after the first a ``pydt.loop/beam_search`` trip, and the host's
    read of whether every element is done a ``pydt.sync/beam_done``.
    Freezing finished elements leaves alone a state leaf the LM's step and
    reorder returned unchanged (the same tensor), and ``frozen_bytes``
    counts the bytes the freezes read and wrote.
    """

    def __init__(
        self,
        lm: ExtractableSequentialLanguageModel,
        width: int,
        eos: Optional[int] = None,
        finish_all_paths: bool = False,
        pad_value: int = config.INDEX_PAD_VALUE,
    ):
        self.width = argcheck.is_posi(width, "width")
        if eos is not None:
            if eos < -lm.vocab_size or eos >= lm.vocab_size:
                raise ValueError(f"eos ({eos}) must index a token in the vocabulary")
            eos = (eos + lm.vocab_size) % lm.vocab_size
        self.lm = lm
        self.eos = eos
        self.finish_all_paths = argcheck.is_bool(finish_all_paths, "finish_all_paths")
        self.pad_value = argcheck.is_int(pad_value, "pad_value")
        self.frozen_bytes = 0

    def update_log_probs_for_step(
        self, log_probs_prev, log_probs_t, y_prev, y_prev_lens, eos_mask
    ):
        """Subclass hook to turn probabilities into scores for one step."""
        return log_probs_prev, log_probs_t

    def takes_sparse_route(self) -> bool:
        """Whether the LM is a lookup n-gram LM of order 2 or more with at
        most :data:`~pydrobert_tpu_torch.config.SPARSE_FUSION_MAX_CORRECTIONS`
        corrections and the scores are the log probabilities (read at call
        time, as the JAX package reads it)."""
        lm = self.lm
        return (
            isinstance(lm, LookupLanguageModel)
            and lm.max_ngram >= 2
            and lm.max_corrections <= config.SPARSE_FUSION_MAX_CORRECTIONS
            and type(self).update_log_probs_for_step
            is BeamSearch.update_log_probs_for_step
        )

    def __call__(
        self,
        initial_state: Optional[Dict[str, Any]] = None,
        batch_size: Optional[int] = None,
        max_iters: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        with span("search/beam"):
            return self._search(initial_state, batch_size, max_iters)

    def _search(self, initial_state, batch_size, max_iters):
        lm, W, V, eos = self.lm, self.width, self.lm.vocab_size, self.eos
        initial_state = {} if initial_state is None else initial_state
        if max_iters is None:
            raise ValueError("max_iters must be set")
        if max_iters < 0:
            raise RuntimeError(f"max_iters must be non-negative, got {max_iters}")
        N = 1 if batch_size is None else batch_size
        S = max_iters
        dev = _search_device(lm, initial_state)
        f32, i64 = torch.float32, torch.long

        def out(y, lens, lp):
            if batch_size is None:
                return y[:, 0], lens[0], lp[0]
            return y, lens, lp

        state = lm.update_input(initial_state, torch.zeros((0, N), dtype=i64, device=dev))
        if S == 0:
            lp = torch.full((N, W), NEG_INF, dtype=f32, device=dev)
            lp[:, 0] = 0.0
            return out(
                torch.zeros((0, N, W), dtype=i64, device=dev),
                torch.zeros((N, W), dtype=i64, device=dev), lp,
            )
        y_buf = torch.full((S, N, 1), self.pad_value, dtype=i64, device=dev)
        eos_vec = None if eos is None else torch.arange(V, device=dev) == eos

        def lm_step(y_buf_k, state, t, Kp):
            hist = y_buf_k.clamp(0, V - 1).reshape(S, N * Kp)
            log_probs_t, in_next = lm.calc_idx_log_probs(hist, state, t)
            return log_softmax(log_probs_t.reshape(N, Kp, V), -1), in_next

        def mask_eos(log_probs_t, eos_mask):
            if eos is None:
                return log_probs_t
            em = eos_mask[..., None]
            lp = torch.where(em, NEG_INF, log_probs_t)
            return torch.where(em & eos_vec, 0.0, lp)

        use_sparse = self.takes_sparse_route()
        if use_sparse:
            # a backoff LM's conditional is uni[v] + base_k except on the
            # beam's C stored corrections, and base_k keeps the beam's
            # order, so the top-W extensions come from a static top-M of
            # the unigrams, the corrections and eos
            Ng = lm.max_ngram
            M = min(V, W + lm.max_corrections + 1)
            uni_np = np.asarray(lm._uni_logp)
            order = np.argsort(-uni_np, kind="stable")[:M]
            top_toks = torch.as_tensor(order.astype(np.int64), device=dev)
            stop_vals = torch.as_tensor(uni_np[order].astype(np.float32), device=dev)
            uni_eos = float(uni_np[eos]) if eos is not None else 0.0

            def select_sparse(lp_prev, ctx, eos_mask, Kp, K):
                """``(lp_next, next_src, y_tok)``: the top-K over every
                beam's slots."""
                base, ctoks, cvals, cvalid, logZ = lm.sparse_corrections_ext(ctx)[:5]
                ctoks = ctoks.long()
                lp3 = lp_prev[:, :, None]
                shared = lp3 + (base - logZ)[:, :, None] + stop_vals
                dup = (
                    (top_toks[None, None, :, None] == ctoks[:, :, None, :])
                    & cvalid[:, :, None, :]
                ).any(3)
                if eos is not None:
                    dup = dup | (top_toks == eos)[None, None, :]
                shared = torch.where(dup, NEG_INF, shared)
                corr = lp3 + cvals - logZ[:, :, None]
                corr_bad = ~cvalid
                if eos is not None:
                    corr_bad = corr_bad | (ctoks == eos)
                corr = torch.where(corr_bad, NEG_INF, corr)
                slots = [shared, corr]
                slot_toks = [top_toks[None, None].expand(N, Kp, M), ctoks]
                if eos is not None:
                    em3 = eos_mask[:, :, None]
                    slots = [torch.where(em3, NEG_INF, shared), torch.where(em3, NEG_INF, corr)]
                    eos_in_corr = (ctoks == eos) & cvalid
                    lm_eos = torch.where(eos_in_corr, cvals, 0.0).sum(2) + torch.where(
                        eos_in_corr.any(2), 0.0, base + uni_eos
                    )
                    eos_score = lp_prev + lm_eos - logZ
                    # finished beams continue only via eos, at log-prob 0
                    eos_score = torch.where(eos_mask, lp_prev, eos_score)
                    slots.append(eos_score[:, :, None])
                    slot_toks.append(torch.full((N, Kp, 1), eos, dtype=i64, device=dev))
                cand = torch.cat(slots, 2)  # (N, Kp, Ssl)
                toks = torch.cat(slot_toks, 2)
                Ssl = cand.shape[2]
                lp_next, ind = exact_top_k(cand.reshape(N, Kp * Ssl), K)
                return lp_next, ind // Ssl, torch.gather(toks.reshape(N, Kp * Ssl), 1, ind)

            ctx = torch.full((Ng - 1, N, 1), lm.sos, dtype=i64, device=dev)
        else:
            ctx = None

        # ---- step 0 (beam width 1 -> W) ----
        lp_prev0 = torch.zeros((N, 1), dtype=f32, device=dev)
        eos_mask0 = torch.zeros((N, 1), dtype=torch.bool, device=dev)
        K = min(W, V)
        if use_sparse:
            in_next = state
            log_probs, _, y_t = select_sparse(lp_prev0, ctx, eos_mask0, 1, K)
            ctx_b = ctx.expand(Ng - 1, N, K)
            ctx = torch.cat([y_t[None], ctx_b[:-1]], 0)
            if K < W:
                ctx = torch.cat(
                    [ctx, torch.full((Ng - 1, N, W - K), lm.sos, dtype=i64, device=dev)], 2
                )
        else:
            log_probs_t, in_next = lm_step(y_buf, state, 0, 1)
            lens0 = torch.zeros((N, 1), dtype=i64, device=dev)
            lp_prev0, log_probs_t = self.update_log_probs_for_step(
                lp_prev0, log_probs_t, y_buf, lens0, eos_mask0
            )
            log_probs_t = mask_eos(log_probs_t, eos_mask0)
            cand = (lp_prev0[..., None] + log_probs_t).reshape(N, V)
            log_probs, next_ind = exact_top_k(cand, K)
            y_t = next_ind % V
        if K < W:
            log_probs = torch.cat([log_probs, log_probs.new_full((N, W - K), NEG_INF)], 1)
            y_t = torch.cat([y_t, y_t.new_zeros((N, W - K))], 1)
        y_buf = y_buf.expand(S, N, W).clone()
        y_buf[0] = y_t
        y_lens = torch.cat(
            [torch.ones((N, K), dtype=i64, device=dev), torch.zeros((N, W - K), dtype=i64, device=dev)],
            1,
        )
        state = lm.extract_by_src(in_next, torch.arange(N, device=dev).repeat_interleave(W))
        if eos is not None:
            eos_mask = (y_t == eos) & (y_lens > 0)
        else:
            eos_mask = torch.zeros((N, W), dtype=torch.bool, device=dev)
        flat_base = torch.arange(N, device=dev)[:, None] * W

        for t in range(1, S):
            with loop_trip("beam_search"):
                if eos is not None:
                    done = eos_mask.all(1) if self.finish_all_paths else eos_mask[:, 0]
                    with span("sync/beam_done"):
                        finished = bool(done.all())
                    if finished:
                        break
                    done_mask = (
                        eos_mask.all(1, keepdim=True) if self.finish_all_paths else eos_mask[:, :1]
                    )
                else:
                    done_mask = torch.zeros((N, 1), dtype=torch.bool, device=dev)
                if use_sparse:
                    in_next = state
                    lp_next, next_src, y_tok = select_sparse(log_probs, ctx, eos_mask, W, W)
                    y_t = y_tok[None]  # (1, N, W)
                else:
                    log_probs_t, in_next = lm_step(y_buf, state, t, W)
                    log_probs_prev, log_probs_t = self.update_log_probs_for_step(
                        log_probs, log_probs_t, y_buf, y_lens, eos_mask
                    )
                    log_probs_t = mask_eos(log_probs_t, eos_mask)
                    cand = (log_probs_prev[..., None] + log_probs_t).reshape(N, W * V)
                    lp_next, next_ind = exact_top_k(cand, W)
                    next_src = next_ind // V
                    y_t = (next_ind % V)[None]
                y_next = torch.gather(y_buf, 2, next_src[None].expand(S, N, W))
                lens_prefix = torch.gather(y_lens, 1, next_src)
                y_next = _scatter_token_rows(y_next, lens_prefix, y_t)
                lens_next = lens_prefix + 1
                if eos is not None:
                    lens_next = lens_next - torch.gather(eos_mask.long(), 1, next_src)
                state_next = lm.extract_by_src(in_next, (flat_base + next_src).reshape(-1))
                if use_sparse:
                    ctx_src = torch.gather(ctx, 2, next_src[None].expand(Ng - 1, N, W))
                    ctx_next = torch.cat([y_t, ctx_src[:-1]], 0)
                    ctx = torch.where(done_mask[None], ctx, ctx_next)
                # freeze finished batch elements
                y_next = torch.where(done_mask[None], y_buf, y_next)
                lens_next = torch.where(done_mask, y_lens, lens_next)
                lp_next = torch.where(done_mask, log_probs, lp_next)
                if eos is not None and not use_sparse:
                    keep = done_mask[:, 0].repeat_interleave(W)

                    def freeze(new, old):
                        if new is not old and new.dim() and new.shape[0] == N * W:
                            self.frozen_bytes += 3 * new.numel() * new.element_size()
                            return torch.where(
                                keep.reshape((N * W,) + (1,) * (new.dim() - 1)), old, new
                            )
                        return new

                    state_next = _pytree.tree_map(freeze, state_next, state)
                if eos is not None:
                    eos_next = (y_t[0] == eos) & (lens_next > 0)
                    eos_mask = torch.where(done_mask, eos_mask, eos_next)
                y_buf, y_lens, log_probs, state = y_next, lens_next, lp_next, state_next
        return out(y_buf, y_lens, log_probs)


def _gumbel_max(generator: Optional[torch.Generator], log_probs: torch.Tensor) -> torch.Tensor:
    """One sample per row of ``log_probs (N, V)``, from the categorical
    distribution of its softmax: ``argmax(log_probs + Gumbel noise)``, the
    uniforms drawn from ``generator`` (on its own device)."""
    dev = log_probs.device if generator is None else generator.device
    u = torch.rand(log_probs.shape, generator=generator, device=dev).to(log_probs.device)
    return torch.argmax(log_probs - torch.log(-torch.log(u)), -1)


def random_walk_advance(
    generator: Optional[torch.Generator],
    log_probs_t: torch.Tensor,
    log_probs_prev: torch.Tensor,
    y_prev: torch.Tensor,
    y_prev_lens: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One random-walk step: sample a token per batch element from
    ``log_probs_t (N, V)`` with ``generator``. Returns ``(y_next (S + 1,
    N), log_probs_next (N,))``; ``y_next`` always gains a row, and with
    ``y_prev_lens`` the token lands at each element's length."""
    if log_probs_t.dim() != 2:
        raise RuntimeError("log_probs_t must be 2-dimensional")
    N, V = log_probs_t.shape
    if tuple(log_probs_prev.shape) != (N,):
        raise RuntimeError(
            f"Expected log_probs_prev to be of shape {(N,)}, got "
            f"{tuple(log_probs_prev.shape)}"
        )
    if y_prev.dim() != 2:
        raise RuntimeError("y_prev must be 2-dimensional")
    if y_prev.shape[1] != N:
        raise RuntimeError(f"Expected dim 1 of y_prev to be {N}, got {y_prev.shape[1]}")
    tm1 = y_prev.shape[0]
    y_t = _gumbel_max(generator, log_probs_t)
    log_probs_next = log_probs_prev + torch.gather(log_probs_t, 1, y_t[:, None])[:, 0]
    y_t = y_t.to(y_prev.dtype if tm1 else torch.long)
    if tm1:
        y_next = torch.cat([y_prev, y_t[None]], 0)
        if y_prev_lens is not None:
            pos = torch.arange(tm1 + 1, device=y_prev.device)[:, None]
            y_next = torch.where(pos == y_prev_lens[None], y_t[None], y_next)
    else:
        y_next = y_t[None]
    return y_next, log_probs_next


class RandomWalk:
    """Ancestral sampling from a
    :class:`~pydrobert_tpu_torch.lm.SequentialLanguageModel`: each step
    draws a token from the LM's conditional (all ``V`` tokens scored), a
    finished path (one that drew ``eos``) continues only by eos at log
    probability 0, and the walk stops when every path is finished or after
    ``max_iters`` steps. Call with ``(generator, initial_state=None,
    batch_size=None, max_iters)``; returns ``(y (max_iters, N), y_lens
    (N,), y_log_probs (N,))``, without the batch axis when ``batch_size``
    is None. Unfilled rows of ``y`` are 0, and a finished path's rows
    after its eos repeat eos, as in the JAX package's walk.
    """

    def __init__(self, lm: SequentialLanguageModel, eos: Optional[int] = None):
        if eos is not None:
            if eos < -lm.vocab_size or eos >= lm.vocab_size:
                raise ValueError(f"eos ({eos}) must index a token in the vocabulary")
            eos = (eos + lm.vocab_size) % lm.vocab_size
        self.lm = lm
        self.eos = eos

    def update_log_probs_for_step(
        self, log_probs_prev, log_probs_t, y_prev, y_prev_lens, eos_mask
    ):
        """Subclass hook to turn probabilities into scores for one step."""
        return log_probs_prev, log_probs_t

    def __call__(
        self,
        generator: Optional[torch.Generator],
        initial_state: Optional[Dict[str, Any]] = None,
        batch_size: Optional[int] = None,
        max_iters: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        lm, eos = self.lm, self.eos
        V = lm.vocab_size
        prev = {} if initial_state is None else initial_state
        if max_iters is None:
            raise ValueError("max_iters must be set")
        if max_iters < 0:
            raise RuntimeError(f"max_iters must be non-negative, got {max_iters}")
        N = 1 if batch_size is None else batch_size
        S = max_iters
        dev = _search_device(lm, prev)
        prev = lm.update_input(prev, torch.zeros((0, N), dtype=torch.long, device=dev))
        y = torch.zeros((S, N), dtype=torch.long, device=dev)
        y_lens = torch.zeros((N,), dtype=torch.long, device=dev)
        eos_mask = torch.zeros((N,), dtype=torch.bool, device=dev)
        log_probs = torch.zeros((N,), dtype=torch.float32, device=dev)
        eos_vec = None if eos is None else torch.arange(V, device=dev) == eos
        pos = torch.arange(S, device=dev)[:, None]
        for t in range(S):
            if eos is not None and bool(eos_mask.all()):
                break
            log_probs_t, prev = lm.calc_idx_log_probs(y, prev, t)
            log_probs_t = log_softmax(log_probs_t, -1)
            log_probs, log_probs_t = self.update_log_probs_for_step(
                log_probs, log_probs_t, y, y_lens, eos_mask
            )
            if eos is not None:
                lp = torch.where(eos_mask[:, None], NEG_INF, log_probs_t)
                log_probs_t = torch.where(eos_mask[:, None] & eos_vec, 0.0, lp)
            y_t = _gumbel_max(generator, log_probs_t)
            log_probs = log_probs + torch.gather(log_probs_t, 1, y_t[:, None])[:, 0]
            y = torch.where(pos == y_lens[None], y_t[None], y)
            if eos is not None:
                y_lens = y_lens + (~eos_mask).long()
                last = torch.gather(y, 0, (y_lens - 1).clamp_min(0)[None])[0]
                eos_mask = (last == eos) & (y_lens > 0)
            else:
                y_lens = y_lens + 1
        if batch_size is None:
            return y[:, 0], y_lens[0], log_probs[0]
        return y, y_lens, log_probs


def sequence_log_probs(
    logits: torch.Tensor,
    hyp: torch.Tensor,
    dim: int = 0,
    eos: Optional[int] = None,
) -> torch.Tensor:
    """Joint log probability of the sequences ``hyp`` under ``logits``
    (``hyp``'s shape plus the vocabulary): the log-softmax of ``logits`` at
    each token, summed over ``dim`` up to and including the first ``eos``.
    Tokens outside ``[0, V)`` (padding) count nothing."""
    from .string import _lens_from_eos

    hyp_dim = hyp.dim()
    if dim < -hyp_dim or dim > hyp_dim - 1:
        raise RuntimeError(
            "Dimension out of range (expected to be in range of [{}, {}], but "
            "got {})".format(-hyp_dim, hyp_dim - 1, dim)
        )
    dim = (hyp_dim + dim) % hyp_dim
    steps = hyp.shape[dim]
    num_classes = logits.shape[-1]
    logits = log_softmax(logits, -1)
    hyp = hyp.to(logits.device)
    mask = (hyp < 0) | (hyp >= num_classes)
    if eos is not None:
        hyp_lens = _lens_from_eos(hyp, eos, dim) + 1
        shape = [1] * hyp_dim
        shape[dim] = steps
        arange = torch.arange(steps, device=hyp.device).reshape(shape)
        mask = mask | (arange >= hyp_lens.unsqueeze(dim))
    hyp_safe = torch.where(mask, 0, hyp).long()
    gathered = torch.gather(logits, -1, hyp_safe[..., None])[..., 0]
    return torch.where(mask, 0.0, gathered).sum(dim)


class SequenceLogProbabilities(torch.nn.Module):
    """Module wrapper for :func:`sequence_log_probs`."""

    def __init__(self, dim: int = 0, eos: Optional[int] = None):
        super().__init__()
        self.dim = argcheck.is_int(dim, "dim")
        self.eos = None if eos is None else argcheck.is_int(eos, "eos")

    def forward(self, logits, hyp):
        return sequence_log_probs(logits, hyp, self.dim, self.eos)


class TokenSequenceConstraint:
    """Support of completed token sequences: a value is in the support when
    its tokens lie in ``[0, vocab_size)`` and it is completed, its length
    equal to ``max_iters`` or holding an ``eos`` within ``max_iters``
    steps."""

    is_discrete = True
    event_dim = 1

    def __init__(self, vocab_size: int, eos: Optional[int] = None, max_iters: Optional[int] = None):
        self.vocab_size = argcheck.is_posi(vocab_size, "vocab_size")
        if eos is None and max_iters is None:
            raise ValueError("At least one of max_iters or eos must be non-none")
        self.eos = None if eos is None else argcheck.is_int(eos, "eos")
        self.max_iters = (
            float("inf") if max_iters is None else argcheck.is_nonnegi(max_iters, "max_iters")
        )

    def check(self, value: torch.Tensor) -> torch.Tensor:
        value = torch.as_tensor(value)
        completed = torch.full(
            value.shape[:-1], value.shape[-1] == self.max_iters, device=value.device
        )
        if self.eos is not None:
            from .string import fill_after_eos

            value = fill_after_eos(value, self.eos, -1)
            completed = (
                (value == self.eos).any(-1) & (value.shape[-1] <= self.max_iters)
            ) | completed
        in_vocab = ((value % 1 == 0) & (value >= 0) & (value < self.vocab_size)).all(-1)
        return in_vocab & completed


class SequentialLanguageModelDistribution:
    """A :class:`RandomWalk`'s language model as a distribution over token
    sequences, for the estimators of :mod:`pydrobert_tpu_torch.estimators`.

    Samples come from the walk (``sample(sample_shape, generator)``), one
    walk of ``batch_shape[0]`` paths per sample when ``batch_shape`` is
    given; log-probabilities from the LM's whole step distributions,
    summed up to the first eos. As in the JAX package, ``max_iters`` is
    required and samples are padded to it with eos, and the sample cache
    is keyed on the identity of the value, not on its contents.
    """

    def __init__(
        self,
        random_walk: RandomWalk,
        batch_shape: Tuple[int, ...] = (),
        initial_state: Optional[Dict[str, Any]] = None,
        max_iters: Optional[int] = None,
        cache_samples: bool = False,
        validate_args: Optional[bool] = None,
    ):
        if max_iters is None:
            raise ValueError("max_iters must be set (static sequence bound)")
        if len(tuple(batch_shape)) > 1:
            raise ValueError(f"batch_shape must be scalar or 1-D, got {tuple(batch_shape)}")
        self.random_walk = random_walk
        self.batch_shape = tuple(batch_shape)
        self.event_shape = (argcheck.is_nonnegi(max_iters, "max_iters"),)
        self.initial_state = dict() if initial_state is None else initial_state
        self.max_iters = max_iters
        self.cache_samples = argcheck.is_bool(cache_samples, "cache_samples")
        self._samples_cache = None
        self._log_probs_cache = None

    @property
    def support(self) -> TokenSequenceConstraint:
        return TokenSequenceConstraint(
            self.random_walk.lm.vocab_size, self.random_walk.eos, self.max_iters
        )

    def _pad_eos(self, y: torch.Tensor, y_lens: torch.Tensor) -> torch.Tensor:
        if self.random_walk.eos is None:
            return y
        pos = torch.arange(y.shape[0], device=y.device)[:, None]
        return torch.where(pos >= y_lens[None], self.random_walk.eos, y)

    def sample(
        self, sample_shape: Tuple[int, ...] = (), generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        shape = tuple(sample_shape) + self.batch_shape + self.event_shape
        num_samples = int(np.prod(sample_shape, dtype=np.int64))
        if num_samples == 0:
            return torch.zeros(shape, dtype=torch.long)
        walk, state = self.random_walk, self.initial_state
        # the samples are discrete; only cached log-probabilities keep a graph
        with torch.set_grad_enabled(torch.is_grad_enabled() and self.cache_samples):
            if len(self.batch_shape):
                samples, log_probs = [], []
                for _ in range(num_samples):
                    y, y_lens, lp = walk(generator, dict(state), self.batch_shape[0], self.max_iters)
                    samples.append(self._pad_eos(y, y_lens).T)
                    log_probs.append(lp)
                samples, log_probs = torch.stack(samples), torch.stack(log_probs)
            else:
                y, y_lens, log_probs = walk(generator, dict(state), num_samples, self.max_iters)
                samples = self._pad_eos(y, y_lens).T  # (num, S)
        samples = samples.reshape(shape)
        if self.cache_samples:
            self._samples_cache = samples
            self._log_probs_cache = log_probs.reshape(shape[:-1])
        return samples

    @property
    def has_enumerate_support(self) -> bool:
        return self.max_iters is not None

    def enumerate_support(self, expand: bool = True) -> torch.Tensor:
        from .combinatorics import enumerate_vocab_sequences

        lm = self.random_walk.lm
        support = enumerate_vocab_sequences(self.max_iters, lm.vocab_size, device="cpu")
        if self.random_walk.eos is not None:
            from .string import fill_after_eos

            support = fill_after_eos(support, self.random_walk.eos, 1)
            support = torch.from_numpy(np.unique(support.numpy(), axis=0))
        # enumerated on the host (np.unique), returned where the walk runs
        support = support.to(_search_device(lm, self.initial_state))
        if len(self.batch_shape):
            support = support.reshape((-1,) + (1,) * len(self.batch_shape) + support.shape[-1:])
            if expand:
                support = support.expand(
                    (support.shape[0],) + self.batch_shape + support.shape[-1:]
                )
        return support

    def clear_cache(self) -> None:
        """Manually clear the sample cache."""
        self._samples_cache = self._log_probs_cache = None

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        if self.cache_samples and self._samples_cache is not None and self._samples_cache is value:
            return self._log_probs_cache
        lm, eos = self.random_walk.lm, self.random_walk.eos
        shape = value.shape[:-1]
        if len(self.batch_shape):
            flat = value.reshape((-1,) + tuple(value.shape[-2:])).long()  # (num, batch, S)
            log_probs = torch.stack(
                [lm(h.T[:-1], dict(self.initial_state)) for h in flat]
            )  # (num, S, batch, V)
            lp = sequence_log_probs(log_probs.transpose(1, 2), flat, dim=-1, eos=eos)
        else:
            flat = value.reshape(-1, value.shape[-1]).long()  # (num, S)
            log_probs = lm(flat.T[:-1], dict(self.initial_state))  # (S, num, V)
            lp = sequence_log_probs(log_probs.transpose(0, 1), flat, dim=-1, eos=eos)
        lp = lp.reshape(shape)
        if self.cache_samples:
            self._samples_cache = value
            self._log_probs_cache = lp
        return lp


def _emissions(lp: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``emit (N, T, S)``: ``lp (N, T, V)`` at each state's label ``z (N,
    S)``, as the JAX package's one-hot contraction ``sum_v lp[v] *
    onehot(z)[v]`` gives it: a frame with a non-finite entry anywhere but
    at ``z`` sums an ``inf * 0`` and gives NaN, and a label outside ``[0,
    V)`` picks nothing, 0."""
    V = lp.shape[2]
    in_vocab = (z >= 0) & (z < V)
    idx = torch.where(in_vocab, z, 0)[:, None].expand(-1, lp.shape[1], -1)
    picked = torch.gather(lp, 2, idx)
    nonfinite = ~torch.isfinite(lp)
    at_z = torch.gather(nonfinite, 2, idx) & in_vocab[:, None]
    others = nonfinite.sum(2, keepdim=True) - at_z.long()
    picked = torch.where(in_vocab[:, None], picked, torch.zeros((), dtype=lp.dtype, device=lp.device))
    return torch.where(others > 0, torch.full((), float("nan"), dtype=lp.dtype, device=lp.device), picked)


def ctc_forced_align(
    logits: torch.Tensor,
    refs: torch.Tensor,
    in_lens: Optional[torch.Tensor] = None,
    ref_lens: Optional[torch.Tensor] = None,
    blank_idx: int = -1,
    batch_first: bool = False,
    is_probs: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Viterbi forced alignment over the CTC lattice.

    For each batch element, the most probable frame-level label sequence
    (tokens and blanks) that collapses to the reference: the best path
    through the states ``blank, r_1, blank, ..., r_U, blank`` with CTC's
    stay, advance and skip-over-blank moves. ``logits (T, N, V)`` (``(N,
    T, V)`` with ``batch_first``) are log-softmaxed unless ``is_probs``
    (then logged); ``refs (U, N)`` (``(N, U)``) hold ``ref_lens`` valid
    labels each, no blank among them. Returns ``(paths, scores)``:
    ``paths (T, N)`` (``(N, T)``) the label of each frame, valid for frames
    before ``in_lens`` (later frames repeat the final state's label), and
    ``scores (N,)`` the best path's log probability, ``-inf`` for a
    reference its frames cannot hold (the path is then arbitrary).

    One Viterbi step a frame on the logits' device, backpointers kept as
    int8, then a backtrace a frame, as the JAX package's forward and
    reverse scans. Only bfloat16 is upcast; float16 takes ``jax.nn``'s
    rounding steps. Emissions are gathered, but with the JAX package's
    one-hot contraction's values: a frame holding a non-finite
    log-probability off the state's label (a zero probability, a ``-inf``
    logit) gives that state NaN, and NaN then spreads through the
    maxima, so the score is NaN as in the JAX package.
    """
    if logits.dim() != 3:
        raise RuntimeError("logits must be 3-dimensional")
    if refs.dim() != 2:
        raise RuntimeError("refs must be 2-dimensional")
    if not batch_first:
        logits, refs = logits.transpose(0, 1), refs.T
    N, T, V = logits.shape
    U = refs.shape[1]
    if refs.shape[0] != N:
        raise RuntimeError(f"batch dim of refs ({refs.shape[0]}) != logits ({N})")
    if blank_idx < -V or blank_idx > (V - 1):
        raise RuntimeError(
            "Blank index out of range (expected to be in the range of "
            f"[-{V},{V-1}], but got {blank_idx})"
        )
    blank_idx = (blank_idx + V) % V
    dev = logits.device
    refs = refs.to(dev).long()
    in_lens = (
        torch.full((N,), T, dtype=torch.long, device=dev)
        if in_lens is None else torch.as_tensor(in_lens).to(dev).long()
    )
    ref_lens = (
        torch.full((N,), U, dtype=torch.long, device=dev)
        if ref_lens is None else torch.as_tensor(ref_lens).to(dev).long()
    )
    if logits.dtype == torch.bfloat16:
        logits = logits.float()  # exact; the Viterbi runs in float32
    lp = torch.log(logits) if is_probs else log_softmax(logits, -1)

    S = 2 * U + 1
    s_idx = torch.arange(S, device=dev)
    is_tok = (s_idx % 2) == 1  # odd states carry reference tokens
    tok_pos = ((s_idx - 1) // 2).clamp(0, max(U - 1, 0))
    padded = torch.cat([refs, refs.new_zeros((N, 1))], 1)
    z = torch.where(is_tok[None], padded[:, tok_pos], blank_idx)  # (N, S) state labels
    valid_s = s_idx[None] < (2 * ref_lens[:, None] + 1)
    # s - 2 -> s skips the blank between two different tokens
    prev_tok = torch.roll(z, 2, 1)
    can_skip = is_tok[None] & (s_idx[None] >= 2) & (z != prev_tok) & valid_s
    emit = _emissions(lp, z).transpose(0, 1)  # (T, N, S)

    neg = torch.full((), NEG_INF, dtype=lp.dtype, device=dev)
    delta = torch.where((s_idx[None] < 2) & valid_s, emit[0], neg)
    # stay reads pad[:, 2:], advance pad[:, 1:-1], skip pad[:, :-2]
    pad = torch.full((N, S + 2), NEG_INF, dtype=lp.dtype, device=dev)
    bps = torch.zeros((max(T - 1, 0), N, S), dtype=torch.int8, device=dev)
    two, one = torch.tensor(2, dtype=torch.int8, device=dev), torch.tensor(1, dtype=torch.int8, device=dev)
    zero = torch.tensor(0, dtype=torch.int8, device=dev)
    for t in range(1, T):
        pad[:, 2:] = delta
        adv = pad[:, 1:-1]
        skip = torch.where(can_skip, pad[:, :-2], neg)
        best = torch.maximum(torch.maximum(delta, adv), skip)
        bp = torch.where(skip >= best, two, torch.where(adv >= best, one, zero))
        new = torch.where(valid_s, best + emit[t], neg)
        live = (t < in_lens)[:, None]
        delta = torch.where(live, new, delta)
        bps[t - 1] = torch.where(live, bp, zero)

    # the best final state: the last blank (2 U_b) or the last token
    end_blank = 2 * ref_lens
    end_tok = (2 * ref_lens - 1).clamp(0, S - 1)
    d_blank = torch.gather(delta, 1, end_blank[:, None])[:, 0]
    d_tok = torch.where(ref_lens > 0, torch.gather(delta, 1, end_tok[:, None])[:, 0], neg)
    scores = torch.maximum(d_blank, d_tok)
    state = torch.where(d_blank >= d_tok, end_blank, end_tok)
    states = torch.empty((T, N), dtype=torch.long, device=dev)
    states[T - 1] = state
    for t in range(T - 2, -1, -1):
        state = state - torch.gather(bps[t], 1, state[:, None])[:, 0]
        states[t] = state
    paths = torch.gather(z, 1, states.T)  # (N, T)
    if not batch_first:
        paths = paths.T
    return paths, scores


class CTCForcedAligner(torch.nn.Module):
    """Module wrapper for :func:`ctc_forced_align`."""

    def __init__(self, blank_idx: int = -1, batch_first: bool = False, is_probs: bool = False):
        super().__init__()
        self.blank_idx = argcheck.is_int(blank_idx, "blank_idx")
        self.batch_first = argcheck.is_bool(batch_first, "batch_first")
        self.is_probs = argcheck.is_bool(is_probs, "is_probs")

    def forward(self, logits, refs, in_lens=None, ref_lens=None):
        return ctc_forced_align(
            logits, refs, in_lens, ref_lens, self.blank_idx, self.batch_first, self.is_probs
        )


def compress_blank_frames(
    logits: torch.Tensor,
    in_lens: Optional[torch.Tensor] = None,
    threshold: float = 0.99,
    max_frames: Optional[int] = None,
    batch_first: bool = False,
    is_probs: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Collapse every run of frames whose blank probability is at least
    ``threshold`` to its first frame, and pack the kept frames to the
    front of the time axis, in order.

    ``logits (T, N, V + 1)`` (``(N, T, V + 1)`` with ``batch_first``) hold
    the blank last; ``in_lens (N,)`` masks the valid frames. The blank's
    probability is ``softmax(logits)`` taken by the JAX package's steps
    (the float32 max, the sum of exponentials, then ``exp(blank - max) /
    den``), or the blank lane itself with ``is_probs``. One surviving blank
    keeps repeated tokens on either side apart, so greedy transcripts are
    unchanged for any ``threshold`` above 0.5. ``max_frames``, if given,
    cuts the output to that many frames (kept frames past it are dropped
    and not counted). Returns ``(new_logits, new_lens)`` in the input's
    layout, contiguous; frames past ``new_lens[n]`` are arbitrary.
    """
    if logits.dim() != 3:
        raise RuntimeError("logits must be 3-dimensional")
    if not 0.0 < threshold <= 1.0:
        raise RuntimeError(f"threshold must be in (0, 1], got {threshold}")
    if batch_first:
        logits = logits.transpose(0, 1)
    T, N, _ = logits.shape
    dev = logits.device
    if in_lens is None:
        in_lens = torch.full((N,), T, dtype=torch.int32, device=dev)
    else:
        in_lens = torch.as_tensor(in_lens, device=dev).to(torch.int32)
    lp32 = logits[..., -1].float()  # the blank lane, (T, N)
    if is_probs:
        p_blank = lp32
    else:
        mx = logits.amax(2).float()
        den = torch.exp(logits.float() - mx[..., None]).sum(2)
        p_blank = torch.exp(lp32 - mx) / den
    t_iota = torch.arange(T, dtype=torch.int32, device=dev)[:, None]
    valid = t_iota < in_lens[None]  # (T, N)
    dom = (p_blank >= threshold) & valid
    prev_dom = torch.cat([torch.zeros_like(dom[:1]), dom[:-1]], 0)
    keep = valid & ~(dom & prev_dom)
    # a stable compaction: kept frames keyed by their position, the others
    # pushed past T
    order = torch.sort(torch.where(keep, t_iota, T + t_iota), dim=0, stable=True).indices
    new_lens = keep.sum(0, dtype=torch.int32)
    if max_frames is not None and max_frames < T:
        order = order[:max_frames]
        new_lens = torch.clamp(new_lens, max=max_frames)
    out = torch.gather(logits, 0, order[..., None].expand(-1, -1, logits.shape[2]))
    if batch_first:
        out = out.transpose(0, 1).contiguous()
    return out, new_lens
