"""RNN-Transducer loss and searches (counterpart of
:mod:`pydrobert_tpu.ops.transducer`).

The lattice recurrence

    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                            alpha[t, u-1] + emit[t, u-1])

is, along ``u`` at fixed ``t``, an affine recurrence in the log semiring.
The JAX package solves it with an associative scan; here it is a doubling
(Hillis-Steele) scan of ``ceil(log2(U + 1))`` steps, inside a loop over
time. The two sum the same terms in other orders, so losses may part in
the last ulps. The loss takes per-node blank and emit log-probabilities
(:func:`transducer_loss`), so that callers never hold the
``(N, T, U + 1, V + 1)`` joint; :func:`transducer_loss_from_joint`
materializes it.

The searches follow the JAX package's step for step: the greedy search's
per-row frame pointer and symbol cap, and the fixed-expansion beam search
(every frame runs ``max_symbols_per_frame`` rounds, each one joint
evaluation and one exact top-k over a static pool of closures and
extensions), with optional shallow fusion of an external LM. The JAX
package picks frames, beams and tokens with one-hot contractions; here
they are gathers, exact as those picks are. Ranks come from
:func:`~pydrobert_tpu_torch.ops.topk.exact_top_k` (``jax.lax.top_k``'s
order: equal values lowest index first), since the pools hold exact ties:
on the first frame every beam but the first scores ``-1e30``.

The JAX greedy search is a ``lax.while_loop`` whose condition is checked
on the device. An eager loop would read it on the host every iteration;
this one reads, at each check, how many frames the slowest row still has,
and runs that many iterations before it checks again. Each iteration
advances a row by at most one frame, so the loop never runs past the
JAX loop's last iteration, and iterations where a row is done leave it
unchanged: the hypotheses are the same. While :func:`torch.export.export`
traces them, the loops read nothing on the host: the greedy search runs
the JAX loop's static bound of ``T * max_symbols_per_frame + T`` trips
and the beam search every frame, each as one ``scan``
(:func:`~pydrobert_tpu_torch.ops._loops.frame_loop`), with the finished
rows and padded frames masked.

Predictor state is a pytree of tensors (dicts, lists, tuples) whose leaves
have the batch (times the beam) first.
"""

from typing import Any, Callable, Optional, Tuple

import torch

from ..utils.profiling import span
from ..utils.pytree import tree_map
from ._loops import frame_loop
from ._softmax import log_softmax
from .topk import exact_top_k

__all__ = [
    "transducer_beam_advance",
    "transducer_beam_finalize",
    "transducer_beam_init",
    "transducer_beam_search",
    "transducer_greedy_advance",
    "transducer_greedy_init",
    "transducer_greedy_search",
    "transducer_loss",
    "transducer_loss_from_joint",
]

_NEG_INF = -1.0e30  # finite, as the JAX package's


def _log_affine_scan(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Solve ``y_u = logaddexp(y_{u-1} + c_u, x_u)`` along the last axis
    (``y_{-1} = -inf``) by composing the affine maps ``(c_u, x_u)`` in a
    doubling scan: ``(a1, b1) o (a2, b2) = (a1 + a2, logaddexp(b1 + a2,
    b2))``."""
    a, b = c, x
    U = c.shape[-1]
    off = 1
    while off < U:
        a_prev, b_prev = a[..., :-off], b[..., :-off]
        a_tail, b_tail = a[..., off:], b[..., off:]
        a = torch.cat([a[..., :off], a_prev + a_tail], -1)
        b = torch.cat([b[..., :off], torch.logaddexp(b_prev + a_tail, b_tail)], -1)
        off *= 2
    return b


def transducer_loss(
    blank_lp: torch.Tensor,
    emit_lp: torch.Tensor,
    logit_lens: Optional[torch.Tensor] = None,
    ref_lens: Optional[torch.Tensor] = None,
    reduction: str = "mean",
) -> torch.Tensor:
    """Negative transducer log-likelihood from node log-probabilities.

    ``blank_lp (N, T, U + 1)`` is the log-probability of a blank at node
    ``(t, u)``, ``emit_lp (N, T, U)`` that of reference label ``u`` at
    frame ``t``. ``logit_lens`` (default ``T``) and ``ref_lens`` (default
    ``U``), both ``(N,)``, mask the padding. ``reduction`` is ``"mean"``,
    ``"sum"`` or ``"none"``."""
    N, T, U1 = blank_lp.shape
    U = U1 - 1
    if tuple(emit_lp.shape) != (N, T, U):
        raise RuntimeError(f"emit_lp must be (N, T, U) = {(N, T, U)}, got {tuple(emit_lp.shape)}")
    dev = blank_lp.device
    if logit_lens is None:
        logit_lens = torch.full((N,), T, device=dev)
    if ref_lens is None:
        ref_lens = torch.full((N,), U, device=dev)
    logit_lens = torch.as_tensor(logit_lens, device=dev).long()
    ref_lens = torch.as_tensor(ref_lens, device=dev).long()
    # columns past each reference's length are unreachable
    u_idx = torch.arange(U, device=dev)
    emit_lp = torch.where(u_idx[None, None] < ref_lens[:, None, None], emit_lp, _NEG_INF)
    # c[u]: the emit score taken into column u (c[0] unused)
    c_full = torch.cat([emit_lp.new_full((N, T, 1), _NEG_INF), emit_lp], 2)
    x0 = blank_lp.new_full((N, U1), _NEG_INF)
    x0[:, 0] = 0.0
    row = _log_affine_scan(c_full[:, 0], x0)
    for t in range(1, T):
        new = _log_affine_scan(c_full[:, t], row + blank_lp[:, t - 1])
        # rows past an utterance's length stay at alpha[T_n - 1]
        row = torch.where((t < logit_lens)[:, None], new, row)
    t_last = (logit_lens - 1).clamp(0, T - 1)
    final_blank = blank_lp[torch.arange(N, device=dev), t_last, ref_lens]
    alpha_final = row.gather(1, ref_lens[:, None])[:, 0]
    loss = -(alpha_final + final_blank)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise RuntimeError(f"unknown reduction {reduction!r}")


def transducer_loss_from_joint(
    joint_logits: torch.Tensor,
    refs: torch.Tensor,
    logit_lens: Optional[torch.Tensor] = None,
    ref_lens: Optional[torch.Tensor] = None,
    blank_idx: int = -1,
    reduction: str = "mean",
) -> torch.Tensor:
    """:func:`transducer_loss` from raw joint logits ``(N, T, U + 1, V)``
    and references ``(N, U)``; ``blank_idx`` indexes the logit axis
    (negative counts from the end). It holds the joint's log-softmax."""
    N, T, U1, V = joint_logits.shape
    U = U1 - 1
    if tuple(refs.shape) != (N, U):
        raise RuntimeError(f"refs must be (N, U) = {(N, U)}, got {tuple(refs.shape)}")
    if blank_idx < 0:
        blank_idx += V
    lp = log_softmax(joint_logits, -1)
    blank_lp = lp[..., blank_idx]
    idx = refs.long().to(lp.device)[:, None, :, None].expand(N, T, U, 1)
    emit_lp = lp[:, :, :U].gather(3, idx)[..., 0]
    return transducer_loss(blank_lp, emit_lp, logit_lens, ref_lens, reduction)


def _select(mask: torch.Tensor, new: Any, old: Any) -> Any:
    """``where(mask, new, old)`` over two identically structured pytrees,
    ``mask`` along each leaf's first axis."""

    def pick(a, b):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)

    return tree_map(pick, new, old)


def _rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[idx]`` along the first axis, ``+ 0.0`` for floats (the JAX
    package's one-hot picks turn ``-0.0`` into ``+0.0``)."""
    out = a.index_select(0, idx)
    return out + 0.0 if out.is_floating_point() else out


def transducer_greedy_init(
    batch_size: int,
    u_max: int,
    pred_step: Callable,
    init_state: Any,
    blank_idx: int,
):
    """A fresh carry for :func:`transducer_greedy_advance`: ``(k, u, hyps,
    pred_out, state)``, the symbols emitted on the current frame, the
    hypothesis lengths, the ``(batch_size, u_max)`` hypothesis buffer
    (``u_max`` covers the whole utterance), and the predictor primed on the
    blank start token, on ``init_state``'s device."""
    N = batch_size
    device = _device_of(init_state)
    start = torch.full((N,), blank_idx, dtype=torch.long, device=device)
    pred_out0, state0 = pred_step(start, init_state)
    zeros = torch.zeros((N,), dtype=torch.long, device=device)
    hyps0 = torch.full((N, u_max), blank_idx, dtype=torch.long, device=device)
    return zeros, zeros.clone(), hyps0, pred_out0, state0


def _device_of(tree: Any) -> torch.device:
    """The device of a pytree's first leaf."""
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values() if isinstance(tree, dict) else tree))
    return tree.device


def transducer_greedy_search(
    enc: torch.Tensor,
    enc_lens: torch.Tensor,
    pred_step: Callable,
    joint_fn: Callable,
    init_state: Any,
    blank_idx: int,
    max_symbols_per_frame: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy RNN-T decoding: ``(hyps (N, U_max), hyp_lens (N,))``
    with ``U_max = max_symbols_per_frame * T``, padded with ``blank_idx``.

    ``enc (N, T, D)`` is the encoder output; ``pred_step(tok (N,), state)
    -> (pred_out, state)`` advances the prediction network on an emitted
    token; ``joint_fn(enc_t, pred_out) -> logits (N, V)``. A row emitting
    a non-blank stays on its frame (at most ``max_symbols_per_frame``
    times); a blank moves it on. Exactly :func:`transducer_greedy_init`
    and one :func:`transducer_greedy_advance`."""
    N, T, _ = enc.shape
    carry = transducer_greedy_init(
        N, int(max_symbols_per_frame) * T, pred_step, init_state, blank_idx
    )
    _, u, hyps, _, _ = transducer_greedy_advance(
        enc, enc_lens, pred_step, joint_fn, blank_idx, carry, max_symbols_per_frame
    )
    return hyps, u


def transducer_greedy_advance(
    enc: torch.Tensor,
    enc_lens: torch.Tensor,
    pred_step: Callable,
    joint_fn: Callable,
    blank_idx: int,
    carry,
    max_symbols_per_frame: int = 4,
):
    """Greedy-decode one encoder segment: ``enc (N, T_chunk, D)`` holds
    each row's next ``enc_lens`` frames. Returns the updated carry;
    advancing segment by segment emits the one-shot
    :func:`transducer_greedy_search` hypotheses (the frame pointer restarts
    per segment, the symbol count, buffer and predictor state carry on)."""
    N, T, _ = enc.shape
    dev = enc.device
    k, u, hyps, pred_out, state = carry
    U_max = hyps.shape[1]
    enc_lens = torch.as_tensor(enc_lens, device=dev).long()
    rows = torch.arange(N, device=dev)
    cols = torch.arange(U_max, device=dev)
    E = int(max_symbols_per_frame)
    t = torch.zeros((N,), dtype=torch.long, device=dev)

    def trip(carry, fr, i):
        t, k, u, hyps, pred_out, state = carry
        enc_t = enc[rows, t.clamp(0, T - 1)]
        tok = joint_fn(enc_t, pred_out).argmax(1)
        active = t < enc_lens
        emit = active & (tok != blank_idx) & (k < E)
        hyps = torch.where(emit[:, None] & (cols[None] == u[:, None]), tok[:, None], hyps)
        u = u + emit.long()
        new_pred, new_state = pred_step(tok, state)
        pred_out = _select(emit, new_pred, pred_out)
        state = _select(emit, new_state, state)
        adv = active & ~emit
        t = t + adv.long()
        k = torch.where(adv, 0, k + emit.long())
        return t, k, u, hyps, pred_out, state

    carry = (t, k, u, hyps, pred_out, state)
    if torch.compiler.is_exporting():
        # no host reads in a traced program: run the JAX loop's static
        # bound, T * E + T trips; trips after a row is done leave it as it
        # was, so the hypotheses are the eager loop's
        carry = frame_loop(trip, carry, (), 0, T * (E + 1), "transducer_greedy", dev)
        return carry[1:]
    with span("search/transducer_greedy"):
        while True:
            # every iteration moves a row at most one frame: the slowest
            # row needs at least this many more (one host sync a check)
            with span("sync/transducer_greedy"):
                todo = int((enc_lens - carry[0]).clamp_min(0).max()) if N else 0
            if todo == 0:
                break
            carry = frame_loop(trip, carry, (), 0, todo, "transducer_greedy")
    return carry[1:]


def transducer_beam_search(
    enc: torch.Tensor,
    enc_lens: torch.Tensor,
    pred_step: Callable,
    joint_fn: Callable,
    init_state: Any,
    blank_idx: int,
    width: int,
    max_symbols_per_frame: int = 4,
    lm: Optional[Tuple[Callable, torch.Tensor, Any]] = None,
    lm_weight: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched time-synchronous RNN-T beam search with fixed expansion:
    ``(hyps (N, W, U_max), hyp_lens (N, W), scores (N, W))`` best-first,
    ``U_max = max_symbols_per_frame * T``, hypotheses padded with
    ``blank_idx``.

    Every frame runs ``E = max_symbols_per_frame`` rounds. In a round each
    open hypothesis offers its blank closure (score plus the blank's
    log-probability; it then waits for the next frame) and its ``width``
    best non-blank extensions (which stay open); closed ones carry over.
    The ``width`` best of that pool survive. After the rounds, open
    hypotheses close with their blank log-probability. Equal prefixes are
    not merged. Width 1 emits :func:`transducer_greedy_search`'s tokens.

    ``pred_step`` and ``joint_fn`` are as the greedy search's (``joint_fn``
    broadcasts over leading axes); ``init_state`` is per row and is tiled
    over the beams. ``lm = (lm_step, init_lp (N, V_joint), init_lm_state)``
    fuses an external LM: extensions rank and score by ``lp_joint +
    lm_weight * lp_lm``, closures carry no LM term, and ``lm_step(tok,
    lm_state) -> (next_lp, lm_state)`` advances it on emitted tokens
    (:func:`pydrobert_tpu_torch.models.transducer.lookup_lm_fusion` adapts
    a lookup LM). Exactly :func:`transducer_beam_init`, one
    :func:`transducer_beam_advance` and :func:`transducer_beam_finalize`."""
    N, T, _ = enc.shape
    carry = transducer_beam_init(
        N, width, int(max_symbols_per_frame) * T, pred_step, init_state, blank_idx, lm
    )
    carry = transducer_beam_advance(
        enc, enc_lens, pred_step, joint_fn, blank_idx, carry, max_symbols_per_frame,
        lm_step=None if lm is None else lm[0], lm_weight=lm_weight,
    )
    return transducer_beam_finalize(carry)


def transducer_beam_init(
    batch_size: int,
    width: int,
    u_max: int,
    pred_step: Callable,
    init_state: Any,
    blank_idx: int,
    lm: Optional[Tuple[Callable, torch.Tensor, Any]] = None,
):
    """A fresh carry for :func:`transducer_beam_advance`: ``(scores (N, W),
    hyps (N, W, u_max), lens (N, W), pred_out (N * W, P), state, lm_lp,
    lm_state)``, on ``init_state``'s device. Beam 0 is the live seed; the
    others start at ``-1e30``. Of ``lm``'s triple only ``init_lp`` and
    ``init_lm_state`` are read here (the advance takes ``lm_step``)."""
    N, W = batch_size, int(width)
    device = _device_of(init_state)

    def tile(a):
        return a.repeat_interleave(W, 0)

    scores0 = torch.full((N, W), _NEG_INF, device=device)
    scores0[:, 0] = 0.0
    start = torch.full((N,), blank_idx, dtype=torch.long, device=device)
    pred_out0, state0 = pred_step(start, init_state)
    hyps0 = torch.full((N, W, u_max), blank_idx, dtype=torch.long, device=device)
    lens0 = torch.zeros((N, W), dtype=torch.long, device=device)
    if lm is not None:
        _, lm_lp0, lm_state0 = lm
        lm_lp0 = tile(torch.as_tensor(lm_lp0, dtype=torch.float32, device=device))
        lm_state0 = tree_map(tile, lm_state0)
    else:
        lm_lp0, lm_state0 = None, None
    return scores0, hyps0, lens0, tile(pred_out0), tree_map(tile, state0), lm_lp0, lm_state0


def transducer_beam_finalize(carry) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort a beam carry best-first: ``(hyps, hyp_lens, scores)``."""
    scores, hyps, lens = carry[0], carry[1], carry[2]
    W = scores.shape[1]
    order_sc, order = exact_top_k(scores, W)
    hyps = hyps.gather(1, order[..., None].expand(hyps.shape))
    return hyps, lens.gather(1, order), order_sc


def transducer_beam_advance(
    enc: torch.Tensor,
    enc_lens: torch.Tensor,
    pred_step: Callable,
    joint_fn: Callable,
    blank_idx: int,
    carry,
    max_symbols_per_frame: int = 4,
    lm_step: Optional[Callable] = None,
    lm_weight: float = 1.0,
):
    """Beam-search one encoder segment: ``enc (N, T_chunk, D)`` holds each
    row's next ``enc_lens`` frames. Returns the updated carry; chaining
    advances over an utterance's segments computes the one-shot
    :func:`transducer_beam_search` (every hypothesis closes before the
    next frame, so no beam state spans a frame boundary). Call
    :func:`transducer_beam_finalize` after the last."""
    N, T, _ = enc.shape
    dev = enc.device
    scores, hyps, lens, pred_out, state, lm_lp, lm_state = carry
    W = scores.shape[1]
    E = int(max_symbols_per_frame)
    U_max = hyps.shape[2]
    enc_lens = torch.as_tensor(enc_lens, device=dev).long()
    iota_u = torch.arange(U_max, device=dev)
    base = (torch.arange(N, device=dev) * W)[:, None]  # (N, 1)
    blank_col = torch.tensor([blank_idx], device=dev)

    def log_probs(enc_t, pred_out):
        return log_softmax(joint_fn(enc_t[:, None], pred_out.reshape(N, W, -1)), -1)

    def frame(carry, fr, t):
        scores, hyps, lens, pred_out, state, lm_lp, lm_state = carry
        (enc_t,) = fr
        active = t < enc_lens  # (N,)
        amw = active.repeat_interleave(W)
        open_ = torch.ones((N, W), dtype=torch.bool, device=dev)
        for _ in range(E):
            lp = log_probs(enc_t, pred_out)  # (N, W, V + 1)
            blank_lp = lp[..., blank_idx]
            basis = lp if lm_step is None else lp + lm_weight * lm_lp.reshape(N, W, -1)
            basis = basis.index_fill(-1, blank_col, _NEG_INF)
            ext_lp, ext_tok = exact_top_k(basis, W)  # (N, W, W)
            can_ext = open_ & (lens < U_max)
            ext_sc = torch.where(can_ext[..., None], scores[..., None] + ext_lp, _NEG_INF)
            close_sc = torch.where(open_, scores + blank_lp, scores)
            pool = torch.cat([close_sc, ext_sc.reshape(N, W * W)], 1)
            new_sc, pick = exact_top_k(pool, W)
            is_ext = pick >= W
            src = torch.where(is_ext, (pick - W) // W, pick)  # (N, W)
            tok_slot = torch.where(is_ext, (pick - W) % W, 0)
            picked_tok = ext_tok.gather(1, src[..., None].expand(N, W, W)).gather(
                2, tok_slot[..., None]
            )[..., 0]
            new_lens = lens.gather(1, src)
            new_hyps = hyps.gather(1, src[..., None].expand(N, W, U_max))
            new_hyps = torch.where(
                is_ext[..., None] & (iota_u[None, None] == new_lens[..., None]),
                picked_tok[..., None], new_hyps,
            )
            new_lens = new_lens + is_ext.long()
            flat_src = (base + src).reshape(-1)
            emask = is_ext.reshape(-1)
            src_pred = _rows(pred_out, flat_src)
            src_state = tree_map(lambda a: _rows(a, flat_src), state)
            adv_pred, adv_state = pred_step(picked_tok.reshape(-1), src_state)
            new_pred = _select(emask, adv_pred, src_pred)
            new_state = _select(emask, adv_state, src_state)
            # rows past their length keep everything as it was
            scores = torch.where(active[:, None], new_sc, scores)
            hyps = torch.where(active[:, None, None], new_hyps, hyps)
            lens = torch.where(active[:, None], new_lens, lens)
            pred_out = _select(amw, new_pred, pred_out)
            state = _select(amw, new_state, state)
            open_ = active[:, None] & is_ext
            if lm_step is not None:
                src_lm_lp = _rows(lm_lp, flat_src)
                src_lm_state = tree_map(lambda a: _rows(a, flat_src), lm_state)
                adv_lm_lp, adv_lm_state = lm_step(picked_tok.reshape(-1), src_lm_state)
                lm_lp = _select(amw, _select(emask, adv_lm_lp, src_lm_lp), lm_lp)
                lm_state = _select(
                    amw, _select(emask, adv_lm_state, src_lm_state), lm_state
                )
        # open survivors close with their blank log-probability
        blank_lp = log_probs(enc_t, pred_out)[..., blank_idx]
        scores = torch.where(active[:, None] & open_, scores + blank_lp, scores)
        return scores, hyps, lens, pred_out, state, lm_lp, lm_state

    if torch.compiler.is_exporting():
        # no host reads in a traced program: every frame, the ones past a
        # row's length masked (the JAX package's lax.scan)
        T_run = T
    else:
        # frames past every row's length change nothing (one host sync)
        T_run = min(T, int(enc_lens.max())) if N else 0
    carry = (scores, hyps, lens, pred_out, state, lm_lp, lm_state)
    # frame-major and contiguous, as the exported scan slices its frames: a
    # product over a strided frame may sum in another order
    frames = (enc.transpose(0, 1).contiguous(),)
    return frame_loop(frame, carry, frames, 0, T_run, "transducer_beam")
