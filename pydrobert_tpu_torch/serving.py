"""Streaming recognition sessions (counterpart of
:mod:`pydrobert_tpu.serving`).

A serving frontend receives feature frames incrementally: arbitrary push
sizes, many concurrent streams, streams ending at different times. Both
recognizers encode what each push determines with a causal encoder, through
one front end (:class:`_Frontier`) and the encode routes of
:mod:`pydrobert_tpu_torch.models.conformer`.
:class:`StreamingCTCRecognizer` re-encodes the receptive-field margin ``R``
over a fixed window of ``4 * (chunk + R + 1)`` raw frames and re-decodes the
accumulated logits of a :class:`~pydrobert_tpu_torch.models.ConformerCTC`
with :class:`~pydrobert_tpu_torch.ops.decoding.CTCPrefixSearch` when results
are asked for (``push(..., partials=True)`` and ``finish``).
:class:`StreamingTransducerRecognizer` encodes each chunk once from a
per-layer state cache (:func:`~pydrobert_tpu_torch.models.conformer.
encoder_stream_step`; a mixture-of-experts encoder takes the window
instead), threads the greedy or beam carry of a
:class:`~pydrobert_tpu_torch.models.ConformerTransducer` through each chunk
as it is encoded, and defers each stream's last partial-block frame to
``finish``.

All streams of a session share one frame timeline (push ``(N, T_new, F)``
slabs); per-stream ``new_lens`` marks how many of the new frames are real.
A stream may fall behind (its remaining pushes all zero-length: it has
ended) but must not resume.

Work runs on the model's device, ``cuda`` unless the model was built on
the CPU. Raw frames and logits stay there; lengths are kept on the host,
where the session's control flow reads them.
"""

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .models.conformer import (
    encoder_stream_state, encoder_stream_step, margin_start, margin_window, streaming_margin,
)
from .ops import transducer as _rnnt
from .ops.decoding import CTCPrefixSearch
from .utils.profiling import span

__all__ = [
    "StreamingCTCRecognizer",
    "StreamingCTCSession",
    "StreamingSession",
    "StreamingTransducerRecognizer",
]


def _ceil4(x):
    return -(-np.asarray(x) // 4)


class _Frontier:
    """Both recognizers' sessions: a raw-frame timeline whose frontier
    ``sess.o0`` moves on in chunks as far as the pushes determine (at
    ``finish``, to the end) through the recognizer's ``_chunk(sess, o1,
    out_lens)``, which consumes frames ``[sess.o0, o1)``."""

    def __init__(self, model, enc_cfg, chunk: int, device):
        self.R = streaming_margin(enc_cfg, "streaming recognition")
        if chunk < 1:
            raise ValueError(f"chunk must be positive, got {chunk}")
        self.model, self.cfg = model, model.cfg
        self.device = device
        self.chunk = int(chunk)
        # a fixed window: warm-up and steady state encode the same shape
        self.Lw = 4 * (self.chunk + self.R + 1)

    def _timeline(self, N: int, num_filts: int) -> dict:
        return dict(
            buf=torch.zeros((N, 0, num_filts), device=self.device), base=0, pushed=0,
            total=np.zeros((N,), np.int64), o0=0,
        )

    def _feed(self, sess, feats, new_lens, max_frames: Optional[int] = None):
        """Check a push, buffer it and encode the chunks it completes."""
        if sess.done:
            raise RuntimeError("session already finished")
        feats = torch.as_tensor(feats, dtype=torch.float32, device=self.device)
        N, T_new = feats.shape[:2]
        if N != sess.total.shape[0]:
            raise ValueError(f"batch size {N} != session batch {sess.total.shape[0]}")
        new_lens = (
            np.full((N,), T_new, np.int64)
            if new_lens is None
            else np.asarray(new_lens, np.int64)  # an array or a CPU tensor
        )
        if (new_lens < 0).any() or (new_lens > T_new).any():
            raise ValueError("new_lens must lie in [0, T_new]")
        resumed = (sess.total < sess.pushed) & (new_lens > 0)
        if resumed.any():
            raise RuntimeError(
                f"streams {np.nonzero(resumed)[0].tolist()} ended (fell "
                "behind the shared timeline) and cannot resume"
            )
        with span("stream/push"):
            sess.buf = torch.cat([sess.buf, feats], 1)
            sess.total = sess.total + new_lens
            sess.pushed += T_new
            if max_frames is not None and _ceil4(sess.pushed) > max_frames:
                raise RuntimeError(
                    f"stream exceeds max_frames={max_frames} post-subsample frames"
                )
            # fully determined frames, in chunks of a fixed size
            while sess.pushed // 4 - sess.o0 >= self.chunk:
                self._chunk(sess, sess.o0 + self.chunk, sess.total // 4)

    def finish(self, sess):
        """Encode and decode everything outstanding; the final result."""
        if sess.done:
            raise RuntimeError("session already finished")
        with span("stream/finish"):
            out_lens = _ceil4(sess.total)
            o1 = int(out_lens.max(initial=0))
            # the frames still on the shared frontier
            while sess.o0 < o1:
                self._chunk(sess, min(sess.o0 + self.chunk, o1), out_lens)
            out = self._final(sess, out_lens)
            sess.done = True
            return out

    def _trim(self, sess, keep_from: int):
        """Drop the raw frames before ``keep_from``, which no encode reads."""
        if keep_from > sess.base:
            sess.buf = sess.buf[:, keep_from - sess.base :]
            sess.base = keep_from

    def _window(self, sess, encode, o0: int, o1: int, length: Optional[int]) -> torch.Tensor:
        """Rows ``[o0, o1)`` of ``encode`` from a margin window of the buffer."""
        return margin_window(
            lambda f, l, pos_offset: encode(f, self._on_device(l, "stream_window"),
                                            pos_offset=pos_offset),
            sess.buf, sess.base, sess.total, self.R, o0, o1, length,
        )

    def _on_device(self, a: np.ndarray, site: str) -> torch.Tensor:
        """Host lengths on the model's device: a copy from pageable memory,
        which waits for the card's queue to drain."""
        with span("sync/" + site):
            return torch.from_numpy(a).to(self.device)


@dataclasses.dataclass
class StreamingCTCSession:
    """State of one batch of concurrent CTC streams."""

    logits: torch.Tensor  # (N, o0, V + 1) encoder outputs decoded so far
    buf: torch.Tensor  # (N, kept, F) raw frames from global raw index `base`
    base: int
    pushed: int  # raw frames pushed so far (shared timeline)
    total: np.ndarray  # (N,) per-stream valid raw lengths
    o0: int  # post-subsample frames encoded so far
    done: bool = False


class StreamingCTCRecognizer(_Frontier):
    """Streaming CTC recognition sessions over a fixed model.

    ``start(batch_size)`` opens a session; ``push(sess, feats, new_lens=None,
    partials=False)`` feeds ``(N, T_new, F)`` frames (a tensor or an
    array) and, with ``partials=True``, returns the search over what is
    encoded so far; ``finish(sess)`` encodes the rest and returns the final
    ``(y (S, N, W), y_lens (N, W), y_probs (N, W))``, the
    :class:`~pydrobert_tpu_torch.ops.decoding.CTCPrefixSearch` contract,
    equal to the one-shot search of the model's full forward. ``S`` is the
    encoded length padded up to a multiple of ``decode_pad_multiple``, as
    in the JAX package. The encoder runs over a fixed window of
    ``4 * (chunk + R + 1)`` raw frames, ``R`` the config's receptive-field
    margin. Partials re-decode the whole stream each time: poll them at
    the cadence they are shown.

    ``lm`` and ``beta`` are the search's shallow fusion
    (:class:`~pydrobert_tpu_torch.ops.decoding.CTCPrefixSearch`); a
    :class:`~pydrobert_tpu_torch.lm.LookupLanguageModel` must live on the
    model's device.

    The model's config must be causal: ``attention_context=(L, 0)`` with
    finite ``L`` and ``causal_conv=True``.
    """

    def __init__(
        self,
        model,
        chunk: int = 8,
        width: int = 8,
        beta: float = 0.2,
        lm=None,
        decode_pad_multiple: int = 32,
    ):
        super().__init__(model, model.cfg, chunk, next(model.parameters()).device)
        self.decode_pad_multiple = max(1, int(decode_pad_multiple))
        self.search = CTCPrefixSearch(width, beta=beta, lm=lm)

    def start(self, batch_size: int) -> StreamingCTCSession:
        """Open a session of `batch_size` concurrent streams."""
        N = int(batch_size)
        return StreamingCTCSession(
            logits=torch.zeros(
                (N, 0, self.cfg.vocab_size + 1), dtype=torch.float32, device=self.device
            ),
            **self._timeline(N, self.cfg.num_filts),
        )

    def push(
        self,
        sess: StreamingCTCSession,
        feats,
        new_lens: Optional[np.ndarray] = None,
        partials: bool = False,
    ):
        """Feed ``(N, T_new, F)`` new frames; encode what they determine.

        With ``partials=True`` the accumulated logits are re-decoded and
        ``(y (S, N, W), y_lens (N, W), y_probs (N, W))`` is returned
        (otherwise ``None``)."""
        self._feed(sess, feats, new_lens)
        if not partials:
            return None
        # a stream's frames < ceil4(total) are exact once encoded (the
        # window encode masks by the stream's true valid length)
        lens = np.minimum(_ceil4(sess.total), sess.o0)
        return self._decode_padded(sess.logits, lens)

    def _final(self, sess: StreamingCTCSession, out_lens: np.ndarray):
        return self._decode_padded(sess.logits, out_lens)

    @torch.no_grad()
    def _chunk(self, sess: StreamingCTCSession, o1: int, out_lens: np.ndarray):
        with span("stream/encode"):
            rows = self._window(sess, self.model, sess.o0, o1, self.Lw)
        sess.logits = torch.cat([sess.logits, rows], 1)
        sess.o0 = o1
        self._trim(sess, 4 * margin_start(sess.o0, self.R))

    @torch.no_grad()
    def _decode_padded(self, logits: torch.Tensor, lens: np.ndarray):
        """Decode the logits padded up to a multiple of
        ``decode_pad_multiple`` frames."""
        N, T, C = logits.shape
        m = self.decode_pad_multiple
        Tp = max(-(-max(T, 1) // m) * m, m)
        padded = logits.new_zeros((Tp, N, C))
        padded[:T] = logits.transpose(0, 1)
        return self.search(padded, torch.from_numpy(np.asarray(lens)).to(self.device))


@dataclasses.dataclass
class StreamingSession:
    """State of one batch of concurrent transducer streams."""

    carry: Any  # the greedy or beam search's carry
    buf: torch.Tensor  # (N, kept, F) raw frames from global raw index `base`
    base: int
    pushed: int  # raw frames pushed so far (shared timeline)
    total: np.ndarray  # (N,) per-stream valid raw lengths
    consumed: np.ndarray  # (N,) post-subsample frames decoded per stream
    o0: int  # next global post-subsample frame to decode
    done: bool = False
    # the cached route: the encoder's state cache, and each stream's last
    # partial-block frame (N, d_model), kept when its chunk is encoded
    enc_state: Any = None
    tail: Optional[torch.Tensor] = None


class StreamingTransducerRecognizer(_Frontier):
    """Streaming RNN-T recognition sessions over a fixed model.

    ``start(batch_size)`` opens a session; ``push(sess, feats,
    new_lens=None)`` feeds ``(N, T_new, num_filts)`` raw frames (a tensor or
    an array, any ``T_new``), decodes the post-subsample frames they
    determine, in chunks of ``chunk``, and returns the partial result;
    ``finish(sess)`` decodes the rest, each stream's deferred last frame
    included, and returns the final one. Greedy: ``(hyps (N, U_max),
    hyp_lens (N,))``. Beam: ``(hyps (N, W, U_max), hyp_lens (N, W), scores
    (N, W))``, best-first at ``finish`` and unsorted in partials. The
    results equal :meth:`~pydrobert_tpu_torch.models.ConformerTransducer.
    greedy` or ``beam`` on the concatenated pushes.

    ``mode`` is ``"greedy"`` or ``"beam"`` (then ``width``, and ``lm`` and
    ``lm_weight`` for shallow fusion). ``max_frames`` bounds each stream's
    post-subsample length and sizes the hypothesis buffer, ``U_max =
    max_symbols_per_frame * max_frames``. The model's encoder config must
    be causal: ``attention_context=(L, 0)`` with finite ``L`` and
    ``causal_conv=True``. Work runs on the model's device.

    A dense encoder encodes each chunk once, from the session's per-layer
    state cache (:attr:`cached`). A mixture-of-experts encoder routes by the
    tokens of its batch, so it re-encodes a fixed window of ``4 * (chunk +
    R + 1)`` raw frames for each chunk instead, ``R`` the receptive-field
    margin, and routes as that window does."""

    def __init__(
        self,
        model,
        chunk: int = 8,
        mode: str = "greedy",
        width: int = 4,
        max_symbols_per_frame: int = 4,
        max_frames: int = 1024,
        lm=None,
        lm_weight: float = 0.3,
    ):
        if mode not in ("greedy", "beam"):
            raise ValueError(f"mode must be 'greedy' or 'beam', got {mode!r}")
        super().__init__(model, model.cfg.encoder, chunk, model.device)
        self.mode = mode
        self.width = int(width)
        self.E = int(max_symbols_per_frame)
        self.max_frames = int(max_frames)
        self.blank = model.cfg.vocab_size
        self.lm, self.lm_weight = lm, float(lm_weight)
        self._lm_step = None

    @property
    def cached(self) -> bool:
        """Whether sessions encode each chunk from the state cache (a dense
        encoder) rather than re-encode a window (a mixture of experts)."""
        return self.cfg.encoder.num_experts <= 1

    def start(self, batch_size: int) -> StreamingSession:
        """Open a session of ``batch_size`` concurrent streams."""
        from .models.transducer import _fusion

        N = int(batch_size)
        u_max = self.E * self.max_frames
        model = self.model
        with torch.no_grad():
            init_state = model.predictor.init_carry(N)
            if self.mode == "greedy":
                carry = _rnnt.transducer_greedy_init(
                    N, u_max, model.predictor.stepper(), init_state, self.blank
                )
            else:
                lm = _fusion(self.lm, self.cfg, N)
                self._lm_step = None if lm is None else lm[0]
                carry = _rnnt.transducer_beam_init(
                    N, self.width, u_max, model.predictor.stepper(), init_state, self.blank,
                    lm,
                )
        sess = StreamingSession(
            carry=carry, consumed=np.zeros((N,), np.int64),
            **self._timeline(N, self.cfg.encoder.num_filts),
        )
        if self.cached:
            sess.enc_state = encoder_stream_state(model.encoder, self.cfg.encoder, N)
            sess.tail = torch.zeros((N, self.cfg.encoder.d_model), device=self.device)
        return sess

    def push(self, sess: StreamingSession, feats, new_lens: Optional[np.ndarray] = None):
        """Feed ``(N, T_new, F)`` new frames; decode what they determine.
        ``new_lens`` (default: all ``T_new``) counts each stream's real
        frames; a stream that has ended pushes zero. Returns the partial
        result."""
        self._feed(sess, feats, new_lens, self.max_frames)
        return self._partial(sess)

    @torch.no_grad()
    def _final(self, sess: StreamingSession, out_lens: np.ndarray):
        # deferred tails: streams whose last partial-block frame fell behind
        # the frontier before it was determined. Each stream gets its own
        # tail frame as a chunk of one: kept when its chunk was encoded on
        # the cached route, from one encode on the window's
        pending = out_lens - sess.consumed
        assert (pending >= 0).all() and (pending <= 1).all(), pending
        if pending.any():
            if self.cached:
                enc_tail = sess.tail[:, None]
            else:
                tail_o = np.where(pending > 0, out_lens - 1, 0)
                o0 = int(tail_o[pending > 0].min())
                with span("stream/encode"):
                    enc = self._window(sess, self.model.encode, o0, int(_ceil4(sess.pushed)), None)
                pick = self._on_device(np.clip(tail_o - o0, 0, enc.shape[1] - 1), "stream_tail")
                enc_tail = enc[torch.arange(enc.shape[0], device=self.device), pick][:, None]
            self._advance(sess, enc_tail, pending)
        if self.mode == "greedy":
            return self._partial(sess)
        return _rnnt.transducer_beam_finalize(sess.carry)

    @torch.no_grad()
    def _advance(self, sess: StreamingSession, enc_chunk, chunk_lens: np.ndarray):
        lens = self._on_device(chunk_lens, "stream_advance")
        step, joint = self.model.predictor.stepper(), self.model.joint
        if self.mode == "greedy":
            sess.carry = _rnnt.transducer_greedy_advance(
                enc_chunk, lens, step, joint, self.blank, sess.carry, self.E
            )
        else:
            sess.carry = _rnnt.transducer_beam_advance(
                enc_chunk, lens, step, joint, self.blank, sess.carry, self.E,
                lm_step=self._lm_step, lm_weight=self.lm_weight,
            )
        sess.consumed = sess.consumed + chunk_lens

    @torch.no_grad()
    def _chunk(self, sess: StreamingSession, o1: int, out_lens: np.ndarray):
        """Advance the decode over global frames ``[sess.o0, o1)``."""
        with span("stream/encode"):
            if self.cached:
                enc_chunk = self._encode_cached(sess)
            else:
                # rows past o1 lie past every stream's end
                enc_chunk = self._window(
                    sess, self.model.encode, sess.o0, sess.o0 + self.chunk, self.Lw
                )
        # only streams on the frontier read this chunk; a drained stream's
        # deferred tail frame waits for finish()
        on_frontier = sess.consumed == sess.o0
        chunk_lens = np.where(on_frontier, np.clip(out_lens - sess.o0, 0, o1 - sess.o0), 0)
        self._advance(sess, enc_chunk, chunk_lens)
        sess.o0 = o1
        if self.cached:
            # the state holds the subsampler's context: drop the chunk's frames
            self._trim(sess, 4 * sess.o0)
        else:
            # drop raw frames behind the margin of the frontier and of the
            # earliest deferred tail
            tails = sess.consumed[sess.consumed < sess.o0]
            self._trim(sess, 4 * margin_start(min([sess.o0] + tails.tolist()), self.R))

    def _encode_cached(self, sess: StreamingSession) -> torch.Tensor:
        """The encoder's rows of frames ``[o0, o0 + chunk)`` from the
        session's state cache (past the raw frames pushed, zeros: finish's
        last chunk), kept in ``sess.tail`` for each stream whose last
        partial-block frame they hold."""
        C, o0 = self.chunk, sess.o0
        with span("stream/encode_cached"):
            f = sess.buf[:, 4 * o0 - sess.base : 4 * (o0 + C) - sess.base]
            N, Tf, F = f.shape
            if Tf < 4 * C:
                f = torch.cat([f, f.new_zeros((N, 4 * C - Tf, F))], 1)
            l = self._on_device(sess.total - 4 * o0, "stream_window")
            rows, sess.enc_state = encoder_stream_step(
                self.model.encoder, self.cfg.encoder, sess.enc_state, f, l, o0
            )
            rows = rows.float()
            # a stream's frame o_n = ceil4(total) - 1 of a partial block is
            # final here: its chunk is encoded only once pushed > total
            j = torch.div(l, 4, rounding_mode="floor")
            has = (l % 4 != 0) & (j >= 0) & (j < C)
            picked = rows[torch.arange(N, device=self.device), j.clamp(0, C - 1)]
            sess.tail = torch.where(has[:, None], picked, sess.tail)
        return rows

    def _partial(self, sess: StreamingSession):
        if self.mode == "greedy":
            _, u, hyps, _, _ = sess.carry
            return hyps, u
        scores, hyps, lens = sess.carry[:3]
        return hyps, lens, scores
