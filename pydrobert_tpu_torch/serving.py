"""Streaming CTC recognition sessions (counterpart of the CTC sessions of
:mod:`pydrobert_tpu.serving`).

A serving frontend receives feature frames incrementally: arbitrary push
sizes, many concurrent streams, streams ending at different times.
:class:`StreamingCTCRecognizer` encodes what each push determines with a
causal :class:`~pydrobert_tpu_torch.models.ConformerCTC`, re-encoding only
the receptive-field margin ``R``, and re-decodes the accumulated logits
with :class:`~pydrobert_tpu_torch.ops.decoding.CTCPrefixSearch` when
results are asked for (``push(..., partials=True)`` and ``finish``).

All streams of a session share one frame timeline (push ``(N, T_new, F)``
slabs); per-stream ``new_lens`` marks how many of the new frames are real.
A stream may fall behind (its remaining pushes all zero-length: it has
ended) but must not resume.

Work runs on the model's device, ``cuda`` unless the model was built on
the CPU. Raw frames and logits stay there; lengths are kept on the host,
where the session's control flow reads them.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from .models.conformer import streaming_margin
from .ops.decoding import CTCPrefixSearch

__all__ = ["StreamingCTCRecognizer", "StreamingCTCSession"]


def _ceil4(x):
    return -(-np.asarray(x) // 4)


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


class StreamingCTCRecognizer:
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
        self.R = streaming_margin(model.cfg, "streaming recognition")
        if chunk < 1:
            raise ValueError(f"chunk must be positive, got {chunk}")
        self.model, self.cfg = model, model.cfg
        self.device = next(model.parameters()).device
        self.chunk = int(chunk)
        self.decode_pad_multiple = max(1, int(decode_pad_multiple))
        self.search = CTCPrefixSearch(width, beta=beta, lm=lm)
        self.Lw = 4 * (self.chunk + self.R + 1)

    def start(self, batch_size: int) -> StreamingCTCSession:
        """Open a session of `batch_size` concurrent streams."""
        N = int(batch_size)
        return StreamingCTCSession(
            logits=torch.zeros(
                (N, 0, self.cfg.vocab_size + 1), dtype=torch.float32, device=self.device
            ),
            buf=torch.zeros((N, 0, self.cfg.num_filts), device=self.device),
            base=0,
            pushed=0,
            total=np.zeros((N,), np.int64),
            o0=0,
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
        sess.buf = torch.cat([sess.buf, feats], 1)
        sess.total = sess.total + new_lens
        sess.pushed += T_new
        while sess.pushed // 4 - sess.o0 >= self.chunk:
            self._encode_window(sess, sess.o0 + self.chunk)
        if not partials:
            return None
        # a stream's frames < ceil4(total) are exact once encoded (the
        # window encode masks by the stream's true valid length)
        lens = np.minimum(_ceil4(sess.total), sess.o0)
        return self._decode_padded(sess.logits, lens)

    def finish(self, sess: StreamingCTCSession):
        """Encode and decode everything outstanding; final hypotheses."""
        if sess.done:
            raise RuntimeError("session already finished")
        out_lens = _ceil4(sess.total)
        o1 = int(out_lens.max(initial=0))
        while sess.o0 < o1:
            self._encode_window(sess, min(sess.o0 + self.chunk, o1))
        sess.done = True
        return self._decode_padded(sess.logits, out_lens)

    @torch.no_grad()
    def _encode_window(self, sess: StreamingCTCSession, o1: int):
        m0 = max(sess.o0 - self.R - 1, 0)
        i0, i1 = 4 * m0, min(4 * o1, sess.pushed)
        f = sess.buf[:, i0 - sess.base : i1 - sess.base]
        N, Tf, F = f.shape
        if Tf < self.Lw:
            # pad to the fixed window; padded frames sit beyond every
            # stream's valid length, so the encoder masks them out
            f = torch.cat([f, f.new_zeros((N, self.Lw - Tf, F))], 1)
        l = torch.from_numpy(np.clip(sess.total - i0, 0, i1 - i0))
        logits = self.model(f, l, pos_offset=m0)[0]
        sl0 = sess.o0 - m0
        # final (finish-time) windows can be shorter than a full chunk
        rows = logits[:, sl0 : sl0 + min(self.chunk, o1 - sess.o0)]
        sess.logits = torch.cat([sess.logits, rows], 1)
        sess.o0 = o1
        keep_from = 4 * max(sess.o0 - self.R - 1, 0)
        if keep_from > sess.base:
            sess.buf = sess.buf[:, keep_from - sess.base :]
            sess.base = keep_from

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
