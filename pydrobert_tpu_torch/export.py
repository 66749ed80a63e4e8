"""Serving heads (counterpart of the recognizers in
:mod:`pydrobert_tpu.export`).

:func:`ctc_recognizer` builds the callable that the JAX package's
``export_ctc_recognizer`` compiles into an artifact: acoustic model
forward, then greedy or prefix-beam CTC search, with batch-major outputs.
Saving it as an artifact (``torch.export``) is not ported yet.
"""

from typing import Callable, Optional

import torch

from .ops.decoding import CTCPrefixSearch, ctc_greedy_search

__all__ = ["ctc_recognizer"]


def ctc_recognizer(
    model: torch.nn.Module, width: Optional[int] = None, beta: float = 0.2
) -> Callable:
    """``recognize(feats (N, T, F), lens (N,))`` on ``model``'s device.

    With ``width`` None the head is greedy and returns ``(hyps (N, S),
    lens (N,))``; otherwise a width-``width`` CTC prefix search returns
    ``(hyps (N, W, S), lens (N, W), probs (N, W))``, beams in descending
    order of probability. ``model`` maps ``(feats, lens)`` to batch-major
    ``(logits (N, T', V + 1), out_lens)`` with the blank last, as
    :class:`pydrobert_tpu_torch.models.ConformerCTC` does. ``beta`` is the
    LM weight of :class:`CTCPrefixSearch`; no LM is ported yet, so it has no
    effect.
    """
    if width is None:

        @torch.no_grad()
        def recognize(feats, lens):
            logits, out_lens = model(feats, lens)
            _, hyps, hyp_lens = ctc_greedy_search(
                logits, out_lens, batch_first=True
            )
            return hyps, hyp_lens

    else:
        search = CTCPrefixSearch(width, beta=beta)

        @torch.no_grad()
        def recognize(feats, lens):
            logits, out_lens = model(feats, lens)
            y, y_lens, y_probs = search(
                logits.transpose(0, 1).contiguous(), out_lens
            )
            # (S, N, W) -> batch-major (N, W, S)
            return y.permute(1, 2, 0), y_lens, y_probs

    return recognize
