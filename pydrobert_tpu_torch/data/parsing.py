"""ARPA language-model parsing and the transcript/token conversions
(counterpart of :func:`pydrobert_tpu.data.parsing.parse_arpa_lm`,
``transcript_to_token`` and ``token_to_transcript``).

Host-side pure Python: the same format, the same edge-case semantics
(base-10 to base-e conversion, implicit backoffs, count validation against
the ``\\data\\`` header) and the same returned dicts, so a port
:class:`~pydrobert_tpu_torch.lm.LookupLanguageModel` built from them has
the JAX package's tables.
"""

import math
import re
import warnings
from logging import Logger
from typing import IO, Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["parse_arpa_lm", "token_to_transcript", "transcript_to_token"]


def parse_arpa_lm(
    file_: Union[IO, str],
    token2id: Optional[Dict[str, int]] = None,
    to_base_e: Optional[bool] = None,
    ftype: type = float,
    logger: Optional[Logger] = None,
) -> List[Dict[Any, Any]]:
    """Parse an ARPA statistical language model.

    Returns a list of dicts, one per n-gram order: unigram keys are tokens
    (or ids with `token2id`), higher orders are tuples; values are
    ``(logp, logb)`` pairs except for the highest order (just ``logp``).
    Semantics parity with the reference (``_parsing.py:47-199``): base-10 ->
    base-e conversion via division by ``log10(e)``, implicit zero backoffs,
    count validation against the ``\\data\\`` header.
    """
    if isinstance(file_, str):
        with open(file_) as f:
            return parse_arpa_lm(f, token2id, to_base_e, ftype, logger)
    if to_base_e is None:
        warnings.warn(
            "The default of to_base_e will be changed to True in a later "
            "version. Please manually specify this argument to suppress "
            "this warning"
        )
        to_base_e = False
    norm = ftype(math.log10(math.e) if to_base_e else 1.0)
    info = logger.info if logger is not None else (lambda msg: None)
    line = ""
    info("finding \\data\\ header")
    for line in file_:
        if line.strip() == "\\data\\":
            break
    if line.strip() != "\\data\\":
        raise IOError("Could not find \\data\\ line. Is this an ARPA file?")
    ngram_counts: List[int] = []
    count_pattern = re.compile(r"^ngram\s+(\d+)\s*=\s*(\d+)$")
    for line in file_:
        line = line.strip()
        if not line:
            continue
        match = count_pattern.match(line)
        if match is None:
            break
        n, count = (int(x) for x in match.groups())
        info(f"there are {count} {n}-grams")
        if len(ngram_counts) < n:
            ngram_counts.extend(0 for _ in range(n - len(ngram_counts)))
        ngram_counts[n - 1] = count
    prob_dicts: List[Dict[Any, Any]] = [dict() for _ in ngram_counts]
    header_pattern = re.compile(r"^\\(\d+)-grams:$")
    entry_pattern = re.compile(r"^(-?\d+(?:\.\d+)?(?:[Ee]-?\d+)?)\s+(.*)$")
    while line != "\\end\\":
        match = header_pattern.match(line)
        if match is None:
            raise IOError(f'line "{line}" is not valid')
        ngram = int(match.group(1))
        if ngram > len(ngram_counts):
            raise IOError(f"{ngram}-grams count was not listed, but found entry")
        dict_ = prob_dicts[ngram - 1]
        for line in file_:
            line = line.strip()
            if not line:
                continue
            match = entry_pattern.match(line)
            if match is None:
                break
            logp, rest = match.groups()
            tokens = tuple(rest.strip().split())
            # IRSTLM/SRILM allow implicit backoffs on non-final n-grams,
            # but final n-grams must not have backoffs
            logb = ftype(0.0)
            if len(tokens) == ngram + 1 and ngram < len(prob_dicts):
                try:
                    logb = ftype(tokens[-1])
                    tokens = tokens[:-1]
                except ValueError:
                    pass
            if len(tokens) != ngram:
                raise IOError(f'expected line "{line}" to be a(n) {ngram}-gram')
            if token2id is not None:
                tokens = tuple(token2id[tok] for tok in tokens)
            key = tokens[0] if ngram == 1 else tokens
            if ngram != len(ngram_counts):
                dict_[key] = (ftype(logp) / norm, logb / norm)
            else:
                dict_[key] = ftype(logp) / norm
        else:
            # EOF without a terminating non-entry line: without this the
            # outer loop would re-match the stale header forever (the
            # reference hangs on such truncated files)
            raise IOError("Could not find \\end\\ line")
    if line != "\\end\\":
        raise IOError("Could not find \\end\\ line")
    for ngram_m1, (count, dict_) in enumerate(zip(ngram_counts, prob_dicts)):
        if len(dict_) != count:
            raise IOError(f"Expected {count} {ngram_m1}-grams, got {len(dict_)}")
    return prob_dicts


def transcript_to_token(
    transcript: Sequence[Any],
    token2id: Optional[dict] = None,
    frame_shift_ms: Optional[float] = None,
    unk: Optional[Union[str, int]] = None,
    skip_frame_times: bool = False,
) -> torch.Tensor:
    """Convert a transcript to a token sequence tensor.

    Returns int64 ``(R, 3)`` (or ``(R,)`` with `skip_frame_times`) of
    ``(id, start_frame, end_frame)``; missing times are ``-1``. The
    seconds->frames rule matches the reference exactly
    (``_parsing.py:740-855``): ``start = floor(1000 s / shift)``,
    ``end = max(start + [s == e], round(1000 e / shift))`` via floor of
    ``+ 0.5 * shift``.
    """
    if token2id is not None and unk in token2id:
        unk = token2id[unk]
    shape = (len(transcript),) if skip_frame_times else (len(transcript), 3)
    tok = np.empty(shape, dtype=np.int64)
    for i, token in enumerate(transcript):
        start = end = -1
        try:
            if len(token) == 3 and np.isreal(token[1]) and np.isreal(token[2]):
                token, start, end = token
                if frame_shift_ms:
                    if start == end:
                        start = end = (1000 * start) // frame_shift_ms
                    else:
                        start = (1000 * start) // frame_shift_ms
                        end = (1000 * end + 0.5 * frame_shift_ms) // frame_shift_ms
                        end = max(end, start + 1)
                else:
                    start, end = int(start), int(end)
        except TypeError:
            pass
        if token2id is None:
            id_ = token
        else:
            id_ = token2id.get(token, token if unk is None else unk)
        if skip_frame_times:
            tok[i] = id_
        else:
            tok[i] = (id_, start, end)
    return torch.from_numpy(tok)


def token_to_transcript(
    ref,
    id2token: Optional[Dict[int, str]] = None,
    frame_shift_ms: Optional[float] = None,
) -> List[Any]:
    """Convert a token sequence array back to a transcript.

    Inverse of :func:`transcript_to_token` (reference ``_parsing.py:858-903``).
    """
    if isinstance(ref, torch.Tensor):
        ref = ref.detach().cpu().numpy()
    ref = np.asarray(ref)
    transcript: List[Any] = []
    for tup in ref:
        start = end = -1
        if np.ndim(tup):
            id_ = int(tup[0])
            if np.size(tup) == 3:
                start, end = int(tup[1]), int(tup[2])
        else:
            id_ = int(tup)
        token = id2token.get(id_, id_) if id2token is not None else id_
        if start == -1 or end == -1:
            transcript.append(token)
        else:
            if frame_shift_ms:
                start = start * frame_shift_ms / 1000
                end = end * frame_shift_ms / 1000
            transcript.append((token, start, end))
    return transcript
