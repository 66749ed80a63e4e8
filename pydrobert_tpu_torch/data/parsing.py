"""Transcript and LM file parsing: ARPA, NIST trn and ctm, Praat TextGrid,
and the transcript/token conversions (counterpart of
:mod:`pydrobert_tpu.data.parsing`).

Host-side pure Python: the same formats, the same edge-case semantics
(sclite alternates, base-10 to base-e conversion, implicit backoffs, count
validation against the ``\\data\\`` header, the seconds-to-frames rules)
and the same returned objects, so a port
:class:`~pydrobert_tpu_torch.lm.LookupLanguageModel` built from an ARPA
file has the JAX package's tables, and files written by either package's
writers read the same in both. Token sequences are int64 CPU tensors.
"""

import math
import re
import warnings
from collections import OrderedDict
from logging import Logger
from multiprocessing import Pool
from typing import (
    IO, Any, Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple, Union,
)

import numpy as np
import torch

from .. import config
from .textgrid import TEXTTIER, TextGrid

__all__ = [
    "parse_arpa_lm",
    "read_ctm",
    "read_textgrid",
    "read_trn",
    "read_trn_iter",
    "token_to_transcript",
    "transcript_to_token",
    "write_ctm",
    "write_textgrid",
    "write_trn",
]


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


class _AltState:
    """State machine for sclite trn alternates (``{ a b / c }``)."""

    def __init__(self, parent=None):
        self.parent = parent
        self.tokens: List[Any] = []
        if parent is not None:
            parent.tokens.append([self.tokens])

    def new_branch(self):
        assert self.parent
        self.tokens = []
        self.parent.tokens[-1].append(self.tokens)


def _trn_line_to_transcript(
    x: Tuple[str, bool],
) -> Optional[Tuple[str, List[Any]]]:
    # sclite behavioral quirks preserved (reference ``_parsing.py:305-317``):
    # the last parenthesized group is the utterance id; an unmatched '}' or a
    # '/' outside braces is a word; an unterminated alternate is discarded;
    # internal parentheses are words; spaces are part of the utterance id.
    line, warn = x
    line = line.strip()
    if not line:
        return None
    try:
        last_open = line.rindex("(")
        last_close = line.rindex(")")
        if last_open > last_close:
            raise ValueError()
    except ValueError:
        raise IOError("Line does not end in utterance id")
    utt_id = line[last_open + 1 : last_close]
    line = line[:last_open].strip()
    transcript: List[Any] = []
    token = ""
    alt = _AltState()
    found_alt = False

    def flush():
        nonlocal token
        if token:
            if alt.parent is None:
                transcript.append(token)
            else:
                alt.tokens.append(token)
            token = ""

    for c in line:
        if c == "{":
            found_alt = True
            flush()
            alt = _AltState(alt)
        elif c == "/" and alt.parent is not None:
            if token:
                alt.tokens.append(token)
                token = ""
            alt.new_branch()
        elif c == "}" and alt.parent is not None:
            if token:
                alt.tokens.append(token)
                token = ""
            if not alt.tokens:
                raise IOError('Empty alternate found ("{ }")')
            alt = alt.parent
            if alt.parent is None:
                assert len(alt.tokens) == 1
                transcript.append((alt.tokens[0], -1, -1))
                alt.tokens = []
        elif c == " ":
            flush()
        else:
            token += c
    if token and alt.parent is None:
        transcript.append(token)
    if found_alt and warn:
        warnings.warn(
            f'Found an alternate in transcription for utt="{utt_id}". '
            "Transcript will contain an array of alternates at that point, "
            "and will not be compatible with transcript_to_token until "
            "resolved. To suppress this warning, set warn=False"
        )
    return utt_id, transcript


def read_trn_iter(
    trn: Union[IO, str],
    warn: bool = True,
    processes: int = 0,
    chunk_size: int = config.DEFT_CHUNK_SIZE,
) -> Iterator[Tuple[str, List[Any]]]:
    """Read a NIST sclite trn file, yielding ``(utt_id, transcript)``."""
    if isinstance(trn, str):
        with open(trn) as f:
            yield from read_trn_iter(f, warn, processes, chunk_size)
    elif processes == 0:
        for line in trn:
            x = _trn_line_to_transcript((line, warn))
            if x is not None:
                yield x
    else:
        with Pool(processes) as pool:
            out = pool.imap(
                _trn_line_to_transcript,
                ((line, warn) for line in trn),
                chunk_size,
            )
            for x in out:
                if x is not None:
                    yield x
            pool.close()
            pool.join()


def read_trn(
    trn: Union[IO, str],
    warn: bool = True,
    processes: int = 0,
    chunk_size: int = config.DEFT_CHUNK_SIZE,
) -> List[Tuple[str, List[Any]]]:
    """Read a NIST sclite trn file into a list of transcripts."""
    return list(read_trn_iter(trn, warn, processes, chunk_size))


def write_trn(
    transcripts: Iterable[Tuple[str, List[Any]]], trn: Union[str, IO]
) -> None:
    """Write transcripts to a NIST trn file (inverse of :func:`read_trn`)."""
    if isinstance(trn, str):
        with open(trn, "w") as f:
            return write_trn(transcripts, f)

    def _handle_x(x):
        if isinstance(x, str):
            return x + " "
        # x is a list of alternates
        return "{ " + "/ ".join("".join(_handle_x(xx) for xx in alts) for alts in x) + "} "

    for utt_id, transcript in transcripts:
        line = ""
        for x in transcript:
            # drop start/end times if present; alternates always carry the
            # placeholder (-1, -1) so this is unambiguous
            try:
                if len(x) == 3 and np.isreal(x[1]) and np.isreal(x[2]):
                    x = x[0]
            except TypeError:
                pass
            line += _handle_x(x)
        trn.write(f"{line}({utt_id})\n")


def read_ctm(
    ctm: Union[IO, str], wc2utt: Optional[dict] = None
) -> List[Tuple[str, List[Tuple[str, float, float]]]]:
    """Read a NIST sclite ctm file into a list of transcriptions.

    Token segments are ``(token, start_secs, end_secs)``; utterances are
    identified by wavefile name (or ``wc2utt[(wfn, channel)]``). Alternate
    delimiters error, as in the reference (``_parsing.py:443-529``).
    """
    if isinstance(ctm, str):
        with open(ctm) as f:
            return read_ctm(f, wc2utt)
    transcripts: "OrderedDict[str, list]" = OrderedDict()
    for line_no, line in enumerate(ctm):
        line = line.split(";;")[0].strip()
        if not line:
            continue
        parts = line.split()
        try:
            if len(parts) not in {5, 6}:
                raise ValueError()
            wfn, chan, start, dur, token = parts[:5]
            utt_id = wfn if wc2utt is None else wc2utt[(wfn, chan)]
            start = float(start)
            end = start + float(dur)
            if start < 0.0 or start > end:
                raise ValueError()
            transcripts.setdefault(utt_id, []).append((token, start, end))
        except ValueError:
            raise ValueError(f"Could not parse line {line_no + 1} of ctm")
        except KeyError:
            raise KeyError(
                f"ctm line {line_no}: ({wfn}, {chan}) was not found in wc2utt"
            )
    return [
        (utt_id, sorted(transcript, key=lambda x: x[1]))
        for utt_id, transcript in transcripts.items()
    ]


def write_ctm(
    transcripts: Sequence[Tuple[str, Sequence[Tuple[str, float, float]]]],
    ctm: Union[IO, str],
    utt2wc: Union[Mapping[str, Tuple[str, str]], str] = config.DEFT_CTM_CHANNEL,
) -> None:
    """Write transcripts to a NIST ctm file (inverse of :func:`read_ctm`)."""
    if isinstance(ctm, str):
        with open(ctm, "w") as f:
            return write_ctm(transcripts, f, utt2wc)
    is_dict = not isinstance(utt2wc, str)
    segments = []
    for utt_id, transcript in transcripts:
        try:
            wfn, chan = utt2wc[utt_id] if is_dict else (utt_id, utt2wc)
        except KeyError:
            raise KeyError(f'Utt "{utt_id}" has no value in utt2wc')
        for tup in transcript:
            if (
                isinstance(tup, str)
                or len(tup) != 3
                or tup[1] < 0.0
                or tup[2] < 0.0
            ):
                raise ValueError(
                    f'Utt "{utt_id}" contains token "{tup}" with no timing '
                    "info"
                )
            token, start, end = tup
            if end - start < 0.0:
                raise ValueError(
                    f'Utt "{utt_id}" contains token with negative duration'
                )
            segments.append((wfn, chan, start, end - start, token))
    for segment in sorted(segments):
        ctm.write("{} {} {} {} {}\n".format(*segment))


def read_textgrid(
    tg: Union[IO, str],
    tier_id: Union[str, int] = config.DEFT_TEXTGRID_TIER_ID,
    fill_token: Optional[str] = None,
) -> Tuple[List[Tuple[str, float, float]], float, float]:
    """Read a Praat TextGrid file as a transcription.

    Returns ``(transcript, tier_xmin, tier_xmax)`` with segments
    ``(token, start_secs, end_secs)`` (point tiers collapse start == end);
    `fill_token` fills gaps. Parity: reference ``read_textgrid``
    (``_parsing.py:570-650``).
    """
    if isinstance(tg, str):
        with open(tg) as f:
            return read_textgrid(f, tier_id, fill_token)
    tg_ = TextGrid(tg.read())
    if isinstance(tier_id, str):
        tier = None
        for tier_ in tg_.tiers:
            if tier_.nameid == tier_id:
                tier = tier_
                break
        if tier is None:
            raise ValueError(f"Could not find tier '{tier_id}'")
    else:
        tier = tg_.tiers[tier_id]
    if tier.classid == TEXTTIER:
        transcript = [
            (x[1], float(x[0]), float(x[0]))
            for x in sorted(tier.simple_transcript)
        ]
    else:
        transcript = [
            (x[2], float(x[0]), float(x[1]))
            for x in sorted(tier.simple_transcript)
        ]
    i = 0
    start_time = tier.xmin
    while i < len(transcript):
        _, next_start, end_time = transcript[i]
        if fill_token is not None and start_time < next_start:
            transcript.insert(i, (fill_token, start_time, next_start))
            i += 1
        i += 1
        start_time = end_time
    if fill_token is not None and tier.xmax is not None and start_time < tier.xmax:
        transcript.append((fill_token, start_time, tier.xmax))
    return transcript, tier.xmin, tier.xmax


def write_textgrid(
    transcript: Sequence[Tuple[str, float, float]],
    tg: Union[IO, str],
    start_time: Optional[float] = None,
    end_time: Optional[float] = None,
    tier_name: str = config.DEFT_TEXTGRID_TIER_NAME,
    point_tier: Optional[bool] = None,
    precision: int = config.DEFT_FLOAT_PRINT_PRECISION,
) -> None:
    """Write a transcription as a (short-form ooTextFile) TextGrid.

    Parity: reference ``write_textgrid`` (``_parsing.py:653-737``): point
    tier inferred when all segments have zero length within `precision`.
    """
    if isinstance(tg, str):
        with open(tg, "w") as f:
            return write_textgrid(
                transcript, f, start_time, end_time, tier_name, point_tier,
                precision,
            )
    transcript = list(transcript)
    if not len(transcript):
        raise ValueError("Will not write an empty transcript")
    tier_start_time = min(x[1] for x in transcript)
    tier_end_time = max(x[2] for x in transcript)
    if start_time is None:
        start_time = tier_start_time
    elif start_time > tier_start_time:
        raise ValueError(
            f"gave start_time={start_time} but an interval starts at "
            f"{tier_start_time}"
        )
    if end_time is None:
        end_time = tier_end_time
    elif end_time < tier_end_time:
        raise ValueError(
            f"gave end_time={end_time} but an interval ends at {tier_end_time}"
        )
    if point_tier is None:
        point_tier = all(
            f"{x[1]:0.{precision}f}" == f"{x[2]:0.{precision}f}"
            for x in transcript
        )
    tier_type = "TextTier" if point_tier else "IntervalTier"
    tg.write(
        'File type = "ooTextFile"\n'
        'Object class = "TextGrid"\n'
        f"{start_time:0.{precision}f}\n"
        f"{end_time:0.{precision}f}\n"
        "<exists>\n"
        "1\n"
        f'"{tier_type}"\n'
        f'"{tier_name}"\n'
        f"{tier_start_time:0.{precision}f}\n"
        f"{tier_end_time:0.{precision}f}\n"
        f"{len(transcript)}\n"
    )
    for tok, start, end in transcript:
        if point_tier:
            tg.write(f'{start:0.{precision}f}\n"{tok}"\n')
        else:
            tg.write(f'{start:0.{precision}f}\n{end:0.{precision}f}\n"{tok}"\n')


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
