"""ARPA language-model parsing (counterpart of
:func:`pydrobert_tpu.data.parsing.parse_arpa_lm`).

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
from typing import IO, Any, Dict, List, Optional, Union

__all__ = ["parse_arpa_lm"]


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
