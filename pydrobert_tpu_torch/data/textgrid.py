"""Praat TextGrid parsing (counterpart of :mod:`pydrobert_tpu.data.textgrid`,
this package's own copy).

Parses the three layouts of Praat's TextGrid files: "long" ooTextFile
(``item [n]:`` blocks with ``key = value`` lines), "short" ooTextFile
(bare values, one per line), and chronological TextGrid files. Everything
reduces to a token stream of values, which also makes the parser robust to
indentation and blank lines.
"""

import re
from typing import List, Tuple, Union

__all__ = ["INTERVALTIER", "TEXTTIER", "TextGrid", "Tier"]

TEXTTIER = "TextTier"
INTERVALTIER = "IntervalTier"

_QUOTED = re.compile(r'"((?:[^"]|"")*)"')
_FLAG = re.compile(r"<[^>]*>")


class Tier:
    """One tier of a TextGrid.

    Attributes: `classid` (``"IntervalTier"`` or ``"TextTier"``), `nameid`,
    `xmin`, `xmax`, `size`, and `simple_transcript` — a list of
    ``(start, end, text)`` tuples for interval tiers or ``(time, mark)``
    pairs for point tiers (matching the reference's ``Tier.simple_transcript``,
    ``_textgrid.py:399-423``).
    """

    def __init__(
        self,
        classid: str,
        nameid: str,
        xmin: float,
        xmax: float,
        simple_transcript: List[Tuple],
    ):
        self.classid = classid
        self.nameid = nameid
        self.xmin = xmin
        self.xmax = xmax
        self.simple_transcript = simple_transcript
        self.size = len(simple_transcript)

    def min_max(self) -> Tuple[float, float]:
        return self.xmin, self.xmax

    def __repr__(self):
        return (
            f"<Tier {self.nameid!r} ({self.classid}) {self.xmin}-{self.xmax},"
            f" {self.size} entries>"
        )


def _tokenize(text: str) -> List[Union[str, float]]:
    """Reduce a TextGrid body to a stream of values.

    Quoted strings become str tokens (with doubled quotes unescaped); bare
    numbers become floats; ``<flags>`` (e.g. ``<exists>``) become the str
    flag. Key names, brackets, and punctuation from the long format are
    dropped.
    """
    tokens: List[Union[str, float]] = []
    # quoted texts may legally span lines in Praat files; join lines while
    # a quote is open (doubled "" escapes count as two, keeping parity)
    lines: List[str] = []
    buf = None
    for raw in text.splitlines():
        if buf is None:
            if raw.count('"') % 2 == 1:
                buf = raw
            else:
                lines.append(raw)
        else:
            buf += "\n" + raw
            if raw.count('"') % 2 == 1:
                lines.append(buf)
                buf = None
    if buf is not None:
        lines.append(buf)
    for line in lines:
        # in long format, values follow '='; headers like "intervals [1]:"
        # and "item []:" carry no value
        if "=" in line and not _QUOTED.match(line.strip()):
            line = line.split("=", 1)[1]
        pos = 0
        while pos < len(line):
            m = _QUOTED.search(line, pos)
            bare = line[pos : m.start() if m else len(line)]
            for piece in bare.replace("!", " ! ").split():
                if piece == "!":  # chron-format comment: rest of line is text
                    pos = len(line)
                    break
                try:
                    tokens.append(float(piece))
                except ValueError:
                    fm = _FLAG.match(piece)
                    if fm:
                        tokens.append(piece)
                    # else: stray word (e.g. "tiers?", "Time domain.") - skip
            else:
                if m is None:
                    break
                tokens.append(("str", m.group(1).replace('""', '"')))
                pos = m.end()
                continue
            break
    return tokens


def _is_str(tok) -> bool:
    return isinstance(tok, tuple) and tok[0] == "str"


def _sval(tok) -> str:
    return tok[1] if _is_str(tok) else str(tok)


class TextGrid:
    """A parsed TextGrid file: `xmin`, `xmax`, `size`, and `tiers`."""

    def __init__(self, read_file: str):
        first = read_file.strip().splitlines()[0] if read_file.strip() else ""
        if "chronological" in first:
            self._parse_chron(read_file)
        else:
            self._parse_oo(read_file)
        self.size = len(self.tiers)

    def _parse_oo(self, text: str) -> None:
        # drop the two header lines (File type / Object class)
        lines = text.splitlines()
        body_start = 0
        seen = 0
        for i, line in enumerate(lines):
            if "ooTextFile" in line or "TextGrid" in line:
                seen += 1
                body_start = i + 1
                if seen == 2:
                    break
        toks = _tokenize("\n".join(lines[body_start:]))
        # stream: xmin xmax [<exists>] size, then per tier:
        #   class name xmin xmax size, then entries
        pos = 0

        def next_num():
            nonlocal pos
            while pos < len(toks) and not isinstance(toks[pos], float):
                pos += 1
            if pos >= len(toks):
                raise IOError("truncated TextGrid")
            val = toks[pos]
            pos += 1
            return val

        def next_str():
            nonlocal pos
            while pos < len(toks) and not _is_str(toks[pos]):
                pos += 1
            if pos >= len(toks):
                raise IOError("truncated TextGrid")
            val = toks[pos][1]
            pos += 1
            return val

        self.xmin = next_num()
        self.xmax = next_num()
        num_tiers = int(next_num())
        self.tiers = []
        for _ in range(num_tiers):
            classid = next_str()
            if classid not in (INTERVALTIER, TEXTTIER):
                raise IOError(f"unknown tier class {classid!r}")
            nameid = next_str()
            xmin = next_num()
            xmax = next_num()
            size = int(next_num())
            entries = []
            for _ in range(size):
                if classid == INTERVALTIER:
                    a, b = next_num(), next_num()
                    entries.append((a, b, next_str()))
                else:
                    t = next_num()
                    entries.append((t, next_str()))
            self.tiers.append(Tier(classid, nameid, xmin, xmax, entries))

    def _parse_chron(self, text: str) -> None:
        toks = _tokenize(text)
        pos = 0
        # header: "<title>" xmin xmax num_tiers
        while pos < len(toks) and _is_str(toks[pos]):
            pos += 1
        self.xmin, self.xmax = toks[pos], toks[pos + 1]
        num_tiers = int(toks[pos + 2])
        pos += 3
        headers = []
        for _ in range(num_tiers):
            classid = _sval(toks[pos])
            nameid = _sval(toks[pos + 1])
            xmin, xmax = toks[pos + 2], toks[pos + 3]
            headers.append((classid, nameid, xmin, xmax))
            pos += 4
        entries: List[List[Tuple]] = [[] for _ in range(num_tiers)]
        while pos < len(toks):
            tier_no = int(toks[pos]) - 1
            if headers[tier_no][0] == INTERVALTIER:
                a, b = toks[pos + 1], toks[pos + 2]
                entries[tier_no].append((a, b, _sval(toks[pos + 3])))
                pos += 4
            else:
                entries[tier_no].append((toks[pos + 1], _sval(toks[pos + 2])))
                pos += 3
        self.tiers = [
            Tier(c, n, a, b, e) for (c, n, a, b), e in zip(headers, entries)
        ]
