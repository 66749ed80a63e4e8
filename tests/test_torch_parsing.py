"""The port's transcript and LM parsers against the JAX package's: ARPA,
NIST trn (with sclite's alternates and quirks), ctm and Praat TextGrids in
the long, short and chronological layouts. Parsed objects must be equal
(floats exactly: both packages parse the same text with Python's
``float``), written text byte-equal, and each package's reader must read
the other's writer's files to the same objects."""

import io
import warnings

import numpy as np
import pytest
import torch

from pydrobert_tpu.data import parsing as jp
from pydrobert_tpu_torch.data import parsing as pp
from pydrobert_tpu_torch.data import textgrid as ptg

ARPA = r"""
some garbage
\data\
ngram 1=5
ngram 2=6
ngram 3=2

\1-grams:
-1.384 <s> -0.30
-1.0 </s>
-0.7 a -0.5
-0.9 b -0.4
-1.2 c

\2-grams:
-0.30 <s> a -0.2
-0.5 a b -0.1
-0.6 b a -0.15
-0.4 a </s>
-0.9 b </s>
-1.1 c a 0.0

\3-grams:
-0.2 <s> a b
-0.3 a b a

\end\
"""

TRN = """\
here is a simple line (utt1)
 this has { an / alternate } in it (utt2)
a / slash and } unmatched close (utt3)
(utt4)
nested { a { b / c } / d } end (utt 5)
unterminated { alt / x (utt6)
"""

CTM = """\
;; a comment
wfn1 A 0.1 1.0 hello
wfn1 A 1.2 0.5 there ;; trailing comment
wfn2 B 0.0 0.25 what
wfn1 A 0.05 0.05 well
"""

TG_LONG = """\
File type = "ooTextFile"
Object class = "TextGrid"

xmin = 0.1
xmax = 1
tiers? <exists>
size = 2
item []:
    item [1]:
       class = "IntervalTier"
       name = "a"
       xmin = 0.3
       xmax = 0.7
       intervals: size = 2
       intervals [1]:
          xmin = 0.3
          xmax = 0.4
          text = "paul"
       intervals [2]:
          xmin = 0.4
          xmax = 0.7
          text = "blart"
    item [2]:
       class = "TextTier"
       name = "b"
       xmin = 0.1
       xmax = 1
       points: size = 2
       points [1]:
          number = 0.3
          mark = "mall"
       points [2]:
          number = 0.9
          mark = "cop"
"""

TG_SHORT = """\
File type = "ooTextFile"
Object class = "TextGrid"
0
1
<exists>
1
"IntervalTier"
"pup"
0
1
3
0
0.1
"a"
0.1
0.2
"b"
0.2
1
"Z"
"""

TG_CHRON = """\
"Praat chronological TextGrid text file"
0 2.5   ! Time domain.
2   ! Number of tiers.
"IntervalTier" "words" 0 2.5
"TextTier" "bells" 0 2.5
1 0.2 0.9
"one ""quoted"" word"
2 1.1
"ding"
1 1.2 2.4
"two"
"""


def test_parse_arpa_lm_equals_jax():
    """Both bases and a token2id: the same dicts, values exactly equal."""
    t2i = {"<s>": 5, "</s>": 6, "a": 0, "b": 1, "c": 2}
    for kw in ({"to_base_e": True}, {"to_base_e": False, "token2id": t2i}):
        got = pp.parse_arpa_lm(io.StringIO(ARPA), **kw)
        exp = jp.parse_arpa_lm(io.StringIO(ARPA), **kw)
        assert got == exp


@pytest.mark.parametrize(
    "text",
    [
        "no data header here",
        ARPA.replace("ngram 2=6", "ngram 2=7"),
        "\\data\\\nngram 1=1\n\n\\1-grams:\n",
    ],
    ids=["no-header", "count", "truncated"],
)
def test_parse_arpa_lm_raises_where_jax_raises(text):
    with pytest.raises(IOError):
        jp.parse_arpa_lm(io.StringIO(text), to_base_e=True)
    with pytest.raises(IOError):
        pp.parse_arpa_lm(io.StringIO(text), to_base_e=True)


def test_read_trn_equals_jax():
    """sclite's quirks: nested and unterminated alternates, a stray ``/``
    and ``}``, an empty line, spaces in an utterance id; with and without
    a process pool."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        exp = jp.read_trn(io.StringIO(TRN))
        got = pp.read_trn(io.StringIO(TRN))
        assert got == exp
        assert list(pp.read_trn_iter(io.StringIO(TRN))) == exp
        assert pp.read_trn(io.StringIO(TRN), processes=2, chunk_size=2) == exp
    assert got[0] == ("utt1", ["here", "is", "a", "simple", "line"])
    assert got[1][1][2] == ([["an"], ["alternate"]], -1, -1)
    with pytest.warns(UserWarning, match="alternate"):
        pp.read_trn(io.StringIO(TRN))
    for text in ("no id here\n", "{ } (x)\n"):
        with pytest.raises(IOError):
            jp.read_trn(io.StringIO(text))
        with pytest.raises(IOError):
            pp.read_trn(io.StringIO(text))


def test_trn_written_byte_equal_and_read_across():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        transcripts = pp.read_trn(io.StringIO(TRN))
        # timed tokens lose their times on the way out, in both
        transcripts.append(("utt7", [("x", 0.1, 0.2), "y"]))
        jbuf, pbuf = io.StringIO(), io.StringIO()
        jp.write_trn(transcripts, jbuf)
        pp.write_trn(transcripts, pbuf)
        assert pbuf.getvalue() == jbuf.getvalue()
        assert pp.read_trn(io.StringIO(jbuf.getvalue())) == jp.read_trn(
            io.StringIO(pbuf.getvalue())
        )


def test_read_ctm_equals_jax():
    assert pp.read_ctm(io.StringIO(CTM)) == jp.read_ctm(io.StringIO(CTM))
    wc2utt = {("wfn1", "A"): "u1", ("wfn2", "B"): "u2"}
    assert pp.read_ctm(io.StringIO(CTM), wc2utt) == jp.read_ctm(io.StringIO(CTM), wc2utt)
    for text, err in (("wfn A -1.0 0.5 neg", ValueError), ("w A 0 1 x y z", ValueError)):
        with pytest.raises(err):
            jp.read_ctm(io.StringIO(text))
        with pytest.raises(err):
            pp.read_ctm(io.StringIO(text))
    with pytest.raises(KeyError):
        pp.read_ctm(io.StringIO(CTM), {("wfn1", "A"): "u1"})


def test_ctm_written_byte_equal_and_read_across():
    transcripts = pp.read_ctm(io.StringIO(CTM))
    for utt2wc in ("A", {"wfn1": ("w1", "B"), "wfn2": ("w2", "A")}):
        jbuf, pbuf = io.StringIO(), io.StringIO()
        jp.write_ctm(transcripts, jbuf, utt2wc)
        pp.write_ctm(transcripts, pbuf, utt2wc)
        assert pbuf.getvalue() == jbuf.getvalue()
        assert pp.read_ctm(io.StringIO(jbuf.getvalue())) == jp.read_ctm(
            io.StringIO(pbuf.getvalue())
        )
    for bad in ([("u", ["untimed"])], [("u", [("x", 0.5, 0.1)])]):
        with pytest.raises(ValueError):
            jp.write_ctm(bad, io.StringIO())
        with pytest.raises(ValueError):
            pp.write_ctm(bad, io.StringIO())


@pytest.mark.parametrize(
    "text,tier_ids",
    [(TG_LONG, [0, 1, "a", "b"]), (TG_SHORT, [0, "pup"]), (TG_CHRON, [0, 1, "words", "bells"])],
    ids=["long", "short", "chron"],
)
def test_read_textgrid_equals_jax(text, tier_ids):
    for tier_id in tier_ids:
        for fill in (None, "fill"):
            got = pp.read_textgrid(io.StringIO(text), tier_id, fill)
            assert got == jp.read_textgrid(io.StringIO(text), tier_id, fill), (tier_id, fill)
    tg = ptg.TextGrid(text)
    assert [(t.classid, t.nameid, t.size, t.min_max()) for t in tg.tiers] == [
        (t.classid, t.nameid, t.size, t.min_max()) for t in jp.TextGrid(text).tiers
    ]
    with pytest.raises(ValueError):
        pp.read_textgrid(io.StringIO(text), "no such tier")


def test_textgrid_written_byte_equal_and_read_across():
    """Interval and (inferred) point tiers, precision, given bounds."""
    cases = [
        ([("cool", 0.1234, 0.1237), ("beans", 0.35, 0.4444)], {}),
        ([("x", 0.5, 0.5), ("y", 0.75, 0.75)], {}),
        ([("a", 0.0, 1.0)], {"start_time": 0.0, "end_time": 2.0, "tier_name": "t",
                             "precision": 5}),
    ]
    for transcript, kw in cases:
        jbuf, pbuf = io.StringIO(), io.StringIO()
        jp.write_textgrid(transcript, jbuf, **kw)
        pp.write_textgrid(transcript, pbuf, **kw)
        assert pbuf.getvalue() == jbuf.getvalue()
        assert pp.read_textgrid(io.StringIO(jbuf.getvalue())) == jp.read_textgrid(
            io.StringIO(pbuf.getvalue())
        )
    for kw in ({"start_time": 0.2}, {"end_time": 0.3}):
        with pytest.raises(ValueError):
            pp.write_textgrid(cases[0][0], io.StringIO(), **kw)
    with pytest.raises(ValueError):
        pp.write_textgrid([], io.StringIO())


def test_transcript_token_conversions_over_parsed_files_equal_jax():
    """trn and ctm transcripts to tokens and back at 10 and 25 ms."""
    transcript = ["a", ("b", 0.1, 0.4), ("c", 0.4, 0.44), ("d", 0.5, 0.5)]
    token2id = {"a": 0, "b": 1, "c": 2}
    for shift in (None, 10.0, 25.0):
        got = pp.transcript_to_token(transcript, token2id, shift, unk="c")
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(
            got.numpy(), jp.transcript_to_token(transcript, token2id, shift, unk="c")
        )
    id2token = {v: k for k, v in token2id.items()}
    for _, tr in pp.read_ctm(io.StringIO(CTM)):
        tok = pp.transcript_to_token(tr, {"hello": 0, "there": 1, "what": 2, "well": 3}, 10.0)
        assert pp.token_to_transcript(tok, id2token, 10.0) == jp.token_to_transcript(
            tok.numpy(), id2token, 10.0
        )


def test_textgrid_multiline_quoted_text(tmp_path):
    """Quoted interval texts may span lines in Praat files."""
    tg = (
        'File type = "ooTextFile"\n'
        'Object class = "TextGrid"\n'
        "xmin = 0\nxmax = 2\ntiers? <exists>\nsize = 1\nitem []:\n"
        "    item [1]:\n"
        '        class = "IntervalTier"\n'
        '        name = "words"\n'
        "        xmin = 0\n        xmax = 2\n"
        "        intervals: size = 1\n"
        "        intervals [1]:\n"
        "            xmin = 0\n            xmax = 2\n"
        '            text = "hello\nworld"\n'
    )
    pth = tmp_path / "x.TextGrid"
    pth.write_text(tg)
    got = pp.read_textgrid(str(pth), "words")
    assert got == jp.read_textgrid(str(pth), "words")
    assert got[0][0][0] == "hello\nworld"
