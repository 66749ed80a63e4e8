"""The port's 17 corpus commands against the JAX package's, on the same
seeded input directories: every command runs through both packages, and
their outputs must match. Tensor files are equal bit for bit (dtype, shape
and values, each file read by both packages' readers); text files (trn,
ctm, TextGrid, moments, LM info) are byte-equal; MVN statistics, which the
port sums on the CPU with the same numpy code, are bit-equal; tar shards
read the same in both packages' ``SpectTarDataSet``; compiled LM archives
hold bit-equal arrays. Commands that compute run with ``--device cpu``
here; ``chip_smoke.py``'s ``corpus`` phase holds them on the card against
these CPU runs."""

import os
import pickle
import tarfile
import warnings

import numpy as np
import pytest
import torch

from pydrobert_tpu import command_line as jcl
from pydrobert_tpu.utils import serial as jserial
from pydrobert_tpu_torch import command_line as pcl
from pydrobert_tpu_torch.utils import serial as pserial

CPU = ["--device", "cpu"]


def _token2id(path, ids=range(20), swap=False):
    with open(path, "w") as f:
        for i in ids:
            f.write(f"{i} tok{i}\n" if swap else f"tok{i} {i}\n")
    return str(path)


def _same_tree(jdir, pdir):
    """Both trees hold the same names; ``.pt`` files the same tensors, read
    by either package; everything else the same bytes."""
    jnames, pnames = sorted(os.listdir(jdir)), sorted(os.listdir(pdir))
    assert jnames == pnames, (jdir, pdir)
    assert jnames
    for name in jnames:
        j, p = os.path.join(jdir, name), os.path.join(pdir, name)
        if os.path.isdir(j):
            _same_tree(j, p)
        elif name.endswith(".pt"):
            exp = jserial.load_tensor(j)
            for got in (pserial.load_tensor(p).numpy(), jserial.load_tensor(p),
                        pserial.load_tensor(j).numpy()):
                assert got.dtype == exp.dtype and got.shape == exp.shape, name
                np.testing.assert_array_equal(got, exp)
        else:
            with open(j, "rb") as fj, open(p, "rb") as fp:
                assert fp.read() == fj.read(), name


def _both(tmp_path, name, make_args, port_extra=(), expect_rc=0):
    """Run command `name` of both packages with ``make_args(out)``; returns
    the JAX and port outputs."""
    outs = []
    for pkg, extra in ((jcl, []), (pcl, list(port_extra))):
        out = str(tmp_path / f"{pkg.__name__.split('.')[0]}_{name}")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert getattr(pkg, name)(make_args(out) + extra) == expect_rc, pkg.__name__
        outs.append(out)
    return outs


def test_every_command_has_help_and_dispatches(capsys):
    assert sorted(pcl.__all__) == sorted(jcl.__all__)
    for name in pcl.__all__:
        assert getattr(pcl, name)(["--help"]) == 0, name
        assert "usage:" in capsys.readouterr().out
        assert pcl.main([name.replace("_", "-"), "--help"]) == 0
        capsys.readouterr()
    assert pcl.main(["no-such-command"]) == 2


TRN = """\
tok1 tok2 tok3 (utt_a)
tok4 (utt_b)
tok0 tok0 tok19 (utt_c)
tok5 { tok6 / tok7 tok8 } tok9 (utt_d)
tok42 tok1 (utt_e)
"""


@pytest.mark.parametrize(
    "opts",
    [["--alt-handler", "first", "--unk-symbol", "tok0"],
     ["--alt-handler", "first", "--unk-symbol", "tok0", "--skip-frame-times"],
     ["--alt-handler", "first", "--unk-symbol", "tok0", "--feat-sizing", "--num-workers", "2"]],
    ids=["plain", "skip-frame-times", "feat-sizing-pool"],
)
def test_trn_commands_equal_jax(tmp_path, opts):
    """trn-to-torch-token-data-dir and torch-token-data-dir-to-trn: the same
    dirs and byte-equal trn files, each package reading the other's."""
    token2id = _token2id(tmp_path / "token2id")
    trn = tmp_path / "in.trn"
    trn.write_text(TRN)
    jdir, pdir = _both(tmp_path, "trn_to_torch_token_data_dir",
                       lambda out: [str(trn), token2id, out] + opts)
    _same_tree(jdir, pdir)
    jtrn, ptrn = _both(tmp_path, "torch_token_data_dir_to_trn",
                       lambda out: [pdir, token2id, out, "--swap"])
    with open(jtrn, "rb") as fj, open(ptrn, "rb") as fp:
        assert fp.read() == fj.read()
    back = str(tmp_path / "back")
    assert not jcl.trn_to_torch_token_data_dir([ptrn, token2id, back] + opts)
    _same_tree(back, pdir)
    # an alternate in the default "error" mode raises in both
    for pkg in (jcl, pcl):
        with pytest.raises(ValueError, match="alternate"), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            pkg.trn_to_torch_token_data_dir([str(trn), token2id, str(tmp_path / "e")])
    assert pcl.trn_to_torch_token_data_dir(
        [str(trn), token2id, str(tmp_path / "e"), "--unk-symbol", "nope"]) == 1


CTM = """\
;; a comment
utt_a A 0.0 0.1 tok1
utt_a A 0.1 0.15 tok2
utt_b A 0.5 0.0 tok3
utt_b A 0.25 0.2 tok19 ;; trailing
utt_c B 0.03 0.4 tok77
"""


@pytest.mark.parametrize(
    "in_opts,out_opts",
    [([], ["--frame-shift-ms", "10"]),
     (["--frame-shift-ms", "25", "--unk-symbol", "tok0"], ["--frame-shift-ms", "25",
                                                           "--channel", "B"]),
     (["--wc2utt", "WC2UTT", "--unk-symbol", "tok0"], ["--utt2wc", "UTT2WC"]),
     (["--skip-frame-times", "--unk-symbol", "tok0"], None)],
    ids=["10ms", "25ms-unk", "wc2utt", "skip-frame-times"],
)
def test_ctm_commands_equal_jax(tmp_path, in_opts, out_opts):
    token2id = _token2id(tmp_path / "token2id")
    ctm = tmp_path / "in.ctm"
    ctm.write_text(CTM)
    (tmp_path / "wc2utt").write_text("utt_a A u1\nutt_b A u2\nutt_c B u3\n")
    (tmp_path / "utt2wc").write_text("u1 w1 A\nu2 w2 B\nu3 w3 A\n")

    def subst(opts):
        return [str(tmp_path / o.lower()) if o in ("WC2UTT", "UTT2WC") else o for o in opts]

    if "--unk-symbol" not in in_opts:
        ctm.write_text(CTM.replace("tok77", "tok7"))
    jdir, pdir = _both(tmp_path, "ctm_to_torch_token_data_dir",
                       lambda out: [str(ctm), token2id, out] + subst(in_opts))
    _same_tree(jdir, pdir)
    if out_opts is None:
        return
    jctm, pctm = _both(tmp_path, "torch_token_data_dir_to_ctm",
                       lambda out: [pdir, token2id, out, "--swap"] + subst(out_opts))
    with open(jctm, "rb") as fj, open(pctm, "rb") as fp:
        assert fp.read() == fj.read()
    back = str(tmp_path / "back")
    shift = [o for o in in_opts if o in ("--frame-shift-ms", "25")]
    wc = ["--utt2wc", str(tmp_path / "utt2wc")] if "--wc2utt" in in_opts else []
    assert not jcl.ctm_to_torch_token_data_dir([pctm, token2id, back] + shift + wc)
    _same_tree(back, jdir)


@pytest.mark.parametrize(
    "to_tg,from_tg",
    [(["--infer"], []),
     (["--feat-dir", "FEAT", "--precision", "5"], ["--fill-symbol", "tok0"]),
     (["--infer", "--force-method", "2", "--tier-name", "t"], ["--tier-name", "t"]),
     (["--feat-dir", "FEAT", "--force-method", "3", "--frame-shift-ms", "20"],
      ["--tier-idx", "0", "--frame-shift-ms", "20", "--skip-frame-times"])],
    ids=["infer", "feat-dir-fill", "points", "method3"],
)
def test_textgrid_commands_equal_jax(populate_data_dir, tmp_path, to_tg, from_tg):
    """torch-token-data-dir-to-textgrids (methods 1-3) and
    textgrids-to-torch-token-data-dir: byte-equal TextGrids, equal dirs."""
    root, _, _, refs, _ = populate_data_dir(num_utts=6, num_ref_classes=13)
    id2tok = _token2id(tmp_path / "id2token", range(13), swap=True)
    feat = os.path.join(root, "feat")
    opts = [feat if o == "FEAT" else o for o in to_tg]
    jtg, ptg = _both(tmp_path, "torch_token_data_dir_to_textgrids",
                     lambda out: [os.path.join(root, "ref"), id2tok, out] + opts)
    _same_tree(jtg, ptg)
    if "3" in to_tg:  # one label holding the joined transcript: no tokens to read back
        return
    jdir, pdir = _both(tmp_path, "textgrids_to_torch_token_data_dir",
                       lambda out: [ptg, id2tok, out, "--swap"] + from_tg)
    _same_tree(jdir, pdir)


def test_textgrids_num_workers_equal_serial_and_jax(populate_data_dir, tmp_path):
    root, *_ = populate_data_dir(num_utts=6)
    id2tok = _token2id(tmp_path / "id2token", range(13), swap=True)
    ref = os.path.join(root, "ref")
    ser, par = str(tmp_path / "ser"), str(tmp_path / "par")
    assert not pcl.torch_token_data_dir_to_textgrids([ref, id2tok, ser, "--infer"])
    assert not pcl.torch_token_data_dir_to_textgrids(
        [ref, id2tok, par, "--infer", "--num-workers", "2"])
    _same_tree(ser, par)
    jtg = str(tmp_path / "jtg")
    assert not jcl.torch_token_data_dir_to_textgrids([ref, id2tok, jtg, "--infer"])
    _same_tree(jtg, par)


def test_ali_token_commands_equal_jax(populate_data_dir, tmp_path):
    """Seeded alis to (R, 3) refs with boundaries and back, exactly; the
    frame check against features; a non-partition raises in both."""
    root, _, alis, _, _ = populate_data_dir(num_utts=7)
    jref, pref = _both(tmp_path, "torch_ali_data_dir_to_torch_token_data_dir",
                       lambda out: [os.path.join(root, "ali"), out, "--num-workers", "2"])
    _same_tree(jref, pref)
    jali, pali = _both(tmp_path, "torch_token_data_dir_to_torch_ali_data_dir",
                       lambda out: [pref, out, "--feat-dir", os.path.join(root, "feat")])
    _same_tree(jali, pali)
    _same_tree(os.path.join(root, "ali"), pali)
    for pkg in (jcl, pcl):  # the populated refs do not partition the frames
        with pytest.raises(ValueError):
            pkg.torch_token_data_dir_to_torch_ali_data_dir(
                [os.path.join(root, "ref"), str(tmp_path / "x")])


def test_mvn_stats_command_equals_jax(populate_data_dir, tmp_path):
    """Whole-dir and per-group statistics, with Bessel's correction: the
    pickled mean and std arrays bit-equal (the port's CPU sums are the JAX
    package's numpy code), each pickle read by either."""
    root, _, _, _, utt_ids = populate_data_dir(num_utts=8)
    feat = os.path.join(root, "feat")
    id2gid = tmp_path / "id2gid"
    id2gid.write_text("".join(f"{u} g{i % 3}\n" for i, u in enumerate(utt_ids)))
    for opts in ([], ["--bessel"], ["--id2gid", str(id2gid), "--bessel"]):
        jout, pout = _both(tmp_path, "compute_mvn_stats_for_torch_feat_data_dir",
                           lambda out: [feat, out] + opts, CPU)
        with open(jout, "rb") as fj, open(pout, "rb") as fp:
            exp, got = pickle.load(fj), pickle.load(fp)
        flat = (lambda d: d if "mean" in d else {f"{g}.{k}": v for g, s in d.items()
                                                  for k, v in s.items()})
        exp, got = flat(exp), flat(got)
        assert sorted(exp) == sorted(got)
        for k in exp:
            assert got[k].dtype == exp[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], exp[k])
    assert pcl.compute_mvn_stats_for_torch_feat_data_dir(
        [str(tmp_path), str(tmp_path / "none.pkl")] + CPU) == 1


def test_wds_command_equals_jax(populate_data_dir, tmp_path):
    """The same members in the same order, whole and sharded, each
    member's tensor equal; both packages' readers take either tar."""
    from pydrobert_tpu import data as jdata
    from pydrobert_tpu_torch import data as pdata

    root, *_ = populate_data_dir(num_utts=7)
    for opts in ([], ["--shard", "--max-samples-per-shard", "3"]):
        jtar, ptar = _both(tmp_path, "torch_spect_data_dir_to_wds",
                           lambda out: [root, out + ".tar"] + opts)
        pattern = ".tar.*" if opts else ".tar"
        import glob

        jshards, pshards = sorted(glob.glob(jtar + pattern)), sorted(glob.glob(ptar + pattern))
        assert [s[len(jtar):] for s in jshards] == [s[len(ptar):] for s in pshards]
        assert len(jshards) == (3 if opts else 1)
        for js, ps in zip(jshards, pshards):
            with tarfile.open(js) as jt, tarfile.open(ps) as pt:
                assert jt.getnames() == pt.getnames()
                for jm, pm in zip(jt.getmembers(), pt.getmembers()):
                    a = jserial.load_tensor(_member_file(jt, jm, tmp_path / "j.pt"))
                    b = pserial.load_tensor(_member_file(pt, pm, tmp_path / "p.pt")).numpy()
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
        kw = dict(suppress_alis=False, suppress_uttids=False)
        pds, jds = pdata.SpectTarDataSet(pshards, **kw), jdata.SpectTarDataSet(pshards, **kw)
        for i in range(len(pds)):
            for x, y in zip(pds[i], jds[i]):
                if isinstance(x, str):
                    assert x == y
                else:
                    np.testing.assert_array_equal(x.numpy(), y)


def _member_file(tf, member, path):
    with open(path, "wb") as f:
        f.write(tf.extractfile(member).read())
    return str(path)


@pytest.mark.parametrize(
    "opts",
    [["--first-n", "3"], ["--last-ratio", "0.4", "--copy"], ["--shortest-n", "2", "--copy"],
     ["--longest-ratio", "0.3"], ["--rand-n", "4", "--seed", "3"],
     ["--utt-list", "utt_002", "utt_005", "utt_404", "--symlink"], ["--first-n", "2", "--only"]],
    ids=["first-n", "last-ratio", "shortest", "longest", "rand", "list", "only"],
)
def test_subset_command_equals_jax(populate_data_dir, tmp_path, opts):
    root, *_ = populate_data_dir(num_utts=10)
    src = os.path.join(root, "feat") if "--only" in opts else root
    jdir, pdir = _both(tmp_path, "subset_torch_spect_data_dir", lambda out: [src, out] + opts)
    _same_tree(jdir, pdir)


@pytest.mark.parametrize(
    "opts",
    [["--policy", "fixed", "--lobe-size", "1", "--pad-mode", "constant", "--pad-constant", "2"],
     ["--policy", "fixed", "--lobe-size", "2", "--window-type", "causal"],
     ["--policy", "ali", "--lobe-size", "1", "--pad-mode", "replicate"],
     ["--policy", "ref", "--partial-tokens", "--retain-token-boundaries"],
     ["--policy", "ref", "--window-type", "future", "--pad-mode", "reflect"]],
    ids=["fixed-constant", "fixed-causal", "ali", "ref-partial", "ref-future"],
)
def test_chunk_command_equals_jax(populate_data_dir, tmp_path, opts):
    """Chunked feats, alis and refs under each policy equal JAX's; two
    workers give the same files as none."""
    root, *_ = populate_data_dir(num_utts=4, max_width=14)
    jdir, pdir = _both(tmp_path, "chunk_torch_spect_data_dir",
                       lambda out: [root, out, "--quiet"] + opts, CPU)
    _same_tree(jdir, pdir)
    if opts[1] == "ali":
        par = str(tmp_path / "par")
        assert not pcl.chunk_torch_spect_data_dir(
            [root, par, "--quiet", "--num-workers", "2"] + opts + CPU)
        _same_tree(pdir, par)


def test_length_moment_printers_equal_jax(populate_data_dir, tmp_path):
    """Both printers' text byte-equal to JAX's under each option; a
    malformed ref warns, or raises with --strict, in both."""
    root, *_ = populate_data_dir(num_utts=9)
    for cmd, sub, optss in (
        ("print_torch_ali_data_dir_length_moments", "ali",
         ([], ["--std", "--precision", "6"], ["--bessel", "--exclude-ids", "0", "3"])),
        ("print_torch_ref_data_dir_length_moments", "ref",
         ([], ["--std", "--bessel"], ["--exclude-ids", "1", "--precision", "2"])),
    ):
        for opts in optss:
            jout, pout = _both(tmp_path, cmd,
                               lambda out: [os.path.join(root, sub), out] + opts)
            with open(jout, "rb") as fj, open(pout, "rb") as fp:
                assert fp.read() == fj.read()
    bad = str(tmp_path / "bad")
    os.makedirs(bad)
    pserial.save_tensor(torch.tensor([[1, 3, 2]]), os.path.join(bad, "u.pt"))
    pserial.save_tensor(torch.tensor([1, 2]), os.path.join(bad, "v.pt"))
    jout, pout = _both(tmp_path, "print_torch_ref_data_dir_length_moments",
                       lambda out: [bad, out])
    with open(jout, "rb") as fj, open(pout, "rb") as fp:
        assert fp.read() == fj.read() == b"n/a (n/a)\n"
    for pkg in (jcl, pcl):
        with pytest.raises(ValueError, match="invalid"):
            pkg.print_torch_ref_data_dir_length_moments([bad, str(tmp_path / "o"), "--strict"])


ARPA = """\
\\data\\
ngram 1=6
ngram 2=4
ngram 3=2

\\1-grams:
-0.8 <s> -0.3
-0.9 </s>
-0.5 a -0.2
-0.6 b -0.25
-1.1 c
-1.3 d -0.1

\\2-grams:
-0.4 <s> a -0.05
-0.3 a b -0.1
-0.7 b </s>
-0.2 d a

\\3-grams:
-0.1 <s> a b
-0.15 a b </s>

\\end\\
"""


@pytest.mark.parametrize("opts", [[], ["--keep-base-10", "--sos", "<s>"],
                                  ["--vocab-size", "8", "--swap"]])
def test_arpa_commands_equal_jax(tmp_path, opts):
    """arpa-lm-to-state-dict: every array of the archive bit-equal to JAX's,
    each archive loading in both packages' LM; print-arpa-lm-state-dict-info
    byte-equal."""
    from pydrobert_tpu.lm import LookupLanguageModel as JLM
    from pydrobert_tpu_torch.lm import LookupLanguageModel as PLM

    arpa = tmp_path / "lm.arpa"
    arpa.write_text(ARPA)
    t2i = tmp_path / "token2id"
    pairs = [("<s>", 5), ("</s>", 4), ("a", 0), ("b", 1), ("c", 2), ("d", 3)]
    t2i.write_text("".join(f"{i} {t}\n" if "--swap" in opts else f"{t} {i}\n" for t, i in pairs))
    jnpz, pnpz = _both(tmp_path, "arpa_lm_to_state_dict",
                       lambda out: [str(arpa), str(t2i), out] + opts, CPU)
    jd, pd = dict(np.load(jnpz)), dict(np.load(pnpz))
    assert sorted(jd) == sorted(pd)
    for k in jd:
        assert jd[k].dtype == pd[k].dtype, k
        np.testing.assert_array_equal(pd[k], jd[k])
    plm = PLM(1, sos=0, device="cpu")
    plm.load_state_dict(dict(np.load(jnpz)))
    jlm = JLM(1, sos=0)
    jlm.load_state_dict(dict(np.load(pnpz)))
    assert (plm.vocab_size, plm.sos) == (jlm.vocab_size, jlm.sos)
    jinfo, pinfo = _both(tmp_path, "print_arpa_lm_state_dict_info",
                         lambda out: [pnpz, out])
    with open(jinfo, "rb") as fj, open(pinfo, "rb") as fp:
        text = fp.read()
        assert text == fj.read()
    assert b"max_ngram 3" in text


def test_logit_forced_align_command_equals_jax(tmp_path):
    """Viterbi CTC alignments of a logit dir (1-D and (R, 3) refs, one
    utterance with no tokens, buckets of two lengths) equal JAX's; an
    infeasible reference warns in both and is still written."""
    rng = np.random.RandomState(11)
    logit_dir, ref_dir = tmp_path / "logit", tmp_path / "ref"
    os.makedirs(logit_dir)
    os.makedirs(ref_dir)
    V, blank = 7, 6
    for i, (T, U) in enumerate([(12, 3), (9, 4), (40, 1), (5, 0), (33, 9)]):
        toks = rng.randint(0, blank, (U,)).astype(np.int64)
        logits = rng.randn(T, V).astype(np.float32)
        for u, t in enumerate(np.linspace(0, T - 1, max(U, 1), dtype=int)[:U]):
            logits[t, toks[u]] += 8.0
        pserial.save_tensor(torch.from_numpy(logits), str(logit_dir / f"utt_{i}.pt"))
        ref = np.stack([toks, np.arange(U), np.arange(U) + 1], 1) if i == 1 else toks
        pserial.save_tensor(torch.from_numpy(ref), str(ref_dir / f"utt_{i}.pt"))
    pserial.save_tensor(torch.randn(2, V), str(logit_dir / "bad.pt"))
    pserial.save_tensor(torch.zeros(3, dtype=torch.long), str(ref_dir / "bad.pt"))
    args = lambda out: [str(logit_dir), str(ref_dir), out, "--blank-idx", str(blank),  # noqa
                        "--batch-size", "2"]
    jali, pali = _both(tmp_path, "torch_logit_data_dir_to_torch_ali_data_dir", args, CPU)
    _same_tree(jali, pali)
    with pytest.warns(UserWarning, match="no alignment"):
        pcl.torch_logit_data_dir_to_torch_ali_data_dir(args(str(tmp_path / "w")) + CPU)
