"""The port's Hopper kernels on a card, against their plain versions.

Every test needs a CUDA device and skips without one (the kernels have no
CPU mode). This file imports nothing of JAX, so it also runs where only
PyTorch is installed; there, skip the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from pydrobert_tpu_torch import config as pconfig
from pydrobert_tpu_torch import lm as plm
from pydrobert_tpu_torch import serving as pserving
from pydrobert_tpu_torch.models import conformer as pconf
from pydrobert_tpu_torch.ops import img as pimg
from pydrobert_tpu_torch.ops import kernels
from pydrobert_tpu_torch.ops._build import load_library
from pydrobert_tpu_torch.ops import string as pstr
from pydrobert_tpu_torch.ops import decoding as pdec
from pydrobert_tpu_torch.ops.decoding import CTCPrefixSearch
from pydrobert_tpu_torch.ops.topk import hoisted_top_k

from _lm_dicts import random_prob_dicts

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _logits(shape, seed, dev, dtype=torch.float32, ties=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 3
    if ties:
        x = np.round(x * 4) / 4
    return torch.from_numpy(x).to(dev, dtype)


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,m", [((50, 8, 1025), 32), ((20, 3, 1001), 1), ((4, 2, 65), 64)]
)
def test_kernels_match_plain_versions(dev, dtype, shape, m):
    """top values/indices bit-exact, max and blank exact, den rtol 2e-6."""
    x = _logits(shape, m, dev, dtype, ties=True)
    g = torch.randn(shape[-1] - 1, generator=torch.Generator().manual_seed(0)).to(dev)
    for bias in (None, g):
        tv, ti, mx, den, blank = kernels.decode_prologue(x, m, bias)
        ev, ei, emx, eden, eblank = kernels.decode_prologue_reference(x, m, bias)
        assert _bits_equal(tv, ev) and torch.equal(ti, ei)
        assert torch.equal(mx, emx) and torch.equal(blank, eblank)
        torch.testing.assert_close(den, eden, rtol=2e-6, atol=0)
    gv, gi = kernels.top_m(x, m)
    ev, ei = kernels.top_m_reference(x, m)
    assert _bits_equal(gv, ev) and torch.equal(gi, ei)


def _signed_zero_rows(shape, seed):
    """Rows of -0.0 and +0.0 mixed, with a few nonzero logits among them."""
    rng = np.random.RandomState(seed)
    z = rng.rand(*shape)
    x = np.where(z < 0.45, np.float32(-0.0), np.float32(0.0))
    return np.where(z > 0.97, rng.randn(*shape).astype(np.float32), x).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["signed_zeros", "all_tie"])
def test_kernels_match_plain_versions_on_degenerate_rows(dev, dtype, kind):
    """Rows of mixed signed zeros (+0.0 ranks above -0.0) and rows whose
    keys all tie (lowest indices first): bit-exact values and indices."""
    shape, m = (20, 8, 1025), 32
    if kind == "signed_zeros":
        x = _signed_zero_rows(shape, 5)
    else:
        x = np.full(shape, 0.75, np.float32)
        x[::2] = -1.5  # every other frame ties on another value
    x = torch.from_numpy(x).to(dev, dtype)
    tv, ti, mx, den, blank = kernels.decode_prologue(x, m)
    ev, ei, emx, eden, eblank = kernels.decode_prologue_reference(x, m)
    assert _bits_equal(tv, ev) and torch.equal(ti, ei)
    assert torch.equal(mx, emx) and torch.equal(blank, eblank)
    torch.testing.assert_close(den, eden, rtol=2e-6, atol=0)
    gv, gi = kernels.top_m(x, m)
    ev, ei = kernels.top_m_reference(x, m)
    assert _bits_equal(gv, ev) and torch.equal(gi, ei)


@pytest.mark.parametrize("m", [64, 33, 1024])
def test_top_m_kernel_above_a_warp(dev, m):
    """M past 32 sorts the winners in shared memory: M=64 on V=1,024 rows
    (the beam route's top-M at width 32), an M one past a warp, and M=V."""
    x = _logits((12, 4, 1024), m, dev, ties=True)
    gv, gi = kernels.top_m(x, m)
    ev, ei = kernels.top_m_reference(x, m)
    assert _bits_equal(gv, ev) and torch.equal(gi, ei)


def test_wrappers_count_launches_and_check_inputs(dev):
    x = _logits((6, 4, 129), 1, dev)
    kernels.reset_launches()
    kernels.decode_prologue(x, 8)
    kernels.top_m(x, 8)
    assert kernels.LAUNCHES == {
        "decode_prologue": 1, "top_m": 1, "spec_augment_apply": 0, "edit_distance": 0,
        "ctc_beam_search": 0,
    }
    with pytest.raises(ValueError):
        kernels.decode_prologue(x.transpose(0, 1), 8)  # not contiguous
    with pytest.raises(ValueError):
        kernels.decode_prologue(x, 8, torch.zeros(128))  # bias on the CPU
    assert kernels.LAUNCHES == {
        "decode_prologue": 1, "top_m": 1, "spec_augment_apply": 0, "edit_distance": 0,
        "ctc_beam_search": 0,
    }


def test_hoisted_top_k_takes_the_kernel_or_raises(dev):
    x = _logits((6, 4, 129), 3, dev)
    kernels.reset_launches()
    hv, hi = hoisted_top_k(x, 8)
    assert kernels.LAUNCHES["top_m"] == 1
    ev, ei = kernels.top_m_reference(x, 8)
    assert _bits_equal(hv, ev) and torch.equal(hi, ei)
    with pytest.raises(TypeError):
        hoisted_top_k(x.half(), 8)  # no float16 kernel, and no plain route
    with pytest.raises(ValueError):
        hoisted_top_k(x, 0)
    assert kernels.LAUNCHES["top_m"] == 1


def test_search_on_card_matches_cpu(dev):
    x = _logits((40, 6, 65), 2, torch.device("cpu"))
    lens = torch.tensor([40, 33, 20, 7, 1, 0])
    cy, cl, cp = CTCPrefixSearch(8)(x, lens)
    kernels.reset_launches()
    gy, gl, gp = (t.cpu() for t in CTCPrefixSearch(8)(x.to(dev), lens.to(dev)))
    assert kernels.LAUNCHES["decode_prologue"] == 1
    assert torch.equal(cl, gl)
    for n in range(6):
        for w in range(8):
            L = int(cl[n, w])
            assert torch.equal(cy[:L, n, w], gy[:L, n, w])
    torch.testing.assert_close(gp, cp, rtol=1e-5, atol=0)


def _same_bits(a, b):
    """Equal bit patterns, or NaN in both."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return bool(((a.view(view) == b.view(view)) | (torch.isnan(a) & torch.isnan(b))).all())


def _fmask(kind, N, F, gen):
    """Frequency masks that start and end inside a 16-byte vector ("span":
    columns 2-6), cover whole vectors of 4 and of 8 ("whole": columns 8-23),
    or are no span at all ("scattered": random columns with 16-23 whole)."""
    cols = torch.arange(F)
    if kind == "span":
        return ((cols >= 2) & (cols < 7)).expand(N, F).clone()
    if kind == "whole":
        return ((cols >= 8) & (cols < 24)).expand(N, F).clone()
    m = torch.rand((N, F), generator=gen) < 0.3
    m[:, 16:24] = True
    return m


def _sa_inputs(dev, dtype, N=6, T=200, F=80, seed=0, fmask="span"):
    """Ragged lengths, a time warp clamped at the borders (t0 == t1 there),
    masks that cross each length (the drawn frequency mask or'd with
    ``_fmask(fmask)``), and inf/NaN in every masked column."""
    gen = torch.Generator().manual_seed(seed)
    feats = torch.randn((N, T, F), generator=gen)
    lens = torch.randint((T + 1) // 2, T + 1, (N,), generator=gen)
    lens[0] = T
    params = list(pimg.spec_augment_draw_parameters(
        gen, feats, 20.0, 0.0, 30, 10, 0.5, 4, 0.2, 2, lengths=lens
    ))
    grid = pimg.warp_1d_grid(params[0], params[1], lens, T)
    t0, t1, w0, w1 = pimg._axis_lerp_weights(grid, T)
    tmask = pimg._span_mask(params[4], params[5], T)
    fmask = pimg._span_mask(params[6], params[7], F) | _fmask(fmask, N, F, gen)
    special = torch.tensor([float("inf"), float("nan"), -float("inf")])
    poison = special[torch.arange(F) % 3].expand(N, T, F)
    feats = torch.where(fmask[:, None, :], poison, feats)
    args = [a.to(dev) for a in (feats.to(dtype), t0, t1, w0, w1, tmask, fmask)]
    return args, params, lens


def _sa_check(got, exp, tm, fm):
    """Bit-exact (NaN equal to NaN) and every masked output +0.0."""
    torch.cuda.synchronize()
    assert _same_bits(got, exp)
    masked = tm[:, :, None] | fm[:, None, :]
    zeros = got[masked.expand_as(got)].float()
    assert bool((zeros == 0).all()) and not bool(torch.signbit(zeros).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("warp", [True, False])
@pytest.mark.parametrize("F", [80, 13, 8, 7])
@pytest.mark.parametrize("fmask", ["span", "whole", "scattered"])
def test_spec_augment_kernel_matches_plain_version(dev, dtype, warp, F, fmask):
    """Bit-exact, masked outputs +0.0, with vector rows (F=80 and F=8: 4
    floats or 8 bfloat16 a vector) and scalar rows (F=13, F=7), masks cut
    inside a vector, over whole vectors and scattered."""
    (x, t0, t1, w0, w1, tm, fm), _, _ = _sa_inputs(dev, dtype, F=F, fmask=fmask)
    if not warp:
        t0 = t1 = w0 = w1 = None
    got = kernels.spec_augment_apply(x, t0, t1, w0, w1, tm, fm)
    exp = kernels.spec_augment_apply_reference(x, t0, t1, w0, w1, tm, fm)
    _sa_check(got, exp, tm, fm)
    assert t0 is None or bool((t0 == t1).any())  # a border case was exercised


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,T,F", [(1, 1, 80), (1, 1, 8), (3, 1, 16), (1, 300, 80), (40, 7, 80)])
def test_spec_augment_kernel_small_and_odd_shapes(dev, dtype, N, T, F):
    """One frame, one utterance, and many utterances of a few frames."""
    (x, t0, t1, w0, w1, tm, fm), _, _ = _sa_inputs(
        dev, dtype, N=N, T=T, F=F, seed=N + T, fmask="scattered"
    )
    for warp in (True, False):
        args = (t0, t1, w0, w1) if warp else (None,) * 4
        got = kernels.spec_augment_apply(x, *args, tm, fm)
        exp = kernels.spec_augment_apply_reference(x, *args, tm, fm)
        _sa_check(got, exp, tm, fm)
        for masks in ((None, fm), (tm, None), (None, None)):
            got = kernels.spec_augment_apply(x, *args, *masks)
            exp = kernels.spec_augment_apply_reference(x, *args, *masks)
            torch.cuda.synchronize()
            assert _same_bits(got, exp)


def test_spec_augment_kernel_other_dtypes_and_views(dev):
    """float16 goes through float32 I/O and comes back float32 with a
    warp (the JAX package's XLA route), float16 without; a contiguous
    tensor that starts 4 bytes past an alignment takes the direct-load
    path; all match the plain version."""
    (x, t0, t1, w0, w1, tm, fm), _, _ = _sa_inputs(dev, torch.float32, F=80)
    shifted = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    for feats in (x.half(), shifted):
        got = kernels.spec_augment_apply(feats, t0, t1, w0, w1, tm, fm)
        exp = kernels.spec_augment_apply_reference(feats, t0, t1, w0, w1, tm, fm)
        assert got.dtype == torch.float32 and _same_bits(got, exp)
    got = kernels.spec_augment_apply(x.half(), None, None, None, None, tm, fm)
    exp = kernels.spec_augment_apply_reference(x.half(), None, None, None, None, tm, fm)
    assert got.dtype == torch.float16 and _same_bits(got, exp)
    # a frequency mask that starts one byte past its allocation's alignment
    fm_shifted = torch.zeros(fm.numel() + 1, dtype=torch.bool, device=dev)[1:].view(fm.shape)
    fm_shifted.copy_(fm)
    assert fm_shifted.is_contiguous() and fm_shifted.data_ptr() % 4
    got = kernels.spec_augment_apply(x, t0, t1, w0, w1, tm, fm_shifted)
    exp = kernels.spec_augment_apply_reference(x, t0, t1, w0, w1, tm, fm)
    _sa_check(got, exp, tm, fm)


SA_DRAW = (80.0, 0.0, 100, 27, 0.04, 20, 0.04, 2)  # the training cell's draw


def _sa_draw(dev, N, T, F, seed):
    """The training cell's SpecAugment draw on ragged lengths, inf and NaN
    in the masked columns."""
    gen = torch.Generator().manual_seed(seed)
    feats = torch.randn((N, T, F), generator=gen)
    lens = torch.randint(max(T // 2, 1), T + 1, (N,), generator=gen)
    lens[0] = T
    p = list(pimg.spec_augment_draw_parameters(gen, feats, *SA_DRAW, lengths=lens))
    t0, t1, w0, w1 = pimg._axis_lerp_weights(pimg.warp_1d_grid(p[0], p[1], lens, T), T)
    tm, fm = pimg._span_mask(p[4], p[5], T), pimg._span_mask(p[6], p[7], F)
    special = torch.tensor([float("inf"), float("nan"), -float("inf")])
    feats = torch.where(fm[:, None, :], special[torch.arange(F) % 3], feats)
    return [a.to(dev) for a in (feats, t0, t1, w0, w1, tm, fm)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "N,T,F",
    [(32, 1000, 80), (1, 1000, 80), (5, 113, 80), (40, 7, 80), (3, 300, 83), (2, 90, 640)],
)
def test_spec_augment_kernel_at_the_training_draw(dev, dtype, N, T, F):
    """Bit-exact at the training cell's draw, inf and NaN in the masked
    columns: the training shape, one utterance, T not a multiple of 16,
    many short utterances, rows not whole 16-byte vectors (F=83) and wide
    rows (F=640)."""
    x, *args = _sa_draw(dev, N, T, F, seed=N + T + F)
    x = x.to(dtype)
    exp = kernels.spec_augment_apply_reference(x, *args)
    _sa_check(kernels.spec_augment_apply(x, *args), exp, args[4], args[5])


def test_spec_augment_kernel_on_masked_spans_and_extreme_warps(dev):
    """A long time-masked span, a map stretched near the start, a scrambled
    map and a shrinking one, in both dtypes; and parameters in views that
    start 4 bytes past an alignment."""
    N, T, F = 3, 400, 80
    x, *args = _sa_draw(dev, N, T, F, seed=9)
    t = torch.arange(T, dtype=torch.float32)
    src = torch.stack([
        torch.where(t < 8, t * 20, 160 + (t - 8) * (T - 161) / (T - 9)),
        torch.rand(T, generator=torch.Generator().manual_seed(0)) * (T - 1),
        t * 0.25,
    ])
    t0 = src.floor().int().clamp(0, T - 1)
    t1 = (t0 + 1).clamp(max=T - 1)
    w1 = src - src.floor()
    args[:4] = [a.to(dev) for a in (t0, t1, 1 - w1, w1)]
    args[4][:, 64:160] = True
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        exp = kernels.spec_augment_apply_reference(xd, *args)
        _sa_check(kernels.spec_augment_apply(xd, *args), exp, args[4], args[5])

    def shifted(a):
        b = torch.empty(a.numel() + 4, dtype=a.dtype, device=dev)[1:a.numel() + 1]
        return b.view(a.shape).copy_(a)

    moved = [shifted(a) for a in args[:5]] + [args[5]]
    assert all(a.data_ptr() % 16 for a in moved[:5])
    exp = kernels.spec_augment_apply_reference(x, *args)
    _sa_check(kernels.spec_augment_apply(x, *moved), exp, args[4], args[5])


def _ed_inputs(dev, R, H, N, seed, V=6):
    gen = torch.Generator().manual_seed(seed)
    ref = torch.randint(0, V, (R, N), generator=gen, dtype=torch.int32)
    hyp = torch.randint(0, V, (H, N), generator=gen, dtype=torch.int32)
    ref_lens = torch.randint(0, R + 1, (N,), generator=gen, dtype=torch.int32)
    hyp_lens = torch.randint(0, H + 1, (N,), generator=gen, dtype=torch.int32)
    ref_lens[0], hyp_lens[1] = 0, 0  # an empty reference and hypothesis
    return [a.to(dev) for a in (ref, hyp, ref_lens, hyp_lens)]


@pytest.mark.parametrize(
    "costs",
    [(1.0, 1.0, 1.0), (3.0, 3.0, 4.0), (0.5, 1.25, 2.0),
     (1.0, 1.0, float("inf")), (float("nan"), 1.0, 1.0)],
)
@pytest.mark.parametrize(
    "shape",
    [(40, 500, 32), (100, 250, 32), (1, 1, 3), (31, 33, 5), (64, 7, 70), (0, 9, 7),
     (31, 500, 32), (32, 250, 9), (63, 100, 16), (64, 500, 8), (300, 120, 5),
     (1000, 500, 8), (1024, 60, 4)],
)
@pytest.mark.parametrize("exclude_last", [False, True])
def test_edit_distance_kernel_matches_plain_version(dev, costs, shape, exclude_last):
    """Bit-exact (or NaN in both), at the scoring shapes and at every strip
    width's edges: 1, 2, 4, 16 and 32 columns a lane in registers, 33 in
    shared memory. sub=inf and a NaN cost take the kernels' NaN-aware
    instantiations; with sub=inf a match adds 0, so every distance stays
    finite."""
    args = _ed_inputs(dev, *shape, seed=sum(shape))
    got = kernels.edit_distance(*args, *costs, exclude_last=exclude_last)
    exp = kernels.edit_distance_reference(*args, *costs, exclude_last=exclude_last)
    torch.cuda.synchronize()
    assert _same_bits(got, exp)
    if np.isnan(costs).any() and shape[0] > 1:
        assert bool(torch.isnan(got).any())  # the NaN path ran
    if np.isposinf(costs[2]):
        assert bool(torch.isfinite(got).all())  # a match adds 0, not inf * 0


def test_edit_distance_strip_widths(dev):
    """The kernel library's columns a lane, at every strip bucket's edges:
    test_torch_string.py's table, against which the CPU model of the
    kernel's order is held."""
    lib = load_library()
    widths = [
        (0, 1), (31, 1), (32, 2), (63, 2), (64, 4), (127, 4), (128, 8), (255, 8),
        (256, 16), (511, 16), (512, 32), (1023, 32), (1024, 33), (2000, 63),
    ]
    assert [(R, lib.pydt_edit_distance_strip(R)) for R, _ in widths] == widths


def test_edit_distance_kernel_at_the_largest_reference(dev):
    """The largest R whose strips fit one block's shared memory runs
    bit-exact; one more raises before any launch."""
    lib = load_library()
    words = lib.pydt_max_warp_words()
    R = 1023
    while lib.pydt_edit_distance_warp_words(R + 32) <= words:
        R += 32
    assert lib.pydt_edit_distance_warp_words(R) <= words
    assert lib.pydt_edit_distance_warp_words(R + 1) > words
    assert R >= 19370  # every reference the row-in-shared-memory layout took
    args = _ed_inputs(dev, R, 40, 3, seed=5)
    args[2][2] = R
    got = kernels.edit_distance(*args, 0.5, 1.25, 2.0)
    exp = kernels.edit_distance_reference(*args, 0.5, 1.25, 2.0)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), exp.view(torch.int32))
    big = _ed_inputs(dev, R + 1, 4, 2, seed=6)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        kernels.edit_distance(*big, 1.0, 1.0, 1.0)
    assert kernels.LAUNCHES["edit_distance"] == 0


def test_new_wrappers_count_launches_and_check_inputs(dev, monkeypatch):
    """A CUDA tensor launches the kernel and never reaches a plain version;
    bad inputs raise before any launch."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    (x, t0, t1, w0, w1, tm, fm), _, _ = _sa_inputs(dev, torch.float32)
    ed = _ed_inputs(dev, 9, 11, 4, seed=0)
    monkeypatch.setattr(kernels, "spec_augment_apply_reference", refuse)
    monkeypatch.setattr(kernels, "edit_distance_reference", refuse)
    kernels.reset_launches()
    kernels.spec_augment_apply(x, t0, t1, w0, w1, tm, fm)
    kernels.edit_distance(*ed, 1.0, 1.0, 1.0)
    assert kernels.LAUNCHES == {
        "decode_prologue": 0, "top_m": 0, "spec_augment_apply": 1, "edit_distance": 1,
        "ctc_beam_search": 0,
    }
    with pytest.raises(ValueError):
        kernels.spec_augment_apply(x, t0, t1, w0, w1, tm.cpu(), fm)
    with pytest.raises(TypeError):
        kernels.spec_augment_apply(x, t0, t1, w0, w1, tm.float(), fm)
    with pytest.raises(ValueError):
        kernels.spec_augment_apply(x, t0, None, w0, w1, tm, fm)
    with pytest.raises(TypeError):
        kernels.edit_distance(ed[0].float(), *ed[1:], 1.0, 1.0, 1.0)
    with pytest.raises(ValueError):
        kernels.edit_distance(ed[0], ed[1].cpu(), *ed[2:], 1.0, 1.0, 1.0)
    assert kernels.LAUNCHES["spec_augment_apply"] == 1
    assert kernels.LAUNCHES["edit_distance"] == 1


def test_public_paths_take_the_kernels(dev):
    """spec_augment and error_rate on the card launch one kernel each and
    agree with the same calls on the CPU. The warp grid's solves round
    differently on the two devices: the grids agree within 1e-5, and the
    warped features within what that moves a lerp by: the grid error, and
    an ulp on each side from the frame index (g + 1) * T / 2, times T/2
    frames times the largest step between neighbouring frames."""
    (x, *_), params, lens = _sa_inputs(torch.device("cpu"), torch.float32, seed=3)
    x = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    T = x.shape[1]
    grid = pimg.warp_1d_grid(params[0], params[1], lens, T)
    grid_err = float(
        (pimg.warp_1d_grid(params[0].to(dev), params[1].to(dev), lens.to(dev), T).cpu()
         - grid).abs().max()
    )
    assert grid_err <= 1e-5
    kernels.reset_launches()
    got = pimg.spec_augment_apply_parameters(
        x.to(dev), [None if p is None else p.to(dev) for p in params],
        lengths=lens.to(dev),
    )
    exp = pimg.spec_augment_apply_parameters(x, params, lengths=lens)
    step = float((x[:, 1:] - x[:, :-1]).abs().max())
    torch.testing.assert_close(
        got.cpu(), exp, atol=(grid_err + 2.4e-7) * T / 2 * step + 1e-6, rtol=0
    )
    ref, hyp, _, _ = _ed_inputs(torch.device("cpu"), 40, 60, 32, seed=1)
    hyp[50:, :7] = -1
    er = pstr.error_rate(ref.to(dev), hyp.to(dev), eos=-1, norm=False, warn=False)
    assert torch.equal(er.cpu(), pstr.error_rate(ref, hyp, eos=-1, norm=False, warn=False))
    assert kernels.LAUNCHES["spec_augment_apply"] == 1
    assert kernels.LAUNCHES["edit_distance"] == 1


def test_train_step_on_card_matches_cpu(dev):
    """One float32 step (SpecAugment on fixed parameters, dropout 0) on the
    card and on the CPU from the same weights: loss within rtol 1e-4, each
    gradient within 1e-3 of its tensor's largest (an attention key bias,
    whose true gradient is 0, within 1e-3 of the model's largest gradient),
    each device's update AdamW's first step from its own gradient (within
    1e-6). Parameters within atol 1e-4 where both devices' gradients are at
    least 10 times the gradient tolerance and 1e-6: Adam's first step is
    lr * g / (|g| + eps), about lr times the sign of g whatever its size,
    so where a gradient is rounding noise (the attention key biases, which
    softmax is blind to) the two devices' steps may part by up to 2 lr."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = pconf.ConformerConfig(
        vocab_size=11, num_filts=10, d_model=32, num_layers=2, num_heads=2,
        subsample_channels=4, conv_kernel=7, dropout=0.0, dtype=torch.float32,
    )
    gen = torch.Generator().manual_seed(0)
    feats = torch.randn((4, 60, 10), generator=gen)
    lens = torch.tensor([60, 52, 41, 30])
    refs = torch.randint(0, 11, (4, 6), generator=gen)
    ref_lens = torch.tensor([6, 5, 3, 2])
    params = pimg.spec_augment_draw_parameters(
        gen, feats, 5.0, 0.0, 5, 3, 0.2, 2, 0.1, 1, lengths=lens
    )
    out = {}
    for d in (torch.device("cpu"), dev):
        model = pconf.ConformerCTC(cfg, device=d, generator=torch.Generator().manual_seed(1))
        before = {k: v.detach().cpu().clone() for k, v in model.named_parameters()}
        p_d = [None if p is None else p.to(d) for p in params]
        step = pconf.make_train_step(
            model, pconf.adamw(model.parameters(), 1e-3),
            lambda g, f, l: pimg.spec_augment_apply_parameters(f, p_d, lengths=l.float()),
        )
        kernels.reset_launches()
        loss = step(None, *(a.to(d) for a in (feats, lens, refs, ref_lens)))
        assert kernels.LAUNCHES["spec_augment_apply"] == int(d.type == "cuda")
        out[d.type] = (
            float(loss),
            {k: v.detach().cpu() for k, v in model.named_parameters()},
            {k: v.grad.cpu() for k, v in model.named_parameters()},
        )
    (lc, pc, gc), (lg, pg, gg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)

    def first_step(p0, g):  # AdamW's first step with optax's defaults
        p0, g = p0.double(), g.double()
        return p0 * (1 - 1e-3 * 1e-4) - 1e-3 * g / (g.abs() + 1e-8)

    g_max = max(float(g.abs().max()) for g in gc.values())
    held_entries = 0
    for k in pc:
        if k.endswith("attn.key.bias"):
            assert max(float(gc[k].abs().max()), float(gg[k].abs().max())) <= 1e-3 * g_max
        else:
            tol = 1e-3 * float(gc[k].abs().max())
            torch.testing.assert_close(gg[k], gc[k], atol=tol, rtol=0, msg=k)
            held = torch.minimum(gc[k].abs(), gg[k].abs()) >= max(10 * tol, 1e-6)
            held_entries += int(held.sum())
            torch.testing.assert_close(pg[k][held], pc[k][held], atol=1e-4, rtol=0, msg=k)
        own_c, own_g = first_step(before[k], gc[k]), first_step(before[k], gg[k])
        torch.testing.assert_close(pc[k].double(), own_c, atol=1e-6, rtol=0, msg=k)
        torch.testing.assert_close(pg[k].double(), own_g, atol=1e-6, rtol=0, msg=k)
    assert held_entries > 0


def _beam_inputs(T, N, V, seed, scale, dev, ties=False):
    """Softmax probabilities of seeded logits (x2 diffuse: masses go
    subnormal within some 55 frames; x32 decisive; with ``ties`` rounded to
    quarter steps, so that many probabilities and masses tie) and ragged
    lengths with 0 and 1."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(T, N, V + 1).astype(np.float32) * scale
    if ties:
        logits = np.round(logits * 4) / 4
    probs = torch.softmax(torch.from_numpy(logits), 2)
    lens = torch.from_numpy(rng.randint(0, T + 1, N))
    lens[0], lens[1] = T, 0
    if N > 2:
        lens[2] = 1
    return probs[..., :V].contiguous().to(dev), probs[..., V].contiguous().to(dev), lens.to(dev)


@pytest.mark.parametrize("scale", [2.0, 32.0])
@pytest.mark.parametrize(
    "shape",
    [(64, 8, 128, 8), (32, 4, 64, 4), (12, 3, 9, 4), (500, 32, 1024, 16),
     (40, 5, 100, 2), (60, 4, 200, 32), (2, 3, 50, 16), (1771, 2, 64, 16),
     (831, 2, 80, 32)],
)
def test_beam_kernel_matches_plain_version(dev, shape, scale):
    """Lengths and the whole path buffer exact, probabilities bit for bit:
    both round every product and sum alone and keep subnormals."""
    T, N, V, W = shape
    nonext, blank, lens = _beam_inputs(T, N, V, sum(shape), scale, dev)
    top = kernels.top_m(nonext, min(V, 2 * W))
    got = kernels.ctc_beam_search(nonext, blank, lens, W, top)
    exp = kernels.ctc_beam_search_reference(nonext, blank, lens, W, top)
    torch.cuda.synchronize()
    assert torch.equal(got[1], exp[1])
    assert torch.equal(got[0], exp[0])
    assert _bits_equal(got[2], exp[2])


@pytest.mark.parametrize(
    "shape", [(500, 32, 1024, 16), (500, 32, 1024, 8), (64, 8, 128, 8), (40, 5, 30, 3)]
)
def test_beam_kernel_matches_plain_version_on_ties(dev, shape):
    """Logits on quarter steps (x3) make many candidates tie within and
    across beams: ranks must follow the lowest flat index, bit for bit."""
    T, N, V, W = shape
    nonext, blank, lens = _beam_inputs(T, N, V, sum(shape), 3.0, dev, ties=True)
    top = kernels.top_m(nonext, min(V, 2 * W))
    got = kernels.ctc_beam_search(nonext, blank, lens, W, top)
    exp = kernels.ctc_beam_search_reference(nonext, blank, lens, W, top)
    torch.cuda.synchronize()
    assert torch.equal(got[1], exp[1])
    assert torch.equal(got[0], exp[0])
    assert _bits_equal(got[2], exp[2])


def test_beam_smem_layout_matches_fit_predicate(dev):
    lib = load_library()
    for T, W, M in ((500, 16, 32), (832, 32, 64), (2, 2, 4), (12, 4, 8), (1772, 16, 32), (9, 3, 6)):
        assert lib.pydt_ctc_beam_smem_bytes(T, W, M) == kernels._beam_smem_bytes(T, W, M)


def test_beam_wrapper_launches_or_raises(dev, monkeypatch):
    """A CUDA tensor launches the kernel and never reaches the plain
    version; shapes the kernel cannot take raise before any launch."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    nonext, blank, lens = _beam_inputs(20, 4, 40, 0, 2.0, dev)
    monkeypatch.setattr(kernels, "ctc_beam_search_reference", refuse)
    kernels.reset_launches()
    kernels.ctc_beam_search(nonext, blank, lens, 8)
    assert kernels.LAUNCHES["ctc_beam_search"] == 1 and kernels.LAUNCHES["top_m"] == 1
    big = torch.zeros((900, 2, 64), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.ctc_beam_search(big, big[..., 0], torch.tensor([900, 9], device=dev), 32)
    with pytest.raises(ValueError):
        kernels.ctc_beam_search(nonext, blank, lens.cpu(), 8)
    assert kernels.LAUNCHES["ctc_beam_search"] == 1


def _search_equal(got, exp, rtol):
    """tests/test_pallas.py's _beam_outputs_equal rule."""
    (gy, gl, gp), (ey, el, ep) = ([t.cpu() for t in o] for o in (got, exp))
    assert torch.equal(gl, el)
    assert torch.equal(torch.isfinite(gp), torch.isfinite(ep))
    fin = torch.isfinite(ep)
    torch.testing.assert_close(gp[fin], ep[fin], rtol=rtol, atol=1e-12)
    for n in range(el.shape[0]):
        for w in range(el.shape[1]):
            L = int(el[n, w])
            assert torch.equal(gy[:L, n, w], ey[:L, n, w])


def test_beam_route_on_card(dev, monkeypatch):
    """The forced route launches top_m and the beam kernel once each and
    agrees with the card's own scan on raw masses (rtol 1e-4: the softmax
    and the gathers round differently in the last ulps over T frames)."""
    x = _logits((60, 6, 129), 5, dev)
    lens = torch.tensor([60, 41, 30, 7, 1, 0], device=dev)
    monkeypatch.setattr(pconfig, "USE_BEAM_KERNEL", "1")
    kernels.reset_launches()
    got = CTCPrefixSearch(8)(x, lens)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {
        "decode_prologue": 0, "top_m": 1, "spec_augment_apply": 0, "edit_distance": 0,
        "ctc_beam_search": 1,
    }
    monkeypatch.setattr(pconfig, "USE_BEAM_KERNEL", "0")
    monkeypatch.setattr(pconfig, "DECODE_RENORM", False)
    _search_equal(got, CTCPrefixSearch(8)(x, lens), rtol=1e-4)


def test_streaming_session_on_card_matches_one_shot(dev, monkeypatch):
    """A causal float32 model streams on the card through the beam route;
    every search launches the kernel, and finish equals the one-shot search
    of the full forward (lengths and tokens exact, probabilities within
    atol 1e-5, as tests/test_serving.py holds the JAX package's)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    monkeypatch.setattr(pconfig, "USE_BEAM_KERNEL", "1")
    cfg = pconf.ConformerConfig(
        vocab_size=12, num_filts=8, d_model=16, num_layers=2, num_heads=2,
        subsample_channels=4, conv_kernel=5, dropout=0.0, dtype=torch.float32,
        attention_context=(4, 0), causal_conv=True,
    )
    model = pconf.ConformerCTC(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    feats = torch.randn((3, 45, 8), generator=gen)
    lens = np.asarray([45, 35, 23])
    with torch.no_grad():
        logits, out_lens = model(feats.to(dev), torch.from_numpy(lens).to(dev))
    exp = CTCPrefixSearch(4)(logits.transpose(0, 1).contiguous(), out_lens)
    rec = pserving.StreamingCTCRecognizer(model, chunk=4, width=4, decode_pad_multiple=16)
    sess = rec.start(3)
    kernels.reset_launches()
    for t, size in ((0, 3), (3, 30), (33, 12)):
        rec.push(sess, feats[:, t : t + size], np.clip(lens - t, 0, size), partials=True)
    got = rec.finish(sess)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ctc_beam_search"] == 4 and kernels.LAUNCHES["top_m"] == 4
    assert got[0].device.type == "cuda" and got[0].shape[0] == 16
    gy, gl, gp = (t.cpu() for t in got)
    ey, el, ep = (t.cpu() for t in exp)
    assert torch.equal(gl, el)
    torch.testing.assert_close(gp, ep, atol=1e-5, rtol=0)
    for n in range(3):
        for w in range(4):
            L = int(el[n, w])
            assert torch.equal(gy[:L, n, w], ey[:L, n, w])


# ---------------------------------------------------------------------------
# LM fusion: the prologue's g_bias route, an LM-fused decode, probing tables


def _bench_lm(device):
    """chip_smoke.py's copy of bench.py's 3-gram LM (V=1024, 23
    corrections: the sparse route's M is 2 * 16 + 23 = 55)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.bench_lm(plm.LookupLanguageModel, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prologue_with_the_lm_bias_at_m55_matches_plain_version(dev, dtype):
    """The bench LM's bias ``0.5 * uni`` at M = 55, on spread and on
    quarter-step logits: bit-exact values, indices and tie order."""
    lm = _bench_lm(dev)
    M = 2 * 16 + lm.max_corrections
    assert M == 55
    bias = pdec._lm_bias(lm._uni_t, 0.5)
    assert bias.device.type == "cuda" and bias.dtype == torch.float32
    for ties in (False, True):
        x = _logits((100, 8, 1025), 55, dev, dtype, ties=ties)
        kernels.reset_launches()
        tv, ti, mx, den, blank = kernels.decode_prologue(x, M, bias)
        assert kernels.LAUNCHES["decode_prologue"] == 1
        ev, ei, emx, eden, eblank = kernels.decode_prologue_reference(x, M, bias)
        assert _bits_equal(tv, ev) and torch.equal(ti, ei)
        assert torch.equal(mx, emx) and torch.equal(blank, eblank)
        torch.testing.assert_close(den, eden, rtol=2e-6, atol=0)


def _lm_pair(dev, V, N, seed, probing=False, monkeypatch=None):
    if probing:
        monkeypatch.setattr(plm, "_DENSE_CTX_MAX_ROWS", 0)
    cpu = plm.LookupLanguageModel(V, sos=V, prob_dicts=random_prob_dicts(V, N, seed, V), device="cpu")
    card = plm.LookupLanguageModel(V, sos=V, device=dev)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


@pytest.mark.parametrize("route", ["sparse", "uni", "dense"])
def test_lm_search_on_card_matches_cpu(dev, route, monkeypatch):
    """A 4-gram (or unigram) LM over V=40 at W=8, T=30: hypotheses and
    lengths equal to the CPU decode's, probabilities within rtol 1e-5; the
    sparse and unigram routes launch the prologue once, the dense one
    (forced by a zero correction bound) not at all."""
    cpu, card = _lm_pair(dev, 40, 1 if route == "uni" else 4, 6)
    if route == "dense":
        monkeypatch.setattr(pconfig, "SPARSE_FUSION_MAX_CORRECTIONS", 0)
    x = _logits((30, 6, 41), 8, torch.device("cpu"))
    lens = torch.tensor([30, 25, 17, 7, 1, 0])
    cy, cl, cp = CTCPrefixSearch(8, 0.5, cpu)(x, lens)
    search = CTCPrefixSearch(8, 0.5, card)
    assert search.lm_route() == route
    kernels.reset_launches()
    gy, gl, gp = (t.cpu() for t in search(x.to(dev), lens.to(dev)))
    assert kernels.LAUNCHES["decode_prologue"] == (0 if route == "dense" else 1)
    assert torch.equal(cl, gl)
    mask = torch.arange(30)[:, None, None] < cl[None]
    assert torch.equal(torch.where(mask, gy, -1), torch.where(mask, cy, -1))
    torch.testing.assert_close(gp, cp, rtol=1e-5, atol=0)
    with pytest.raises(RuntimeError, match="tables are on"):
        CTCPrefixSearch(8, 0.5, cpu)(x.to(dev), lens.to(dev))


@pytest.mark.parametrize("probing", [False, True])
def test_lm_tables_on_card_match_cpu(dev, probing, monkeypatch):
    """A 5-gram over V=40 (order 4 probing only; with ``probing`` every
    order): the hash slots the card probes, its full log-probs, sequence
    scores and sparse corrections equal the CPU's bit for bit."""
    cpu, card = _lm_pair(dev, 40, 5, 4, probing, monkeypatch)
    assert card._ctx_tables[-1].dense_packed is None
    hist = torch.from_numpy(np.random.RandomState(0).randint(0, 40, (9, 50)))
    assert _same_bits(card(hist.to(dev)).cpu(), cpu(hist))
    assert _same_bits(card.score_sequences(hist.to(dev)).cpu(), cpu.score_sequences(hist))
    ctx = torch.from_numpy(np.random.RandomState(1).randint(-1, 42, (4, 7, 3)))
    for g, e in zip(card.sparse_corrections_ext(ctx.to(dev))[:6], cpu.sparse_corrections_ext(ctx)[:6]):
        if e.dtype == torch.float32:
            # the probing normalizer sums the lists in another order
            torch.testing.assert_close(g.cpu(), e, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(g.cpu(), e)


def test_edit_distance_at_the_mer_shape_matches_plain_version(dev):
    """The MER loss's error rates: references (12, 64) and sampled
    hypotheses (16, 64) padded with -1, which is their eos, through
    ``error_rate`` (one launch) and the kernel, each equal to its plain
    version on the same inputs."""
    rng = np.random.RandomState(13)
    ref = rng.randint(0, 63, (12, 64))
    hyp = rng.randint(0, 64, (16, 64))
    ref[rng.randint(4, 12, 64), np.arange(64)] = -1
    hyp[rng.randint(0, 17, 64) % 16, np.arange(64)] = -1
    ref, hyp = torch.from_numpy(ref), torch.from_numpy(hyp)
    kernels.reset_launches()
    got = pstr.error_rate(ref.to(dev), hyp.to(dev), eos=-1, warn=False)
    assert kernels.LAUNCHES["edit_distance"] == 1
    assert torch.equal(got.cpu(), pstr.error_rate(ref, hyp, eos=-1, warn=False))
    rl = torch.from_numpy(np.argmax(np.vstack([ref.numpy(), -np.ones((1, 64))]) == -1, 0))
    hl = torch.from_numpy(np.argmax(np.vstack([hyp.numpy(), -np.ones((1, 64))]) == -1, 0))
    args = (ref, hyp, rl, hl, 1.0, 1.0, 1.0)
    card = kernels.edit_distance(*(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args))
    assert torch.equal(card.cpu(), kernels.edit_distance_reference(*args))


def _s2s_pair(dev, scale=4.0):
    from pydrobert_tpu_torch.models import seq2seq as ps2s

    cfg = ps2s.Seq2SeqConfig(vocab_size=16, num_filts=8, enc_hidden=24, dec_hidden=24,
                             embed_dim=12, attn_hidden=20)
    card = ps2s.AttentionSeq2Seq(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        card.decoder_step.out.weight.mul_(scale)
    cpu = ps2s.AttentionSeq2Seq(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    return ps2s, cpu, card


def test_seq2seq_on_card_matches_cpu(dev):
    """The encoder at every frame, padding included, and the decoder's log
    probabilities over a history within 1e-5 of a CPU copy's (float32:
    cuDNN's GRU without TF32)."""
    ps2s, cpu, card = _s2s_pair(dev)
    rng = np.random.RandomState(1)
    feats = torch.from_numpy(rng.randn(5, 30, 8).astype(np.float32))
    lens = torch.tensor([30, 22, 15, 9, 1])
    hist = torch.from_numpy(rng.randint(0, 16, (7, 5)))
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        ce, cm = cpu.encode(feats, lens)
        ge, gm = card.encode(feats.to(dev), lens.to(dev))
        assert torch.equal(gm.cpu(), cm)
        torch.testing.assert_close(ge.cpu(), ce, rtol=0, atol=1e-5)
        clm, glm = ps2s.Seq2SeqDecoderLM(cpu), ps2s.Seq2SeqDecoderLM(card)
        cl = clm(hist, clm.initial_state(feats, lens))
        gl = glm(hist.to(dev), glm.initial_state(feats.to(dev), lens.to(dev)))
    torch.testing.assert_close(gl.cpu(), cl, rtol=0, atol=1e-5)


@pytest.mark.parametrize("eos,finish_all", [(0, False), (3, True), (None, False)])
def test_seq2seq_beam_search_on_card_matches_cpu(dev, eos, finish_all):
    """BeamSearch over the decoder at W=6 over 8 steps: lengths and the
    whole path buffer equal to the CPU's, log probabilities within rtol
    1e-5."""
    ps2s, cpu, card = _s2s_pair(dev)
    rng = np.random.RandomState(2)
    feats = torch.from_numpy(rng.randn(4, 25, 8).astype(np.float32))
    lens = torch.tensor([25, 20, 11, 3])
    out = []
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for model, d in ((cpu, "cpu"), (card, dev)):
            lm = ps2s.Seq2SeqDecoderLM(model)
            state = lm.initial_state(feats.to(d), lens.to(d))
            out.append([t.cpu() for t in pdec.BeamSearch(lm, 6, eos, finish_all)(state, 4, 8)])
    (cy, cl, cp), (gy, gl, gp) = out
    assert torch.equal(gl, cl) and torch.equal(gy, cy)
    torch.testing.assert_close(gp, cp, rtol=1e-5, atol=0)


def test_ngram_beam_search_on_card_matches_cpu(dev):
    """A lookup 3-gram over V=40 on the sparse route, and on the dense
    route with the sparse bound at 0: lengths and path buffer equal to a
    CPU copy's."""
    cpu, card = _lm_pair(dev, 40, 3, 6)
    for bound in (pconfig.SPARSE_FUSION_MAX_CORRECTIONS, 0):
        old, pconfig.SPARSE_FUSION_MAX_CORRECTIONS = pconfig.SPARSE_FUSION_MAX_CORRECTIONS, bound
        try:
            search = pdec.BeamSearch(card, 8, eos=5)
            assert search.takes_sparse_route() == (bound > 0)
            gy, gl, gp = (t.cpu() for t in search(batch_size=4, max_iters=12))
            cy, cl, cp = pdec.BeamSearch(cpu, 8, eos=5)(batch_size=4, max_iters=12)
        finally:
            pconfig.SPARSE_FUSION_MAX_CORRECTIONS = old
        assert torch.equal(gl, cl) and torch.equal(gy, cy)
        torch.testing.assert_close(gp, cp, rtol=1e-5, atol=0)


def _rnnt_pair(dev, causal=False):
    """The JAX tests' small transducer (V=16, d=16, 2 layers, float32,
    ``pred_dim = joint_dim = 12``), seeded on the card, and a CPU copy."""
    from pydrobert_tpu_torch.models import transducer as prnnt

    enc = pconf.ConformerConfig(
        vocab_size=16, num_filts=8, d_model=16, num_layers=2, num_heads=2,
        subsample_channels=4, conv_kernel=5, dropout=0.0, dtype=torch.float32,
        **(dict(attention_context=(4, 0), causal_conv=True) if causal else {}),
    )
    cfg = prnnt.TransducerConfig(encoder=enc, pred_dim=12, joint_dim=12)
    card = prnnt.ConformerTransducer(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    cpu = prnnt.ConformerTransducer(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    rng = np.random.RandomState(3)
    feats = torch.from_numpy(rng.randn(3, 45, 8).astype(np.float32))
    lens = torch.tensor([45, 35, 23])
    return prnnt, cpu, card, feats, lens


def _rnnt_equal(got, exp):
    """Lengths and tokens exact, beam scores within rtol 1e-5."""
    assert torch.equal(got[1].cpu(), exp[1]) and torch.equal(got[0].cpu(), exp[0])
    if len(got) == 3:
        torch.testing.assert_close(got[2].cpu(), exp[2], rtol=1e-5, atol=0)


@pytest.mark.parametrize("E", [1, 2, 4])
def test_transducer_greedy_on_card_matches_cpu(dev, E):
    """Greedy decoding on the card (float32, no TF32) equals the same code
    on the CPU with a copy of the weights."""
    _, cpu, card, feats, lens = _rnnt_pair(dev)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        _rnnt_equal(card.greedy(feats.to(dev), lens.to(dev), E), cpu.greedy(feats, lens, E))


@pytest.mark.parametrize("W,E", [(1, 4), (3, 2), (4, 4)])
def test_transducer_beam_on_card_matches_cpu(dev, W, E):
    """The beam search, bare and fused with a 3-gram lookup LM (on each
    device a copy), on the card equals the CPU's."""
    _, cpu, card, feats, lens = _rnnt_pair(dev)
    clm, glm = _lm_pair(dev, 16, 3, 5)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for lms in ((None, None), (glm, clm)):
            got = card.beam(feats.to(dev), lens.to(dev), W, E, lm=lms[0], lm_weight=0.4)
            _rnnt_equal(got, cpu.beam(feats, lens, W, E, lm=lms[1], lm_weight=0.4))


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_transducer_streaming_session_on_card_matches_cpu(dev, mode):
    """A session (pushes of 9, 1, 25 and 10 frames) on the card: every
    partial and the finish equal the same session on the CPU, and the
    finish equals the card's one-shot decode."""
    _, cpu, card, feats, lens = _rnnt_pair(dev, causal=True)
    kw = dict(chunk=5, mode=mode, width=3, max_symbols_per_frame=2, max_frames=32)
    recs = [pserving.StreamingTransducerRecognizer(m, **kw) for m in (card, cpu)]
    sessions = [r.start(3) for r in recs]
    t = 0
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for size in (9, 1, 25, 10):
            new_lens = np.clip(lens.numpy() - t, 0, size)
            outs = [r.push(s, feats[:, t : t + size], new_lens) for r, s in zip(recs, sessions)]
            _rnnt_equal(*outs)
            t += size
        got, exp = (r.finish(s) for r, s in zip(recs, sessions))
        _rnnt_equal(got, exp)
        if mode == "greedy":
            one_shot = card.greedy(feats.to(dev), lens.to(dev), 2)
        else:
            one_shot = card.beam(feats.to(dev), lens.to(dev), 3, 2)
    U = one_shot[0].shape[-1]
    assert torch.equal(got[1], one_shot[1]) and torch.equal(got[0][..., :U], one_shot[0])


# The rest of the ops layer on the card: the mistake-counting scan's tie
# order, the int-free OCD mask, deltas in true float32 and blank-frame
# compression, each against the CPU.


def test_cummin_last_argmin_tie_order_on_card(dev):
    """The scan keeps the later index on ties on the card as on the CPU,
    whatever order torch.cummin keeps; and an error rate at non-uniform
    costs, which rides on it, equals the CPU's."""
    v, i = pstr._cummin_last_argmin(torch.tensor([[3.0], [1.0], [1.0], [2.0], [1.0]], device=dev))
    assert v[:, 0].tolist() == [3.0, 1.0, 1.0, 1.0, 1.0] and i[:, 0].tolist() == [0, 1, 2, 2, 4]
    rng = np.random.RandomState(0)
    u = torch.from_numpy(rng.randint(0, 3, (67, 40)).astype(np.float32))
    gv, gi = pstr._cummin_last_argmin(u.to(dev))
    ev, ei = pstr._cummin_last_argmin(u)
    assert torch.equal(gv.cpu(), ev) and torch.equal(gi.cpu(), ei)
    ref = torch.from_numpy(rng.randint(0, 4, (30, 64)))
    hyp = torch.from_numpy(rng.randint(0, 4, (40, 64)))
    for costs in ((1.0, 1.0, 2.0), (0.5, 1.25, 2.0)):
        kw = dict(ins_cost=costs[0], del_cost=costs[1], sub_cost=costs[2], warn=False)
        got = pstr.error_rate(ref.to(dev), hyp.to(dev), **kw)
        assert torch.equal(got.cpu(), pstr.error_rate(ref, hyp, **kw))
        got = pstr.prefix_error_rates(ref.to(dev), hyp.to(dev), **kw)
        assert torch.equal(got.cpu(), pstr.prefix_error_rates(ref, hyp, **kw))


def test_ocd_mask_on_card_is_int_free(dev):
    """The OCD targets and loss on the card equal the CPU's; the JAX
    package's int32 einsum would not run there."""
    rng = np.random.RandomState(1)
    mask = torch.from_numpy(rng.rand(9, 12, 32) > 0.7)
    ref = torch.from_numpy(rng.randint(0, 4, (32, 12)))
    got = pstr._mask_to_unique_targets(mask.to(dev), ref.to(dev), -1)
    assert torch.equal(got.cpu(), pstr._mask_to_unique_targets(mask, ref, -1))
    ref_t = torch.from_numpy(rng.randint(0, 9, (12, 32)))
    hyp = torch.from_numpy(rng.randint(0, 9, (15, 32)))
    logits = torch.from_numpy(rng.randn(15, 32, 10).astype(np.float32))
    outs = []
    for d in (dev, "cpu"):
        lg = logits.to(d).requires_grad_(True)
        loss = pstr.hard_optimal_completion_distillation_loss(
            lg, ref_t.to(d), hyp.to(d), eos=9, warn=False)
        loss.backward()
        outs.append((loss.detach().cpu(), lg.grad.cpu()))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-6, atol=1e-6)


def test_feat_deltas_on_card_are_true_float32(dev, monkeypatch):
    """Deltas on the card lie within rtol and atol 1e-6 of a float64
    evaluation of the same filter taps, with PyTorch's TF32 flags on; the
    same features rounded to TF32 first miss that bound, so the test would
    see a TF32 convolution."""
    from pydrobert_tpu_torch.ops import feats as pfeats

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    x = torch.from_numpy(np.random.RandomState(2).randn(4, 300, 40).astype(np.float32))
    filt = torch.from_numpy(pfeats.feat_delta_filters(2, 2)).double()
    padded = x.double()[:, torch.arange(-4, 304).clamp(0, 299)]
    exact = torch.cat([sum(padded[:, j:j + 300] * filt[k, j] for j in range(9))
                       for k in range(3)], -1)

    def within(got):
        return bool(((got.cpu().double() - exact).abs() <= 1e-6 + 1e-6 * exact.abs()).all())

    assert within(pfeats.feat_deltas(x.to(dev)))
    b = x.to(dev).view(torch.int32)
    tf32 = ((b + 0x1000) & ~0x1FFF).view(torch.float32)
    assert not within(pfeats.feat_deltas(tf32))


@pytest.mark.parametrize("batch_first", [False, True])
def test_compress_blank_frames_on_card_matches_cpu(dev, batch_first):
    """Bit-equal frames and equal lengths, then a search of them equal to
    the CPU's."""
    rng = np.random.RandomState(3)
    T, N, V = 200, 16, 64
    x = rng.randn(T, N, V + 1).astype(np.float32)
    x[..., V] += 6.0
    for n in range(N):
        idx = rng.choice(T, size=T // 6, replace=False)
        x[idx, n, rng.randint(V, size=T // 6)] += 14.0
    lens = torch.from_numpy(rng.randint(T // 2, T + 1, N))
    x = torch.from_numpy(np.swapaxes(x, 0, 1).copy() if batch_first else x)
    kw = dict(threshold=0.9, max_frames=80, batch_first=batch_first)
    got, got_lens = pdec.compress_blank_frames(x.to(dev), lens.to(dev), **kw)
    exp, exp_lens = pdec.compress_blank_frames(x, lens, **kw)
    assert _bits_equal(got.cpu(), exp) and torch.equal(got_lens.cpu(), exp_lens)
    uncut = pdec.compress_blank_frames(x, lens, threshold=0.9, batch_first=batch_first)[1]
    assert int(uncut.sum()) < int(lens.sum())  # the data hold runs of dominant blanks
    if batch_first:
        got, exp = got.transpose(0, 1), exp.transpose(0, 1)
    kernels.reset_launches()
    gy, gl, gp = (t.cpu() for t in CTCPrefixSearch(8)(got, got_lens))
    assert kernels.LAUNCHES["decode_prologue"] == 1
    cy, cl, cp = CTCPrefixSearch(8)(exp, exp_lens)
    assert torch.equal(gl, cl)
    for n in range(N):
        for w in range(8):
            L = int(cl[n, w])
            assert torch.equal(gy[:L, n, w], cy[:L, n, w])
    torch.testing.assert_close(gp, cp, rtol=1e-5, atol=0)


# ---- forced alignment and the estimators on the card (eager paths) ----


@pytest.mark.parametrize("batch_first", [False, True])
@pytest.mark.parametrize("is_probs", [False, True])
def test_ctc_forced_align_on_card_matches_cpu(dev, batch_first, is_probs):
    """Paths exact, scores within rtol 1e-6, and the backpointer pass
    leaves no host sync behind (its output is a device tensor)."""
    rng = np.random.RandomState(5)
    T, N, V, U = 60, 8, 20, 12
    x = rng.randn(T, N, V).astype(np.float32) * 3
    if is_probs:
        x = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    refs = rng.randint(0, V - 1, (U, N))
    refs[1] = refs[0]
    in_lens = torch.from_numpy(rng.randint(40, T + 1, N))
    ref_lens = torch.from_numpy(rng.randint(1, U + 1, N))
    x = torch.from_numpy(np.swapaxes(x, 0, 1).copy() if batch_first else x)
    refs = torch.from_numpy(refs.T.copy() if batch_first else refs)
    args = dict(batch_first=batch_first, is_probs=is_probs)
    gp, gs = pdec.ctc_forced_align(x.to(dev), refs.to(dev), in_lens.to(dev), ref_lens.to(dev),
                                   **args)
    assert gp.is_cuda and gs.is_cuda
    cp, cs = pdec.ctc_forced_align(x, refs, in_lens, ref_lens, **args)
    assert torch.equal(gp.cpu(), cp)
    torch.testing.assert_close(gs.cpu(), cs, rtol=1e-6, atol=0)


def test_relax_estimator_on_card_matches_cpu(dev):
    """REBAR over a Gumbel relaxation given the same uniforms: the value,
    the logits gradient and relax_variance_loss's control-variate
    gradient within rtol 1e-5 (or 1e-4 of the tensor's largest entry)."""
    from pydrobert_tpu_torch.ops import mc
    from pydrobert_tpu_torch.ops import straight_through as pst

    g = torch.Generator().manual_seed(3)
    logits = torch.randn(6, 9, 33, generator=g) * 2
    u_z, u_c = torch.rand((4, 6, 9, 33), generator=g), torch.rand((4, 6, 9, 33), generator=g)
    w = torch.randn(33, generator=g)

    class Given(pst.GumbelOneHotCategorical):
        def rsample(self, sample_shape=(), generator=None, u=None):
            return super().rsample(sample_shape, u=u_z)

        def csample(self, b, generator=None, u=None):
            return super().csample(b, u=u_c)

        def tlog_prob(self, b):
            return super().tlog_prob(b).sum(-1)

    outs = []
    for d in (dev, torch.device("cpu")):
        wd = w.to(d)
        func = lambda b: (b * wd).sum((-2, -1))  # noqa: E731
        cv = mc.GumbelOneHotCategoricalRebarControlVariate(func, device=d)
        lg = logits.to(d).requires_grad_(True)
        v = mc.RelaxEstimator(Given(logits=lg), func, 4, cv)()
        v.sum().backward()
        loss = mc.relax_variance_loss(
            lambda pp, cvm: mc.RelaxEstimator(Given(logits=pp), func, 4, cvm), lg, cv)
        outs.append([v, lg.grad, *torch.autograd.grad(loss, [cv.log_temp, cv.eta])])
    for a, b in zip(*outs):
        a, b = a.detach().cpu(), b.detach()
        assert torch.allclose(a, b, rtol=1e-5, atol=0) or float((a - b).abs().max()) <= 1e-4 * float(
            b.abs().max())


def test_srswor_and_time_distributed_return_on_card(dev):
    from pydrobert_tpu_torch.ops import combinatorics as pc
    from pydrobert_tpu_torch.ops import rl as prl

    total = torch.tensor([5, 7, 3], device=dev)
    given = torch.tensor([2, 3, 3], device=dev)
    u = torch.rand((3, 8), generator=torch.Generator().manual_seed(0))
    got = pc.simple_random_sampling_without_replacement(None, total, given, 8, u=u.to(dev))
    exp = pc.simple_random_sampling_without_replacement(None, total.cpu(), given.cpu(), 8, u=u)
    assert got.is_cuda and torch.equal(got.cpu(), exp)
    r = torch.randn(50, 4, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(prl.time_distributed_return(r.to(dev), 0.9).cpu(),
                               prl.time_distributed_return(r, 0.9), rtol=1e-5, atol=1e-5)


def test_enumerate_estimator_over_sequences_on_card_matches_cpu(dev):
    """EnumerateEstimator over a sequence distribution whose LM lies on the
    card: the enumerated support, and so the function's input, lies on the
    card, the negated error rates go through the edit-distance kernel, and
    the value equals the CPU's within rtol 1e-5."""
    from pydrobert_tpu_torch.ops import mc

    V, eos, S, N = 5, 1, 3, 2
    cpu_lm, card_lm = _lm_pair(dev, V, 3, 4)
    refs = torch.tensor([[2, 3, 1], [4, 1, 1]])  # (N, R), batch-first
    values = []
    for lm, d in ((card_lm, dev), (cpu_lm, torch.device("cpu"))):
        dist = pdec.SequentialLanguageModelDistribution(
            pdec.RandomWalk(lm, eos), (N,), max_iters=S)
        seen = []

        def func(b):
            seen.append(b.device.type)
            r = refs.to(d).repeat(b.shape[0], 1)
            er = pstr.error_rate(r, b.reshape(-1, S), eos=eos, batch_first=True, warn=False)
            return -er.reshape(b.shape[:-1])

        kernels.reset_launches()
        values.append(mc.EnumerateEstimator(dist, func)())
        assert seen == [d.type]
        assert kernels.LAUNCHES["edit_distance"] == (1 if d.type == "cuda" else 0)
    assert values[0].is_cuda
    torch.testing.assert_close(values[0].cpu(), values[1], rtol=1e-5, atol=0)


def _spect_dir(root, n=9, F=6, V=12, seed=0):
    from pydrobert_tpu_torch.utils.serial import save_tensor

    rng = np.random.RandomState(seed)
    for i in range(n):
        T = int(rng.randint(5, 30))
        save_tensor(torch.from_numpy(rng.randn(T, F).astype(np.float32)),
                    os.path.join(root, "feat", f"u{i}.pt"))
        save_tensor(torch.from_numpy(rng.randint(0, V, rng.randint(1, 5)).astype(np.int64)),
                    os.path.join(root, "ref", f"u{i}.pt"))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_copies_pinned_batches_to_the_card(dev, tmp_path, prefetch):
    """Two epochs of SpectDataLoader on the card (pinned host batches,
    non_blocking copies, a worker thread with prefetch=2) equal the CPU
    loader's batches, while the consumer's stream is kept busy, so a copy
    still in flight would read a reused buffer."""
    from pydrobert_tpu_torch.data import SpectDataLoader, SpectDataLoaderParams

    _spect_dir(str(tmp_path))
    p = SpectDataLoaderParams(batch_size=2, do_mvn=True)
    busy = torch.randn(2048, 2048, device=dev)
    for epoch in range(2):
        cpu = list(SpectDataLoader(str(tmp_path), p, seed=3, init_epoch=epoch, device="cpu"))
        card = []
        for batch in SpectDataLoader(str(tmp_path), p, seed=3, init_epoch=epoch,
                                     device=dev, prefetch=prefetch):
            for _ in range(4):
                busy = busy @ busy / 2048  # keep the stream behind the host
            card.append(batch)
        torch.cuda.synchronize()
        assert len(card) == len(cpu)
        for a, b in zip(card, cpu):
            for x, y in zip(a, b):
                assert x.device.type == "cuda" and torch.equal(x.cpu(), y)


@pytest.mark.parametrize("source", ["dir", "tar"])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_native_loader_batches_on_card_equal_per_item_reads(dev, tmp_path, monkeypatch,
                                                            source, prefetch):
    """The native reader builds on the card's machine, and two epochs of
    natively read batches (a directory, and the tar shards of
    torch-spect-data-dir-to-wds) copied to the card, with the consumer's
    stream kept busy, equal the card loader's item-by-item batches bit for
    bit, every batch read the way it should be."""
    from pydrobert_tpu_torch import command_line, native
    from pydrobert_tpu_torch.data import (
        SpectDataLoader, SpectDataLoaderParams, SpectTarDataSet,
    )

    assert native.available(), "the native reader did not build"
    root = str(tmp_path / "data")
    _spect_dir(root)
    p = SpectDataLoaderParams(batch_size=2, do_mvn=True)
    if source == "tar":
        tar = str(tmp_path / "shards.tar")
        assert command_line.torch_spect_data_dir_to_wds(
            [root, tar, "--shard", "--max-samples-per-shard", "3"]) == 0

    def epochs(use_native):
        monkeypatch.setenv("PYDROBERT_TPU_NATIVE_IO", "1" if use_native else "0")
        busy = torch.randn(2048, 2048, device=dev)
        out = []
        for epoch in range(2):
            data = SpectTarDataSet(tar + ".*", params=p) if source == "tar" else root
            loader = SpectDataLoader(data, p, seed=3, init_epoch=epoch, device=dev,
                                     prefetch=prefetch)
            for batch in loader:
                for _ in range(4):
                    busy = busy @ busy / 2048  # keep the stream behind the host
                out.append(batch)
            assert loader.reads["native" if use_native else "per_item"] == len(loader)
        torch.cuda.synchronize()
        return out

    nat, per_item = epochs(True), epochs(False)
    assert len(nat) == len(per_item)
    for a, b in zip(nat, per_item):
        for x, y in zip(a, b):
            assert x.device.type == "cuda" and torch.equal(x, y)


def test_moe_forward_on_card_matches_cpu(dev):
    """A float32 MoE ConformerCTC (E=4, top-2, capacity 0.5 so choices
    drop): the routing equal to the CPU's and the logits within 1e-4."""
    cfg = pconf.ConformerConfig(
        vocab_size=11, num_filts=10, d_model=32, num_layers=2, num_heads=2,
        subsample_channels=4, conv_kernel=7, dtype=torch.float32, num_experts=4,
        expert_top_k=2, expert_capacity_factor=0.5,
    )
    model = pconf.ConformerCTC(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = pconf.ConformerCTC(cfg, device=dev)
    card.load_state_dict(model.state_dict())
    feats = torch.randn(4, 40, 10, generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([40, 33, 21, 9])
    y = torch.randn(2, 7, 32, generator=torch.Generator().manual_seed(2))
    mask = torch.ones(2, 7, dtype=torch.bool)
    with torch.no_grad():
        exp, _, eaux = model(feats, lens, return_aux=True)
        got, _, gaux = card(feats.to(dev), lens.to(dev), return_aux=True)
        r_cpu = model.block_0.moe.route(y, mask)
        r_card = card.block_0.moe.route(y.to(dev), mask.to(dev))
    assert torch.equal(r_cpu["experts"], r_card["experts"].cpu())
    assert torch.equal(r_cpu["keep"], r_card["keep"].cpu())
    np.testing.assert_allclose(got.cpu().numpy(), exp.numpy(), atol=1e-4, rtol=0)
    for a, b in zip(gaux, eaux):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


def test_remat_on_card_replays_the_generator(dev):
    """remat=True against remat=False on the card from one CUDA generator
    state, dropout 0.1: the loss equal and every gradient within 1e-5 of
    its tensor's largest entry; without setting the generator back the
    gradients move far more."""
    def grads(remat, restore=True):
        cfg = pconf.ConformerConfig(
            vocab_size=11, num_filts=10, d_model=32, num_layers=2, num_heads=2,
            subsample_channels=4, conv_kernel=7, dtype=torch.float32, dropout=0.1, remat=remat,
        )
        model = pconf.ConformerCTC(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        feats = torch.randn(3, 40, 10, generator=torch.Generator().manual_seed(1)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(5)
        real = pconf._remat_block
        if not restore:  # a plain checkpoint, which does not replay the generator
            pconf._remat_block = lambda block, *a: torch.utils.checkpoint.checkpoint(
                block, *a, use_reentrant=False)
        try:
            logits, _ = model(feats, torch.tensor([40, 30, 20], device=dev), False, gen)
        finally:
            pconf._remat_block = real
        loss = logits.square().mean()
        loss.backward()
        return float(loss.detach()), {k: p.grad for k, p in model.named_parameters()}

    l0, g0 = grads(False)
    l1, g1 = grads(True)
    l2, g2 = grads(True, restore=False)
    assert l0 == l1 == l2

    def worst(g):
        return max(float((g[k] - g0[k]).abs().max() / g0[k].abs().max().clamp(min=1e-30))
                   for k in g0)

    assert worst(g1) <= 1e-5
    assert worst(g2) > 1e-2
