"""Parity of pydrobert_tpu_torch.ops.decoding with the JAX package's CTC
searches: lengths exact, hypotheses exact within each beam's length,
probabilities within rtol 1e-5 (exp and reduction order differ between
XLA and PyTorch in the last ulps). ``compress_blank_frames`` is exact (its
output frames are copies of its input's), then a search of its output is
held to the JAX search of the JAX compression."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydrobert_tpu.ops import decoding as jdec
from pydrobert_tpu_torch.ops import _ctc_scan as pscan
from pydrobert_tpu_torch.ops import decoding as pdec


def _compare_search(y, y_lens, y_probs, ey, ey_lens, ey_probs):
    ey, ey_lens, ey_probs = (np.asarray(e) for e in (ey, ey_lens, ey_probs))
    y, y_lens, y_probs = (t.numpy() for t in (y, y_lens, y_probs))
    assert y.shape == ey.shape
    np.testing.assert_array_equal(y_lens, ey_lens)
    T, N, W = ey.shape
    for n in range(N):
        for w in range(W):
            L = ey_lens[n, w]
            np.testing.assert_array_equal(y[:L, n, w], ey[:L, n, w])
    np.testing.assert_allclose(y_probs, ey_probs, rtol=1e-5, atol=0)


def _run(
    T, N, V, W, seed, dtype="float32", zero_len=True, blank_shift=0.0, scale=1.0
):
    rng = np.random.RandomState(seed)
    logits = rng.randn(T, N, V + 1).astype(np.float32) * scale
    logits[..., V] += blank_shift
    lens = rng.randint(max(T // 2, 1), max(T + 1, 2), (N,)).astype(np.int32)
    if T == 0:
        lens[:] = 0
    elif zero_len:
        lens[0] = 0
    jl = jnp.asarray(logits).astype(dtype)
    exp = jax.jit(jdec.CTCPrefixSearch(W))(jl, jnp.asarray(lens))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    got = pdec.CTCPrefixSearch(W)(tl, torch.from_numpy(lens))
    _compare_search(*got, *exp)
    return got


@pytest.mark.parametrize("W", [1, 2, 4, 16])
def test_ctc_prefix_search_widths(W):
    _run(9, 8, 12, W, seed=100 + W)


@pytest.mark.parametrize("W", [4, 16])
def test_ctc_prefix_search_width_above_vocab(W):
    _run(9, 8, 3, W, seed=200 + W)


@pytest.mark.parametrize("N", [8, 130])
def test_ctc_prefix_search_both_sides_of_compact_gate(N):
    """N=130 is above the JAX package's TOPK_COMPACT_MIN_BATCH, where it
    switches to the rank-compaction top-K and the direct removal mask."""
    _run(9, N, 40, 8, seed=300 + N)


@pytest.mark.parametrize("T", [0, 1, 9])
def test_ctc_prefix_search_short_inputs(T):
    _run(T, 5, 10, 4, seed=400 + T, zero_len=T > 0)


def test_ctc_prefix_search_bfloat16():
    """bfloat16 logits lie on a coarse grid, so two different paths often
    have mathematically equal masses; their order then rests on the last
    ulp of exp, which XLA and PyTorch round differently for some inputs,
    so at unit-scale logits such a pair can swap. This case has logits
    spread wide enough to hold no such tie among its beams."""
    _run(11, 6, 30, 4, seed=500, dtype="bfloat16", scale=3.0)


def test_ctc_prefix_search_all_lens_zero():
    rng = np.random.RandomState(7)
    logits = rng.randn(5, 3, 9).astype(np.float32)
    lens = np.zeros(3, np.int32)
    exp = jdec.CTCPrefixSearch(3)(jnp.asarray(logits), jnp.asarray(lens))
    got = pdec.CTCPrefixSearch(3)(torch.from_numpy(logits), torch.from_numpy(lens))
    _compare_search(*got, *exp)
    assert (got[1] == 0).all()


def test_ctc_prefix_search_diffuse_long_renorm():
    """T=200 high-entropy frames: masses fall far below the f32 normal
    floor, so this passes only if the power-of-two renormalization carries
    the search exactly as the JAX package does; final probabilities flush
    to zero on both sides."""
    got = _run(200, 6, 256, 8, seed=60200, zero_len=False, blank_shift=4.0)
    assert (got[2] == 0).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ctc_prefix_search_whole_loop_route_on_cpu(dtype, monkeypatch):
    """Under the defaults a fitting no-LM search takes the renormalizing
    whole-loop route; on the CPU its plain version is the scan itself, so
    it is bit-equal to ``USE_BEAM_KERNEL="0"`` and holds the JAX package's
    search with DECODE_RENORM on to this file's rule, here on a long
    diffuse decode whose raw masses underflow: its longer rows' rescales
    pass the subnormal floor (a summed exponent below -149)."""
    calls = []
    real = pdec.ctc_beam_search_renorm

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(pdec, "ctc_beam_search_renorm", spy)
    got = _run(120, 5, 64, 8, seed=60300, dtype=dtype, zero_len=True, blank_shift=4.0)
    assert len(calls) == 1 and calls[0][-1] == 8
    mass, ls = real(*calls[0])[2:]
    assert bool((ls < -149).any()) and bool((ls < -126).sum() >= 3)
    assert torch.equal(got[2], pscan.beam_probs(mass, ls, True))
    monkeypatch.setattr(pdec.config, "USE_BEAM_KERNEL", "0")
    scan = pdec.CTCPrefixSearch(8)(calls[0][0], calls[0][6])
    assert len(calls) == 1
    assert torch.equal(got[1], scan[1])
    assert torch.equal(got[2].view(torch.int32), scan[2].view(torch.int32))
    mask = torch.arange(120)[:, None, None] < scan[1]
    assert torch.equal(torch.where(mask, got[0], 0), torch.where(mask, scan[0], 0))


def test_ldexp_matches_jnp_ldexp():
    """The final mass rescale: x * 2**e with no overflow of 2**e alone and
    the JAX package's flush below the f32 normal floor, bit for bit."""
    rng = np.random.RandomState(13)
    x = np.concatenate([
        rng.rand(300) * 10.0 ** rng.randint(-30, 30, 300),
        np.array([0.0, -0.0, np.inf, 1.0, 0.5, 3e-38], np.float32),
    ]).astype(np.float32)
    e = rng.randint(-300, 300, x.shape).astype(np.int32)
    e[-6:] = [5, 5, -3, 127, 128, -2]
    exp = np.asarray(jnp.ldexp(jnp.asarray(x), jnp.asarray(e)))
    got = pscan._ldexp(torch.from_numpy(x), torch.from_numpy(e)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), exp.view(np.uint32))


def test_pow2_is_exact():
    e = torch.arange(-149, 128, dtype=torch.int32)
    ref = np.ldexp(np.float64(1.0), e.numpy()).astype(np.float32)
    np.testing.assert_array_equal(pscan._pow2(e).numpy(), ref)


def test_ctc_prefix_search_lm_not_ported():
    """LM fusion is ported (tests/test_torch_decoding_lm.py); what is not
    a mixable LM is refused when the search is made."""
    with pytest.raises(TypeError, match="MixableSequentialLanguageModel"):
        pdec.CTCPrefixSearch(4, lm=object())


@pytest.mark.parametrize("batch_first", [False, True])
@pytest.mark.parametrize("is_probs", [False, True])
@pytest.mark.parametrize("with_lens", [False, True])
def test_ctc_greedy_search(batch_first, is_probs, with_lens):
    rng = np.random.RandomState(11 + 2 * batch_first + is_probs)
    T, N, V = 13, 5, 6
    x = rng.randn(T, N, V).astype(np.float32)
    x = np.round(x)  # ties and repeats
    if is_probs:
        x = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    if batch_first:
        x = np.ascontiguousarray(x.transpose(1, 0, 2))
    lens = rng.randint(0, T + 1, (N,)).astype(np.int32) if with_lens else None
    em, ep, el = jdec.ctc_greedy_search(
        jnp.asarray(x),
        None if lens is None else jnp.asarray(lens),
        blank_idx=2,
        batch_first=batch_first,
        is_probs=is_probs,
    )
    gm, gp, gl = pdec.ctc_greedy_search(
        torch.from_numpy(x),
        None if lens is None else torch.from_numpy(lens),
        blank_idx=2,
        batch_first=batch_first,
        is_probs=is_probs,
    )
    np.testing.assert_array_equal(gp.numpy(), np.asarray(ep))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(el))
    np.testing.assert_allclose(gm.numpy(), np.asarray(em), rtol=1e-5, atol=1e-6)
    mod = pdec.CTCGreedySearch(2, batch_first, is_probs)
    assert torch.equal(
        mod(torch.from_numpy(x), None if lens is None else torch.from_numpy(lens))[1],
        gp,
    )


def test_ctc_greedy_search_float16_matches_jax():
    """float16 logits stay float16 through the log-softmax, as in the JAX
    package: at this input float16 rounding ties tokens that float32 keeps
    apart (89 of 1,600 frames pick another token in float32), and JAX
    takes the first. Tokens, lengths and the float16 ``max_`` exact."""
    x = (np.random.RandomState(0).randn(200, 8, 1025) * 0.05).astype(np.float16)
    em, ep, el = jdec.ctc_greedy_search(jnp.asarray(x))
    gm, gp, gl = pdec.ctc_greedy_search(torch.from_numpy(x))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(ep))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(el))
    assert gm.dtype == torch.float16 and em.dtype == jnp.float16
    np.testing.assert_array_equal(gm.numpy(), np.asarray(em))
    # the float32 route picks other tokens here, so the case can tell them apart
    f32 = pdec.ctc_greedy_search(torch.from_numpy(x).float())[1]
    assert not torch.equal(f32, gp)


def test_ctc_prefix_search_float16_matches_jax():
    """float16 logits are upcast to float32 before the prologue, as the
    JAX package's XLA prologue does, and decode to JAX's hypotheses."""
    rng = np.random.RandomState(0)
    logits = rng.randn(20, 2, 65).astype(np.float16)
    lens = np.array([20, 14], np.int32)
    exp = jax.jit(jdec.CTCPrefixSearch(4))(jnp.asarray(logits), jnp.asarray(lens))
    got = pdec.CTCPrefixSearch(4)(torch.from_numpy(logits), torch.from_numpy(lens))
    _compare_search(*got, *exp)
    assert got[2].dtype == torch.float32


def test_ctc_greedy_search_bfloat16_matches_jax():
    """bfloat16 logits are upcast to float32 before the log-softmax, as in
    the JAX package: the same tokens and lengths, and a float32 ``max_``
    within float32 rounding of JAX's."""
    x = (np.random.RandomState(1).randn(200, 8, 1025) * 0.05).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    em, ep, el = jdec.ctc_greedy_search(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    gm, gp, gl = pdec.ctc_greedy_search(xb)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(ep))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(el))
    assert gm.dtype == torch.float32 and em.dtype == jnp.float32
    np.testing.assert_allclose(gm.numpy(), np.asarray(em), rtol=1e-5, atol=1e-6)


def _spiky(T, N, V, seed, blank=5.0, spike=12.0):
    """bench.py's blank-skip logits in small: a raised blank everywhere and
    a token spike on about one frame in six."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(T, N, V + 1).astype(np.float32)
    logits[..., V] += blank
    for n in range(N):
        idx = rng.choice(T, size=T // 6, replace=False)
        logits[idx, n, rng.randint(V, size=T // 6)] += spike
    lens = rng.randint(T // 2, T + 1, (N,)).astype(np.int32)
    lens[0] = T
    return logits, lens


def _blank_margin(logits, threshold):
    """The smallest distance of a blank probability (float64) from the
    threshold: far above the two frameworks' last-ulp differences, or the
    compressions could part on a frame."""
    x = logits.astype(np.float64)
    p = np.exp(x[..., -1] - x.max(-1)) / np.exp(x - x.max(-1, keepdims=True)).sum(-1)
    return np.abs(p - threshold).min()


@pytest.mark.parametrize("threshold", [0.5, 0.9, 0.99])
@pytest.mark.parametrize("max_frames", [None, 20, 100])
@pytest.mark.parametrize("batch_first", [False, True])
def test_compress_blank_frames_matches_jax(threshold, max_frames, batch_first):
    logits, lens = _spiky(60, 6, 12, int(threshold * 100))
    assert _blank_margin(logits, threshold) > 1e-5
    x = np.swapaxes(logits, 0, 1).copy() if batch_first else logits
    kw = dict(threshold=threshold, max_frames=max_frames, batch_first=batch_first)
    exp, exp_lens = jdec.compress_blank_frames(jnp.asarray(x), jnp.asarray(lens), **kw)
    got, got_lens = pdec.compress_blank_frames(torch.from_numpy(x), torch.from_numpy(lens), **kw)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(exp_lens))
    assert got.shape == exp.shape and got.is_contiguous()
    # frames past each length are arbitrary (the searches mask by length)
    t = np.arange(got.shape[1 if batch_first else 0])
    valid = t[None] < np.asarray(exp_lens)[:, None]
    if not batch_first:
        valid = valid.T
    np.testing.assert_array_equal(got.numpy()[valid], np.asarray(exp)[valid])
    assert got_lens.dtype == torch.int32
    if threshold <= 0.9 and max_frames is None:  # 0.99: (almost) no blank dominates
        assert int(got_lens.sum()) < int(lens.sum())


def test_compress_blank_frames_probs_bfloat16_and_errors_match_jax():
    logits, lens = _spiky(40, 4, 10, 3)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    for x, kw in ((probs, dict(is_probs=True)), (logits, dict(threshold=0.95))):
        exp, exp_lens = jdec.compress_blank_frames(jnp.asarray(x), None, **kw)
        got, got_lens = pdec.compress_blank_frames(torch.from_numpy(x), None, **kw)
        np.testing.assert_array_equal(got_lens.numpy(), np.asarray(exp_lens))
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    bf = jnp.asarray(logits).astype(jnp.bfloat16)
    exp, exp_lens = jdec.compress_blank_frames(bf, jnp.asarray(lens), threshold=0.9)
    got, got_lens = pdec.compress_blank_frames(
        torch.from_numpy(logits).bfloat16(), torch.from_numpy(lens), threshold=0.9)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(exp_lens))
    assert got.dtype == torch.bfloat16
    for args, kw in (((logits[0],), {}), ((logits,), dict(threshold=0.0)),
                     ((logits,), dict(threshold=1.5))):
        with pytest.raises(RuntimeError):
            jdec.compress_blank_frames(jnp.asarray(args[0]), **kw)
        with pytest.raises(RuntimeError):
            pdec.compress_blank_frames(torch.from_numpy(args[0]), **kw)


@pytest.mark.parametrize("max_frames", [None, 24])
@pytest.mark.parametrize("W", [1, 4])
def test_search_of_compressed_frames_matches_jax(max_frames, W):
    """bench_ctc_blankskip's pipeline in small: compress, then
    CTCPrefixSearch of the kept frames, against the JAX package's."""
    logits, lens = _spiky(72, 5, 16, 11 + W, blank=4.0, spike=9.0)
    assert _blank_margin(logits, 0.9) > 1e-5
    kw = dict(threshold=0.9, max_frames=max_frames)
    jl, jlens = jdec.compress_blank_frames(jnp.asarray(logits), jnp.asarray(lens), **kw)
    exp = jax.jit(jdec.CTCPrefixSearch(W))(jl, jlens)
    pl, plens = pdec.compress_blank_frames(torch.from_numpy(logits), torch.from_numpy(lens), **kw)
    got = pdec.CTCPrefixSearch(W)(pl, plens)
    _compare_search(*got, *exp)
    # batch-first compression, turned back to time-major, reaches the
    # search unchanged
    bl, blens = pdec.compress_blank_frames(
        torch.from_numpy(np.swapaxes(logits, 0, 1).copy()), torch.from_numpy(lens),
        batch_first=True, **kw)
    again = pdec.CTCPrefixSearch(W)(bl.transpose(0, 1), blens)
    for a, b in zip(again, got):
        assert torch.equal(a, b)
