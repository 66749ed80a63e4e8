"""Parity of pydrobert_tpu_torch.ops.decoding with the JAX package's CTC
searches: lengths exact, hypotheses exact within each beam's length,
probabilities within rtol 1e-5 (exp and reduction order differ between
XLA and PyTorch in the last ulps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydrobert_tpu.ops import decoding as jdec
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
    got = pdec._ldexp(torch.from_numpy(x), torch.from_numpy(e)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), exp.view(np.uint32))


def test_pow2_is_exact():
    e = torch.arange(-149, 128, dtype=torch.int32)
    ref = np.ldexp(np.float64(1.0), e.numpy()).astype(np.float32)
    np.testing.assert_array_equal(pdec._pow2(e).numpy(), ref)


def test_ctc_prefix_search_lm_not_ported():
    with pytest.raises(NotImplementedError):
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
