"""The port's CTC forced aligner (pydrobert_tpu_torch.ops.decoding.
ctc_forced_align and CTCForcedAligner) against the JAX package's on the
same numpy inputs: paths bit-exact, scores within rtol 1e-6 (float32; the
Viterbi takes the same additions in the same order, so they agree exactly
here, but a different libm may round the log-softmax apart in an ulp),
exact in float16 and bfloat16. The JAX package's one-hot contraction turns
any non-finite log-probability off a state's label into NaN; the port
reproduces that, and the tests pin JAX's NaN beside the port's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydrobert_tpu.ops import decoding as jdec
from pydrobert_tpu_torch.ops import decoding as pdec

RTOL = 1e-6


def _inputs(seed, T=13, N=5, V=7, U=5, is_probs=False):
    rng = np.random.RandomState(seed)
    x = (rng.randn(T, N, V) * 2).astype(np.float32)
    if is_probs:
        x = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    refs = rng.randint(0, V - 1, (U, N))  # blank is V - 1
    refs[1, 0] = refs[0, 0]  # a repeated token needs a blank between
    in_lens = rng.randint(T // 2, T + 1, N)
    in_lens[0] = T
    ref_lens = rng.randint(0, U + 1, N)
    ref_lens[0] = U
    return x, refs, in_lens, ref_lens


def _both(x, refs, in_lens=None, ref_lens=None, batch_first=False, is_probs=False,
          jdtype=None, pdtype=None, blank_idx=-1):
    if batch_first:
        x, refs = x.transpose(1, 0, 2), refs.T
    jx = jnp.asarray(x) if jdtype is None else jnp.asarray(x).astype(jdtype)
    px = torch.from_numpy(np.ascontiguousarray(x))
    px = px if pdtype is None else px.to(pdtype)
    opt = lambda a, f: None if a is None else f(a)  # noqa: E731
    exp = jdec.ctc_forced_align(jx, jnp.asarray(refs), opt(in_lens, jnp.asarray),
                                opt(ref_lens, jnp.asarray), blank_idx, batch_first, is_probs)
    got = pdec.ctc_forced_align(px, torch.from_numpy(np.ascontiguousarray(refs)),
                                opt(in_lens, torch.from_numpy), opt(ref_lens, torch.from_numpy),
                                blank_idx, batch_first, is_probs)
    return got, (np.asarray(exp[0]), np.asarray(exp[1].astype(jnp.float32)))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("is_probs", [False, True])
@pytest.mark.parametrize("batch_first", [False, True])
def test_ctc_forced_align_matches_jax(seed, is_probs, batch_first):
    x, refs, in_lens, ref_lens = _inputs(seed, is_probs=is_probs)
    (paths, scores), (e_paths, e_scores) = _both(x, refs, in_lens, ref_lens, batch_first, is_probs)
    assert paths.shape == e_paths.shape
    np.testing.assert_array_equal(paths.numpy(), e_paths)
    np.testing.assert_allclose(scores.numpy(), e_scores, rtol=RTOL)
    assert np.isfinite(e_scores).all()


def test_ctc_forced_align_defaults_and_module():
    x, refs, _, _ = _inputs(7, T=9, N=3, V=6, U=3)
    (paths, scores), (e_paths, e_scores) = _both(x, refs, blank_idx=2)
    np.testing.assert_array_equal(paths.numpy(), e_paths)
    np.testing.assert_allclose(scores.numpy(), e_scores, rtol=RTOL)
    mod = pdec.CTCForcedAligner(blank_idx=2)
    got = mod(torch.from_numpy(x), torch.from_numpy(refs))
    assert torch.equal(got[0], paths) and torch.equal(got[1], scores)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_ctc_forced_align_half_precision_matches_jax(dtype):
    """bfloat16 is upcast (exact); float16 takes jax.nn.log_softmax's
    float16 steps and a float16 Viterbi: both bit-exact."""
    x, refs, in_lens, ref_lens = _inputs(11, T=16, N=6, V=9, U=6)
    (paths, scores), (e_paths, e_scores) = _both(
        x, refs, in_lens, ref_lens, jdtype=getattr(jnp, dtype), pdtype=getattr(torch, dtype))
    assert scores.dtype == (torch.float32 if dtype == "bfloat16" else torch.float16)
    np.testing.assert_array_equal(paths.numpy(), e_paths)
    np.testing.assert_array_equal(scores.float().numpy(), e_scores)


def test_ctc_forced_align_infeasible_reference_scores_minus_inf():
    """Four distinct tokens need 4 frames, a repeated pair 2 + 1: a
    5-frame budget holds the first, not [a, a, b, b]."""
    rng = np.random.RandomState(3)
    x = rng.randn(5, 2, 4).astype(np.float32)
    refs = np.array([[0, 1], [0, 2], [2, 0], [2, 3]])  # (U, N)
    in_lens = np.array([5, 5])
    (paths, scores), (e_paths, e_scores) = _both(x, refs, in_lens)
    assert np.isneginf(e_scores[0]) and np.isfinite(e_scores[1])
    np.testing.assert_array_equal(scores.numpy()[0], e_scores[0])
    np.testing.assert_allclose(scores.numpy()[1], e_scores[1], rtol=RTOL)
    np.testing.assert_array_equal(paths.numpy()[:, 1], e_paths[:, 1])


def _nan_case(kind):
    rng = np.random.RandomState(0)
    x = rng.randn(6, 1, 4).astype(np.float32)
    refs = np.array([[0], [1]])
    if kind == "zero_prob":
        p = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
        p[2, 0, 2] = 0.0  # a token the reference never uses
        return p, refs, True
    x[3, 0, 2] = -np.inf  # a masked token
    return x, refs, False


@pytest.mark.parametrize("kind", ["zero_prob", "masked_logit"])
def test_ctc_forced_align_reproduces_jax_nan(kind):
    """A frame holding a non-finite log-probability makes the JAX package's
    one-hot contraction sum an inf * 0: NaN, which spreads to the score.
    The port's gather reproduces the NaN and the path."""
    x, refs, is_probs = _nan_case(kind)
    (paths, scores), (e_paths, e_scores) = _both(x, refs, is_probs=is_probs)
    assert np.isnan(e_scores).all()  # the JAX package's result, pinned
    assert torch.isnan(scores).all()
    np.testing.assert_array_equal(paths.numpy(), e_paths)


def test_ctc_forced_align_minus_inf_on_the_label_stays_finite_elsewhere():
    """A ``-inf`` at a state's own label is that state's emission, not a
    NaN: states of other labels in the frame get NaN, as in JAX."""
    rng = np.random.RandomState(1)
    x = rng.randn(7, 2, 5).astype(np.float32)
    x[4, 0, 1] = -np.inf
    refs = np.array([[0, 2], [1, 3]])
    (paths, scores), (e_paths, e_scores) = _both(x, refs)
    np.testing.assert_array_equal(paths.numpy(), e_paths)
    np.testing.assert_array_equal(np.isnan(scores.numpy()), np.isnan(e_scores))
    np.testing.assert_allclose(scores.numpy()[1], e_scores[1], rtol=RTOL)


@pytest.mark.parametrize("seed", range(3))
def test_alignment_to_the_greedy_transcript_is_the_argmax_path(seed):
    """The greedy path is the global maximum, so aligning to its transcript
    gives it back, scored by the sum of the frame maxima."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(30, 4, 8) * 3).astype(np.float32))
    lens = torch.tensor([30, 25, 17, 30])
    _, hyps, hyp_lens = pdec.ctc_greedy_search(x, lens)
    paths, scores = pdec.ctc_forced_align(x, hyps, lens, hyp_lens)
    lp = torch.log_softmax(x, -1)
    for n in range(4):
        L = int(lens[n])
        assert torch.equal(paths[:L, n], lp[:L, n].argmax(-1))
        torch.testing.assert_close(scores[n], lp[:L, n].amax(-1).sum(), rtol=RTOL, atol=0)
