"""The port's beam search, random walk and sequence log-probabilities
against the JAX package's, on numpy inputs from seeds: ``beam_search_advance``;
``BeamSearch`` over the seq2seq decoder (dense route) and over lookup
n-gram LMs on both routes (sparse, and dense with the sparse bound set to
0 in both packages), with and without eos and ``finish_all_paths``;
``RandomWalk`` exactly on a decisive LM (all mass on one token a step)
and by its frequencies on a fixed distribution; ``sequence_log_probs``.

Tokens, lengths and the whole path buffer must be equal; log
probabilities within 1e-5 (log-softmax and sums round differently in XLA
and PyTorch in the last ulps). The JAX searches are jitted. A path whose
n-gram terms are a permutation of another kept path's ties it
mathematically, and the two frameworks' last-ulp roundings then order the
pair either way (the parity limit of the CTC searches too): at V=10 and
width 16 the dense route keeps such pairs from its 9th step, so that case
runs 8 steps."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydrobert_tpu.lm as jlm_mod
from pydrobert_tpu import config as jconfig
from pydrobert_tpu.models import seq2seq as js2s
from pydrobert_tpu.ops import decoding as jdec
from pydrobert_tpu_torch import config as pconfig
from pydrobert_tpu_torch import lm as plm_mod
from pydrobert_tpu_torch.models import seq2seq as ps2s
from pydrobert_tpu_torch.ops import decoding as pdec

from _lm_dicts import random_prob_dicts

TOL = dict(rtol=1e-5, atol=1e-5)


def assert_search_equal(got, exp):
    y, y_lens, lp = (t.numpy() for t in got)
    ey, ey_lens, elp = (np.asarray(e) for e in exp)
    np.testing.assert_array_equal(y, ey)
    np.testing.assert_array_equal(y_lens, ey_lens)
    np.testing.assert_array_equal(np.isinf(lp), np.isinf(elp))
    np.testing.assert_allclose(lp, elp, **TOL)


@pytest.mark.parametrize("width", [3, 20, 30])
@pytest.mark.parametrize("tm1,with_lens", [(0, False), (0, True), (2, False), (2, True)])
def test_beam_search_advance_matches_jax(width, tm1, with_lens):
    rng = np.random.RandomState(width + tm1)
    N, Kp, V = 3, 4, 6
    lp_t = rng.randn(N, Kp, V).astype(np.float32)
    lp_prev = rng.randn(N, Kp).astype(np.float32)
    y_prev = rng.randint(0, V, (tm1, N, Kp)).astype(np.int32)
    lens = rng.randint(0, tm1 + 1, (N, Kp)).astype(np.int32) if with_lens else None
    exp = jdec.beam_search_advance(
        jnp.asarray(lp_t), width, jnp.asarray(lp_prev), jnp.asarray(y_prev),
        None if lens is None else jnp.asarray(lens),
    )
    got = pdec.beam_search_advance(
        torch.from_numpy(lp_t), width, torch.from_numpy(lp_prev), torch.from_numpy(y_prev),
        None if lens is None else torch.from_numpy(lens),
    )
    for g, e in zip(got, exp):  # the scores are sums of two floats: exact
        assert g.shape == np.shape(e)
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


# ---- BeamSearch over the seq2seq decoder (the dense route) ----

S2S = dict(vocab_size=8, num_filts=5, enc_hidden=12, dec_hidden=12, embed_dim=6, attn_hidden=10)


@functools.cache
def s2s_pair():
    rng = np.random.RandomState(0)
    feats = rng.randn(3, 11, 5).astype(np.float32)
    lens = np.array([11, 8, 4], np.int32)
    jmodel = js2s.AttentionSeq2Seq(js2s.Seq2SeqConfig(**S2S))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(lens))
    pmodel = ps2s.AttentionSeq2Seq(ps2s.Seq2SeqConfig(**S2S), device="cpu")
    pmodel.load_state_dict(ps2s.state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return js2s.Seq2SeqDecoderLM(jmodel, params), ps2s.Seq2SeqDecoderLM(pmodel), feats, lens


@pytest.mark.parametrize(
    "width,eos,finish_all,max_iters",
    [(4, 0, False, 6), (4, 0, True, 6), (3, None, False, 5), (10, 2, False, 7), (1, 0, False, 4)],
)
def test_beam_search_seq2seq_matches_jax(width, eos, finish_all, max_iters):
    jlm, plm, feats, lens = s2s_pair()
    jstate = jlm.initial_state(jnp.asarray(feats), jnp.asarray(lens))
    jsearch = jdec.BeamSearch(jlm, width, eos=eos, finish_all_paths=finish_all)
    exp = jax.jit(lambda s: jsearch(s, batch_size=3, max_iters=max_iters))(jstate)
    psearch = pdec.BeamSearch(plm, width, eos=eos, finish_all_paths=finish_all)
    assert not psearch.takes_sparse_route()
    with torch.no_grad():
        pstate = plm.initial_state(torch.from_numpy(feats), torch.from_numpy(lens))
        got = psearch(pstate, batch_size=3, max_iters=max_iters)
    assert_search_equal(got, exp)


def test_beam_search_without_batch_and_zero_iters():
    jlm, plm, feats, lens = s2s_pair()
    with torch.no_grad():
        st = plm.initial_state(torch.from_numpy(feats[:1]), torch.from_numpy(lens[:1]))
        y, y_lens, lp = pdec.BeamSearch(plm, 3, eos=0)(st, max_iters=4)
        assert y.shape == (4, 3) and y_lens.shape == (3,) and lp.shape == (3,)
        y, y_lens, lp = pdec.BeamSearch(plm, 3)(st, batch_size=1, max_iters=0)
    assert y.shape == (0, 1, 3) and lp[0, 0] == 0 and torch.isinf(lp[0, 1:]).all()
    with pytest.raises(ValueError):
        pdec.BeamSearch(plm, 3)(st, batch_size=1)
    with pytest.raises(ValueError):
        pdec.BeamSearch(plm, 3, eos=8)


# ---- BeamSearch over lookup n-gram LMs: both routes ----


@functools.cache
def lookup_pair(V, N, seed):
    pd = random_prob_dicts(V, N, seed, sos=V)
    jlm = jlm_mod.LookupLanguageModel(V, sos=V, prob_dicts=pd)
    plm = plm_mod.LookupLanguageModel(V, sos=V, device="cpu")
    plm.load_state_dict(jlm.state_dict())
    return jlm, plm


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("route", ["sparse", "dense"])
@pytest.mark.parametrize(
    "V,order,seed,width,eos,finish_all,batch,max_iters",
    [
        (12, 3, 0, 4, 3, False, 2, 9),
        (12, 2, 1, 6, None, False, 3, 9),
        (10, 3, 2, 16, 7, True, 2, 8),
        (30, 3, 3, 5, 0, False, 4, 9),
    ],
)
def test_beam_search_lookup_lm_matches_jax(monkeypatch, gather, route, V, order, seed, width,
                                           eos, finish_all, batch, max_iters):
    # BeamSearch reads no SPARSE_MEMBERSHIP_GATHER in either package (C12)
    monkeypatch.setattr(jconfig, "SPARSE_MEMBERSHIP_GATHER", gather)
    monkeypatch.setattr(pconfig, "SPARSE_MEMBERSHIP_GATHER", gather)
    jlm, plm = lookup_pair(V, order, seed)
    if route == "dense":
        monkeypatch.setattr(jconfig, "SPARSE_FUSION_MAX_CORRECTIONS", 0)
        monkeypatch.setattr(pconfig, "SPARSE_FUSION_MAX_CORRECTIONS", 0)
    jsearch = jdec.BeamSearch(jlm, width, eos=eos, finish_all_paths=finish_all)
    exp = jax.jit(lambda: jsearch(batch_size=batch, max_iters=max_iters))()
    psearch = pdec.BeamSearch(plm, width, eos=eos, finish_all_paths=finish_all)
    assert psearch.takes_sparse_route() == (route == "sparse")
    got = psearch(batch_size=batch, max_iters=max_iters)
    assert_search_equal(got, exp)


# ---- RandomWalk ----


def _decisive(base):
    """An LM class over ``base`` whose step ``idx`` puts all its mass on
    token ``(3 * idx + n + 1) % V`` for batch row ``n``."""

    class Decisive(base):
        def calc_idx_log_probs(self, hist, prev, idx):
            N, V = hist.shape[1], self.vocab_size
            mod = jnp if base is jlm_mod.SequentialLanguageModel else torch
            tgt = (3 * idx + mod.arange(N) + 1) % V
            hit = tgt[:, None] == mod.arange(V)[None]
            return mod.where(hit, 0.0, -float("inf")) * 1.0, prev

    return Decisive


@pytest.mark.parametrize("eos", [None, 0, 4])
def test_random_walk_on_a_decisive_lm_matches_jax(eos):
    V, N, S = 7, 5, 6
    jlm = _decisive(jlm_mod.SequentialLanguageModel)(V)
    plm = _decisive(plm_mod.SequentialLanguageModel)(V)
    exp = jdec.RandomWalk(jlm, eos=eos)(jax.random.PRNGKey(0), None, N, S)
    got = pdec.RandomWalk(plm, eos=eos)(torch.Generator().manual_seed(0), {"x": torch.zeros(1)}, N, S)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    if eos is not None:
        assert (got[1].numpy() < S).any()


class _Fixed:
    """An LM mixin whose every step has the same distribution ``P``."""

    P = np.array([0.1, 0.2, 0.3, 0.4])

    def calc_idx_log_probs(self, hist, prev, idx):
        lp = np.log(self.P).astype(np.float32)
        N = hist.shape[1]
        if isinstance(hist, torch.Tensor):
            return torch.from_numpy(lp).expand(N, 4).clone(), prev
        return jnp.broadcast_to(jnp.asarray(lp), (N, 4)), prev


def test_random_walk_frequencies_follow_the_distribution():
    """20,000 walks of 3 steps from a fixed distribution, eos = 3 (p 0.4):
    first-step frequencies within 5 standard errors of P in both packages;
    the port's paths stop at their first eos, continue by eos only, and
    carry log P of their tokens."""
    N, S = 20000, 3
    plm = type("P", (_Fixed, plm_mod.SequentialLanguageModel), {})(4)
    jlm = type("J", (_Fixed, jlm_mod.SequentialLanguageModel), {})(4)
    y, y_lens, lp = pdec.RandomWalk(plm, eos=3)(torch.Generator().manual_seed(1), {"x": torch.zeros(1)}, N, S)
    ey, _, _ = jdec.RandomWalk(jlm, eos=3)(jax.random.PRNGKey(1), None, N, S)
    se = np.sqrt(_Fixed.P * (1 - _Fixed.P) / N)
    for first in (y[0].numpy(), np.asarray(ey)[0]):
        freq = np.bincount(first, minlength=4) / N
        assert (np.abs(freq - _Fixed.P) < 5 * se).all(), freq
    y, y_lens, lp = y.numpy(), y_lens.numpy(), lp.numpy()
    logp = np.log(_Fixed.P).astype(np.float32)
    for n in range(200):
        L = y_lens[n]
        toks = y[:L, n]
        assert (toks[:-1] != 3).all() and (L == S or toks[-1] == 3)
        assert np.isin(y[L:, n], (0, 3)).all()  # eos while the walk runs on, then 0
        np.testing.assert_allclose(lp[n], logp[toks].sum(), rtol=1e-6)


def test_random_walk_advance_matches_jax_on_decisive_rows():
    rng = np.random.RandomState(0)
    N, V = 4, 5
    tgt = rng.randint(0, V, N)
    lp_t = np.where(np.arange(V)[None] == tgt[:, None], 0.0, -np.inf).astype(np.float32)
    lp_prev = rng.randn(N).astype(np.float32)
    y_prev = rng.randint(0, V, (3, N)).astype(np.int32)
    lens = np.array([0, 1, 3, 2], np.int32)
    for yl in (None, lens):
        exp = jdec.random_walk_advance(
            jax.random.PRNGKey(0), jnp.asarray(lp_t), jnp.asarray(lp_prev), jnp.asarray(y_prev),
            None if yl is None else jnp.asarray(yl),
        )
        got = pdec.random_walk_advance(
            torch.Generator().manual_seed(0), torch.from_numpy(lp_t), torch.from_numpy(lp_prev),
            torch.from_numpy(y_prev), None if yl is None else torch.from_numpy(yl),
        )
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e))


# ---- sequence_log_probs ----


@pytest.mark.parametrize("dim,eos", [(0, None), (0, 2), (-1, None), (1, 2)])
def test_sequence_log_probs_matches_jax(dim, eos):
    rng = np.random.RandomState(dim + 5)
    S, N, V = 7, 4, 6
    hyp = rng.randint(-1, V + 1, (S, N)).astype(np.int32)  # -1 and V count nothing
    if dim != 0:
        hyp = hyp.T.copy()
    logits = rng.randn(*(hyp.shape + (V,))).astype(np.float32) * 3
    exp = jdec.sequence_log_probs(jnp.asarray(logits), jnp.asarray(hyp), dim, eos)
    got = pdec.sequence_log_probs(torch.from_numpy(logits), torch.from_numpy(hyp), dim, eos)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6, atol=1e-5)
    mod = pdec.SequenceLogProbabilities(dim, eos)
    np.testing.assert_array_equal(mod(torch.from_numpy(logits), torch.from_numpy(hyp)).numpy(),
                                  got.numpy())
    with pytest.raises(RuntimeError):
        pdec.sequence_log_probs(torch.from_numpy(logits), torch.from_numpy(hyp), 2)


# ---- half-precision steps (ROADMAP C7): jax.nn.log_softmax's rounding ----


def _bf16_ulp(x):
    """One bfloat16 ulp at each of ``x``'s magnitudes (float32 keeps 16
    more mantissa bits)."""
    return np.spacing(np.abs(np.asarray(x, np.float32))) * 2.0**16


def _half_table(V, dtype):
    return (np.random.RandomState(9).randn(V + 1, V) * 3).astype(np.float32)


def _half_lm(base, V, dtype):
    """An LM over ``base`` whose step logits (unnormalized, in ``dtype``)
    are the row of a fixed table picked by the previous token."""
    table = _half_table(V, dtype)

    class Half(base):
        def calc_idx_log_probs(self, hist, prev, idx):
            if isinstance(hist, torch.Tensor):
                tab = torch.from_numpy(table).to(getattr(torch, dtype))
                tok = torch.full((hist.shape[1],), V) if idx == 0 else hist[idx - 1].clamp(0, V)
                return tab[tok.long()], prev
            tab = jnp.asarray(table).astype(getattr(jnp, dtype))
            S = hist.shape[0]
            tok = jnp.take(hist, jnp.clip(idx - 1, 0, max(S - 1, 0)), axis=0) if S else 0
            tok = jnp.where(idx == 0, V, jnp.clip(tok, 0, V))
            return tab[tok], prev

    return Half(V)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_sequence_log_probs_half_precision_matches_jax(dtype):
    """float16 bit-exact; bfloat16 within one bfloat16 ulp."""
    rng = np.random.RandomState(3)
    logits = (rng.randn(20, 4, 37) * 3).astype(np.float32)
    hyp = rng.randint(0, 37, (20, 4))
    exp = np.asarray(jdec.sequence_log_probs(jnp.asarray(logits).astype(getattr(jnp, dtype)),
                                             jnp.asarray(hyp)).astype(jnp.float32))
    got = pdec.sequence_log_probs(torch.from_numpy(logits).to(getattr(torch, dtype)),
                                  torch.from_numpy(hyp)).float().numpy()
    if dtype == "float16":
        np.testing.assert_array_equal(got, exp)
    else:
        assert (np.abs(got - exp) <= _bf16_ulp(exp)).all()


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_random_walk_step_log_softmax_half_precision_matches_jax(dtype):
    """Each step's normalized log-probabilities, as the walk hands them to
    ``update_log_probs_for_step``, equal ``jax.nn.log_softmax`` of the same
    half-precision logits: float16 bit-exact, bfloat16 within one ulp."""
    V, N = 23, 4
    seen = []

    class Walk(pdec.RandomWalk):
        def update_log_probs_for_step(self, lp_prev, lp_t, y_prev, y_prev_lens, eos_mask):
            seen.append((lp_t.clone(), y_prev.clone()))
            return lp_prev, lp_t

    lm = _half_lm(plm_mod.SequentialLanguageModel, V, dtype)
    Walk(lm)(torch.Generator().manual_seed(0), {"x": torch.zeros(1)}, N, 3)
    table = jnp.asarray(_half_table(V, dtype)).astype(getattr(jnp, dtype))
    for t, (lp_t, y) in enumerate(seen):
        tok = np.full(N, V) if t == 0 else y[t - 1].numpy()
        exp = np.asarray(jax.nn.log_softmax(table[tok], -1).astype(jnp.float32))
        got = lp_t.float().numpy()
        if dtype == "float16":
            np.testing.assert_array_equal(got, exp)
        else:
            assert (np.abs(got - exp) <= _bf16_ulp(exp)).all()


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_beam_search_half_precision_lm_matches_jax(dtype):
    """The dense route's step log-softmax in the LM's dtype: paths and
    lengths exact, scores (float32 sums of half-precision steps) exact in
    float16 and within a bfloat16 ulp of each step in bfloat16."""
    V, N, W, S = 19, 3, 4, 6
    jlm = _half_lm(jlm_mod.ExtractableSequentialLanguageModel, V, dtype)
    plm = _half_lm(plm_mod.ExtractableSequentialLanguageModel, V, dtype)
    exp = jax.jit(lambda: jdec.BeamSearch(jlm, W, eos=0)(batch_size=N, max_iters=S))()
    got = pdec.BeamSearch(plm, W, eos=0)({"x": torch.zeros(())}, batch_size=N, max_iters=S)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(exp[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(exp[1]))
    e = np.asarray(exp[2], np.float32)
    if dtype == "float16":
        np.testing.assert_array_equal(got[2].float().numpy(), e)
    else:
        fin = np.isfinite(e)
        assert (np.abs(got[2].float().numpy()[fin] - e[fin]) <= S * _bf16_ulp(e[fin])).all()
