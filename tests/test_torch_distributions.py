"""The port's distributions over token sequences
(pydrobert_tpu_torch.ops.decoding.TokenSequenceConstraint and
SequentialLanguageModelDistribution) against the JAX package's: support
checks, enumerated supports and samples of a decisive LM exact,
log-probabilities within rtol 1e-6 and atol 1e-6. Then REINFORCE over the
seq2seq decoder (BASELINE config #5's model at a small width): a
DirectEstimator whose function is the negated error rate against
references, both packages given the same samples; the value within rtol
1e-5 and every parameter's gradient within 1e-4 of its tensor's largest
entry, as the MER step's parity test holds it."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydrobert_tpu.lm as jlm_mod
from pydrobert_tpu.models import seq2seq as js2s
from pydrobert_tpu.ops import decoding as jdec
from pydrobert_tpu.ops import mc as jmc
from pydrobert_tpu.ops import string as jstr
from pydrobert_tpu_torch import distributions as pdist
from pydrobert_tpu_torch import lm as plm_mod
from pydrobert_tpu_torch.models import seq2seq as ps2s
from pydrobert_tpu_torch.ops import decoding as pdec
from pydrobert_tpu_torch.ops import mc as pmc
from pydrobert_tpu_torch.ops import string as pstr

from _lm_dicts import random_prob_dicts


def _close(got, exp, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), rtol=rtol, atol=atol)


@pytest.mark.parametrize("eos,max_iters", [(None, 4), (2, None), (2, 4), (0, 3)])
def test_token_sequence_constraint_matches_jax(eos, max_iters):
    rng = np.random.RandomState(0)
    value = rng.randint(-1, 6, (20, 4))
    value[::3, 2] = 2
    value[1::4] = np.abs(value[1::4])
    jc = jdec.TokenSequenceConstraint(5, eos, max_iters)
    pc = pdist.TokenSequenceConstraint(5, eos, max_iters)
    np.testing.assert_array_equal(pc.check(torch.from_numpy(value)).numpy(),
                                  np.asarray(jc.check(jnp.asarray(value))))
    with pytest.raises(ValueError):
        pdist.TokenSequenceConstraint(5)


@functools.cache
def lookup_pair(V=5, order=3, seed=1):
    pd = random_prob_dicts(V, order, seed, sos=V)
    jlm = jlm_mod.LookupLanguageModel(V, sos=V, prob_dicts=pd)
    plm = plm_mod.LookupLanguageModel(V, sos=V, device="cpu")
    plm.load_state_dict(jlm.state_dict())
    return jlm, plm


def _pair_dists(batch_shape, eos, max_iters=4, cache=False):
    jlm, plm = lookup_pair()
    jd = jdec.SequentialLanguageModelDistribution(
        jdec.RandomWalk(jlm, eos), batch_shape, max_iters=max_iters, cache_samples=cache)
    pd = pdist.SequentialLanguageModelDistribution(
        pdec.RandomWalk(plm, eos), batch_shape, max_iters=max_iters, cache_samples=cache)
    return jd, pd


@pytest.mark.parametrize("batch_shape", [(), (3,)])
@pytest.mark.parametrize("eos", [None, 1])
def test_log_prob_and_enumerate_support_match_jax(batch_shape, eos):
    jd, pd = _pair_dists(batch_shape, eos, max_iters=3)
    assert pd.has_enumerate_support and pd.event_shape == jd.event_shape
    for expand in (True, False):
        s_p, s_j = pd.enumerate_support(expand), jd.enumerate_support(expand)
        np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_j))
    s_p, s_j = pd.enumerate_support(), jd.enumerate_support()
    lp_p, lp_j = pd.log_prob(s_p), jd.log_prob(s_j)
    _close(lp_p, lp_j)
    # the support holds every completed sequence once: its mass is one
    total = torch.logsumexp(lp_p.double(), 0)
    torch.testing.assert_close(total, torch.zeros_like(total), atol=1e-5, rtol=0)
    support = pd.support
    assert bool(support.check(s_p).all())


def test_log_prob_of_padded_samples_and_the_identity_keyed_cache():
    jd, pd = _pair_dists((2,), 1, max_iters=4, cache=True)
    rng = np.random.RandomState(2)
    value = rng.randint(0, 5, (3, 2, 4))
    value_t = torch.from_numpy(value)
    lp = pd.log_prob(value_t)
    _close(lp, jd.log_prob(jnp.asarray(value)))
    assert pd.log_prob(value_t) is lp  # the same object: from the cache
    assert pd.log_prob(value_t.clone()) is not lp
    pd.clear_cache()
    assert pd._samples_cache is None


class _Decisive:
    """Step ``idx`` puts all its mass on token ``(2 * idx + n) % V`` for
    batch row ``n``, and token 0 is eos."""

    def calc_idx_log_probs(self, hist, prev, idx):
        N, V = hist.shape[1], self.vocab_size
        mod = torch if isinstance(hist, torch.Tensor) else jnp
        tgt = (2 * idx + mod.arange(N) + 1) % V
        return mod.where(tgt[:, None] == mod.arange(V)[None], 0.0, -1e4) * 1.0, prev


@pytest.mark.parametrize("batch_shape", [(), (4,)])
def test_samples_of_a_decisive_lm_match_jax(batch_shape):
    jlm = type("J", (_Decisive, jlm_mod.SequentialLanguageModel), {})(5)
    plm = type("P", (_Decisive, plm_mod.SequentialLanguageModel), {})(5)
    jd = jdec.SequentialLanguageModelDistribution(jdec.RandomWalk(jlm, 0), batch_shape, max_iters=6)
    # a state tensor on the CPU places the port's walk there
    pd = pdist.SequentialLanguageModelDistribution(
        pdec.RandomWalk(plm, 0), batch_shape, {"x": torch.zeros(1)}, max_iters=6,
        cache_samples=True)
    exp = jd.sample(jax.random.PRNGKey(0), (2,))
    got = pd.sample((2,), torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    assert pd.log_prob(got) is pd._log_probs_cache
    with pytest.raises(ValueError):
        pdist.SequentialLanguageModelDistribution(pdec.RandomWalk(plm, 0))
    with pytest.raises(ValueError):
        pdist.SequentialLanguageModelDistribution(pdec.RandomWalk(plm, 0), (2, 3), max_iters=2)


# ---- REINFORCE over the seq2seq decoder ----

S2S = dict(vocab_size=8, num_filts=5, enc_hidden=12, dec_hidden=12, embed_dim=6, attn_hidden=10)
N, MC, S, R, EOS = 3, 2, 5, 4, 7


def _samples():
    """Completed samples ``(MC, N, S)``: tokens below eos, an eos at a
    random step or none, eos after it."""
    rng = np.random.RandomState(4)
    y = rng.randint(0, EOS, (MC, N, S))
    stop = rng.randint(1, S + 2, (MC, N))
    pos = np.arange(S)
    return np.where(pos >= stop[..., None], EOS, y)


def test_direct_estimator_over_the_seq2seq_decoder_matches_jax():
    rng = np.random.RandomState(0)
    feats = rng.randn(N, 11, 5).astype(np.float32)
    lens = np.array([11, 8, 4], np.int32)
    refs = rng.randint(0, EOS, (N, R))
    jmodel = js2s.AttentionSeq2Seq(js2s.Seq2SeqConfig(**S2S))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(lens))
    samples = _samples()

    def jvalue(p):
        jlm = js2s.Seq2SeqDecoderLM(jmodel, p)
        state = jlm.initial_state(jnp.asarray(feats), jnp.asarray(lens))
        dist = jdec.SequentialLanguageModelDistribution(
            jdec.RandomWalk(jlm, EOS), (N,), state, max_iters=S)
        dist.sample = lambda key, shape=(): jnp.asarray(samples)
        tiled = jnp.tile(jnp.asarray(refs), (MC, 1))

        def func(b):
            er = jstr.error_rate(tiled, b.reshape(-1, S), eos=EOS, batch_first=True, warn=False)
            return -er.reshape(b.shape[:-1])

        return jmc.DirectEstimator(dist, func, MC)(jax.random.PRNGKey(1))

    exp, exp_g = jax.jit(jax.value_and_grad(lambda p: jvalue(p).sum()))(params)
    exp = jax.jit(jvalue)(params)

    pmodel = ps2s.AttentionSeq2Seq(ps2s.Seq2SeqConfig(**S2S), device="cpu")
    pmodel.load_state_dict(ps2s.state_dict_from_jax(jax.tree.map(np.asarray, params)))
    plm = ps2s.Seq2SeqDecoderLM(pmodel)
    state = plm.initial_state(torch.from_numpy(feats), torch.from_numpy(lens))
    dist = pdist.SequentialLanguageModelDistribution(
        pdec.RandomWalk(plm, EOS), (N,), state, max_iters=S)
    dist.sample = lambda shape=(), generator=None: torch.from_numpy(samples)
    tiled = torch.from_numpy(refs).repeat(MC, 1)

    def func(b):
        er = pstr.error_rate(tiled, b.reshape(-1, S), eos=EOS, batch_first=True, warn=False)
        return -er.reshape(b.shape[:-1])

    got = pmc.DirectEstimator(dist, func, MC)()
    # the value is the mean of the sampled function values
    torch.testing.assert_close(got.detach(), func(torch.from_numpy(samples)).mean(0))
    _close(got, exp, rtol=1e-5)
    got.sum().backward()
    exp_g = ps2s.state_dict_from_jax(jax.tree.map(np.asarray, exp_g))
    for name, p in pmodel.named_parameters():
        e = exp_g[name]
        scale = float(e.abs().max())
        assert scale > 0, name
        assert float((p.grad - e).abs().max()) <= 1e-4 * scale, name
