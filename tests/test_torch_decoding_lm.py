"""The port's LM-fused CTC prefix search against the JAX package's, on the
three routes: sparse (a lookup n-gram LM through the prologue's ``g_bias``
and per-beam corrections), unigram (the factored advance with the same
bias) and dense (the full softmax, with the product fusion and with
``valid_mixture``), with DECODE_RENORM on and off, float32 and bfloat16
logits, and an initial state. The sparse route also with
``SPARSE_MEMBERSHIP_GATHER`` on (set in both packages): the order-2 slots
answered by one gather of the LM's bigram table.

The port LM is carried across by the JAX LM's ``state_dict()``. Lengths
and hypotheses (within each beam's length) must be equal; probabilities
within rtol 1e-5, the no-LM tests' tolerance (exp, log-softmax and
reduction order differ between XLA and PyTorch in the last ulps). The
logits are spread wide (x3) over at most 20 frames, so they hold no
mathematical ties between beams and keep masses normal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydrobert_tpu.lm as jlm_mod
from pydrobert_tpu import config as jconfig
from pydrobert_tpu.ops import decoding as jdec
from pydrobert_tpu_torch import config as pconfig
from pydrobert_tpu_torch import lm as plm_mod
from pydrobert_tpu_torch.ops import _ctc_scan as pscan
from pydrobert_tpu_torch.ops import decoding as pdec
from pydrobert_tpu_torch.ops import kernels

from _lm_dicts import fused_prob_dicts, random_prob_dicts

RTOL = 1e-5


def _compare_search(got, exp):
    y, y_lens, y_probs = (t.numpy() for t in got)
    ey, ey_lens, ey_probs = (np.asarray(e) for e in exp)
    assert y.shape == ey.shape
    np.testing.assert_array_equal(y_lens, ey_lens)
    mask = np.arange(ey.shape[0])[:, None, None] < ey_lens[None]
    np.testing.assert_array_equal(np.where(mask, y, -1), np.where(mask, ey, -1))
    np.testing.assert_allclose(y_probs, ey_probs, rtol=RTOL, atol=0)


@functools.cache
def lm_pair(V, N, seed):
    """A JAX lookup LM and the port's copy of it, carried by its state
    dict (cached: the builds dominate these tests' time otherwise; the
    searches only read them)."""
    pd = random_prob_dicts(V, N, seed, sos=V)
    jlm = jlm_mod.LookupLanguageModel(V, sos=V, prob_dicts=pd)
    plm = plm_mod.LookupLanguageModel(V, sos=V, device="cpu")
    plm.load_state_dict(jlm.state_dict())
    return jlm, plm


def run_both(jlm, plm, T, N, W, seed, beta=0.5, valid_mixture=False,
             dtype="float32", scale=3.0, lens=None):
    V = jlm.vocab_size
    rng = np.random.RandomState(seed)
    logits = (rng.randn(T, N, V + 1) * scale).astype(np.float32)
    if lens is None:
        lens = rng.randint(max(T // 2, 1), T + 1, (N,)).astype(np.int32)
        lens[0] = 0
    jsearch = jdec.CTCPrefixSearch(W, beta, jlm, valid_mixture)
    psearch = pdec.CTCPrefixSearch(W, beta, plm, valid_mixture)
    exp = jax.jit(jsearch)(jnp.asarray(logits).astype(dtype), jnp.asarray(lens))
    got = psearch(torch.from_numpy(logits).to(getattr(torch, dtype)), torch.from_numpy(lens))
    return psearch, got, exp


# route -> (V, max_ngram, LM seed, valid_mixture, forced dense, gather)
ROUTES = {
    "sparse": (20, 3, 1, False, False, False),
    "sparse_gather": (20, 3, 1, False, False, True),
    "uni": (20, 1, 2, False, False, False),
    "dense": (20, 3, 1, False, True, False),
    "dense_mixture": (20, 3, 1, True, False, False),
}


def set_gather(monkeypatch, on):
    """``SPARSE_MEMBERSHIP_GATHER`` in both packages."""
    monkeypatch.setattr(jconfig, "SPARSE_MEMBERSHIP_GATHER", on)
    monkeypatch.setattr(pconfig, "SPARSE_MEMBERSHIP_GATHER", on)


def record_tables(monkeypatch, contexts=None):
    """Wrap the sparse advance: the list it returns gets whether each call
    was handed a bigram table, and ``contexts`` (a list) each call's
    order-1 context tokens ``c1``."""
    seen = []
    advance = pscan._ctc_prefix_search_advance_sparse

    def wrapped(*args, **kwargs):
        seen.append(args[14] is not None)
        if contexts is not None:
            contexts.append(args[15].clone())
        return advance(*args, **kwargs)

    monkeypatch.setattr(pscan, "_ctc_prefix_search_advance_sparse", wrapped)
    return seen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_lm_search_matches_jax(route, renorm, dtype, monkeypatch):
    V, Ng, seed, mixture, forced, gather = ROUTES[route]
    monkeypatch.setattr(jconfig, "DECODE_RENORM", renorm)
    monkeypatch.setattr(pconfig, "DECODE_RENORM", renorm)
    set_gather(monkeypatch, gather)
    tables = record_tables(monkeypatch)
    if forced:
        # more corrections than the sparse route takes: the dense advance
        monkeypatch.setattr(jconfig, "SPARSE_FUSION_MAX_CORRECTIONS", 0)
        monkeypatch.setattr(pconfig, "SPARSE_FUSION_MAX_CORRECTIONS", 0)
    jlm, plm = lm_pair(V, Ng, seed)
    calls = []
    prologue = pdec.decode_prologue
    monkeypatch.setattr(
        pdec, "decode_prologue", lambda *a: calls.append(a) or prologue(*a)
    )
    psearch, got, exp = run_both(
        jlm, plm, 12, 4, 4, seed=100 + len(route.removesuffix("_gather")), valid_mixture=mixture,
        dtype=dtype,
    )
    assert psearch.lm_route() == route.split("_")[0]
    _compare_search(got, exp)
    if psearch.lm_route() == "sparse":
        # every frame of the gather route took the table, none of the other
        assert tables == [gather] * 12
    if route in ("sparse", "sparse_gather", "uni"):
        # the prologue took the LM's bias, at M = 2W + corrections
        (logits, M, g_bias), = calls
        assert M == min(V, 8 + (plm.max_corrections if route != "uni" else 0))
        assert g_bias.dtype == torch.float32 and g_bias.is_contiguous()
    else:
        assert not calls


@pytest.mark.parametrize("route", ["sparse", "dense"])
def test_lm_search_wider_lm_and_beams_matches_jax(route, monkeypatch):
    """A 4-gram over V=40 at W=8 (M = 16 + 39 on the sparse route), T=20."""
    if route == "dense":
        monkeypatch.setattr(jconfig, "SPARSE_FUSION_MAX_CORRECTIONS", 0)
        monkeypatch.setattr(pconfig, "SPARSE_FUSION_MAX_CORRECTIONS", 0)
    jlm, plm = lm_pair(40, 4, 6)
    psearch, got, exp = run_both(jlm, plm, 20, 3, 8, seed=6)
    assert psearch.lm_route() == route
    _compare_search(got, exp)


def test_lm_search_probing_lm_matches_jax():
    """A 5-gram over V=40: its order-4 contexts have only the probing
    table, so the sparse route reads the probing fallback's corrections
    and normalizers."""
    jlm, plm = lm_pair(40, 5, 4)
    assert plm._combined_tables() is None
    psearch, got, exp = run_both(jlm, plm, 10, 3, 4, seed=7)
    assert psearch.lm_route() == "sparse"
    _compare_search(got, exp)


@pytest.mark.parametrize("W", [1, 25])
def test_lm_search_extreme_widths_match_jax(W):
    """W=1, and W above V + 1 (dummy beams at -inf)."""
    jlm, plm = lm_pair(20, 3, 1)
    _, got, exp = run_both(jlm, plm, 9, 3, W, seed=8)
    _compare_search(got, exp)


def test_lm_search_initial_state_and_edge_lengths_match_jax():
    """An explicit (empty) initial state, T=1, and lengths 0, 1 and T."""
    jlm, plm = lm_pair(20, 3, 1)
    for T in (1, 6):
        lens = np.array([0, 1, T], np.int32)
        rng = np.random.RandomState(9 + T)
        logits = (rng.randn(T, 3, 21) * 3).astype(np.float32)
        jsearch = jdec.CTCPrefixSearch(4, 0.5, jlm)
        exp = jax.jit(lambda x, n: jsearch(x, n, {}))(jnp.asarray(logits), jnp.asarray(lens))
        got = pdec.CTCPrefixSearch(4, 0.5, plm)(
            torch.from_numpy(logits), torch.from_numpy(lens), initial_state={}
        )
        _compare_search(got, exp)


def test_lm_search_zero_beta_is_the_plain_search():
    jlm, plm = lm_pair(20, 3, 1)
    search = pdec.CTCPrefixSearch(4, 0.0, plm)
    assert search.lm_route() is None
    x = torch.from_numpy((np.random.RandomState(3).randn(9, 3, 21) * 3).astype(np.float32))
    for a, b in zip(search(x), pdec.CTCPrefixSearch(4)(x)):
        assert torch.equal(a, b)


def test_lm_search_rejects_bad_lms(monkeypatch):
    _, plm = lm_pair(20, 3, 1)
    x = torch.zeros((3, 2, 11))
    with pytest.raises(RuntimeError, match="Expected dim 2"):
        pdec.CTCPrefixSearch(4, 0.5, plm)(x)
    # the gather route checks the vocabulary as well
    monkeypatch.setattr(pconfig, "SPARSE_MEMBERSHIP_GATHER", True)
    with pytest.raises(RuntimeError, match="Expected dim 2"):
        pdec.CTCPrefixSearch(4, 0.5, plm)(x)


def _bias_tie_case():
    """A unigram LM and one frame where token 2's and token 5's biased
    logits tie exactly when ``beta * uni`` is rounded as float32 (beta
    cast, then one float32 product, as JAX's ``beta * uni_dev``), and part
    when the product is rounded in float64 first: beta = 0.3 is not a
    float32, and token 5's unigram makes the two roundings differ."""
    V, beta = 8, 0.3
    uni = np.full((V,), -2.0, np.float32)
    uni[5] = np.float32(-1.8082901)
    g32 = np.float32(beta) * uni  # float32 product
    g64 = (beta * uni.astype(np.float64)).astype(np.float32)
    assert g32[2] == g64[2] and g32[5] < g64[5]
    x = np.full((1, 1, V + 1), -4.0, np.float32)
    x[0, 0, V] = -10.0  # the blank
    # sums near the bias's own magnitude, where its last bit survives
    x[0, 0, 2] = 0.0
    x[0, 0, 5] = g32[2] - g32[5]
    assert x[0, 0, 5] + g32[5] == x[0, 0, 2] + g32[2]
    assert x[0, 0, 5] + g64[5] > x[0, 0, 2] + g64[2]
    pd = [{w: float(uni[w]) for w in range(V)}]
    jlm = jlm_mod.LookupLanguageModel(V, sos=V, prob_dicts=pd)
    plm = plm_mod.LookupLanguageModel(V, sos=V, prob_dicts=pd, device="cpu")
    return x, beta, jlm, plm


def test_lm_bias_is_float32_like_jax(monkeypatch):
    """``g_bias`` must be ``beta * uni`` rounded in float32: bit-equal to
    JAX's, and on this input a float64-rounded bias breaks the tie the
    other way and decodes another best hypothesis than JAX's."""
    x, beta, jlm, plm = _bias_tie_case()
    exp_bias = np.asarray(beta * jnp.asarray(jlm._uni_logp))
    got_bias = pdec._lm_bias(plm._uni_t, beta).numpy()
    np.testing.assert_array_equal(got_bias.view(np.int32), exp_bias.view(np.int32))
    exp = jdec.CTCPrefixSearch(2, beta, jlm)(jnp.asarray(x))
    got = pdec.CTCPrefixSearch(2, beta, plm)(torch.from_numpy(x))
    _compare_search(got, exp)
    assert int(got[0][0, 0, 0]) == 2  # the tie goes to the lower index

    # the same search with the bias rounded in float64 picks token 5 first
    monkeypatch.setattr(
        pdec, "_lm_bias",
        lambda uni, b: (b * uni.double()).float().contiguous(),
    )
    wrong = pdec.CTCPrefixSearch(2, beta, plm)(torch.from_numpy(x))
    assert int(wrong[0][0, 0, 0]) == 5


def test_decode_prologue_with_the_lm_bias_matches_jax():
    """The prologue's plain version with a real LM's bias at M = 2W + C
    (the sparse route's M) against the JAX package's XLA prologue:
    bit-exact top values and indices."""
    pd = random_prob_dicts(64, 3, 12, sos=64, density=0.1)
    jlm = jlm_mod.LookupLanguageModel(64, sos=64, prob_dicts=pd)
    plm = plm_mod.LookupLanguageModel(64, sos=64, prob_dicts=pd, device="cpu")
    M = 2 * 8 + plm.max_corrections
    assert M < 64
    x = (np.random.RandomState(12).randn(6, 3, 65) * 3).astype(np.float32)
    exp = jdec._decode_prologue(jnp.asarray(x), M, 0.5 * jnp.asarray(jlm._uni_logp))
    got = kernels.decode_prologue(torch.from_numpy(x), M, pdec._lm_bias(plm._uni_t, 0.5))
    np.testing.assert_array_equal(got[0].numpy().view(np.int32), np.asarray(exp[0]).view(np.int32))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(exp[1]))


def test_lm_search_with_a_fused_lm_matches_jax():
    """An LM that is not a lookup LM (a mixable shallow fusion of two,
    its state a dict under two prefixes) takes the dense route."""
    ja, pa = lm_pair(20, 3, 1)
    jb, pb = lm_pair(20, 2, 13)
    jf = jlm_mod.MixableShallowFusionLanguageModel(ja, jb, beta=0.4)
    pf = plm_mod.MixableShallowFusionLanguageModel(pa, pb, beta=0.4)
    psearch, got, exp = run_both(jf, pf, 10, 3, 4, seed=14)
    assert psearch.lm_route() == "dense"
    _compare_search(got, exp)


# ---- SPARSE_MEMBERSHIP_GATHER: the bigram-table route ----


def fused_trial(trial, seed0=4100):
    """The draws of tests/test_decoding.py's gather tests (:761-800): V
    4-40, orders 2-4, W 1-8, T 1-11, N 1-3, beta in [0, 2), unscaled
    logits and lengths in [0, T], with the last row's length set to 0 when
    N > 1. Returns the JAX LM, the port's copy (by its state dict), W,
    beta, logits and lengths."""
    rng = np.random.RandomState(seed0 + trial)
    V = int(rng.randint(4, 40))
    Ng = int(rng.randint(2, 5))
    W = int(rng.randint(1, 9))
    T = int(rng.randint(1, 12))
    N = int(rng.randint(1, 4))
    pd = fused_prob_dicts(V, Ng, seed0 + 1000 + trial, density=int(rng.randint(1, 200)))
    beta = float(rng.rand() * 2)
    logits = rng.randn(T, N, V + 1).astype(np.float32)
    lens = rng.randint(0, T + 1, (N,)).astype(np.int32)
    if N > 1:
        lens[-1] = 0
    jlm = jlm_mod.LookupLanguageModel(V, sos=V, prob_dicts=pd)
    plm = plm_mod.LookupLanguageModel(V, sos=V, device="cpu")
    plm.load_state_dict(jlm.state_dict())
    return jlm, plm, W, beta, logits, lens


def both_searches(jlm, plm, W, beta, logits, lens):
    exp = jax.jit(jdec.CTCPrefixSearch(W, beta, jlm))(jnp.asarray(logits), jnp.asarray(lens))
    got = pdec.CTCPrefixSearch(W, beta, plm)(torch.from_numpy(logits), torch.from_numpy(lens))
    return got, exp


@pytest.mark.parametrize("trial", range(6))
def test_gather_route_matches_jax_gather_route(trial, monkeypatch):
    """Random fused LMs with the flag on in both packages: the port's
    gather route against the JAX package's, every frame with the table."""
    set_gather(monkeypatch, True)
    tables = record_tables(monkeypatch)
    jlm, plm, W, beta, logits, lens = fused_trial(trial)
    assert plm.order2_values() is not None
    got, exp = both_searches(jlm, plm, W, beta, logits, lens)
    _compare_search(got, exp)
    assert tables == [True] * logits.shape[0]


def _same_up_to_ties(got, exp, trial):
    """tests/test_decoding.py's criterion (:783-800): sorted probabilities
    within rtol 3e-5, and each real beam of ``exp`` found in ``got`` among
    the beams of nearly equal probability."""
    sy, slens, sprobs = (t.numpy() for t in got)
    dy, dlens, dprobs = (t.numpy() for t in exp)
    np.testing.assert_allclose(np.sort(dprobs, -1), np.sort(sprobs, -1), rtol=3e-5, atol=1e-7)
    N, W = dprobs.shape
    for n in range(N):
        for k in range(W):
            if np.isinf(dprobs[n, k]):
                continue
            L = dlens[n, k]
            ok = any(
                slens[n, kk] == L and (sy[:L, n, kk] == dy[:L, n, k]).all()
                for kk in range(W)
                if abs(sprobs[n, kk] - dprobs[n, k]) < 1e-4 * max(1, abs(dprobs[n, k]))
            )
            assert ok, (trial, n, k, dy[:L, n, k], dprobs[n, k], sprobs[n])


@pytest.mark.parametrize("trial", range(4))
def test_gather_route_matches_compare_route(trial, monkeypatch):
    """The port's gather route against the port's compare route on the
    same inputs, up to ties (the JAX package holds its own two routes to
    this, not bit for bit)."""
    _, plm, W, beta, logits, lens = fused_trial(trial)
    x, n = torch.from_numpy(logits), torch.from_numpy(lens)
    monkeypatch.setattr(pconfig, "SPARSE_MEMBERSHIP_GATHER", False)
    exp = pdec.CTCPrefixSearch(W, beta, plm)(x, n)
    monkeypatch.setattr(pconfig, "SPARSE_MEMBERSHIP_GATHER", True)
    got = pdec.CTCPrefixSearch(W, beta, plm)(x, n)
    _same_up_to_ties(got, exp, trial)


def test_gather_route_without_a_table_takes_the_compare_path(monkeypatch):
    """An LM whose ``order2_values()`` is None (here: more entries than
    ``_DENSE_NGRAM_MAX``, lowered in both packages) takes the compare
    path with the flag on, as in the JAX package."""
    monkeypatch.setattr(jlm_mod.LookupLanguageModel, "_DENSE_NGRAM_MAX", 100)
    monkeypatch.setattr(plm_mod.LookupLanguageModel, "_DENSE_NGRAM_MAX", 100)
    set_gather(monkeypatch, True)
    tables = record_tables(monkeypatch)
    pd = random_prob_dicts(20, 3, 1, sos=20)
    jlm = jlm_mod.LookupLanguageModel(20, sos=20, prob_dicts=pd)
    plm = plm_mod.LookupLanguageModel(20, sos=20, device="cpu")
    plm.load_state_dict(jlm.state_dict())
    assert plm.order2_values() is None and jlm.order2_values() is None
    psearch, got, exp = run_both(jlm, plm, 10, 3, 4, seed=31)
    assert psearch.lm_route() == "sparse"
    _compare_search(got, exp)
    assert tables == [False] * 10


# case -> (T, lengths, W): the first frame alone (every context sos),
# rows frozen at 1 and 5 of 12 frames, and W above V + 1 (placeholder
# beams whose contexts come from invalid correction slots)
GATHER_EDGES = {
    "sos": (1, [0, 1, 1], 4),
    "frozen": (12, [0, 1, 5, 12], 4),
    "placeholders": (9, [9, 3, 0], 25),
}


@pytest.mark.parametrize("case", sorted(GATHER_EDGES))
def test_gather_route_edge_contexts_match_jax(case, monkeypatch):
    """The contexts the gather indexes with: each order-1 context is a
    token below V or sos (= V), so every index lies in the ``(V + 1) * V``
    table; the searches equal the JAX package's gather route."""
    T, lens, W = GATHER_EDGES[case]
    set_gather(monkeypatch, True)
    contexts = []
    tables = record_tables(monkeypatch, contexts)
    jlm, plm = lm_pair(20, 3, 1)
    lens = np.asarray(lens, np.int32)
    _, got, exp = run_both(jlm, plm, T, len(lens), W, seed=40 + T, lens=lens)
    _compare_search(got, exp)
    assert tables == [True] * T
    c1 = torch.cat([c.reshape(-1) for c in contexts])
    assert int(c1.min()) >= 0 and int(c1.max()) <= plm.sos
    assert plm.order2_values().shape == ((plm.sos + 1) * 20,)
    # the first frame reads sos only
    assert bool((contexts[0] == plm.sos).all())
