"""The port's language models (pydrobert_tpu_torch.lm, its state utilities
and its ARPA parser) against the JAX package's.

The port LM is built from the same prob_dicts and, separately, carried
across by the JAX LM's ``state_dict()``. Its tables must equal the JAX
LM's array for array; its scores (``calc_idx_log_probs``,
``calc_full_log_probs``, ``calc_full_log_probs_chunked``,
``score_sequences``) and sparse corrections must agree within rtol 1e-6
(they are in fact bit-equal: the same float32 sums in the same order), and
the hash-probing normalizer, a sum over the correction lists in another
order, within rtol 1e-6 and atol 1e-6. Integer and boolean outputs are
exact.
"""

import gzip
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydrobert_tpu.lm as jlm_mod
import pydrobert_tpu_torch.lm as plm_mod
from pydrobert_tpu.data import parse_arpa_lm as jparse
from pydrobert_tpu.utils import pytree as jtree
from pydrobert_tpu_torch.data import parse_arpa_lm as pparse
from pydrobert_tpu_torch.utils import pytree as ptree

from _lm_dicts import random_prob_dicts

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
RTOL = 1e-6


# (V, max_ngram, seed, probing): "dense" keeps every order's direct table
# (and the combined sparse path); "mixed" is a 5-gram over V=40, whose
# order-4 contexts (41**4 > 2**21 rows) only have the probing table;
# "probing" forces the probing table at every order, as tests/test_lm.py
# does, by lowering _DENSE_CTX_MAX_ROWS in both packages
LMS = {
    "unigram": (12, 1, 2, False),
    "dense": (9, 3, 1, False),
    "dense4": (20, 4, 3, False),
    "mixed": (40, 5, 4, False),
    "probing": (9, 3, 5, True),
}


def build_pair(V, N, seed, probing):
    """The JAX LM, the port's build of the same prob_dicts, and a port LM
    carried across by the JAX LM's state dict. The layout is fixed at
    build (and load) time, so the forced probing bound is lifted after."""
    pd = random_prob_dicts(V, N, seed, sos=V)
    with pytest.MonkeyPatch.context() as mp:
        if probing:
            mp.setattr(jlm_mod, "_DENSE_CTX_MAX_ROWS", 0)
            mp.setattr(plm_mod, "_DENSE_CTX_MAX_ROWS", 0)
        jlm = jlm_mod.LookupLanguageModel(V, sos=V, prob_dicts=[d.copy() for d in pd])
        built = plm_mod.LookupLanguageModel(V, sos=V, prob_dicts=pd, device="cpu")
        carried = plm_mod.LookupLanguageModel(V, sos=V, device="cpu")
        carried.load_state_dict(jlm.state_dict())
    return jlm, built, carried


@pytest.fixture(scope="module", params=sorted(LMS))
def lms(request):
    return (request.param,) + build_pair(*LMS[request.param])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_close(got, exp, atol=0.0):
    got, exp = _np(got), _np(exp)
    assert got.shape == exp.shape, (got.shape, exp.shape)
    if exp.dtype.kind == "f" or got.dtype.kind == "f":
        np.testing.assert_allclose(got, exp, rtol=RTOL, atol=atol)
    else:
        np.testing.assert_array_equal(got, exp)


def test_build_matches_jax_tables(lms):
    """The port's build gives the JAX LM's state dict, array for array
    (the same hash slots, probe counts, child lists and normalizers)."""
    _, jlm, built, carried = lms
    exp = jlm.state_dict()
    for lm in (built, carried):
        got = lm.state_dict()
        assert sorted(got) == sorted(exp)
        for k in exp:
            np.testing.assert_array_equal(got[k], exp[k], err_msg=k)
            assert got[k].dtype == np.asarray(exp[k]).dtype, k
        assert lm.max_corrections == jlm.max_corrections
        assert (lm._combined_tables() is None) == (jlm._combined_tables() is None)
        o2, e2 = lm.order2_values(), jlm.order2_values()
        assert (o2 is None) == (e2 is None)
        if e2 is not None:
            np.testing.assert_array_equal(o2, e2)


def test_log_probs_match_jax(lms):
    name, jlm, built, carried = lms
    V = jlm.vocab_size
    rng = np.random.RandomState(7)
    S, B = 7, 5
    hist = rng.randint(0, V, (S, B))
    hist[:, 0] = V - 1  # a row with one token throughout
    full = np.asarray(jlm(jnp.asarray(hist)))
    idx = rng.randint(0, S + 1, (B,))
    by_idx, _ = jlm.calc_idx_log_probs(jnp.asarray(hist), {}, jnp.asarray(idx))
    scored = jlm.score_sequences(jnp.asarray(hist))
    chunked = jlm.calc_full_log_probs_chunked(jnp.asarray(hist), {}, 3)
    for lm in (built, carried):
        th = torch.from_numpy(hist)
        assert_close(lm(th), full)
        assert_close(lm(th, idx=3)[0], full[3])
        assert_close(lm(th, idx=-1)[0], full[S])
        assert_close(lm.calc_idx_log_probs(th, {}, torch.from_numpy(idx))[0], by_idx)
        assert_close(lm.score_sequences(th), scored)
        assert_close(lm.calc_full_log_probs_chunked(th, {}, 3), chunked)
        assert_close(lm.calc_full_log_probs_chunked(th, {}, 100), full)
    if name == "dense":
        # out-of-vocabulary ids (padding) score -inf, as in JAX
        hist[2, 1], hist[4, 3] = -1, V + 3
        assert_close(
            built.score_sequences(torch.from_numpy(hist)),
            jlm.score_sequences(jnp.asarray(hist)),
        )


def test_empty_history_matches_jax(lms):
    _, jlm, built, _ = lms
    hist = np.zeros((0, 3), np.int64)
    assert_close(built(torch.from_numpy(hist)), jlm(jnp.asarray(hist)))
    assert_close(built.score_sequences(torch.from_numpy(hist)), jlm.score_sequences(jnp.asarray(hist)))


def test_sparse_corrections_match_jax(lms):
    """Both layouts (the combined dense rows with their shadow bits, and
    the hash-probing fallback), with batch dims kept, out-of-range context
    ids, and contexts given as a per-order list."""
    name, jlm, _, carried = lms
    N = jlm.max_ngram
    if N == 1:
        with pytest.raises(RuntimeError):
            carried.sparse_corrections(torch.zeros((0, 2), dtype=torch.long))
        return
    V = jlm.vocab_size
    rng = np.random.RandomState(11)
    ctx = rng.randint(-1, V + 2, (N - 1, 4, 3))
    ctx[:, 0, 0] = V  # the all-sos context
    exp = jlm.sparse_corrections_ext(jnp.asarray(ctx))
    for got in (
        carried.sparse_corrections_ext(torch.from_numpy(ctx)),
        carried.sparse_corrections_ext([torch.from_numpy(c) for c in ctx]),
    ):
        probing = jlm._combined_tables() is None
        for i, (g, e) in enumerate(zip(got[:6], exp[:6])):
            # the probing normalizer sums the lists in another order
            assert_close(g, e, atol=1e-6 if (probing and i == 4) else 0.0)
        np.testing.assert_array_equal(got[6], exp[6])
    no_z = carried.sparse_corrections(torch.from_numpy(ctx), want_logz=False)
    assert no_z[4] is None
    assert_close(no_z[1], exp[1])


def test_legacy_state_dict_loads_like_jax():
    """A state dict saved before stored normalizers (no ``ctx{i}_logz``)
    loads with a warning and gets the same normalizers the JAX load
    recomputes, and the combined dense path back."""
    jlm, _, _ = build_pair(*LMS["dense4"])
    legacy = {k: v for k, v in jlm.state_dict().items() if "_logz" not in k}
    jfresh = jlm_mod.LookupLanguageModel(jlm.vocab_size, sos=jlm.sos)
    with pytest.warns(UserWarning, match="predates stored"):
        jfresh.load_state_dict(legacy)
    fresh = plm_mod.LookupLanguageModel(jlm.vocab_size, sos=jlm.sos, device="cpu")
    with pytest.warns(UserWarning, match="predates stored"):
        fresh.load_state_dict(legacy)
    assert fresh._combined_tables() is not None
    for t, e in zip(fresh._ctx_tables, jfresh._ctx_tables):
        np.testing.assert_array_equal(t.logz_slot, e.logz_slot)
    ctx = np.random.RandomState(2).randint(0, jlm.vocab_size, (3, 6))
    for g, e in zip(
        fresh.sparse_corrections(torch.from_numpy(ctx)),
        jfresh.sparse_corrections(jnp.asarray(ctx)),
    ):
        assert_close(g, e)
    hist = np.random.RandomState(3).randint(0, jlm.vocab_size, (6, 4))
    assert_close(fresh(torch.from_numpy(hist)), jlm(jnp.asarray(hist)))


def test_fnv_hash_matches_uint32_numpy():
    """The int64 hashing that picks probe slots equals the numpy uint32
    hash the build uses, across the whole uint32 range and negative ids."""
    rng = np.random.RandomState(0)
    h = rng.randint(0, 2**32, 2000, dtype=np.uint64).astype(np.uint32)
    x = rng.randint(-(2**31), 2**31, 2000).astype(np.int64)
    h[:4] = [0, 1, 2**32 - 1, 2**31]
    x[:4] = [0, -1, 2**31 - 1, -(2**31)]
    exp_mix = plm_mod._fnv_mix_np(h, x.astype(np.int32))
    exp_fin = plm_mod._fnv_fin_np(h)
    th = torch.from_numpy(h.astype(np.int64))
    got_mix = plm_mod._fnv_mix_t(th, torch.from_numpy(x))
    got_fin = plm_mod._fnv_fin_t(th)
    np.testing.assert_array_equal(got_mix.numpy(), exp_mix.astype(np.int64))
    np.testing.assert_array_equal(got_fin.numpy(), exp_fin.astype(np.int64))
    # the JAX package's device hash
    np.testing.assert_array_equal(
        np.asarray(jlm_mod._fnv_fin_jnp(jlm_mod._fnv_mix_jnp(jnp.asarray(h), jnp.asarray(x, jnp.int32)))),
        plm_mod._fnv_fin_t(got_mix).numpy().astype(np.uint32),
    )


def test_shallow_fusion_matches_jax():
    ja, pa, _ = build_pair(*LMS["dense"])
    pd = random_prob_dicts(9, 2, 8, sos=9)
    jb = jlm_mod.LookupLanguageModel(9, sos=9, prob_dicts=[d.copy() for d in pd])
    pb = plm_mod.LookupLanguageModel(9, sos=9, prob_dicts=pd, device="cpu")
    jf = jlm_mod.MixableShallowFusionLanguageModel(ja, jb, beta=0.3)
    pf = plm_mod.MixableShallowFusionLanguageModel(pa, pb, beta=0.3)
    hist = np.random.RandomState(4).randint(0, 9, (5, 3))
    assert_close(pf(torch.from_numpy(hist)), jf(jnp.asarray(hist)))
    lp, state = pf(torch.from_numpy(hist), idx=2)
    assert_close(lp, jf(jnp.asarray(hist), idx=2)[0])
    assert state == {}
    assert pf.extract_by_src({}, torch.tensor([0])) == {}
    assert pf.mix_by_mask({}, {}, torch.tensor([True])) == {}
    with pytest.raises(ValueError, match="cannot match"):
        plm_mod.ShallowFusionLanguageModel(pa, pb, first_prefix="a", second_prefix="a")
    with pytest.raises(RuntimeError, match="does not start"):
        pf.split_dicts({"third.x": 0})


def test_state_utilities_match_jax():
    rng = np.random.RandomState(5)
    state = {"a": rng.randn(6, 3).astype(np.float32), "b": {"c": rng.randint(0, 9, (6,))},
             "s": np.float32(2.0), "l": [rng.randn(6).astype(np.float32)]}
    other = jax.tree.map(lambda x: np.asarray(x) + 1, state)
    src = np.array([5, 0, 0, 2])
    mask = rng.rand(6) < 0.5
    pstate = ptree.tree_map(torch.as_tensor, state)
    pother = ptree.tree_map(torch.as_tensor, other)
    for got, exp in (
        (ptree.extract_by_src(pstate, torch.from_numpy(src)), jtree.extract_by_src(state, jnp.asarray(src))),
        (ptree.mix_by_mask(pstate, pother, torch.from_numpy(mask)), jtree.mix_by_mask(state, other, jnp.asarray(mask))),
    ):
        jax.tree.map(lambda g, e: np.testing.assert_array_equal(_np(g), _np(e)), got, exp)
    lens = rng.randint(0, 5, (3, 2))
    for axis in (-1, 0, 1):
        np.testing.assert_array_equal(
            ptree.lengths_to_mask(torch.from_numpy(lens), 5, axis).numpy(),
            np.asarray(jtree.lengths_to_mask(jnp.asarray(lens), 5, axis)),
        )


def test_lm_device_defaults_to_cuda():
    """An LM with no device asks for the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plm_mod.LookupLanguageModel(4, sos=4)


ARPA = """
\\data\\
ngram 1=5
ngram 2=4
ngram 3=2

\\1-grams:
-1.0 <unk> -0.3
-99 <s> -0.5
-0.7 </s>
-0.4 a -0.2
-0.6 b

\\2-grams:
-0.2 <s> a -0.1
-0.3 a b
-0.5 b </s>
-0.25 a a 0.05

\\3-grams:
-0.1 <s> a b
-0.15 a a b

\\end\\
"""


@pytest.mark.parametrize("to_base_e", [False, True])
@pytest.mark.parametrize("ids", [False, True])
def test_parse_arpa_lm_matches_jax(to_base_e, ids):
    """Implicit backoffs, a positive backoff, <s> at -99, ids or tokens."""
    token2id = {"<unk>": 0, "</s>": 1, "a": 2, "b": 3, "<s>": 4} if ids else None
    exp = jparse(io.StringIO(ARPA), token2id, to_base_e=to_base_e)
    got = pparse(io.StringIO(ARPA), token2id, to_base_e=to_base_e)
    assert got == exp
    if ids:
        lm = plm_mod.LookupLanguageModel(4, sos=4, prob_dicts=got, device="cpu")
        jlm = jlm_mod.LookupLanguageModel(4, sos=4, prob_dicts=exp)
        hist = np.array([[2, 3], [2, 2], [3, 2]])
        assert_close(lm(torch.from_numpy(hist)), jlm(jnp.asarray(hist)))


def test_parse_arpa_lm_rejects_like_jax():
    with pytest.raises(IOError, match="data"):
        pparse(io.StringIO("nothing here\n"), to_base_e=True)
    with pytest.raises(IOError, match="end"):
        pparse(io.StringIO(ARPA.replace("\\end\\", "")), to_base_e=True)
    with pytest.raises(IOError, match="Expected 5"):
        pparse(io.StringIO(ARPA.replace("-0.6 b\n", "")), to_base_e=True)
    with pytest.warns(UserWarning, match="to_base_e"):
        pparse(io.StringIO(ARPA))


def test_parse_big5_arpa_matches_jax():
    """The committed 5-gram / 10,240-token fixture: every key and value of
    every order equal to the JAX parser's."""
    sys.path.insert(0, FIXTURES)
    try:
        import gen_big_arpa as G
    finally:
        sys.path.remove(FIXTURES)
    token2id = G.token2id()
    with gzip.open(G.OUT, "rt") as f:
        exp = jparse(f, token2id, to_base_e=True, ftype=np.float32)
    with gzip.open(G.OUT, "rt") as f:
        got = pparse(f, token2id, to_base_e=True, ftype=np.float32)
    assert len(got) == len(exp) == 5
    for n, (g, e) in enumerate(zip(got, exp), start=1):
        assert g.keys() == e.keys(), f"order {n}"
        assert all(
            np.array_equal(np.asarray(g[k], np.float32), np.asarray(e[k], np.float32))
            for k in e
        ), f"order {n}"
