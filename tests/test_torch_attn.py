"""The port's attention modules against the JAX package's flax modules on
the same numpy inputs and weights: every class, with masks (a fully
masked row gives NaN in both), broadcast query and key shapes and the
sequence axis first, inner and negative. Outputs within atol 1e-6 and
rtol 1e-6; NaN exactly where JAX has NaN. The checks on shapes and
``dim`` raise in both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydrobert_tpu.ops import attn as jattn
from pydrobert_tpu_torch.ops import attn as pattn

TOL = dict(rtol=1e-6, atol=1e-6)


def load_flax(module, params):
    """Copy a flax parameter tree onto the port's module: a dense's
    ``(in, out)`` kernel becomes a Linear's ``(out, in)`` weight."""
    sd = {}

    def walk(prefix, d):
        for k, v in d.items():
            name = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(name + ".", v)
            elif k == "kernel":
                sd[f"{prefix}weight"] = torch.tensor(np.asarray(v).T)
            else:
                sd[name] = torch.tensor(np.asarray(v))

    walk("", params)
    module.load_state_dict(sd, strict=True)
    return module


def inputs(seed, q_shape, k_shape, v_last, mask_shape=None, dead_row=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(*q_shape).astype(np.float32)
    k = rng.randn(*k_shape).astype(np.float32)
    v = rng.randn(*(k_shape[:-1] + (v_last,))).astype(np.float32)
    mask = None
    if mask_shape is not None:
        mask = rng.rand(*mask_shape) > 0.3
        if dead_row is not None:
            mask[dead_row] = False
    return q, k, v, mask


def run_both(jmod, pmod, q, k, v, mask, init_key=0):
    jargs = [jnp.asarray(a) for a in (q, k, v)] + [None if mask is None else jnp.asarray(mask)]
    params = jmod.init(jax.random.PRNGKey(init_key), *jargs)
    exp = np.asarray(jmod.apply(params, *jargs))
    if params:
        load_flax(pmod, params["params"])
    pargs = [torch.from_numpy(a) for a in (q, k, v)] + [
        None if mask is None else torch.from_numpy(mask)
    ]
    with torch.no_grad():
        got = pmod(*pargs).numpy()
    return got, exp


def assert_same(got, exp):
    assert got.shape == exp.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    np.testing.assert_allclose(got, exp, **TOL)


# (query shape, key shape, value size, mask shape, dim, fully masked row)
CASES = [
    ((4, 6), (9, 4, 6), 5, (9, 4), 0, (slice(None), 2)),
    ((4, 6), (4, 9, 6), 3, (4, 9), 1, (1,)),
    ((2, 1, 6), (9, 2, 3, 6), 4, (9, 2, 3), 0, None),
    ((3, 6), (3, 7, 6), 2, (3, 7), -2, (2,)),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_dot_product_matches_jax(case):
    qs, ks, vl, ms, dim, dead = CASES[case]
    q, k, v, mask = inputs(case, qs, ks, vl, ms, dead)
    jmod = jattn.DotProductSoftAttention(size=6, dim=dim, scale_factor=0.5)
    pmod = pattn.DotProductSoftAttention(size=6, dim=dim, scale_factor=0.5)
    got, exp = run_both(jmod, pmod, q, k, v, mask)
    if dead is not None:
        assert np.isnan(exp).any()
    assert_same(got, exp)


@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_generalized_dot_product_matches_jax(case, use_bias):
    qs, ks, vl, ms, dim, dead = CASES[case]
    q, k, v, mask = inputs(10 + case, qs[:-1] + (5,), ks, vl, ms, dead)
    jmod = jattn.GeneralizedDotProductSoftAttention(
        query_size=5, key_size=6, dim=dim, use_bias=use_bias
    )
    pmod = pattn.GeneralizedDotProductSoftAttention(5, 6, dim, use_bias=use_bias)
    got, exp = run_both(jmod, pmod, q, k, v, mask)
    assert_same(got, exp)


@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_concat_matches_jax(case, use_bias):
    qs, ks, vl, ms, dim, dead = CASES[case]
    q, k, v, mask = inputs(20 + case, qs[:-1] + (5,), ks, vl, ms, dead)
    jmod = jattn.ConcatSoftAttention(
        query_size=5, key_size=6, dim=dim, use_bias=use_bias, hidden_size=7
    )
    pmod = pattn.ConcatSoftAttention(5, 6, dim, use_bias=use_bias, hidden_size=7)
    got, exp = run_both(jmod, pmod, q, k, v, mask)
    assert_same(got, exp)


@pytest.mark.parametrize(
    "single,biases",
    [("dot", (False,) * 4), ("general", (True, False, True, False)), ("concat", (True,) * 4)],
)
def test_multi_headed_matches_jax(single, biases):
    """Three heads over a (T, N) key with a mask whose last utterance is
    all masked (NaN there in both); the single head's parameters ride in
    its own subtree."""
    nh, d_q, d_k = 3, 4, 4
    if single == "dot":
        jsha = jattn.DotProductSoftAttention(size=d_q, dim=0)
        psha = pattn.DotProductSoftAttention(size=d_q, dim=0)
    elif single == "general":
        jsha = jattn.GeneralizedDotProductSoftAttention(query_size=d_q, key_size=d_k, dim=0)
        psha = pattn.GeneralizedDotProductSoftAttention(d_q, d_k, 0)
    else:
        jsha = jattn.ConcatSoftAttention(query_size=d_q, key_size=d_k, dim=0, hidden_size=5)
        psha = pattn.ConcatSoftAttention(d_q, d_k, 0, hidden_size=5)
    bq, bk, bv, bc = biases
    jmod = jattn.MultiHeadedAttention(
        query_size=6, key_size=7, value_size=8, num_heads=nh, single_head_attention=jsha,
        out_size=5, bias_WQ=bq, bias_WK=bk, bias_WV=bv, bias_WC=bc,
    )
    pmod = pattn.MultiHeadedAttention(
        6, 7, 8, nh, psha, out_size=5, bias_WQ=bq, bias_WK=bk, bias_WV=bv, bias_WC=bc
    )
    rng = np.random.RandomState(30)
    q = rng.randn(4, 6).astype(np.float32)
    k = rng.randn(9, 4, 7).astype(np.float32)
    v = rng.randn(9, 4, 8).astype(np.float32)
    mask = rng.rand(9, 4) > 0.3
    mask[:, 3] = False
    got, exp = run_both(jmod, pmod, q, k, v, mask)
    assert np.isnan(exp[3]).all() and not np.isnan(exp[:3]).any()
    assert_same(got, exp)


@pytest.mark.parametrize(
    "q_shape,k_shape,dim",
    [
        ((4, 6), (9, 4, 5, 6), 0),  # query one dimension short
        ((4, 5), (9, 4, 6), 0),  # query size
        ((4, 6), (9, 4, 6), -1),  # the feature axis
        ((4, 6), (9, 4, 6), 2),
        ((4, 6), (9, 4, 6), -3),
        ((3, 6), (9, 4, 6), 0),  # no broadcast
    ],
)
def test_bad_inputs_raise_in_both(q_shape, k_shape, dim):
    q, k, v, _ = inputs(40, q_shape, k_shape, 2)
    jmod = jattn.DotProductSoftAttention(size=6, dim=dim)
    pmod = pattn.DotProductSoftAttention(size=6, dim=dim)
    with pytest.raises(ValueError):
        jmod.apply({}, *(jnp.asarray(a) for a in (q, k, v)))
    with pytest.raises((ValueError, RuntimeError)):
        pmod(*(torch.from_numpy(a) for a in (q, k, v)))


def test_multi_headed_rejects_a_negative_dim():
    with pytest.raises(ValueError):
        pattn.MultiHeadedAttention(6, 6, 6, 2, pattn.DotProductSoftAttention(size=3, dim=-2))
