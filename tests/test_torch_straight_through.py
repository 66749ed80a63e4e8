"""The port's relaxed distributions (pydrobert_tpu_torch.ops.straight_through)
against the JAX package's. Both draw uniforms: the JAX package from a key,
the port from a generator. The tests draw JAX's uniforms from its key as
its own methods do and feed them to the port, so samples, densities and the
straight-through gradients are compared on the same draws, within rtol 1e-6
and atol 1e-6; thresholds (0/1 and one-hot samples) are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydrobert_tpu.ops import straight_through as jst
from pydrobert_tpu_torch.ops import straight_through as pst

SHAPE = (5, 7)


def _close(got, exp):
    exp = np.asarray(exp)
    assert tuple(got.shape) == exp.shape
    np.testing.assert_allclose(got.detach().numpy(), exp, rtol=1e-6, atol=1e-6)


def _params(seed, kind):
    rng = np.random.RandomState(seed)
    if kind == "logits":
        return (rng.randn(*SHAPE) * 2).astype(np.float32)
    p = rng.rand(*SHAPE).astype(np.float32)
    p[0, 0], p[0, 1] = 0.0, 1.0  # clamped
    return p


def _pair(cls, kind, x):
    return (getattr(jst, cls)(**{kind: jnp.asarray(x)}),
            getattr(pst, cls)(**{kind: torch.from_numpy(x)}))


@pytest.mark.parametrize("kind", ["logits", "probs"])
def test_logistic_bernoulli_matches_jax(kind):
    jd, pd = _pair("LogisticBernoulli", kind, _params(1, kind))
    for name in ("logits", "probs", "mean", "stddev", "variance"):
        _close(getattr(pd, name), getattr(jd, name))
    _close(pd.entropy(), jd.entropy())
    assert tuple(pd.batch_shape) == jd.batch_shape and tuple(pd.event_shape) == ()
    key = jax.random.PRNGKey(3)
    z_j = jd.rsample(key, (2,))
    u = np.array(jax.random.uniform(key, (2,) + SHAPE, jnp.float32))
    z_p = pd.rsample((2,), u=torch.from_numpy(u))
    _close(z_p, z_j)
    _close(pd.log_prob(z_p), jd.log_prob(z_j))
    b_j, b_p = jd.threshold(z_j), pd.threshold(z_p)
    np.testing.assert_array_equal(b_p.numpy(), np.asarray(b_j))
    _close(pd.tlog_prob(b_p), jd.tlog_prob(b_j))
    key2 = jax.random.PRNGKey(4)
    zc_j = jd.csample(key2, b_j)
    v = np.array(jax.random.uniform(key2, b_j.shape, jnp.float32))
    zc_p = pd.csample(b_p, u=torch.from_numpy(v))
    _close(zc_p, zc_j)
    np.testing.assert_array_equal(pd.threshold(zc_p).numpy(), b_p.numpy())
    _close(pd.clog_prob(zc_p, b_p), jd.clog_prob(zc_j, b_j))
    # a conditional sample of the other value has zero probability
    assert bool(torch.isneginf(pd.clog_prob(zc_p, 1 - b_p)).all())
    assert bool(jnp.isneginf(jd.clog_prob(zc_j, 1 - b_j)).all())


@pytest.mark.parametrize("kind", ["logits", "probs"])
def test_gumbel_one_hot_categorical_matches_jax(kind):
    x = _params(2, kind)
    if kind == "probs":
        x = x + 0.05
    jd, pd = _pair("GumbelOneHotCategorical", kind, x)
    for name in ("logits", "probs", "mean", "stddev", "variance"):
        _close(getattr(pd, name), getattr(jd, name))
    _close(pd.entropy(), jd.entropy())
    assert tuple(pd.batch_shape) == jd.batch_shape and tuple(pd.event_shape) == jd.event_shape
    key = jax.random.PRNGKey(5)
    z_j = jd.rsample(key, (3,))
    u = np.array(jax.random.uniform(key, (3,) + SHAPE, jnp.float32))
    z_p = pd.rsample((3,), u=torch.from_numpy(u))
    _close(z_p, z_j)
    _close(pd.log_prob(z_p), jd.log_prob(z_j))
    b_j, b_p = jd.threshold(z_j), pd.threshold(z_p)
    np.testing.assert_array_equal(b_p.numpy(), np.asarray(b_j))
    _close(pd.tlog_prob(b_p), jd.tlog_prob(b_j))
    key2 = jax.random.PRNGKey(6)
    zc_j = jd.csample(key2, b_j)
    v = np.array(jax.random.uniform(key2, b_j.shape, jnp.float32))
    zc_p = pd.csample(b_p, u=torch.from_numpy(v))
    _close(zc_p, zc_j)
    np.testing.assert_array_equal(pd.threshold(zc_p).numpy(), b_p.numpy())
    _close(pd.clog_prob(zc_p, b_p), jd.clog_prob(zc_j, b_j))
    other = torch.roll(b_p, 1, -1)
    assert bool(torch.isneginf(pd.clog_prob(zc_p, other)).all())


@pytest.mark.parametrize("cls", ["LogisticBernoulli", "GumbelOneHotCategorical"])
def test_straight_through_gradient_matches_jax(cls):
    """d/dlogits of a weighted sum of the straight-through sample, and of
    the REBAR terms (``log_prob`` of the relaxed sample, ``clog_prob`` of
    the conditional one), on the same uniforms."""
    logits = _params(3, "logits")
    weights = np.random.RandomState(4).randn(*SHAPE).astype(np.float32)
    key, key2 = jax.random.PRNGKey(7), jax.random.PRNGKey(8)
    u = np.array(jax.random.uniform(key, SHAPE, jnp.float32))
    v = np.array(jax.random.uniform(key2, SHAPE, jnp.float32))

    def jfn(lg):
        d = getattr(jst, cls)(logits=lg)
        z = d.rsample(key)
        b = d.threshold(z, straight_through=True)
        zc = d.csample(key2, jax.lax.stop_gradient(b))
        return ((b * jnp.asarray(weights)).sum() + d.log_prob(z).sum()
                + d.clog_prob(zc, jax.lax.stop_gradient(b)).sum())

    lg = torch.from_numpy(logits).requires_grad_(True)
    d = getattr(pst, cls)(logits=lg)
    z = d.rsample(u=torch.from_numpy(u))
    b = d.threshold(z, straight_through=True)
    zc = d.csample(b.detach(), u=torch.from_numpy(v))
    got = (b * torch.from_numpy(weights)).sum() + d.log_prob(z).sum() + d.clog_prob(zc, b.detach()).sum()
    exp = jfn(jnp.asarray(logits))
    np.testing.assert_allclose(got.item(), float(exp), rtol=1e-6, atol=1e-5)
    got.backward()
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(jax.grad(jfn)(jnp.asarray(logits))),
                               rtol=1e-6, atol=1e-6)


def test_protocols_are_duck_typed():
    for cls in (pst.LogisticBernoulli, pst.GumbelOneHotCategorical):
        assert issubclass(cls, pst.Density)
        assert issubclass(cls, pst.StraightThrough)
        assert issubclass(cls, pst.ConditionalStraightThrough)

    class OnlyDensity:
        def log_prob(self, x):
            return x

    class NoThreshold:
        log_prob = rsample = tlog_prob = csample = clog_prob = lambda self: None

    class Masked(pst.LogisticBernoulli):
        csample = None

    assert issubclass(OnlyDensity, pst.Density)
    assert not issubclass(OnlyDensity, pst.StraightThrough)
    assert not issubclass(NoThreshold, pst.StraightThrough)
    assert issubclass(Masked, pst.StraightThrough)
    assert not issubclass(Masked, pst.ConditionalStraightThrough)
    for mod in (jst, pst):
        with pytest.raises(ValueError):
            mod.LogisticBernoulli()
        with pytest.raises(ValueError):
            mod.GumbelOneHotCategorical(logits=np.float32(1.0))


def test_sampling_follows_its_generator():
    """The same generator seed gives the same draws; uniforms of the wrong
    shape are refused."""
    d = pst.GumbelOneHotCategorical(logits=torch.from_numpy(_params(5, "logits")))
    a = d.rsample((2,), generator=torch.Generator().manual_seed(1))
    b = d.rsample((2,), generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.shape == (2,) + SHAPE
    lb = pst.LogisticBernoulli(logits=torch.zeros(SHAPE))
    bits = lb.threshold(lb.rsample((400,), generator=torch.Generator().manual_seed(2)))
    assert abs(float(bits.mean()) - 0.5) < 0.02
    with pytest.raises(ValueError):
        lb.rsample(u=torch.rand(3))


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_gumbel_half_precision_logits_match_jax(dtype):
    """``GumbelOneHotCategorical(logits=)`` normalizes with jax.nn's
    rounding steps in the logits' dtype (ROADMAP C7): float16 bit-exact,
    bfloat16 within one bfloat16 ulp (XLA and PyTorch still round a few
    bfloat16 steps apart)."""
    x = (np.random.RandomState(6).randn(20, 37) * 3).astype(np.float32)
    exp = jst.GumbelOneHotCategorical(logits=jnp.asarray(x).astype(getattr(jnp, dtype))).logits
    got = pst.GumbelOneHotCategorical(logits=torch.from_numpy(x).to(getattr(torch, dtype))).logits
    assert got.dtype == getattr(torch, dtype)
    got, exp = got.float().numpy(), np.asarray(exp.astype(jnp.float32))
    if dtype == "float16":
        np.testing.assert_array_equal(got, exp)
    else:  # one bfloat16 ulp: float32's spacing times 2 ** 16
        assert (np.abs(got - exp) <= np.spacing(np.abs(exp)) * 2.0**16).all()
