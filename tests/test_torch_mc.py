"""The port's estimators (pydrobert_tpu_torch.ops.mc, and the deprecated
functional interface of pydrobert_tpu_torch.estimators) against the JAX
package's, on the same draws: the tests draw the JAX package's uniforms
from its keys as its own methods do and hand them to the port's proposals,
which take them in place of a generator. Values, gradients with respect to
the proposal's logits and relax_variance_loss's control-variate gradients
agree within rtol 1e-5 and atol 1e-6 (float32 sums in another order);
thresholded samples are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydrobert_tpu import estimators as jest
from pydrobert_tpu.ops import mc as jmc
from pydrobert_tpu.ops import straight_through as jst
from pydrobert_tpu_torch import estimators as pest
from pydrobert_tpu_torch.ops import mc as pmc
from pydrobert_tpu_torch.ops import straight_through as pst

B, V, MC = (3,), 5, 4
RTOL, ATOL = 1e-5, 1e-6


def _close(got, exp, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(exp), rtol=rtol, atol=atol)


def _unif(key, shape):
    return np.array(jax.random.uniform(key, shape, jnp.float32))


def _t(x, grad=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=grad)


# ---- proposals drawn from given uniforms ----


class JBern:
    """A Bernoulli proposal for the JAX estimators."""

    def __init__(self, logits):
        self.logits = logits
        self.batch_shape, self.event_shape = logits.shape[:-1], logits.shape[-1:]

    def sample(self, key, shape=()):
        u = jax.random.uniform(key, tuple(shape) + self.logits.shape)
        return (u < jax.nn.sigmoid(self.logits)).astype(jnp.float32)

    def log_prob(self, b):
        return (b * self.logits - jax.nn.softplus(self.logits)).sum(-1)


class PBern:
    """Its port twin: ``sample`` returns the next of the given uniforms'
    thresholds."""

    def __init__(self, logits, *us):
        self.logits, self.us = logits, list(us)
        self.batch_shape, self.event_shape = logits.shape[:-1], logits.shape[-1:]

    def sample(self, shape=(), generator=None):
        u = torch.tensor(self.us.pop(0))
        assert tuple(u.shape) == tuple(shape) + tuple(self.logits.shape)
        return (u < torch.sigmoid(self.logits)).float()

    def log_prob(self, b):
        return (b * self.logits - torch.nn.functional.softplus(self.logits)).sum(-1)


def _given(cls, u_z=None, u_c=None):
    """A port straight-through distribution whose draws are the given
    uniforms."""

    class Given(getattr(pst, cls)):
        def rsample(self, sample_shape=(), generator=None, u=None):
            return super().rsample(sample_shape, u=torch.from_numpy(u_z))

        sample = rsample

        def csample(self, b, generator=None, u=None):
            return super().csample(b, u=torch.from_numpy(u_c))

    return Given


def _logits(seed, shape=B + (V,), scale=1.5):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


W = np.linspace(-1.0, 2.0, V).astype(np.float32)


def _jfunc(b):
    return (b * W).sum(-1)


def _pfunc(b):
    return (b * torch.from_numpy(W)).sum(-1)


# LogisticBernoulli's batch is the whole of the logits' shape: functions of
# its samples are taken elementwise
FUNCS = {
    "GumbelOneHotCategorical": (_jfunc, _pfunc),
    "LogisticBernoulli": (lambda b: b * W, lambda b: b * torch.from_numpy(W)),
}


def _compare(jval_fn, pval_fn, logits):
    """Value and the gradient of its sum with respect to ``logits``."""
    exp = jval_fn(jnp.asarray(logits))
    exp_g = jax.grad(lambda lg: jval_fn(lg).sum())(jnp.asarray(logits))
    lt = _t(logits, True)
    got = pval_fn(lt)
    got.sum().backward()
    _close(got, exp)
    _close(lt.grad, exp_g)


# ---- the estimators ----


@pytest.mark.parametrize("is_log", [False, True])
@pytest.mark.parametrize("with_cv", [False, True])
def test_direct_estimator_matches_jax(is_log, with_cv):
    logits, key = _logits(0), jax.random.PRNGKey(1)
    u = _unif(key, (MC,) + logits.shape)
    w2 = np.full(V, 0.5, np.float32)

    def jrun(lg):
        cv, cvm = (None, None)
        if with_cv:
            cv, cvm = (lambda b: (b * w2).sum(-1)), (jax.nn.sigmoid(lg) * w2).sum(-1)
        return jmc.DirectEstimator(JBern(lg), _jfunc, MC, cv, cvm, is_log)(key)

    def prun(lg):
        cv, cvm = (None, None)
        if with_cv:
            cv = lambda b: (b * torch.from_numpy(w2)).sum(-1)  # noqa: E731
            cvm = (torch.sigmoid(lg) * torch.from_numpy(w2)).sum(-1)
        return pmc.DirectEstimator(PBern(lg, u), _pfunc, MC, cv, cvm, is_log)()

    _compare(jrun, prun, logits)


@pytest.mark.parametrize("is_log", [False, True])
def test_reparameterization_estimator_matches_jax(is_log):
    logits, key = _logits(2), jax.random.PRNGKey(3)
    u = _unif(key, (MC,) + logits.shape)
    _compare(
        lambda lg: jmc.ReparameterizationEstimator(
            jst.GumbelOneHotCategorical(logits=lg), _jfunc, MC, is_log)(key),
        lambda lg: pmc.ReparameterizationEstimator(
            _given("GumbelOneHotCategorical", u)(logits=lg), _pfunc, MC, is_log)(),
        logits,
    )


@pytest.mark.parametrize("cls", ["GumbelOneHotCategorical", "LogisticBernoulli"])
@pytest.mark.parametrize("is_log", [False, True])
def test_straight_through_estimator_matches_jax(cls, is_log):
    logits, key = _logits(4), jax.random.PRNGKey(5)
    u = _unif(key, (MC,) + logits.shape)
    jf, pf = FUNCS[cls]
    _compare(
        lambda lg: jmc.StraightThroughEstimator(
            getattr(jst, cls)(logits=lg), jf, MC, is_log)(key),
        lambda lg: pmc.StraightThroughEstimator(
            _given(cls, u)(logits=lg), pf, MC, is_log)(),
        logits,
    )
    with pytest.raises(ValueError):
        pmc.StraightThroughEstimator(PBern(_t(logits)), _pfunc, MC)


@pytest.mark.parametrize("self_normalize", [False, True])
@pytest.mark.parametrize("is_log", [False, True])
def test_importance_sampling_estimator_matches_jax(self_normalize, is_log):
    """Gradients reach the density's logits, none the proposal's."""
    q, key = _logits(6), jax.random.PRNGKey(7)
    u = _unif(key, (MC,) + q.shape)

    def jrun(p):
        return jmc.ImportanceSamplingEstimator(
            JBern(jnp.asarray(q)), _jfunc, MC, JBern(p), self_normalize, is_log)(key)

    def prun(p):
        return pmc.ImportanceSamplingEstimator(
            PBern(_t(q), u), _pfunc, MC, PBern(p), self_normalize, is_log)()

    _compare(jrun, prun, _logits(8))


def _rebar(cls, seed=10):
    """The JAX control variate with its params and the port's, carried
    across by ``state_dict_from_jax``."""
    jf, pf = FUNCS[cls]
    jcv = getattr(jmc, cls + "RebarControlVariate")(func=jf, start_temp=0.5, start_eta=0.7)
    params = jcv.init(jax.random.PRNGKey(seed), jnp.zeros(B + (V,)))
    params = jax.tree.map(lambda a: a * 1.1, params)
    pcv = getattr(pmc, cls + "RebarControlVariate")(pf, device="cpu")
    pcv.load_state_dict(pmc.state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return jcv, params, pcv


@pytest.mark.parametrize("cls", ["GumbelOneHotCategorical", "LogisticBernoulli"])
@pytest.mark.parametrize("is_log", [False, True])
def test_relax_estimator_matches_jax(cls, is_log):
    logits, key = _logits(9), jax.random.PRNGKey(11)
    k_z, k_cond = jax.random.split(key)
    u_z = _unif(k_z, (MC,) + logits.shape)
    u_c = _unif(k_cond, (MC,) + logits.shape)
    jcv, params, pcv = _rebar(cls)
    jf, pf = FUNCS[cls]
    _compare(
        lambda lg: jmc.RelaxEstimator(
            getattr(jst, cls)(logits=lg), jf, MC, lambda z: jcv.apply(params, z), is_log)(key),
        lambda lg: pmc.RelaxEstimator(_given(cls, u_z, u_c)(logits=lg), pf, MC, pcv, is_log)(),
        logits,
    )


@pytest.mark.parametrize("cls", ["GumbelOneHotCategorical", "LogisticBernoulli"])
def test_relax_variance_loss_control_variate_gradient_matches_jax(cls):
    """jax.grad(relax_variance_loss, argnums=2) against the port's
    second-order torch.autograd.grad, on the same draws."""
    logits, key = _logits(12), jax.random.PRNGKey(13)
    k_z, k_cond = jax.random.split(key)
    u_z = _unif(k_z, (MC,) + logits.shape)
    u_c = _unif(k_cond, (MC,) + logits.shape)
    jcv, params, pcv = _rebar(cls, 14)
    jf, pf = FUNCS[cls]

    def jbuild(pp, cvp):
        return jmc.RelaxEstimator(getattr(jst, cls)(logits=pp), jf, MC,
                                  lambda z: jcv.apply(cvp, z))

    exp_loss = jmc.relax_variance_loss(jbuild, jnp.asarray(logits), params, key)
    exp = jax.grad(jmc.relax_variance_loss, argnums=2)(jbuild, jnp.asarray(logits), params, key)

    def pbuild(pp, cvm):
        return pmc.RelaxEstimator(_given(cls, u_z, u_c)(logits=pp), pf, MC, cvm)

    lt = _t(logits, True)
    loss = pmc.relax_variance_loss(pbuild, lt, pcv)
    g_temp, g_eta = torch.autograd.grad(loss, [pcv.log_temp, pcv.eta])
    _close(loss, exp_loss)
    _close(g_temp, exp["params"]["log_temp"])
    _close(g_eta, exp["params"]["eta"])
    # the proposal's parameters enter as fresh leaves: none of it reaches them
    assert lt.grad is None


def test_enumerate_estimator_matches_jax():
    from pydrobert_tpu.ops import combinatorics as jc
    from pydrobert_tpu_torch.ops import combinatorics as pc

    w = _logits(15, (6,))
    for is_log in (False, True):
        exp = jmc.EnumerateEstimator(
            jc.SimpleRandomSamplingWithoutReplacement(np.full(B, 2), np.full(B, 4), 6),
            lambda b: (b * w).sum(-1), is_log)()
        got = pmc.EnumerateEstimator(
            pc.SimpleRandomSamplingWithoutReplacement(torch.full(B, 2), torch.full(B, 4), 6),
            lambda b: (b * torch.from_numpy(w)).sum(-1), is_log)()
        _close(got, exp)
    with pytest.raises(ValueError):
        pmc.EnumerateEstimator(PBern(_t(w)), _pfunc)


@pytest.mark.parametrize("burn_in", [0, 3])
@pytest.mark.parametrize("is_log", [False, True])
def test_independent_metropolis_hastings_matches_jax(burn_in, is_log):
    """The JAX chain draws step t's proposal from the t-th split key; the
    port draws all of them at once, given here as the same draws."""
    q, p, key, steps = _logits(16), _logits(17), jax.random.PRNGKey(18), 8
    exp = jmc.IndependentMetropolisHastingsEstimator(
        JBern(jnp.asarray(q)), _jfunc, steps, JBern(jnp.asarray(p)), burn_in, is_log=is_log)(key)
    k_init, k_chain, k_u = jax.random.split(key, 3)
    shape = (1,) + q.shape
    u_init = _unif(jax.random.split(k_init, 1000)[0], shape)
    u_chain = np.concatenate([_unif(k, shape) for k in jax.random.split(k_chain, steps)])
    u_acc = _unif(k_u, (steps,) + B)
    est = pmc.IndependentMetropolisHastingsEstimator(
        PBern(_t(q), u_init, u_chain), _pfunc, steps, PBern(_t(p)), burn_in, is_log=is_log)
    _close(est(u=torch.from_numpy(u_acc)), exp)


def test_imh_initial_sample_and_checks():
    q, p = _logits(19), _logits(20)
    b0 = np.ones(q.shape, np.float32)
    est = pmc.IndependentMetropolisHastingsEstimator(
        PBern(_t(q), _unif(jax.random.PRNGKey(0), (6,) + q.shape)), _pfunc, 6,
        PBern(_t(p)), initial_sample=torch.from_numpy(b0))
    assert est(u=torch.full((6,) + B, 0.5)).shape == B
    with pytest.raises(ValueError):
        pmc.IndependentMetropolisHastingsEstimator(PBern(_t(q)), _pfunc, 3, PBern(_t(p)), burn_in=3)
    with pytest.raises(ValueError):
        pmc.IndependentMetropolisHastingsEstimator(
            PBern(_t(q)), _pfunc, 3, PBern(_t(p)), initial_sample=torch.zeros(2, 2))


def test_rebar_control_variates_match_flax():
    z = _logits(21) * 2
    for cls in ("GumbelOneHotCategorical", "LogisticBernoulli"):
        jcv, params, pcv = _rebar(cls, 22)
        _close(pcv(torch.from_numpy(z)), jcv.apply(params, jnp.asarray(z)))
        fresh = getattr(pmc, cls + "RebarControlVariate")(FUNCS[cls][1], 0.5, 0.7, device="cpu")
        init = jcv.init(jax.random.PRNGKey(0), jnp.asarray(z))["params"]
        _close(fresh.log_temp, init["log_temp"])
        _close(fresh.eta, init["eta"])
    with pytest.raises(ValueError):
        pmc.LogisticBernoulliRebarControlVariate(_pfunc, 0.0, device="cpu")


# ---- the deprecated functional interface ----


@pytest.mark.parametrize("dist", ["bern", "cat", "onehot"])
def test_deprecated_functions_match_jax(dist):
    logits = _logits(23)
    key, key2 = jax.random.PRNGKey(24), jax.random.PRNGKey(25)
    u, v = _unif(key, logits.shape), _unif(key2, logits.shape)
    with pytest.warns(DeprecationWarning):
        z = pest.to_z(None, torch.from_numpy(logits), dist, u=torch.from_numpy(u))
    with pytest.warns(DeprecationWarning):
        ez = jest.to_z(key, jnp.asarray(logits), dist)
    _close(z, ez)
    with pytest.warns(DeprecationWarning):
        b = pest.to_b(z, dist)
    with pytest.warns(DeprecationWarning):
        eb = jest.to_b(ez, dist)
    np.testing.assert_array_equal(b.numpy(), np.asarray(eb))
    # a value a sample: elementwise for the Bernoulli, a row's otherwise
    red = (lambda x: x) if dist == "bern" else (lambda x: x.reshape(B + (-1,)).sum(-1))
    with pytest.warns(DeprecationWarning):
        fb = pest.to_fb(lambda x: red(x) * 0.3 + 1, b)
    efb = red(np.asarray(eb)) * 0.3 + 1
    with pytest.warns(DeprecationWarning):
        g = pest.reinforce(fb, b, torch.from_numpy(logits), dist)
    with pytest.warns(DeprecationWarning):
        eg = jest.reinforce(efb, eb, jnp.asarray(logits), dist)
    _close(g, eg)

    eta = torch.tensor(0.8, requires_grad=True)

    def pc(zz):
        s = torch.sigmoid(zz)
        return eta * (s if dist == "bern" else s.sum(-1))

    def jc(zz):
        s = jax.nn.sigmoid(zz)
        return 0.8 * (s if dist == "bern" else s.sum(-1))

    with pytest.warns(DeprecationWarning):
        got = pest.relax(fb, b, torch.from_numpy(logits), z, pc, dist, components=True,
                         u=torch.from_numpy(v))
    with pytest.warns(DeprecationWarning):
        exp = jest.relax(efb, eb, jnp.asarray(logits), ez, jc, dist, key2, components=True)
    for a, e in zip(got, exp):
        _close(a, e)
    # the control variate's terms stay differentiable in its parameters
    diff, dlog_pb, dc_z, dc_z_tilde = got
    (diff * dlog_pb + dc_z - dc_z_tilde).sum().backward()
    assert eta.grad is not None and torch.isfinite(eta.grad)
