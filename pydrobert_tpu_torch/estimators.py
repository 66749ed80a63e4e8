"""Public estimators interface (counterpart of
:mod:`pydrobert_tpu.estimators`): exact enumeration and the Monte Carlo
family of :mod:`pydrobert_tpu_torch.ops.mc`, called with a
:class:`torch.Generator`; and the deprecated v0.3-era functional interface
below, which warns and forwards.
"""

import warnings as _warnings
from typing import Optional as _Optional

import torch as _torch

from .ops._softmax import log_softmax as _log_softmax
from .ops._softmax import softmax as _softmax
from .ops.mc import (  # noqa: F401
    DirectEstimator,
    EnumerateEstimator,
    Estimator,
    ImportanceSamplingEstimator,
    IndependentMetropolisHastingsEstimator,
    MonteCarloEstimator,
    RelaxEstimator,
    ReparameterizationEstimator,
    StraightThroughEstimator,
    relax_variance_loss,
)

__all__ = [
    "DirectEstimator",
    "EnumerateEstimator",
    "Estimator",
    "ImportanceSamplingEstimator",
    "IndependentMetropolisHastingsEstimator",
    "MonteCarloEstimator",
    "RelaxEstimator",
    "ReparameterizationEstimator",
    "StraightThroughEstimator",
    "relax_variance_loss",
]


# ---------------------------------------------------------------------------
# The deprecated functional interface. Each function warns and forwards;
# sampling functions take a generator (or the uniforms, ``u``), and the
# gradient-returning ones compute their gradients with torch.autograd.grad.
# ---------------------------------------------------------------------------

BERNOULLI_SYNONYMS = {"bern", "Bern", "bernoulli", "Bernoulli"}
CATEGORICAL_SYNONYMS = {"cat", "Cat", "categorical", "Categorical"}
ONEHOT_SYNONYMS = {"onehot", "OneHotCategorical"}

_EPS = 1.1920928955078125e-07


def _deprecate():
    _warnings.warn(
        "the functional interface for estimators is deprecated. See "
        "pydrobert_tpu_torch.estimators.Estimator for the new interface.",
        DeprecationWarning,
        stacklevel=3,
    )


def _uniforms(like: _torch.Tensor, generator, u) -> _torch.Tensor:
    if u is None:
        u = _torch.rand(like.shape, generator=generator, dtype=like.dtype, device=like.device)
    else:
        u = _torch.as_tensor(u, device=like.device).to(like.dtype)
    return _torch.clamp(u, _EPS, 1 - _EPS)


def _relaxed_from_uniform(logits, u, dist):
    if dist in BERNOULLI_SYNONYMS:
        return logits + _torch.log(u) - _torch.log1p(-u)
    elif dist in CATEGORICAL_SYNONYMS | ONEHOT_SYNONYMS:
        return _log_softmax(logits, -1) - _torch.log(-_torch.log(u))
    raise RuntimeError(f"Unknown distribution {dist}")


def to_z(generator: _Optional[_torch.Generator], logits, dist, u=None):
    """A relaxed sample of ``dist`` parameterized by ``logits``, its
    uniforms from ``generator`` or given as ``u`` (deprecated)."""
    _deprecate()
    logits = _torch.as_tensor(logits)
    return _relaxed_from_uniform(logits, _uniforms(logits, generator, u), dist)


def to_b(z, dist):
    """Threshold a relaxed sample to a discrete one (deprecated)."""
    _deprecate()
    z = _torch.as_tensor(z)
    if dist in BERNOULLI_SYNONYMS:
        return (z > 0.0).to(z.dtype)
    elif dist in CATEGORICAL_SYNONYMS:
        return _torch.argmax(z, -1).to(z.dtype)
    elif dist in ONEHOT_SYNONYMS:
        return _torch.nn.functional.one_hot(_torch.argmax(z, -1), z.shape[-1]).to(z.dtype)
    raise RuntimeError(f"Unknown distribution {dist}")


def to_fb(f, b, **kwargs):
    """Simply call ``f(b)`` (deprecated)."""
    _deprecate()
    return f(b, **kwargs)


def _log_pb(b, logits, dist):
    if dist in BERNOULLI_SYNONYMS:
        return b * logits - _torch.nn.functional.softplus(logits)
    elif dist in CATEGORICAL_SYNONYMS:
        lsm = _log_softmax(logits, -1)
        return _torch.gather(lsm, -1, b.long()[..., None])[..., 0]
    elif dist in ONEHOT_SYNONYMS:
        return (_log_softmax(logits, -1) * b).sum(-1)
    raise RuntimeError(f"Unknown distribution {dist}")


def _grad(fn, logits, create_graph=False):
    leaf = logits.detach().requires_grad_(True)
    return _torch.autograd.grad(fn(leaf).sum(), leaf, create_graph=create_graph)[0]


def reinforce(fb, b, logits, dist):
    """The single-sample REINFORCE gradient estimate ``f(b) d log Pr(b;
    logits) / d logits`` (deprecated)."""
    _deprecate()
    fb, b, logits = (_torch.as_tensor(a) for a in (fb, b, logits))
    dlog_pb = _grad(lambda lg: _log_pb(b, lg, dist), logits)
    if dist not in BERNOULLI_SYNONYMS:
        fb = fb[..., None]
    return fb * dlog_pb


def _to_z_tilde(v, logits, b, dist):
    if dist in BERNOULLI_SYNONYMS:
        om_theta = _torch.sigmoid(-logits)
        v_prime = b * (v * (1 - om_theta) + om_theta) + (1.0 - b) * v * om_theta
        return logits + _torch.log(v_prime) - _torch.log1p(-v_prime)
    log_v = _torch.log(v)
    theta = _softmax(logits, -1)
    if dist in CATEGORICAL_SYNONYMS:
        idx = b.long()[..., None]
        mask = _torch.arange(logits.shape[-1], device=logits.device) == idx
    elif dist in ONEHOT_SYNONYMS:
        idx = _torch.argmax(b, -1, keepdim=True)
        mask = b.bool()
    else:
        raise RuntimeError(f"Unknown distribution {dist}")
    log_v_b = _torch.gather(log_v, -1, idx)
    return _torch.where(mask, -_torch.log(-log_v), -_torch.log(-log_v / theta - log_v_b))


def relax(fb, b, logits, z, c, dist, generator=None, components=False, u=None, **kwargs):
    """The RELAX gradient estimate with respect to ``logits`` (deprecated).
    The conditional relaxation's uniforms come from ``generator`` or are
    ``u``.

    Returns ``g`` (the shape of ``logits``) or, with ``components``,
    ``(diff, dlog_pb, dc_z, dc_z_tilde)`` with ``g = diff * dlog_pb + dc_z
    - dc_z_tilde``. The derivative terms stay differentiable with respect
    to the parameters of the control variate ``c``, for its
    variance-minimizing objective.
    """
    _deprecate()
    fb, b = _torch.as_tensor(fb), _torch.as_tensor(b)
    logits = _torch.as_tensor(logits).detach()
    z = _torch.as_tensor(z).detach()
    v = _uniforms(logits, generator, u)

    def z_of_logits(lg):
        # z reattached to fresh logits
        if dist in BERNOULLI_SYNONYMS:
            return z + lg - lg.detach()
        lsm = _log_softmax(lg, -1)
        return z + lsm - lsm.detach()

    c_z_tilde = c(_to_z_tilde(v, logits, b, dist), **kwargs)
    diff = fb - c_z_tilde
    if dist not in BERNOULLI_SYNONYMS:
        diff = diff[..., None]
    dlog_pb = _grad(lambda lg: _log_pb(b, lg, dist), logits)
    dc_z = _grad(lambda lg: c(z_of_logits(lg), **kwargs), logits, True)
    dc_z_tilde = _grad(lambda lg: c(_to_z_tilde(v, lg, b, dist), **kwargs), logits, True)
    if components:
        return diff, dlog_pb, dc_z, dc_z_tilde
    return diff * dlog_pb + dc_z - dc_z_tilde
