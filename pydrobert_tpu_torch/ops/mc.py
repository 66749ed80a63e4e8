"""Expectation estimators over (discrete) random variables (counterpart of
:mod:`pydrobert_tpu.ops.mc`).

The :class:`Estimator` interface, the exact :class:`EnumerateEstimator`
and the Monte Carlo family: REINFORCE (:class:`DirectEstimator`),
reparameterization, straight-through, importance sampling (optionally
self-normalized), RELAX/REBAR and independent Metropolis-Hastings, with the
REBAR control variates as :class:`torch.nn.Module`\\ s.

An estimator is called with a :class:`torch.Generator` (``None`` takes
PyTorch's default one), which its proposal's ``sample``/``rsample``/
``csample`` draw from. Gradients come through the surrogate value ``v =
f(b) + d - d.detach()``, as in the JAX package, so ``v.backward()`` gives
the estimator's gradient. :func:`relax_variance_loss` is the RELAX
control variate's objective; its gradient with respect to the control
variate's parameters is the JAX package's ``jax.grad(relax_variance_loss,
argnums=2)``. The Metropolis-Hastings chain draws every proposal up front;
only the accept-and-carry runs as a loop.
"""

import abc
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import argcheck, config, default_device
from ..utils.pytree import tree_map
from ._softmax import log_softmax, softmax
from .straight_through import ConditionalStraightThrough, StraightThrough

__all__ = [
    "DirectEstimator",
    "EnumerateEstimator",
    "Estimator",
    "GumbelOneHotCategoricalRebarControlVariate",
    "ImportanceSamplingEstimator",
    "IndependentMetropolisHastingsEstimator",
    "LogisticBernoulliRebarControlVariate",
    "MonteCarloEstimator",
    "RelaxEstimator",
    "ReparameterizationEstimator",
    "StraightThroughEstimator",
    "relax_variance_loss",
    "state_dict_from_jax",
]

FunctionOnSample = Callable[[torch.Tensor], torch.Tensor]

_F32_MIN_HALF = float(np.finfo(np.float32).min) / 2
_F32_MAX_HALF = float(np.finfo(np.float32).max) / 2


def _exp_clamped(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(x, config.EPS_NINF, config.EPS_INF))


def _log_max(fb: torch.Tensor) -> torch.Tensor:
    """The detached maximum over samples, kept inside half float32's range,
    by which ``is_log`` estimators scale ``exp(fb)``."""
    return torch.clamp(fb.detach().amax(0, keepdim=True), _F32_MIN_HALF, _F32_MAX_HALF)


class Estimator(abc.ABC):
    r"""Computes an estimate of :math:`v = E_{b \sim P}[f(b)]`.

    ``func`` maps samples ``(num_samples,) + batch_shape + event_shape``
    to values ``(num_samples,) + batch_shape``. With ``is_log``, ``func``
    computes :math:`\log f` and the estimate is of :math:`\log v`.
    """

    def __init__(self, proposal, func: FunctionOnSample, is_log: bool = False):
        self.proposal = proposal
        self.func = func
        self.is_log = argcheck.is_bool(is_log, "is_log")

    @abc.abstractmethod
    def __call__(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ...


class EnumerateEstimator(Estimator):
    """The exact expectation, over the proposal's enumerated support. Draws
    nothing."""

    def __init__(self, proposal, func, is_log: bool = False):
        if not getattr(proposal, "has_enumerate_support", False):
            raise ValueError(
                "proposal must be able to enumerate its support "
                "(proposal.has_enumerate_support == True)"
            )
        super().__init__(proposal, func, is_log)

    def __call__(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b = self.proposal.enumerate_support()
        log_pb = self.proposal.log_prob(b)
        fb = self.func(b)
        if self.is_log:
            return torch.logsumexp(fb + log_pb, 0)
        return (fb * torch.exp(log_pb)).sum(0)


class MonteCarloEstimator(Estimator, metaclass=abc.ABCMeta):
    """An estimator that draws ``mc_samples`` samples from the proposal."""

    def __init__(self, proposal, func, mc_samples: int, is_log: bool = False):
        super().__init__(proposal, func, is_log)
        self.mc_samples = argcheck.is_posi(mc_samples, "mc_samples")


class DirectEstimator(MonteCarloEstimator):
    """The sample average with a REINFORCE surrogate gradient, optionally
    with a control variate ``cv`` of known mean ``cv_mean``; with
    ``is_log`` the average is taken in scaled linear space, as the JAX
    package does."""

    def __init__(
        self,
        proposal,
        func,
        mc_samples: int,
        cv: Optional[FunctionOnSample] = None,
        cv_mean: Optional[torch.Tensor] = None,
        is_log: bool = False,
    ):
        super().__init__(proposal, func, mc_samples, is_log)
        self.cv, self.cv_mean = cv, cv_mean

    def __call__(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b = self.proposal.sample((self.mc_samples,), generator).detach()
        fb = self.func(b)
        if self.is_log:
            fb_lmax = _log_max(fb)
            fb = _exp_clamped(fb - fb_lmax)
        if self.cv is not None:
            c = torch.as_tensor(self.cv_mean, device=fb.device)
            cvb = self.cv(b)
            if self.is_log:
                c = _exp_clamped(c[None] - fb_lmax)
                cvb = _exp_clamped(cvb - fb_lmax)
            fb = fb - cvb + c
        log_pb = self.proposal.log_prob(b)
        deriv = (fb.detach() * log_pb).mean(0)
        fb = fb.mean(0)
        if self.is_log:
            fb = torch.clamp(fb, min=math.exp(config.EPS_NINF))
            deriv = deriv / fb.detach()
            return torch.log(fb) + deriv - deriv.detach() + fb_lmax.squeeze(0)
        return fb + deriv - deriv.detach()


class ReparameterizationEstimator(MonteCarloEstimator):
    """The sample average of ``func`` at reparameterized (differentiable)
    samples."""

    def __init__(self, proposal, func, mc_samples: int, is_log: bool = False):
        if not hasattr(proposal, "rsample"):
            raise ValueError("proposal must implement rsample")
        super().__init__(proposal, func, mc_samples, is_log)

    def __call__(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        fz = self.func(self.proposal.rsample((self.mc_samples,), generator))
        if self.is_log:
            return torch.logsumexp(fz, 0) - math.log(fz.shape[0])
        return fz.mean(0)


class StraightThroughEstimator(MonteCarloEstimator):
    """The sample average of ``func`` at thresholded relaxed samples, whose
    gradient passes straight through the threshold."""

    def __init__(self, proposal, func, mc_samples: int, is_log: bool = False):
        proposal = argcheck.is_a(proposal, "proposal", cls=StraightThrough)
        super().__init__(proposal, func, mc_samples, is_log)

    def __call__(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        z = self.proposal.rsample((self.mc_samples,), generator)
        fb = self.func(self.proposal.threshold(z, True))
        if self.is_log:
            return torch.logsumexp(fb, 0) - math.log(fb.shape[0])
        return fb.mean(0)


class ImportanceSamplingEstimator(MonteCarloEstimator):
    """The likelihood-ratio-weighted sample average, optionally
    self-normalized: ``proposal`` is :math:`Q`, ``density`` :math:`P` (maybe
    unnormalized). Gradients flow through ``density`` only."""

    def __init__(
        self,
        proposal,
        func,
        mc_samples: int,
        density,
        self_normalize: bool = False,
        is_log: bool = False,
    ):
        self_normalize = argcheck.is_bool(self_normalize, "self_normalize")
        super().__init__(proposal, func, mc_samples, is_log)
        self.density = density
        self.self_normalize = self_normalize

    def __call__(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b = self.proposal.sample((self.mc_samples,), generator).detach()
        lpb = self.density.log_prob(b)
        lqb = self.proposal.log_prob(b).detach()
        fb = self.func(b)
        if self.self_normalize:
            llr = log_softmax(lpb - lqb, 0)
        else:
            llr = lpb - lqb - math.log(self.mc_samples)
        if self.is_log:
            return torch.logsumexp(fb + llr, 0)
        return (fb * torch.exp(llr)).sum(0)


class RelaxEstimator(MonteCarloEstimator):
    """The RELAX estimator; with a REBAR control variate, REBAR.

    ``proposal`` implements
    :class:`~pydrobert_tpu_torch.ops.straight_through.ConditionalStraightThrough`.
    The value carries REINFORCE-style surrogate gradients for every
    parameter; :func:`relax_variance_loss` is the control variate's
    objective. Relaxed samples are drawn first, then the conditional ones,
    both from ``generator``."""

    def __init__(self, proposal, func, mc_samples: int, cv: FunctionOnSample, is_log: bool = False):
        proposal = argcheck.is_a(proposal, "proposal", cls=ConditionalStraightThrough)
        super().__init__(proposal, func, mc_samples, is_log)
        self.cv = cv

    def __call__(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        z = self.proposal.rsample((self.mc_samples,), generator)
        b = self.proposal.threshold(z)
        zcond = self.proposal.csample(b, generator)
        log_pb = self.proposal.tlog_prob(b)
        fb = self.func(b)
        cvz, cvzcond = self.cv(z), self.cv(zcond)
        if self.is_log:
            fb_lmax = _log_max(fb)
            fb = _exp_clamped(fb - fb_lmax)
            cvz = _exp_clamped(cvz - fb_lmax)
            cvzcond = _exp_clamped(cvzcond - fb_lmax)
        fb_cvzcond = fb - cvzcond
        deriv = fb_cvzcond.detach() * log_pb
        v = (fb_cvzcond + cvz).mean(0)
        if self.is_log:
            v = torch.clamp(v, min=math.exp(config.EPS_NINF))
            deriv = deriv / v.detach()
            out = torch.log(v) + deriv - deriv.detach() + fb_lmax
        else:
            out = v + deriv - deriv.detach()
        return out.mean(0)


def _leaves(tree: Any) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def relax_variance_loss(
    est_builder: Callable[[Any, Any], RelaxEstimator],
    proposal_params: Any,
    cv_params: Any,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    r"""The control variate's variance-minimizing objective for RELAX and
    REBAR: :math:`\sum_k \|g_{\theta_k}\|_2`, the 2-norms of the REINFORCE
    gradient estimates of the proposal's parameters, through the
    second-order graph.

    ``est_builder(proposal_params, cv_params)`` (re)builds the
    :class:`RelaxEstimator` from the two sets of parameters (tensors, or
    dicts, lists or tuples of them; ``cv_params`` may be the control
    variate module itself). The proposal's parameters enter as fresh
    leaves, so the result's gradient reaches ``cv_params`` only, as
    ``jax.grad(relax_variance_loss, argnums=2)`` in the JAX package:
    minimize it with respect to the control variate alone.
    """
    pp = tree_map(lambda p: p.detach().requires_grad_(True), proposal_params)
    v = est_builder(pp, cv_params)(generator).sum()
    leaves = _leaves(pp)
    gs = torch.autograd.grad(v, leaves, create_graph=True, allow_unused=True)
    return sum(
        torch.sqrt(torch.sum(torch.square(g))) if g is not None else torch.zeros((), device=p.device)
        for g, p in zip(gs, leaves)
    )


class IndependentMetropolisHastingsEstimator(MonteCarloEstimator):
    """An independent Metropolis-Hastings estimate (no gradient).

    The chain takes ``mc_samples`` steps and its first ``burn_in`` samples
    are dropped from the average. Every proposal of the chain is drawn up
    front, in one call, from ``generator``, then the acceptance uniforms
    (or the given ``u``, ``(mc_samples,) + batch_shape``)."""

    def __init__(
        self,
        proposal,
        func,
        mc_samples: int,
        density,
        burn_in: int = 0,
        initial_sample: Optional[torch.Tensor] = None,
        initial_sample_tries: int = 1000,
        is_log: bool = False,
    ):
        burn_in = argcheck.is_nonnegi(burn_in, "burn_in")
        mc_samples = argcheck.is_posi(mc_samples, "mc_samples")
        argcheck.is_lt(burn_in, mc_samples, "burn_in")
        super().__init__(proposal, func, mc_samples, is_log)
        if initial_sample is not None:
            initial_sample = torch.as_tensor(initial_sample)
            sample_shape = tuple(proposal.batch_shape) + tuple(proposal.event_shape)
            if tuple(initial_sample.shape) == sample_shape:
                initial_sample = initial_sample[None]
            elif tuple(initial_sample.shape) != (1,) + sample_shape:
                raise ValueError(
                    f"Expected initial_sample to have shape "
                    f"{(1,) + sample_shape} or {sample_shape}"
                )
            if not bool(torch.isfinite(density.log_prob(initial_sample)).all()):
                raise ValueError(
                    "all values in initial_sample must lie in the support of density"
                )
        elif initial_sample_tries < 1:
            raise ValueError("initial_sample_tries must be positive when initial_sample is None")
        self.density, self.initial_sample = density, initial_sample
        self.initial_sample_tries, self.burn_in = initial_sample_tries, burn_in

    def find_initial_sample(
        self, generator: Optional[torch.Generator] = None, tries: Optional[int] = None
    ) -> torch.Tensor:
        """An in-support starting sample, from repeated proposal draws."""
        if tries is None:
            tries = self.initial_sample_tries
        if tries < 1:
            raise ValueError("tries must be positive")
        sample = self.proposal.sample((1,), generator).detach()
        keep = torch.isfinite(self.density.log_prob(sample))
        for _ in range(tries - 1):
            if bool(keep.all()):
                return sample
            cur = self.proposal.sample((1,), generator).detach()
            keep_e = keep.reshape(keep.shape + (1,) * (cur.dim() - keep.dim()))
            sample = torch.where(keep_e, sample, cur)
            keep = torch.isfinite(self.density.log_prob(sample))
        if bool(keep.all()):
            return sample
        raise RuntimeError(
            f"Unable to find initial sample in {tries} draws. Either specify "
            "initial_sample on instantiation or increase initial_sample_tries."
        )

    def _ratio(self, b: torch.Tensor) -> torch.Tensor:
        return (self.density.log_prob(b) - self.proposal.log_prob(b)).detach()

    def __call__(
        self, generator: Optional[torch.Generator] = None, u: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        if self.initial_sample is None:
            last = self.find_initial_sample(generator)
        else:
            last = self.initial_sample
        last = torch.as_tensor(last).detach()  # the proposal's own dtype
        last_ratio = self._ratio(last)[0]
        cur = self.proposal.sample((self.mc_samples,), generator).detach()
        cur_ratio = self._ratio(cur)
        if u is None:
            u = torch.rand(cur_ratio.shape, generator=generator, device=cur_ratio.device)
        log_us = torch.log(torch.as_tensor(u, device=cur_ratio.device))
        chain = []
        extra = (1,) * (cur.dim() - cur_ratio.dim())
        last = last[0]
        for t in range(self.mc_samples):
            accept = (cur_ratio[t] - last_ratio) > log_us[t]
            last_ratio = torch.where(accept, cur_ratio[t], last_ratio)
            last = torch.where(accept.reshape(accept.shape + extra), cur[t], last)
            chain.append(last)
        fbs = self.func(torch.stack(chain))
        kept = fbs[self.burn_in:]
        if self.is_log:
            return torch.logsumexp(kept, 0) - math.log(self.mc_samples - self.burn_in)
        return kept.mean(0)


class _RebarControlVariate(torch.nn.Module):
    r"""``c(z) = eta * f(squash(z / exp(log_temp)))`` with learnable
    ``log_temp`` and ``eta``, each of shape ``(1,)``."""

    def __init__(
        self,
        func: FunctionOnSample,
        start_temp: float = 0.1,
        start_eta: float = 1.0,
        device=None,
    ):
        super().__init__()
        if start_temp <= 0:
            raise ValueError("start_temp must be positive")
        device = default_device(device)
        self.func = func
        self.log_temp = torch.nn.Parameter(
            torch.log(torch.full((1,), start_temp, dtype=torch.float32)).to(device)
        )
        self.eta = torch.nn.Parameter(torch.full((1,), start_eta, dtype=torch.float32, device=device))

    def _squash(self, z: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.eta * self.func(self._squash(z / torch.exp(self.log_temp)))


class LogisticBernoulliRebarControlVariate(_RebarControlVariate):
    """The REBAR control variate for
    :class:`~pydrobert_tpu_torch.ops.straight_through.LogisticBernoulli`
    (a sigmoid)."""

    def _squash(self, z):
        return torch.sigmoid(z)


class GumbelOneHotCategoricalRebarControlVariate(_RebarControlVariate):
    """The REBAR control variate for
    :class:`~pydrobert_tpu_torch.ops.straight_through.GumbelOneHotCategorical`
    (a softmax over the last axis)."""

    def _squash(self, z):
        return softmax(z, -1)


def state_dict_from_jax(params) -> dict:
    """A REBAR control variate's ``state_dict`` (``log_temp`` and ``eta``)
    from the JAX package's flax parameters of the same control variate (the
    ``{"params": ...}`` dict ``init`` returns, or its ``"params"`` entry),
    as numpy arrays."""
    params = params.get("params", params)
    return {k: torch.tensor(np.asarray(params[k], np.float32)) for k in ("log_temp", "eta")}
