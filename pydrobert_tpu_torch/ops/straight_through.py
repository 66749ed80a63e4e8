"""Relaxed distributions and straight-through protocols (counterpart of
:mod:`pydrobert_tpu.ops.straight_through`).

The duck-typed :class:`Density`, :class:`StraightThrough` and
:class:`ConditionalStraightThrough` interfaces, and the
:class:`LogisticBernoulli` and :class:`GumbelOneHotCategorical`
relaxations with their conditional (REBAR) sampling.

Sampling takes an explicit :class:`torch.Generator` (on the parameters'
device), or the uniforms themselves as ``u``: the JAX package draws its
uniforms from a key, and a caller who holds those draws gets the same
samples here. The straight-through estimate is ``b + z - z.detach()``.
"""

import abc
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ._softmax import log_softmax

__all__ = [
    "ConditionalStraightThrough",
    "Density",
    "GumbelOneHotCategorical",
    "LogisticBernoulli",
    "StraightThrough",
]

_EULER_GAMMA = float(np.euler_gamma)
_EPS = 1.1920928955078125e-07  # float32 machine epsilon, as torch's clamp_probs


def _check_methods(C, *methods):
    mro = C.__mro__
    for method in methods:
        for B in mro:
            if method in B.__dict__:
                if B.__dict__[method] is None:
                    return NotImplemented
                break
        else:
            return NotImplemented
    return True


def _clamp_probs(p: torch.Tensor) -> torch.Tensor:
    return torch.clamp(p, _EPS, 1 - _EPS)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``logaddexp(x, 0)``, as ``jax.nn.softplus``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _uniforms(shape, like: torch.Tensor, generator, u) -> torch.Tensor:
    """Clamped uniforms of ``shape``: ``u`` when given, else drawn from
    ``generator`` on ``like``'s device."""
    if u is None:
        u = torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)
    else:
        u = torch.as_tensor(u, device=like.device).to(like.dtype)
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"expected uniforms of shape {tuple(shape)}, got {tuple(u.shape)}")
    return _clamp_probs(u)


class Density(abc.ABC):
    """An object that assigns (maybe unnormalized) log-densities.

    Duck-typed: any class with a ``log_prob`` method is a virtual
    subclass.
    """

    @abc.abstractmethod
    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        ...

    @classmethod
    def __subclasshook__(cls, C):
        if cls is Density:
            return _check_methods(C, "log_prob")
        return NotImplemented


class StraightThrough(abc.ABC):
    """A distribution with relaxed samples and a threshold: duck-typed on
    ``rsample(sample_shape, generator)``, ``threshold(z,
    straight_through=False)`` and ``tlog_prob(b)``."""

    @abc.abstractmethod
    def rsample(self, sample_shape: Sequence[int] = (), generator=None):
        ...

    @abc.abstractmethod
    def threshold(self, z: torch.Tensor, straight_through: bool = False):
        ...

    @abc.abstractmethod
    def tlog_prob(self, b: torch.Tensor) -> torch.Tensor:
        ...

    @classmethod
    def __subclasshook__(cls, C):
        if cls is StraightThrough:
            return _check_methods(C, "rsample", "threshold", "tlog_prob")
        return NotImplemented


class ConditionalStraightThrough(StraightThrough):
    """A :class:`StraightThrough` with conditional relaxed samples ``z |
    b``, as RELAX and REBAR need: adds ``csample(b, generator)`` and
    ``clog_prob(zcond, b)``."""

    @abc.abstractmethod
    def csample(self, b: torch.Tensor, generator=None) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def clog_prob(self, zcond: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ...

    @classmethod
    def __subclasshook__(cls, C):
        if cls is ConditionalStraightThrough:
            return _check_methods(
                C, "rsample", "threshold", "tlog_prob", "csample", "clog_prob"
            )
        return NotImplemented


class LogisticBernoulli:
    r"""Logistic relaxation of the Bernoulli: ``z = logits + logit(u)``;
    thresholding at 0 gives Bernoulli samples, ``b = I[z >= 0]``.
    Implements :class:`ConditionalStraightThrough`."""

    def __init__(
        self,
        probs: Optional[torch.Tensor] = None,
        logits: Optional[torch.Tensor] = None,
    ):
        if (probs is None) == (logits is None):
            raise ValueError("Either probs or logits must be specified, not both")
        if probs is not None:
            self._probs = torch.as_tensor(probs)
            self._logits = None
        else:
            self._logits = torch.as_tensor(logits)
            self._probs = None

    @property
    def logits(self) -> torch.Tensor:
        if self._logits is None:
            p = _clamp_probs(self._probs)
            return torch.log(p) - torch.log1p(-p)
        return self._logits

    @property
    def probs(self) -> torch.Tensor:
        if self._probs is None:
            return torch.sigmoid(self._logits)
        return self._probs

    @property
    def _param(self) -> torch.Tensor:
        return self._probs if self._logits is None else self._logits

    @property
    def batch_shape(self) -> torch.Size:
        return self._param.shape

    event_shape = torch.Size()

    @property
    def mean(self) -> torch.Tensor:
        return self.logits

    @property
    def stddev(self) -> torch.Tensor:
        return torch.full(self.batch_shape, math.pi / math.sqrt(3), device=self._param.device)

    @property
    def variance(self) -> torch.Tensor:
        return self.stddev**2

    def entropy(self) -> torch.Tensor:
        return torch.full(self.batch_shape, 2.0, device=self._param.device)

    def rsample(
        self, sample_shape: Sequence[int] = (), generator=None, u=None
    ) -> torch.Tensor:
        logits = self.logits
        u = _uniforms(tuple(sample_shape) + tuple(self.batch_shape), logits, generator, u)
        return logits + torch.log(u) - torch.log1p(-u)

    sample = rsample

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        # the logistic density: g(z) = exp(G^{-1}) (1 + exp(G^{-1}))^{-2}
        Ginv = self.logits - z
        return Ginv - 2 * _softplus(Ginv)

    def threshold(self, z: torch.Tensor, straight_through: bool = False) -> torch.Tensor:
        b = (z >= 0.0).to(z.dtype)
        if straight_through:
            b = b + z - z.detach()
        return b

    def tlog_prob(self, b: torch.Tensor) -> torch.Tensor:
        logits, b = torch.broadcast_tensors(self.logits, b)
        return b * logits - _softplus(logits)

    def csample(self, b: torch.Tensor, generator=None, u=None) -> torch.Tensor:
        v = _uniforms(b.shape, b, generator, u)
        probs = _clamp_probs(self.probs)
        zcond = v / ((1 - v) * ((1 - b) * probs + b * (1 - probs))) + 1
        zcond = (2 * b - 1) * torch.log(zcond)
        return zcond + b * _EPS

    def clog_prob(self, zcond: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        zero_prob = self.threshold(zcond) != b
        logits = self.logits
        lp = (
            -zcond
            + (1 - b) * logits
            + _softplus(logits)
            - 2 * _softplus(logits - zcond)
        )
        return torch.where(zero_prob, -torch.inf, lp)


class GumbelOneHotCategorical:
    r"""Gumbel relaxation of the one-hot categorical: ``z = logits +
    Gumbel`` over the last axis; thresholding takes the one-hot argmax.
    Implements :class:`ConditionalStraightThrough`."""

    def __init__(
        self,
        logits: Optional[torch.Tensor] = None,
        probs: Optional[torch.Tensor] = None,
    ):
        if (probs is None) == (logits is None):
            raise ValueError("Either probs or logits must be specified, not both")
        if probs is not None:
            probs = torch.as_tensor(probs)
            if probs.dim() < 1:
                raise ValueError("probs must be at least 1 dimensional")
            self._probs = probs / probs.sum(-1, keepdim=True)
            self._logits = None
        else:
            logits = torch.as_tensor(logits)
            if logits.dim() < 1:
                raise ValueError("logits must be at least 1 dimensional")
            self._logits = log_softmax(logits, -1)
            self._probs = None

    @property
    def logits(self) -> torch.Tensor:
        if self._logits is None:
            return torch.log(_clamp_probs(self._probs))
        return self._logits

    @property
    def probs(self) -> torch.Tensor:
        if self._probs is None:
            return torch.exp(self._logits)
        return self._probs

    @property
    def _param(self) -> torch.Tensor:
        return self._probs if self._logits is None else self._logits

    @property
    def batch_shape(self) -> torch.Size:
        return self._param.shape[:-1]

    @property
    def event_shape(self) -> torch.Size:
        return self._param.shape[-1:]

    @property
    def mean(self) -> torch.Tensor:
        return self.logits + _EULER_GAMMA

    @property
    def stddev(self) -> torch.Tensor:
        return torch.full(self._param.shape, math.pi / math.sqrt(6), device=self._param.device)

    @property
    def variance(self) -> torch.Tensor:
        return self.stddev**2

    def entropy(self) -> torch.Tensor:
        return torch.full(
            self.batch_shape, self.event_shape[0] * (1 + _EULER_GAMMA),
            device=self._param.device,
        )

    def rsample(
        self, sample_shape: Sequence[int] = (), generator=None, u=None
    ) -> torch.Tensor:
        logits = self.logits
        shape = tuple(sample_shape) + tuple(self.batch_shape) + tuple(self.event_shape)
        u = _uniforms(shape, logits, generator, u)
        return logits - torch.log(-torch.log(u))

    sample = rsample

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        g = self.logits - z
        return (g - torch.exp(g)).sum(-1)

    def threshold(self, z: torch.Tensor, straight_through: bool = False) -> torch.Tensor:
        b = torch.nn.functional.one_hot(z.argmax(-1), z.shape[-1]).to(z.dtype)
        if straight_through:
            b = b + z - z.detach()
        return b

    def tlog_prob(self, b: torch.Tensor) -> torch.Tensor:
        return torch.where(b.bool(), self.logits, 0.0).sum(-1)

    def csample(self, b: torch.Tensor, generator=None, u=None) -> torch.Tensor:
        probs = _clamp_probs(self.probs)
        log_v = torch.log(_uniforms(b.shape, b, generator, u))
        zcond_match = -torch.log(-log_v) * b
        zcond_match_k = zcond_match.sum(-1, keepdim=True)
        zcond_nomatch = -torch.log(-log_v / probs - (log_v * b).sum(-1, keepdim=True))
        # the reparameterization is unstable: keep the conditionals strictly
        # below the matched maximum
        zcond_nomatch = torch.minimum(zcond_match_k - _EPS, zcond_nomatch) * (1 - b)
        return zcond_match + zcond_nomatch

    def clog_prob(self, zcond: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        zero_prob = (self.threshold(zcond) != b).any(-1)
        neg_b = 1 - b
        logits = self.logits * neg_b
        g = logits - zcond
        g = g - torch.exp(g)
        z_k = (zcond * b).sum(-1, keepdim=True)
        G = -torch.exp(logits - z_k) * neg_b
        log_prob = (g - G).sum(-1)
        return torch.where(zero_prob, -torch.inf, log_prob)
