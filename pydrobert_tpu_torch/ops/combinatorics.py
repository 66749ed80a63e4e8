"""Support enumeration, exact binomial coefficients and simple random
sampling without replacement (counterpart of
:mod:`pydrobert_tpu.ops.combinatorics`).

Enumeration and the binomial coefficients are computed on the host in
exact ``int64`` (their shapes depend on the data) and returned on the
caller's ``device`` (``cuda`` unless it asks for the CPU); a
``torch.int64`` tensor holds every count exactly, so none is ever
narrowed. The sampler
draws Fan et al. (1962)'s sequential Bernoullis, one step a position, from
a :class:`torch.Generator` or from given uniforms ``u``: the JAX package
draws step ``t``'s uniforms from the ``t``-th of ``out_size`` split keys,
and a caller holding those draws gets the same samples here.
"""

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .. import default_device

__all__ = [
    "SimpleRandomSamplingWithoutReplacement",
    "binomial_coefficient",
    "enumerate_binary_sequences",
    "enumerate_binary_sequences_with_cardinality",
    "enumerate_vocab_sequences",
    "simple_random_sampling_without_replacement",
]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _srswor(total_count, given_count, out_size, generator, u):
    shape = torch.broadcast_shapes(total_count.shape, given_count.shape)
    rem_ell = given_count.expand(shape).float()
    rem_t = total_count.expand(shape).float().clamp(min=1)
    dev = rem_t.device
    if u is None:
        u = torch.rand(tuple(shape) + (out_size,), generator=generator, device=dev)
    else:
        u = torch.as_tensor(u, device=dev).float()
        if tuple(u.shape) != tuple(shape) + (out_size,):
            raise ValueError(
                f"expected uniforms of shape {tuple(shape) + (out_size,)}, got {tuple(u.shape)}"
            )
    b = []
    for t in range(out_size):
        b_t = (u[..., t] < rem_ell / rem_t).float()
        rem_ell, rem_t = rem_ell - b_t, (rem_t - 1).clamp(min=1)
        b.append(b_t)
    return torch.stack(b, -1) if b else torch.zeros(tuple(shape) + (0,), device=dev)


def simple_random_sampling_without_replacement(
    generator: Optional[torch.Generator],
    total_count,
    given_count,
    out_size: Optional[int] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Uniform binary vectors of fixed cardinality: float32 samples of shape
    ``broadcast(total_count, given_count) + (out_size,)`` whose first
    ``total_count`` entries hold ``given_count`` ones. The uniforms come
    from ``generator`` (on the counts' device), or are ``u`` of the
    output's shape, ``u[..., t]`` the draw of step ``t``."""
    total_count = torch.as_tensor(total_count)
    given_count = torch.as_tensor(given_count)
    if out_size is None:
        out_size = int(_np(total_count).max())
    if np.any(_np(given_count) > _np(total_count)):
        raise RuntimeError("given_count cannot exceed total_count")
    if out_size < int(np.max(_np(total_count), initial=0)):
        raise RuntimeError(
            f"out_size ({out_size}) must not be less than max of "
            f"total_count ({int(np.max(_np(total_count)))})"
        )
    return _srswor(total_count, given_count.to(total_count.device), int(out_size), generator, u)


def _binom(length, count) -> np.ndarray:
    length, count = _np(length), _np(count)
    if ((count < 0) | (length < 0)).any():
        raise RuntimeError("length and count must be non-negative")
    length, count = np.broadcast_arrays(length, count)
    length_ = int(length.max(initial=0))
    if length_ > 20:
        count_ = int(count.max(initial=0))
        binom = np.zeros((count_ + 1, length_ + 1), np.int64)
        binom[0] = 1
        for c in range(1, count_ + 1):
            binom[c, 1:] = binom[c - 1, :-1].cumsum(0)
        out = binom[count, length]
    else:
        fact = np.ones(length_ + 2, np.int64)
        fact[1:] = np.arange(1, length_ + 2)
        fact = np.cumprod(fact)
        lmc = np.clip(length - count, -1, None)
        cnt = np.minimum(count, length_)
        out = fact[length] // (fact[cnt] * fact[np.clip(lmc, 0, None)])
        out = np.where(lmc == -1, 0, out)
    return np.asarray(out, np.int64)


def binomial_coefficient(length, count, device=None) -> torch.Tensor:
    """Exact integer ``length choose count``, elementwise with broadcasting,
    as ``torch.int64`` on ``device`` (Pascal's recursion past length 20,
    factorials below)."""
    return torch.from_numpy(_binom(length, count)).to(default_device(device))


def _vocab_sequences(length: int, vocab_size: int) -> np.ndarray:
    if length < 0:
        raise RuntimeError(f"length must be non-negative, got {length}")
    if vocab_size <= 0:
        raise RuntimeError(f"vocab_size must be positive, got {vocab_size}")
    if not length:
        return np.zeros((1, 0), np.int64)
    s = np.arange(int(vocab_size) ** int(length), dtype=np.int64)
    return np.stack([(s // vocab_size**t) % vocab_size for t in range(length)], 1)


def enumerate_vocab_sequences(
    length: int, vocab_size: int, dtype: torch.dtype = torch.long, device=None
) -> torch.Tensor:
    """All ``vocab_size ** length`` sequences ``(vocab_size ** length,
    length)`` on ``device``, counting fastest in early steps: sequence
    ``s`` holds token ``(s // vocab_size ** t) % vocab_size`` at step
    ``t``."""
    support = _vocab_sequences(length, vocab_size)
    return torch.from_numpy(support).to(default_device(device), dtype)


def enumerate_binary_sequences(
    length: int, dtype: torch.dtype = torch.long, device=None
) -> torch.Tensor:
    """All ``2 ** length`` binary sequences (see
    :func:`enumerate_vocab_sequences`)."""
    return enumerate_vocab_sequences(length, 2, dtype, device)


def enumerate_binary_sequences_with_cardinality(
    length: Union[int, torch.Tensor], count: Union[int, torch.Tensor], dtype=torch.long,
    device=None,
):
    """Binary sequences of a fixed sum, on ``device``. With int arguments,
    the ``(binom(length, count), length)`` sequences; with tensors,
    ``(support, binom)``, ``support`` of shape ``B* + (binom_max,
    length_max)`` (rows past ``binom[b]`` are zero) and ``binom`` of the
    broadcast shape."""
    device = default_device(device)
    if isinstance(length, (int, np.integer)) and isinstance(count, (int, np.integer)):
        support = _vocab_sequences(int(length), 2)
        return torch.from_numpy(support[support.sum(1) == int(count)]).to(device, dtype)
    length, count = np.broadcast_arrays(_np(length), _np(count))
    binom = _binom(length, count)
    length_ = int(length.max(initial=0))
    binom_ = int(binom.max(initial=0))
    base = _vocab_sequences(length_, 2)  # (2**L, L)
    sums = base.sum(1)
    out = np.zeros(binom.shape + (binom_, length_), dtype=base.dtype)
    for b in np.ndindex(*binom.shape) if binom.shape else [()]:
        keep = base[(np.arange(len(base)) < 2 ** length[b]) & (sums == count[b])]
        out[b][: len(keep)] = keep
    return torch.from_numpy(out).to(device, dtype), torch.from_numpy(binom).to(device)


class SimpleRandomSamplingWithoutReplacement:
    """The uniform distribution over binary vectors of ``out_size`` entries
    whose first ``total_count`` hold ``given_count`` ones: sampling (from a
    generator or given uniforms), exact log-probabilities and support
    enumeration."""

    def __init__(self, given_count, total_count, out_size: Optional[int] = None):
        total_count, given_count = torch.broadcast_tensors(
            torch.as_tensor(total_count), torch.as_tensor(given_count)
        )
        if out_size is None:
            out_size = int(_np(total_count).max())
        self.total_count, self.given_count = total_count, given_count
        self.out_size = int(out_size)

    @property
    def batch_shape(self) -> torch.Size:
        return self.given_count.shape

    @property
    def event_shape(self) -> torch.Size:
        return torch.Size((self.out_size,))

    @property
    def has_enumerate_support(self) -> bool:
        tc, gc = _np(self.total_count).ravel(), _np(self.given_count).ravel()
        return bool((tc == tc[0]).all() and (gc == gc[0]).all())

    def enumerate_support(self, expand: bool = True) -> torch.Tensor:
        if not self.has_enumerate_support:
            raise NotImplementedError(
                "total_count must all be equal and given_count must all be "
                "equal to enumerate support"
            )
        total = int(_np(self.total_count).ravel()[0])
        given = int(_np(self.given_count).ravel()[0])
        support = enumerate_binary_sequences_with_cardinality(
            total, given, torch.float32, self.total_count.device
        )
        if self.out_size != total:
            support = torch.nn.functional.pad(support, (0, self.out_size - total))
        support = support.reshape((-1,) + (1,) * len(self.batch_shape) + (self.out_size,))
        if expand:
            support = support.expand((support.shape[0],) + tuple(self.batch_shape) + (self.out_size,))
        return support

    @property
    def log_partition(self) -> torch.Tensor:
        """``log C(total_count, given_count)``, batched."""
        dev = self.total_count.device
        log_factorial = torch.cumsum(
            torch.log(torch.arange(1, self.out_size + 1, dtype=torch.float32, device=dev)), 0
        )
        tc, gc = self.total_count.long(), self.given_count.long()
        return (
            log_factorial[(tc - 1).clamp(min=0)]
            - log_factorial[(gc - 1).clamp(min=0)]
            - log_factorial[(tc - gc - 1).clamp(min=0)]
        )

    @property
    def mean(self) -> torch.Tensor:
        dev = self.total_count.device
        len_mask = self.total_count[..., None] <= torch.arange(self.out_size, device=dev)
        m = (self.given_count / self.total_count.clamp(min=1))[..., None]
        return torch.where(len_mask, 0.0, m.expand(tuple(self.batch_shape) + (self.out_size,)))

    @property
    def variance(self) -> torch.Tensor:
        return self.mean * (1 - self.mean)

    def sample(
        self,
        sample_shape: Sequence[int] = (),
        generator: Optional[torch.Generator] = None,
        u: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        shape = tuple(sample_shape) + tuple(self.batch_shape)
        return simple_random_sampling_without_replacement(
            generator, self.total_count.expand(shape), self.given_count.expand(shape),
            self.out_size, u,
        )

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return (-self.log_partition).expand(value.shape[:-1])
