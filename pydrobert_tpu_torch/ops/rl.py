"""Reinforcement-learning returns (counterpart of
:mod:`pydrobert_tpu.ops.rl`)."""

import torch

__all__ = ["time_distributed_return"]


def time_distributed_return(r: torch.Tensor, gamma: float, batch_first: bool = False) -> torch.Tensor:
    """The sum of discounted future rewards at every step, ``R[t] = sum_{t'
    >= t} gamma^(t' - t) r[t']``, over ``r (T, N)`` (``(N, T)`` with
    ``batch_first``): one product with the triangular discount matrix.
    The powers are taken of the index difference, so they do not
    underflow to ``0 / 0`` on long sequences. On the card the product is
    float32 only while TF32 matmuls are off (PyTorch's default)."""
    r = torch.as_tensor(r)
    if r.dim() != 2:
        raise RuntimeError("r must be 2 dimensional")
    if not gamma:
        return r
    T = r.shape[1] if batch_first else r.shape[0]
    exp = torch.arange(T, dtype=r.dtype, device=r.device)
    diff = exp[None, :] - exp[:, None]  # (t, t')
    pow_ = torch.pow(torch.tensor(float(gamma), dtype=r.dtype, device=r.device), diff.abs())
    if batch_first:
        return r @ torch.tril(pow_.T)
    return torch.triu(pow_) @ r
