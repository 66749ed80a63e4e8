"""``log_softmax`` and ``softmax`` as ``jax.nn`` rounds them.

``jax.nn.log_softmax`` and ``jax.nn.softmax`` take their steps (the max,
the shift, the exponentials, their sum, the log or the division) in the
input's dtype, rounding each. ``torch.log_softmax`` and ``torch.softmax``
round once, which parts from the JAX package in float16 and bfloat16. The
helpers below take the stepwise form for those two dtypes and keep the
library call for every other dtype, where it is one pass over the data.
The max is detached, as ``jax.nn`` stops its gradient.
"""

import torch

__all__ = ["log_softmax", "softmax"]

_HALF = (torch.float16, torch.bfloat16)


def log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.log_softmax(x, dim)``."""
    if x.dtype not in _HALF:
        return torch.log_softmax(x, dim)
    shifted = x - x.amax(dim, keepdim=True).detach()
    return shifted - torch.log(torch.exp(shifted).sum(dim, keepdim=True))


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax(x, dim)``."""
    if x.dtype not in _HALF:
        return torch.softmax(x, dim)
    unnormalized = torch.exp(x - x.amax(dim, keepdim=True).detach())
    return unnormalized / unnormalized.sum(dim, keepdim=True)
