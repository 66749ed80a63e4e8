"""Global soft attention (counterpart of :mod:`pydrobert_tpu.ops.attn`).

The same broadcast contract as the JAX package's flax modules: ``query``
``(A*, query_size)``, ``key`` ``(B*, T, C*, key_size)``, ``value``
``(B*, T, C*, D*)`` and a boolean ``mask`` ``(B*, T, C*)``, the attended
sequence axis at ``dim`` of ``key`` (any axis but the last). Masking fills
``-inf`` before the softmax, so a fully masked row gives NaN, as in the JAX
package. The weighted sum is ``(a[..., None] * value).sum(dim)``.

Parameters are named as the flax tree names them (``linear``, ``v``,
``WQ``...), with :class:`torch.nn.Linear` weights ``(out, in)`` where flax
keeps ``(in, out)`` kernels. Weights are drawn from an optional CPU
:class:`torch.Generator` with flax's initializers' scales; the draws differ
from flax's.
"""

import abc
import math
from typing import Optional

import torch
from torch import nn

__all__ = [
    "ConcatSoftAttention",
    "DotProductSoftAttention",
    "GeneralizedDotProductSoftAttention",
    "GlobalSoftAttention",
    "MultiHeadedAttention",
]


def _dense(d_in: int, d_out: int, bias: bool, generator) -> nn.Linear:
    """A flax ``nn.Dense``'s counterpart: LeCun-normal weights, zero bias."""
    lin = nn.Linear(d_in, d_out, bias=bias)
    with torch.no_grad():
        lin.weight.normal_(0.0, 1.0 / math.sqrt(d_in), generator=generator)
        if bias:
            lin.bias.zero_()
    return lin


def _broadcast_checks(att, query, key, value, mask):
    """The shape checks both ``check_input`` methods share."""
    key_dim = key.dim()
    if query.dim() != key_dim - 1:
        raise ValueError("query must have one fewer dimension than key")
    if key_dim != value.dim():
        raise ValueError("key must have same number of dimensions as value")
    if query.shape[-1] != att.query_size:
        raise ValueError("Last dimension of query must match query_size")
    if key.shape[-1] != att.key_size:
        raise ValueError("Last dimension of key must match key_size")
    # dim == -1 would put the attended axis on the feature axis
    if att.dim > key_dim - 2 or att.dim == -1 or att.dim < -key_dim + 1:
        raise ValueError(
            f"dim must be in the range [{-key_dim + 1}, {key_dim - 2}] and not -1"
        )
    e_shape = torch.broadcast_shapes(
        query.unsqueeze(att.dim).shape[:-1], key.shape[:-1]
    )
    if mask is not None:
        torch.broadcast_shapes(e_shape, mask.shape)
    torch.broadcast_shapes(tuple(e_shape) + (1,), value.shape)


class GlobalSoftAttention(nn.Module, metaclass=abc.ABCMeta):
    """Base class: softmax over scores along ``dim``, weighted sum of
    values. Subclasses implement :meth:`score`."""

    def __init__(self, query_size: int = 0, key_size: int = 0, dim: int = 0):
        super().__init__()
        self.query_size = query_size
        self.key_size = key_size
        self.dim = dim

    @abc.abstractmethod
    def score(self, query: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
        """Scores ``(E*, T, F*)`` from query ``(A*, qs)`` and key ``(B*, T,
        C*, ks)``."""

    def check_input(self, query, key, value, mask=None) -> None:
        _broadcast_checks(self, query, key, value, mask)

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        self.check_input(query, key, value, mask)
        e = self.score(query, key)
        if mask is not None:
            e = torch.where(mask, e, -math.inf)
        a = torch.softmax(e, self.dim)
        return (a[..., None] * value).sum(self.dim)


class DotProductSoftAttention(GlobalSoftAttention):
    """``e = scale_factor * <query, key>``. ``size`` sets both
    ``query_size`` and ``key_size``."""

    def __init__(
        self,
        query_size: int = 0,
        key_size: int = 0,
        dim: int = 0,
        size: Optional[int] = None,
        scale_factor: float = 1.0,
    ):
        if size is not None:
            query_size = key_size = size
        super().__init__(query_size, key_size, dim)
        self.size = size
        self.scale_factor = scale_factor

    def score(self, query, key):
        return (query.unsqueeze(self.dim) * key).sum(-1) * self.scale_factor


class GeneralizedDotProductSoftAttention(GlobalSoftAttention):
    """``e = query^T W key (+ query^T b)``: Luong's "general" score."""

    def __init__(
        self,
        query_size: int = 0,
        key_size: int = 0,
        dim: int = 0,
        use_bias: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(query_size, key_size, dim)
        self.use_bias = use_bias
        self.linear = _dense(key_size, query_size, use_bias, generator)

    def score(self, query, key):
        return (query.unsqueeze(self.dim) * self.linear(key)).sum(-1)


class ConcatSoftAttention(GlobalSoftAttention):
    """Bahdanau's score: ``e = v^T tanh(W [query; key])``."""

    def __init__(
        self,
        query_size: int = 0,
        key_size: int = 0,
        dim: int = 0,
        use_bias: bool = False,
        hidden_size: int = 1000,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(query_size, key_size, dim)
        self.use_bias = use_bias
        self.hidden_size = hidden_size
        self.linear = _dense(query_size + key_size, hidden_size, use_bias, generator)
        self.v = nn.Parameter(torch.randn((hidden_size,), generator=generator))

    def score(self, query, key):
        query = query.unsqueeze(self.dim)
        shape = torch.broadcast_shapes(query.shape[:-1], key.shape[:-1])
        query = query.expand(tuple(shape) + (query.shape[-1],))
        key = key.expand(tuple(shape) + (key.shape[-1],))
        cat = torch.cat([query, key], -1)
        return torch.tanh(self.linear(cat)) @ self.v


class MultiHeadedAttention(GlobalSoftAttention):
    """Project query, key and value into ``num_heads`` heads, run
    ``single_head_attention`` on each (the head axis rides the broadcast
    contract), concatenate and project. ``d_v`` defaults to ``max(1,
    value_size // num_heads)`` and ``dim`` is the single head's, which may
    not be negative."""

    def __init__(
        self,
        query_size: int,
        key_size: int,
        value_size: int,
        num_heads: int,
        single_head_attention: GlobalSoftAttention,
        out_size: Optional[int] = None,
        d_v: Optional[int] = None,
        bias_WQ: bool = False,
        bias_WK: bool = False,
        bias_WV: bool = False,
        bias_WC: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        if single_head_attention.dim < 0:
            raise ValueError("Negative dimensions are ambiguous for multi-headed attention")
        super().__init__(query_size, key_size, single_head_attention.dim)
        self.value_size = value_size
        self.num_heads = num_heads
        self.single_head_attention = single_head_attention
        self.out_size = value_size if out_size is None else out_size
        self.d_v = max(1, value_size // num_heads) if d_v is None else d_v
        nh = num_heads
        d_q, d_k = single_head_attention.query_size, single_head_attention.key_size
        self.WQ = _dense(query_size, nh * d_q, bias_WQ, generator)
        self.WK = _dense(key_size, nh * d_k, bias_WK, generator)
        self.WV = _dense(value_size, nh * self.d_v, bias_WV, generator)
        self.WC = _dense(nh * self.d_v, self.out_size, bias_WC, generator)

    def score(self, query, key):
        raise NotImplementedError(
            "In MultiHeadedAttention, score() is handled by single_head_attention"
        )

    def check_input(self, query, key, value, mask=None):
        _broadcast_checks(self, query, key, value, mask)
        if value.shape[-1] != self.value_size:
            raise ValueError("Last dimension of value must match value_size")

    def forward(self, query, key, value, mask=None):
        self.check_input(query, key, value, mask)
        sha, nh = self.single_head_attention, self.num_heads
        q = self.WQ(query)
        q = q.reshape(q.shape[:-1] + (nh, sha.query_size))
        k = self.WK(key)
        k = k.reshape(k.shape[:-1] + (nh, sha.key_size))
        v = self.WV(value)
        v = v.reshape(v.shape[:-1] + (nh, self.d_v))
        if mask is not None:
            mask = mask.unsqueeze(-1)
        cat = sha(q, k, v, mask)
        return self.WC(cat.reshape(cat.shape[:-2] + (nh * self.d_v,)))
