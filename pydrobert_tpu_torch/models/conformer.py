"""Conformer CTC acoustic model and its training step (counterpart of
:mod:`pydrobert_tpu.models.conformer`).

The same network as the JAX package's ``ConformerCTC``: a two-conv
stride-4 subsampler, sinusoidal positions, Conformer blocks (half-step
feed-forward, self-attention, convolution module, half-step feed-forward,
per-block LayerNorm) and a float32 CTC head with the blank last. Module
and parameter names follow the flax tree (``block_0.mhsa.attn.query`` ...),
so :func:`state_dict_from_jax` is a renaming plus layout changes.

Numerics follow flax: parameters are float32 and every layer computes in
``cfg.dtype`` (bfloat16 by default), LayerNorm takes float32 statistics
with ``eps = 1e-6``, attention scales the query by ``1/sqrt(head_dim)``
before ``Q K^T`` and fills masked scores with ``finfo(dtype).min``. On the
card a float32 matrix product runs in full float32 by default
(``torch.backends.cuda.matmul.allow_tf32`` is False) while a float32
convolution runs in TF32 unless ``torch.backends.cudnn.allow_tf32`` is set
False; bfloat16 compute is unaffected by either.

Training follows the JAX package: dropout at the same sites with the same
quantized rate and scale (:class:`_FastDropout`), flax's attention-weight
dropout, :func:`ctc_loss` and :func:`make_train_step` (SpecAugment, forward,
CTC loss, backward, AdamW with optax's defaults from :func:`adamw`). Random
bits come from an explicit :class:`torch.Generator`, so they differ from
``jax.random``'s.

With ``num_experts > 1`` each block's second feed-forward is a top-k routed
mixture of experts (:class:`_MoEFeedForward`); the forward then also
returns each block's load-balance loss when asked (``return_aux=True``),
and :func:`make_train_step` adds ``moe_aux_weight`` times their sum
(:func:`moe_aux_loss`). With ``remat=True`` each block recomputes its
activations in the backward pass (:func:`_remat_block`), replaying the
step generator's dropout bits. Sequence sharding is not ported.

:func:`encoder_stream_step` runs a causal, dense encoder one chunk at a
time through the blocks' own modules, each handed its part of a per-layer
state cache (:class:`EncoderStreamState`); :func:`margin_window` re-encodes
a chunk with its receptive-field margin. Every streaming route takes one.

:func:`conformer_partition_rules` gives the tensor-parallel layout of the
state dict for :func:`pydrobert_tpu_torch.parallel.shard_params`;
:func:`stack_block_params`, :func:`make_pipelined_forward` and
:func:`make_pipeline_train_step` run the block stack as GPipe stages.
"""

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import default_device
from ..ops import kernels
from ..ops.topk import exact_top_k
from ..utils.profiling import span

__all__ = [
    "ConformerCTC",
    "ConformerConfig",
    "EncoderStreamState",
    "adamw",
    "conformer_partition_rules",
    "ctc_loss",
    "encoder_stream_state",
    "encoder_stream_step",
    "make_pipeline_train_step",
    "make_pipelined_forward",
    "make_train_step",
    "moe_aux_loss",
    "pipeline_partition_rules",
    "pipelined_encoder_forward",
    "stack_block_params",
    "state_dict_from_jax",
    "streaming_logits",
    "unstack_block_params",
]


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    """Hyperparameters for :class:`ConformerCTC`: the JAX package's
    ``ConformerConfig`` without its sharding field."""

    vocab_size: int = 1024  # excludes the CTC blank (blank = vocab_size)
    num_filts: int = 80
    d_model: int = 256
    num_layers: int = 8
    num_heads: int = 4
    ffn_factor: int = 4
    conv_kernel: int = 15
    subsample_channels: int = 128
    dropout: float = 0.1
    attn_dropout: float = 0.0  # attention-weight dropout (flax semantics)
    dtype: torch.dtype = torch.bfloat16  # compute dtype; params stay f32
    # limited attention context (left, right) in post-subsampling frames
    attention_context: Tuple[Optional[int], Optional[int]] = (None, None)
    causal_conv: bool = False
    # recompute each block's activations in the backward pass
    remat: bool = False
    # above 1, each block's second feed-forward is a top-k routed mixture
    # of experts with per-expert capacity buffers (_MoEFeedForward)
    num_experts: int = 1
    expert_top_k: int = 2
    expert_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def subsampling(self) -> int:
        return 4


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float (so a product with
    a tensor of that dtype rounds once, as ``x * jnp.asarray(value,
    dtype)`` does, with no host-to-device copy)."""
    return float(torch.tensor(value, dtype=dtype))


class _FastDropout(nn.Module):
    """The JAX package's ``_FastDropout``: the keep mask thresholds raw
    ``uint8`` random bits.

    The drop probability is quantized to 1/256 (``cutoff = round(rate *
    256)``, at most 255), a rate that rounds to 0 is a no-op, and a rate of
    1 or more gives zeros. Kept values scale by the realized keep
    probability ``256 / (256 - cutoff)`` rounded to ``x``'s dtype, so the
    output's expectation is ``x``. The bits come from ``generator``.
    """

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, deterministic: bool = True, generator=None):
        if deterministic or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        cutoff = min(round(self.rate * 256.0), 255)
        if cutoff == 0:
            return x
        scale = _in_dtype(256.0 / (256.0 - cutoff), x.dtype)
        bits = torch.randint(
            0, 256, x.shape, dtype=torch.uint8, generator=generator, device=x.device
        )
        return torch.where(bits >= cutoff, x * scale, 0)


class _LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: eps 1e-6, float32 statistics, output cast to
    the compute dtype."""

    def __init__(self, d: int, dtype: torch.dtype):
        super().__init__(d, eps=1e-6)
        self.dtype = dtype

    def forward(self, x):
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        ).to(self.dtype)


class _Dense(nn.Linear):
    """flax ``nn.Dense`` with a compute dtype: input, weight and bias cast
    to ``dtype`` before the product."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype):
        super().__init__(d_in, d_out)
        self.dtype = dtype

    def forward(self, x):
        return F.linear(
            x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype)
        )


class _FeedForward(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        d, f = cfg.d_model, cfg.d_model * cfg.ffn_factor
        self.ln = _LayerNorm(d, cfg.dtype)
        self.wi = _Dense(d, f, cfg.dtype)
        self.wo = _Dense(f, d, cfg.dtype)
        self.drop = _FastDropout(cfg.dropout)

    def forward(self, x, deterministic=True, generator=None):
        h = self.drop(F.silu(self.wi(self.ln(x))), deterministic, generator)
        return self.drop(self.wo(h), deterministic, generator)


class _MoEFeedForward(nn.Module):
    """The JAX package's ``_MoEFeedForward``: top-k routed experts with
    static per-expert capacity ``C = ceil(S * k * capacity_factor / E)``
    over the ``S`` tokens of the batch.

    The router runs in float32 and ranks with :func:`exact_top_k`
    (``lax.top_k``'s tie order). With ``k == 1`` the raw probability is the
    gate; with ``k > 1`` the gates are renormalized over the chosen
    experts. Each choice is ranked in its expert's buffer by the JAX
    package's slot-major float32 cumulative sum (every token's first choice
    before any second choice; exact below ``2**24`` tokens); choices past
    ``C`` drop, and padded frames never route.

    JAX builds ``(k S, E, C)`` one-hots and contracts them. Here the kept
    tokens are scattered into an ``(E C, d)`` buffer, the experts run as
    batched matrix products, and each token gathers its ``k`` outputs back,
    weighted by the gates rounded to the compute dtype. Dispatch copies one
    row per slot and combine sums at most ``k`` products, as the one-hot
    contractions do, without their ``O(S E C)`` memory.
    """

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        E, d = int(cfg.num_experts), cfg.d_model
        f = d * cfg.ffn_factor
        self.cfg = cfg
        self.ln = _LayerNorm(d, cfg.dtype)
        self.gate = _Dense(d, E, torch.float32)
        self.wi = nn.Parameter(torch.empty(E, d, f))
        self.bi = nn.Parameter(torch.zeros(E, f))
        self.wo = nn.Parameter(torch.empty(E, f, d))
        self.bo = nn.Parameter(torch.zeros(E, d))
        self.drop = _FastDropout(cfg.dropout)

    def route(
        self, y: torch.Tensor, pad_mask: torch.Tensor, experts: Optional[torch.Tensor] = None
    ) -> Dict[str, torch.Tensor]:
        """The router over normalized tokens ``y (N, T, d)``: ``probs (S,
        E)`` (zero on padded frames), ``gates (S, k)`` and ``experts (S,
        k)`` per choice, ``pos (S, k)`` each choice's slot in its expert's
        buffer, ``keep (S, k)`` whether it fits, and the capacity ``C``.
        Given ``experts`` replace the router's own top-k choices (to replay
        another run's decisions); the gates still come from ``probs``."""
        cfg = self.cfg
        E = int(cfg.num_experts)
        k = min(int(cfg.expert_top_k), E)
        S = y.shape[0] * y.shape[1]
        C = max(1, -(-int(S * k * cfg.expert_capacity_factor) // E))
        valid = pad_mask.reshape(S).float()
        logits = self.gate(y.reshape(S, -1).float())
        probs = torch.softmax(logits, -1) * valid[:, None]
        if experts is None:
            _, experts = exact_top_k(probs.detach(), k)
        gates = probs.gather(1, experts)
        if k > 1:
            gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
            gates = gates * valid[:, None]
        routed = (gates > 0).float()  # (S, k)
        # slot-major ranks: a float32 cumsum over (k S, E), as JAX ranks
        assign = F.one_hot(experts.T.reshape(-1), E).float() * routed.T.reshape(-1, 1)
        before = torch.cumsum(assign, 0) - assign
        pos = before.gather(1, experts.T.reshape(-1, 1)).reshape(k, S).T
        keep = (pos < C) & (routed > 0)
        return {
            "probs": probs, "gates": gates, "experts": experts,
            "pos": pos.long(), "keep": keep, "capacity": C,
        }

    def forward(self, x, pad_mask, deterministic=True, generator=None):
        """``(out (N, T, d), aux)``: the block's output and its Switch
        load-balance loss ``E * sum_e f_e P_e`` over unpadded tokens."""
        cfg = self.cfg
        dt = cfg.dtype
        E = int(cfg.num_experts)
        N, T, d = x.shape
        S = N * T
        y = self.ln(x)
        r = self.route(y, pad_mask)
        C, experts, keep = r["capacity"], r["experts"], r["keep"]
        slot = experts * C + r["pos"]  # (S, k), valid where keep
        tok = torch.arange(S, device=x.device)[:, None].expand_as(slot)
        yf = y.reshape(S, d).to(dt)
        xe = torch.zeros((E * C, d), dtype=dt, device=x.device)
        xe = xe.index_put((slot[keep],), yf[tok[keep]])
        h = F.silu(
            torch.bmm(xe.view(E, C, d), self.wi.to(dt)) + self.bi.to(dt)[:, None]
        )
        h = self.drop(h, deterministic, generator)
        oe = torch.bmm(h, self.wo.to(dt)) + self.bo.to(dt)[:, None]
        oe = oe.reshape(E * C, d)
        gates = torch.where(keep, r["gates"], 0.0).to(dt)
        picked = oe[torch.where(keep, slot, 0)]  # a dropped choice's gate is 0
        out = (picked.float() * gates.float()[..., None]).sum(1).to(dt)
        valid = pad_mask.reshape(S).float()
        nvalid = valid.sum().clamp(min=1.0)
        top1 = F.one_hot(experts[:, 0], E).float() * valid[:, None]
        aux = E * torch.sum((top1.sum(0) / nvalid) * (r["probs"].sum(0) / nvalid))
        out = self.drop(out.reshape(N, T, d), deterministic, generator)
        return out, aux


class _Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` as explicit matmuls and a
    softmax: query/key/value/out projections over all heads at once.

    Attention-weight dropout is flax's: one Bernoulli keep mask of shape
    ``(T, T)`` shared by every utterance and head, kept weights divided by
    the keep probability rounded to the compute dtype. Given ``cache``,
    queries attend over ``[cached ‖ new]`` keys, masked by ``cache.masked``."""

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        d = cfg.d_model
        self.num_heads = cfg.num_heads
        self.dtype = cfg.dtype
        self.dropout_rate = float(cfg.attn_dropout)
        self.query = _Dense(d, d, cfg.dtype)
        self.key = _Dense(d, d, cfg.dtype)
        self.value = _Dense(d, d, cfg.dtype)
        self.out = _Dense(d, d, cfg.dtype)

    def forward(self, y, mask, deterministic=True, generator=None, cache=None):
        N, T, d = y.shape
        H = self.num_heads
        hd = d // H

        def heads(x):  # (N, S, d) -> (N, H, S, hd)
            return x.view(N, x.shape[1], H, hd).transpose(1, 2)

        # flax divides the query by sqrt(depth) cast to the compute dtype; a
        # Python float, so an exported program holds no host tensor that a
        # move to another device would change (a card divides by a host
        # scalar as a product with its reciprocal)
        q = heads(self.query(y)) / _in_dtype(
            _in_dtype(math.sqrt(hd), torch.float32), self.dtype
        )
        k, v = self.key(y), self.value(y)
        if cache is None:
            masked = ~mask
        else:
            k, v = torch.cat([cache.keys, k], 1), torch.cat([cache.values, v], 1)
            cache.keys, cache.values, masked = k[:, T:], v[:, T:], cache.masked
        scores = torch.matmul(q, heads(k).transpose(-1, -2))  # (N, H, T, S)
        scores = scores.masked_fill(masked, torch.finfo(scores.dtype).min)
        w = torch.softmax(scores, -1).to(self.dtype)
        if not deterministic and self.dropout_rate > 0.0:
            keep_prob = 1.0 - self.dropout_rate
            keep = (
                torch.rand((T, T), generator=generator, device=y.device) < keep_prob
            )
            w = w * (keep.to(self.dtype) / _in_dtype(keep_prob, self.dtype))
        o = torch.matmul(w, heads(v)).transpose(1, 2).reshape(N, T, d)
        return self.out(o)


class _MHSA(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        self.ln = _LayerNorm(cfg.d_model, cfg.dtype)
        self.attn = _Attention(cfg)
        self.drop = _FastDropout(cfg.dropout)

    def forward(self, x, pad_mask, deterministic=True, generator=None, cache=None):
        mask = None  # a stream chunk's is in its cache
        if cache is None:
            T = x.shape[1]
            mask = pad_mask[:, None, None, :]  # (N, 1, 1, T): any unpadded key
            left, right = self.cfg.attention_context
            if left is not None or right is not None:
                q = torch.arange(T, device=x.device)[:, None]
                k = torch.arange(T, device=x.device)[None]
                band = torch.ones((T, T), dtype=torch.bool, device=x.device)
                if left is not None:
                    band = band & (k >= q - int(left))
                if right is not None:
                    band = band & (k <= q + int(right))
                mask = mask & band
        y = self.attn(self.ln(x), mask, deterministic, generator, cache)
        return self.drop(y, deterministic, generator)


class _DepthwiseConv1D(nn.Module):
    """Depthwise conv over time as K shifted multiply-adds in the compute
    dtype (``y``'s, which the block's dense layer gives), summed in the JAX
    package's order; ``kernel (K, C)``.

    With no gradient recorded through it, it runs
    :func:`~pydrobert_tpu_torch.ops.kernels.depthwise_conv1d` (one kernel
    launch on the card, the same bits; the wrapper refuses what its kernel
    cannot take); otherwise, as in training, the loop under autograd."""

    def __init__(self, K: int, C: int, causal: bool):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(K, C))
        self.bias = nn.Parameter(torch.zeros(C))
        self.causal = causal

    def forward(self, y):
        K = self.kernel.shape[0]
        left = K - 1 if self.causal else (K - 1) // 2
        args = (y, self.kernel, self.bias, left)
        with span("conv/depthwise"):
            if _kernel_route(*args[:3]):
                return kernels.depthwise_conv1d(*args)
            return kernels.depthwise_conv1d_reference(*args)


def _kernel_route(y, kernel, bias) -> bool:
    """Whether :class:`_DepthwiseConv1D` takes the kernel's wrapper: no
    gradient is recorded through it (the kernel has no backward)."""
    return not (torch.is_grad_enabled() and any(a.requires_grad for a in (y, kernel, bias)))


class _ConvModule(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        d = cfg.d_model
        self.ln = _LayerNorm(d, cfg.dtype)
        self.pw1 = _Dense(d, 2 * d, cfg.dtype)
        self.dw = _DepthwiseConv1D(cfg.conv_kernel, d, cfg.causal_conv)
        self.norm = _LayerNorm(d, cfg.dtype)
        self.pw2 = _Dense(d, d, cfg.dtype)
        self.drop = _FastDropout(cfg.dropout)

    def forward(self, x, pad_mask, deterministic=True, generator=None, cache=None):
        y = F.glu(self.pw1(self.ln(x)), -1)
        # zero padded frames so the depthwise conv cannot leak across lengths
        y = y * pad_mask[..., None].to(y.dtype)
        if cache is None:
            y = self.dw(y)
        else:
            T = y.shape[1]
            y = torch.cat([cache.conv, y], 1)
            cache.conv = y[:, T:]
            y = self.dw(y)[:, -T:]  # the causal conv's rows that read no padding
        y = self.pw2(F.silu(self.norm(y)))
        return self.drop(y, deterministic, generator)


class _ConformerBlock(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.ffn1 = _FeedForward(cfg)
        self.mhsa = _MHSA(cfg)
        self.conv = _ConvModule(cfg)
        if cfg.num_experts > 1:
            self.moe = _MoEFeedForward(cfg)
        else:
            self.ffn2 = _FeedForward(cfg)
        self.ln_out = _LayerNorm(cfg.d_model, cfg.dtype)

    def forward(self, x, pad_mask, deterministic=True, generator=None, cache=None):
        """``(x, aux)``: the block's output and the mixture of experts'
        load-balance loss (None for a dense block). Given ``cache`` (a
        :class:`_BlockCache`), ``x`` is the chunk of a stream that follows
        the cached frames, and the cache moves on past it in place."""
        if cache is not None and hasattr(self, "moe"):
            raise ValueError("a stream chunk requires a dense block (num_experts=1)")
        x = x + 0.5 * self.ffn1(x, deterministic, generator)
        x = x + self.mhsa(x, pad_mask, deterministic, generator, cache)
        x = x + self.conv(x, pad_mask, deterministic, generator, cache)
        aux = None
        if hasattr(self, "moe"):
            y, aux = self.moe(x, pad_mask, deterministic, generator)
        else:
            y = self.ffn2(x, deterministic, generator)
        return self.ln_out(x + 0.5 * y), aux


def _remat_block(
    block: nn.Module,
    x: torch.Tensor,
    pad_mask: torch.Tensor,
    deterministic: bool,
    generator: Optional[torch.Generator],
):
    """``block(x, pad_mask, deterministic, generator)`` under
    :func:`torch.utils.checkpoint.checkpoint`: its activations are
    recomputed in the backward pass instead of kept (the JAX package's
    ``nn.remat``).

    ``checkpoint`` replays the default CPU and CUDA generators only. The
    dropout bits here come from ``generator``, which the rest of the
    forward has moved on by the time the backward recomputes, so the
    recomputation would draw other masks and give wrong gradients without
    an error. The forward records ``generator``'s state before the block;
    the recomputation sets it back, runs, and then restores the state it
    found."""
    if generator is None or deterministic:
        return torch.utils.checkpoint.checkpoint(
            block, x, pad_mask, deterministic, generator, use_reentrant=False
        )
    start = []

    def run(x, pad_mask):
        if not start:  # the forward
            start.append(generator.get_state())
            return block(x, pad_mask, deterministic, generator)
        found = generator.get_state()
        generator.set_state(start[0])
        try:
            return block(x, pad_mask, deterministic, generator)
        finally:
            generator.set_state(found)

    return torch.utils.checkpoint.checkpoint(run, x, pad_mask, use_reentrant=False)


class _Conv2d(nn.Conv2d):
    """3x3 stride-2 conv with (1, 1) padding in the compute dtype."""

    def __init__(self, c_in: int, c_out: int, dtype: torch.dtype):
        super().__init__(c_in, c_out, 3, stride=2, padding=1)
        self.dtype = dtype

    def forward(self, x):
        return F.conv2d(
            x, self.weight.to(self.dtype), self.bias.to(self.dtype),
            stride=2, padding=1,
        )


class _ConvSubsample(nn.Module):
    """Two stride-2 convs over (time, freq), then a projection of each
    frame's (freq, channel) features, flattened channel-fastest as flax
    does for NHWC."""

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        C = cfg.subsample_channels
        F4 = -(-(-(-cfg.num_filts // 2)) // 2)
        self.conv1 = _Conv2d(1, C, cfg.dtype)
        self.conv2 = _Conv2d(C, C, cfg.dtype)
        self.proj = _Dense(F4 * C, cfg.d_model, cfg.dtype)

    def forward(self, feats):
        x = F.relu(self.conv1(feats[:, None]))  # (N, C, T2, F2)
        x = F.relu(self.conv2(x))  # (N, C, T4, F4)
        N, C, T4, F4 = x.shape
        x = x.permute(0, 2, 3, 1).reshape(N, T4, F4 * C)
        return self.proj(x)


def _sinusoidal_pos_emb(T: int, d: int, dtype, device, offset: int = 0) -> torch.Tensor:
    # `offset` shifts the absolute positions (streaming chunks encode with
    # their true global positions; int offsets are exact in f32 < 2**24)
    pos = (torch.arange(T, device=device) + int(offset)).float()[:, None]
    dim = torch.arange(0, d, 2, device=device, dtype=torch.float32)[None]
    angles = pos / torch.pow(10000.0, dim / d)
    emb = torch.zeros((T, d), dtype=torch.float32, device=device)
    emb[:, 0::2] = torch.sin(angles)
    emb[:, 1::2] = torch.cos(angles[:, : d // 2])
    return emb.to(dtype)


def _add_encoder(module: nn.Module, cfg: ConformerConfig) -> None:
    """Give ``module`` the encoder's submodules under the flax names
    (``subsample``, ``block_i``) and its input dropout, for
    :func:`_encoder_body`."""
    module.subsample = _ConvSubsample(cfg)
    for i in range(cfg.num_layers):
        module.add_module(f"block_{i}", _ConformerBlock(cfg))
    module.drop = _FastDropout(cfg.dropout)


def _encoder_body(
    module: nn.Module,
    cfg: ConformerConfig,
    feats: torch.Tensor,
    lens: torch.Tensor,
    deterministic: bool,
    generator: Optional[torch.Generator],
    pos_offset: int,
):
    """The shared conformer encoder (the JAX package's ``_encoder_body``):
    mask, subsample, positions, dropout, the block stack, over the
    submodules :func:`_add_encoder` gave ``module``. Returns ``(x (N, T',
    d_model) in cfg.dtype, pad_mask (N, T'), out_lens (N,), aux)``, ``aux``
    the list of the mixture-of-experts blocks' load-balance losses (empty
    for a dense config)."""
    dev = module.subsample.proj.weight.device
    feats = feats.to(dev)
    lens = lens.to(dev, torch.long)
    in_mask = torch.arange(feats.shape[1], device=dev)[None] < lens[:, None]
    # zero frames past each length so nothing leaks through the
    # subsampling convs into the last valid frame
    feats = feats * in_mask[..., None].to(feats.dtype)
    x = module.subsample(feats.to(cfg.dtype))
    out_lens = (((lens + 1) // 2) + 1) // 2  # ceil-div by 2, twice
    T4 = x.shape[1]
    pad_mask = torch.arange(T4, device=dev)[None] < out_lens[:, None]
    x = x + _sinusoidal_pos_emb(T4, cfg.d_model, cfg.dtype, dev, pos_offset)[None]
    x = module.drop(x, deterministic, generator)
    aux = []
    for i in range(cfg.num_layers):
        block = getattr(module, f"block_{i}")
        if cfg.remat:
            x, a = _remat_block(block, x, pad_mask, deterministic, generator)
        else:
            x, a = block(x, pad_mask, deterministic, generator)
        if a is not None:
            aux.append(a)
    return x, pad_mask, out_lens, aux


@torch.no_grad()
def _init_params(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """LeCun-normal weights, zero biases, unit LayerNorm scales (the flax
    defaults' scales; the draws differ from flax's)."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(module.get_submodule(name.rsplit(".", 1)[0]), nn.LayerNorm):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf in ("bias", "bi", "bo"):
            p.zero_()
        else:
            fan_in = p[0].numel() if p.dim() > 1 else 1
            if leaf == "kernel":  # depthwise (K, C): one input per tap
                fan_in = p.shape[0]
            elif leaf in ("wi", "wo"):  # experts (E, in, out)
                fan_in = p.shape[1]
            p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)


class ConformerCTC(nn.Module):
    """Conformer encoder + CTC head.

    ``ConformerCTC(cfg, device=None, generator=None)`` builds the model on
    ``device`` (``cuda`` when None; raises without a card) with parameters
    drawn from ``generator`` (a CPU :class:`torch.Generator`, so a seed
    gives the same weights on every device). Call with batch-major
    ``feats (N, T, num_filts)`` and ``lens (N,)``; returns ``(logits
    (N, T', vocab_size + 1) float32, out_lens (N,))`` with the blank at
    index ``vocab_size`` and ``T' = ceil(ceil(T / 2) / 2)``. With
    ``deterministic=False`` dropout is on, drawing its bits from
    ``generator`` (on the model's device; its default generator when
    None). The module's ``train()``/``eval()`` mode plays no part.
    ``pos_offset`` shifts the sinusoidal positions, so a chunk of a stream
    encodes with its frames' global positions (:func:`streaming_logits`).
    With ``return_aux=True`` it returns ``(logits, out_lens, aux)``,
    ``aux`` the list of the mixture-of-experts blocks' load-balance losses
    (:func:`moe_aux_loss` sums them).
    """

    def __init__(
        self,
        cfg: ConformerConfig,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = default_device(device)
        self.cfg = cfg
        _add_encoder(self, cfg)
        self.ctc_head = _Dense(cfg.d_model, cfg.vocab_size + 1, torch.float32)
        _init_params(self, generator)
        self.to(device)

    def forward(
        self,
        feats: torch.Tensor,
        lens: torch.Tensor,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        pos_offset: int = 0,
        return_aux: bool = False,
    ):
        x, _, out_lens, aux = _encoder_body(
            self, self.cfg, feats, lens, deterministic, generator, pos_offset
        )
        logits = self.ctc_head(x.float())
        return (logits, out_lens, aux) if return_aux else (logits, out_lens)


def streaming_margin(cfg: ConformerConfig, what: str) -> int:
    """The receptive-field margin ``R = num_layers * (L + conv_kernel - 1)``
    of a causal config, in post-subsampling frames; raises ``ValueError``
    for any other config (``what`` names the caller)."""
    left, right = cfg.attention_context
    if left is None or right != 0 or not cfg.causal_conv:
        raise ValueError(
            f"{what} requires a causal config: "
            "attention_context=(L, 0) with finite L and causal_conv=True "
            f"(got attention_context={cfg.attention_context}, "
            f"causal_conv={cfg.causal_conv})"
        )
    return cfg.num_layers * (int(left) + cfg.conv_kernel - 1)


@torch.no_grad()
def streaming_logits(
    model: ConformerCTC, feats: torch.Tensor, lens: torch.Tensor, chunk: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked (streaming) CTC logits of a causal config: the output of
    ``model(feats, lens)``, computed in post-subsampling chunks of ``chunk``
    frames that each re-encode only their receptive-field margin (the JAX
    package's ``streaming_logits``).

    The config must have ``attention_context = (L, 0)`` with finite ``L``
    and ``causal_conv = True``; each chunk then encodes ``O(chunk + R)``
    frames, ``R = num_layers * (L + conv_kernel - 1)``. Within each
    utterance's ``out_lens`` the logits match the one-shot forward up to
    the order of reductions; frames past ``out_lens`` are unspecified in
    both.
    """
    _, chunks = margin_chunks(model, model.cfg, feats, lens, chunk, "streaming_logits")
    logits = torch.cat([rows for rows, _ in chunks], 1)
    out_lens = (((torch.as_tensor(lens).to(logits.device).long() + 1) // 2) + 1) // 2
    return logits, out_lens


def margin_start(o: int, R: int) -> int:
    """The first frame that re-encoding frames ``o...`` reads: ``R`` back,
    and one more, as subsampled row ``m`` reads raw frames left of ``4 m``."""
    return max(o - R - 1, 0)


def margin_window(encode, feats, start, lens, R, o0, o1, length=None) -> torch.Tensor:
    """Rows ``[o0, o1)`` of a causal encoder from one encode of raw frames
    ``[4 margin_start(o0, R), min(4 o1, start + T))``, zero-padded to
    ``length`` frames when given: ``encode(f, l, pos_offset=m0)[0]`` with
    ``feats (N, T, F)`` raw frames from ``start`` on and ``lens`` (a tensor
    or an array) the raw lengths from 0, clipped to the window."""
    m0 = margin_start(o0, R)
    i0, i1 = 4 * m0, min(4 * o1, start + feats.shape[1])
    f = feats[:, i0 - start : i1 - start]
    if length is not None and f.shape[1] < length:
        f = torch.cat([f, f.new_zeros((f.shape[0], length - f.shape[1], f.shape[2]))], 1)
    rows = encode(f, (lens - i0).clip(0, i1 - i0), pos_offset=m0)[0]
    return rows[:, o0 - m0 : o1 - m0]


def margin_chunks(encode, cfg: ConformerConfig, feats, lens, chunk: int, what: str):
    """The causal encoder ``encode`` of config ``cfg`` over ``feats`` in
    chunks of ``chunk`` post-subsampling frames, each from its
    :func:`margin_window`: ``(T', [(rows, chunk_lens), ...])``, the chunks
    lazily, ``chunk_lens`` each stream's valid rows; ``what`` names the
    caller."""
    R = streaming_margin(cfg, what)
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    T4 = -(-feats.shape[1] // 4)  # the subsampler's ceil-div by 2, twice
    lens = torch.as_tensor(lens)
    out_lens = ((lens.long() + 1) // 2 + 1) // 2
    return T4, (
        (
            margin_window(encode, feats, 0, lens, R, o0, min(o0 + chunk, T4)),
            (out_lens - o0).clamp(0, min(chunk, T4 - o0)),
        )
        for o0 in range(0, T4, chunk)
    )


# ---------------------------------------------------------------------------
# The encoder one chunk at a time from a per-layer state cache: each chunk's
# frames encoded once by the blocks' own modules, attending to the cached
# keys and values and convolving over the cached GLU outputs, in place of
# re-encoding the receptive-field margin.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EncoderStreamState:
    """What :func:`encoder_stream_step` carries from one chunk to the next
    for ``N`` streams, the next chunk starting at post-subsampling frame
    ``o0``: the subsampler's raw context, and per block the keys and values
    of the last ``L`` frames and the last ``conv_kernel - 1`` GLU outputs
    (after the pad mask), in the compute dtype. Frames before the stream's
    start are zeros, as the one-shot forward pads them."""

    raw: torch.Tensor  # (N, 4, num_filts) float32: raw frames [4 o0 - 4, 4 o0), masked
    keys: List[torch.Tensor]  # per block (N, L, d_model): frames [o0 - L, o0)
    values: List[torch.Tensor]
    conv: List[torch.Tensor]  # per block (N, conv_kernel - 1, d_model)


def encoder_stream_state(
    module: nn.Module, cfg: ConformerConfig, batch_size: int
) -> EncoderStreamState:
    """The state of ``batch_size`` streams before their first chunk, for
    :func:`encoder_stream_step` over the submodules :func:`_add_encoder`
    gave ``module``. The config must be causal (:func:`streaming_margin`)
    and dense: a mixture of experts routes by the tokens of the batch, so a
    chunk would route otherwise than the one-shot forward."""
    streaming_margin(cfg, "the encoder's stream step")
    if cfg.num_experts > 1:
        raise ValueError("the encoder's stream step requires a dense config (num_experts=1)")
    N, d, L, K = int(batch_size), cfg.d_model, int(cfg.attention_context[0]), cfg.conv_kernel
    dev = module.subsample.proj.weight.device

    def zeros(T):
        return [torch.zeros((N, T, d), dtype=cfg.dtype, device=dev) for _ in range(cfg.num_layers)]

    raw = torch.zeros((N, 4, cfg.num_filts), device=dev)
    return EncoderStreamState(raw, zeros(L), zeros(L), zeros(K - 1))


@dataclasses.dataclass
class _BlockCache:
    """A block's part of :class:`EncoderStreamState`, and ``masked (N, 1,
    C, L + C)`` the ``[cached ‖ new]`` keys each query may not see."""

    masked: torch.Tensor
    keys: torch.Tensor
    values: torch.Tensor
    conv: torch.Tensor


@torch.no_grad()
def encoder_stream_step(
    module: nn.Module,
    cfg: ConformerConfig,
    state: EncoderStreamState,
    feats: torch.Tensor,
    lens: torch.Tensor,
    pos_offset: int,
) -> Tuple[torch.Tensor, EncoderStreamState]:
    """One chunk of a causal, dense encoder (deterministic) from the state
    the chunks before it left: ``(x (N, C, d_model) in cfg.dtype, state)``,
    the rows of post-subsampling frames ``[o0, o0 + C)``, ``o0 =
    pos_offset``, and the state for the chunk at ``o0 + C``.

    ``feats (N, 4 C, num_filts)`` are the raw frames ``[4 o0, 4 o0 + 4 C)``
    and ``lens (N,)`` each stream's raw length counted from raw frame ``4
    o0`` (zero or negative for a stream that ended before it). Lengths must
    be final up to the chunk's end. Within each stream's
    ``ceil(length / 4)`` frames the rows match :func:`_encoder_body`'s
    over the whole stream, padded past its end, up to the order of
    reductions; rows past them are unspecified, and no later valid row
    reads them. Chunks follow one another from ``o0 = 0``; chunks of one
    size keep every shape after the first fixed."""
    dt, dev = cfg.dtype, module.subsample.proj.weight.device
    N, T, _ = feats.shape
    C, L = T // 4, int(cfg.attention_context[0])
    lens = lens.to(dev, torch.long)
    feats = feats.to(dev) * (torch.arange(T, device=dev)[None] < lens[:, None])[..., None].to(
        feats.dtype
    )
    if pos_offset == 0:
        x = module.subsample(feats.to(dt))
    else:
        # row 0 of [context ‖ chunk] reads the subsampler's padding; rows
        # 1.. read only real frames, as the one-shot forward's do
        x = module.subsample(torch.cat([state.raw, feats], 1).to(dt))[:, 1:]
    x = x + _sinusoidal_pos_emb(C, cfg.d_model, dt, dev, pos_offset)[None]
    out_lens = -torch.div(-lens, 4, rounding_mode="floor")  # valid rows of the chunk
    pad = torch.arange(C, device=dev)[None] < out_lens[:, None]
    # key i of [cached ‖ new] sits at frame o0 - L + i; query j at o0 + j
    rel = torch.arange(-L, C, device=dev)
    q = torch.arange(C, device=dev)[:, None]
    band = (rel >= q - L) & (rel <= q) & (rel >= -int(pos_offset))
    masked = ~(band & (rel < out_lens[:, None, None])[:, None])  # (N, 1, C, L + C)
    keys, values, conv = [], [], []
    for i, kvc in enumerate(zip(state.keys, state.values, state.conv)):
        cache = _BlockCache(masked, *kvc)
        x, _ = getattr(module, f"block_{i}")(x, pad, cache=cache)
        keys.append(cache.keys)
        values.append(cache.values)
        conv.append(cache.conv)
    return x, EncoderStreamState(feats[:, T - 4 :], keys, values, conv)


def _linear(kernel, bias) -> Dict[str, np.ndarray]:
    return {"weight": np.asarray(kernel).T, "bias": np.asarray(bias)}


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A :class:`ConformerCTC` ``state_dict`` from the JAX package's flax
    parameter tree, given as nested dicts of numpy arrays (for example
    ``jax.tree.map(np.asarray, params)``). The result loads with
    ``load_state_dict(..., strict=True)``.

    Dense kernels ``(in, out)`` transpose to ``(out, in)``; attention
    kernels ``(d, H, hd)`` and ``(H, hd, d)`` flatten their head axes;
    conv kernels HWIO become OIHW; LayerNorm ``scale`` becomes ``weight``;
    the experts' ``wi (E, d, f)``, ``bi``, ``wo (E, f, d)`` and ``bo`` keep
    their layouts. The map is linear, so it also carries a gradient tree of the same
    structure onto the names of the port's ``.grad``s.
    """
    out = _encoder_state_dict(params)
    out["ctc_head.weight"] = np.asarray(params["ctc_head"]["kernel"]).T
    out["ctc_head.bias"] = np.asarray(params["ctc_head"]["bias"])
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in out.items()}


def _encoder_state_dict(params: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """The encoder's part of :func:`state_dict_from_jax`: the flax
    ``subsample`` and ``block_i`` subtrees of ``params`` as port names
    under ``prefix``, numpy arrays."""
    out: Dict[str, np.ndarray] = {}

    def put(name, d):
        for k, v in d.items():
            out[f"{prefix}{name}.{k}"] = v

    def ln(p):
        return {"weight": np.asarray(p["scale"]), "bias": np.asarray(p["bias"])}

    sub = params["subsample"]
    for c in ("conv1", "conv2"):
        put(
            f"subsample.{c}",
            {
                "weight": np.transpose(np.asarray(sub[c]["kernel"]), (3, 2, 0, 1)),
                "bias": np.asarray(sub[c]["bias"]),
            },
        )
    put("subsample.proj", _linear(sub["proj"]["kernel"], sub["proj"]["bias"]))
    i = 0
    while f"block_{i}" in params:
        blk, pre = params[f"block_{i}"], f"block_{i}"
        if "moe" in blk:
            moe = blk["moe"]
            put(f"{pre}.moe.ln", ln(moe["ln"]))
            put(f"{pre}.moe.gate", _linear(moe["gate"]["kernel"], moe["gate"]["bias"]))
            put(f"{pre}.moe", {w: np.asarray(moe[w]) for w in ("wi", "bi", "wo", "bo")})
        for f in ("ffn1", "ffn2") if "ffn2" in blk else ("ffn1",):
            put(f"{pre}.{f}.ln", ln(blk[f]["ln"]))
            for w in ("wi", "wo"):
                put(f"{pre}.{f}.{w}", _linear(blk[f][w]["kernel"], blk[f][w]["bias"]))
        attn = blk["mhsa"]["attn"]
        put(f"{pre}.mhsa.ln", ln(blk["mhsa"]["ln"]))
        for w in ("query", "key", "value"):
            kern = np.asarray(attn[w]["kernel"])  # (d, H, hd)
            put(
                f"{pre}.mhsa.attn.{w}",
                _linear(
                    kern.reshape(kern.shape[0], -1),
                    np.asarray(attn[w]["bias"]).reshape(-1),
                ),
            )
        kern = np.asarray(attn["out"]["kernel"])  # (H, hd, d)
        put(
            f"{pre}.mhsa.attn.out",
            _linear(kern.reshape(-1, kern.shape[-1]), attn["out"]["bias"]),
        )
        conv = blk["conv"]
        put(f"{pre}.conv.ln", ln(conv["ln"]))
        put(f"{pre}.conv.pw1", _linear(conv["pw1"]["kernel"], conv["pw1"]["bias"]))
        put(
            f"{pre}.conv.dw",
            {
                "kernel": np.asarray(conv["dw"]["kernel"]),
                "bias": np.asarray(conv["dw"]["bias"]),
            },
        )
        put(f"{pre}.conv.norm", ln(conv["norm"]))
        put(f"{pre}.conv.pw2", _linear(conv["pw2"]["kernel"], conv["pw2"]["bias"]))
        put(f"{pre}.ln_out", ln(blk["ln_out"]))
        i += 1
    return out


def moe_aux_loss(aux) -> torch.Tensor:
    """The sum of the mixture-of-experts load-balance losses that the
    forward returned with ``return_aux=True`` (one scalar per block); 0.0
    when no block routes."""
    aux = list(aux)
    if not aux:
        return torch.zeros(())
    return torch.stack(aux).sum()


def ctc_loss(
    logits: torch.Tensor,
    logit_lens: torch.Tensor,
    refs: torch.Tensor,
    ref_lens: torch.Tensor,
    blank_id: int,
) -> torch.Tensor:
    """Mean per-utterance CTC loss from batch-major ``logits (N, T, C)``
    and dense ``refs (N, U)`` (``optax.ctc_loss`` then ``.mean()``, as the
    JAX package computes it). An alignment that cannot fit its reference
    costs ``inf`` here, where optax gives a large finite value. On a card
    ``F.ctc_loss`` copies the lengths to the host."""
    log_probs = torch.log_softmax(logits.float(), -1).transpose(0, 1)
    per_utt = F.ctc_loss(
        log_probs,
        refs.long(),
        logit_lens.long(),
        ref_lens.long(),
        blank=blank_id,
        reduction="none",
        zero_infinity=False,
    )
    return per_utt.mean()


def adamw(
    params,
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-4,
) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` with ``optax.adamw``'s defaults (PyTorch's own
    weight decay default is 0.01); both decay every parameter."""
    return torch.optim.AdamW(
        params, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=weight_decay
    )


def make_train_step(
    model: ConformerCTC,
    optimizer: torch.optim.Optimizer,
    augment: Optional[Callable] = None,
) -> Callable:
    """The training step: ``step(generator, feats, feat_lens, refs,
    ref_lens) -> loss``.

    ``augment`` optionally maps ``(generator, feats, lens) -> feats`` (for
    example SpecAugment) before the forward, which runs with dropout on;
    then the CTC loss, its backward and one optimizer step. Unlike the JAX
    package's pure step, this one updates ``model``'s parameters and
    ``optimizer``'s state in place, the PyTorch idiom, and returns the
    detached loss. The same generator feeds the augmentation and every
    dropout site, in that order. A mixture-of-experts config adds
    ``moe_aux_weight`` times :func:`moe_aux_loss` to the loss.
    """
    cfg = model.cfg
    blank_id = cfg.vocab_size

    def step(generator, feats, feat_lens, refs, ref_lens):
        if augment is not None:
            feats = augment(generator, feats, feat_lens)
        logits, out_lens, aux = model(
            feats, feat_lens, deterministic=False, generator=generator,
            return_aux=True,
        )
        loss = ctc_loss(logits, out_lens, refs, ref_lens, blank_id)
        if cfg.num_experts > 1:
            loss = loss + cfg.moe_aux_weight * moe_aux_loss(aux)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


# ---------------------------------------------------------------------------
# Tensor and pipeline parallelism: partition rules over the port's state
# dict names, and the block stack as GPipe stages
# (pydrobert_tpu_torch.parallel.pipeline) with the subsampler and the CTC
# head outside the pipeline.
# ---------------------------------------------------------------------------


def _names(path) -> Tuple[str, ...]:
    return tuple(path.split(".")) if isinstance(path, str) else tuple(str(p) for p in path)


def conformer_partition_rules(path, leaf: torch.Tensor):
    """Tensor-parallel :class:`~pydrobert_tpu_torch.parallel.PartitionSpec`
    of a :class:`ConformerCTC` parameter, by its state dict name (a dotted
    string or its parts): the JAX package's Megatron layout in PyTorch's
    ``(out, in)`` weight layout. Expand projections (feed-forward ``wi``,
    attention query/key/value, the CTC head) split their output features
    over ``model``, contract projections (feed-forward ``wo``, attention
    ``out``) their input features; mixture-of-experts weights split their
    expert axis; everything else (norms, biases, convolutions) is
    replicated."""
    from ..parallel.mesh import MODEL_AXIS, PartitionSpec

    names = _names(path)
    joined = ".".join(names)
    last = names[-1] if names else ""
    if ".moe." in f".{joined}.":
        if last in ("wi", "wo") and leaf.dim() == 3:
            return PartitionSpec(MODEL_AXIS, None, None)
        if last in ("bi", "bo") and leaf.dim() == 2:
            return PartitionSpec(MODEL_AXIS, None)
    if leaf.dim() == 2 and last == "weight":
        if len(names) >= 2 and names[-2] == "wi":
            return PartitionSpec(MODEL_AXIS, None)
        if len(names) >= 2 and names[-2] == "wo":
            return PartitionSpec(None, MODEL_AXIS)
        if any(f"attn.{w}." in joined for w in ("query", "key", "value")):
            return PartitionSpec(MODEL_AXIS, None)  # heads are output rows
        if "attn.out." in joined:
            return PartitionSpec(None, MODEL_AXIS)
        if names[0] == "ctc_head":
            return PartitionSpec(MODEL_AXIS, None)
    return PartitionSpec()


def _stack(params: Dict[str, torch.Tensor], pp: int, prefix: str) -> Dict[str, torch.Tensor]:
    blocks: Dict[str, Dict[int, torch.Tensor]] = {}
    out: Dict[str, torch.Tensor] = {}
    for k, v in params.items():
        if k.startswith(prefix + "block_"):
            i, rest = k[len(prefix) + 6 :].split(".", 1)
            blocks.setdefault(rest, {})[int(i)] = v
        else:
            out[k] = v
    L = len(next(iter(blocks.values()))) if blocks else 0
    if not L or L % pp:
        raise ValueError(f"num_layers {L} not divisible by pipeline {pp}")
    for rest, layers in blocks.items():
        x = torch.stack([layers[i].detach() for i in range(L)])
        out[f"{prefix}blocks.{rest}"] = x.reshape((pp, L // pp) + x.shape[1:]).requires_grad_(
            layers[0].requires_grad
        )
    return out


def _unstack(pparams: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for k, v in pparams.items():
        if not k.startswith(prefix + "blocks."):
            out[k] = v
            continue
        rest = k[len(prefix) + 7 :]
        flat = v.detach().reshape((v.shape[0] * v.shape[1],) + v.shape[2:])
        for i in range(flat.shape[0]):
            out[f"{prefix}block_{i}.{rest}"] = flat[i]
    return out


def stack_block_params(params: Dict[str, torch.Tensor], pipeline_parallelism: int):
    """A :class:`ConformerCTC` state dict in pipeline form: the ``block_i.*``
    tensors become ``blocks.*`` tensors with leading axes ``(pp,
    layers_per_stage)``, stage-major (new leaf tensors, requiring grad as
    the blocks' did); every other entry is the same tensor object.
    ``num_layers`` must divide by ``pipeline_parallelism``."""
    return _stack(params, pipeline_parallelism, "")


def unstack_block_params(pparams: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`stack_block_params` (views of the stacked
    tensors, detached)."""
    return _unstack(pparams, "")


def pipeline_partition_rules(path, leaf: torch.Tensor):
    """Partition rules of pipeline-form parameters: the block stacks split
    their stage axis over ``pipe``; everything outside the pipeline keeps
    :func:`conformer_partition_rules`' layout."""
    from ..parallel.mesh import PartitionSpec
    from ..parallel.pipeline import PIPE_AXIS

    names = _names(path)
    if names and names[0] == "blocks":
        return PartitionSpec(PIPE_AXIS)
    return conformer_partition_rules(path, leaf)


@functools.lru_cache(maxsize=None)
def _template(cls, cfg: ConformerConfig) -> nn.Module:
    """A parameterless ``cls(cfg)`` (on the meta device) to run with given
    parameters through :func:`torch.func.functional_call`."""
    with torch.device("meta"):
        return cls(cfg)


def _prefixed(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def _warn_pipeline_dropout(cfg: ConformerConfig) -> None:
    import warnings

    if cfg.dropout:
        warnings.warn(
            "the pipelined forward is deterministic: cfg.dropout="
            f"{cfg.dropout} will NOT be applied (regularize via the augment "
            "hook, or set dropout=0.0 to silence this)",
            stacklevel=3,
        )
    if cfg.num_experts > 1:
        warnings.warn(
            "the pipelined forward routes MoE experts but DROPS the router "
            "load-balance aux loss (it does not cross the pipeline's "
            "stages); train MoE configs with the non-pipelined step or "
            "accept unbalanced routing",
            stacklevel=3,
        )


def pipelined_encoder_forward(cfg: ConformerConfig, enc_pparams, feats, lens, mesh, n_microbatches):
    """The pipeline-form conformer encoder: the front (mask, subsampler,
    positions) outside the pipeline, the block stack as GPipe stages over
    ``mesh``'s ``pipe`` axis (:func:`~pydrobert_tpu_torch.parallel.
    pipeline_apply`). ``enc_pparams`` holds ``subsample.*`` and ``blocks.*``
    (:func:`stack_block_params`). Returns ``(x, pad_mask, out_lens)`` as
    :func:`_encoder_body` does, deterministic (no dropout)."""
    from ..parallel.pipeline import pipeline_apply

    dev = enc_pparams["subsample.proj.weight"].device
    feats = feats.to(dev)
    lens = lens.to(dev, torch.long)
    in_mask = torch.arange(feats.shape[1], device=dev)[None] < lens[:, None]
    feats = feats * in_mask[..., None].to(feats.dtype)
    x = torch.func.functional_call(
        _template(_ConvSubsample, cfg), _prefixed(enc_pparams, "subsample."),
        (feats.to(cfg.dtype),),
    )
    out_lens = (((lens + 1) // 2) + 1) // 2
    T4 = x.shape[1]
    pad_mask = torch.arange(T4, device=dev)[None] < out_lens[:, None]
    x = x + _sinusoidal_pos_emb(T4, cfg.d_model, cfg.dtype, dev)[None]
    block = _template(_ConformerBlock, cfg)

    def stage_fn(params, h, pm):
        for j in range(next(iter(params.values())).shape[0]):
            h, _ = torch.func.functional_call(
                block, {k: v[j] for k, v in params.items()}, (h, pm)
            )
        return h

    x = pipeline_apply(
        stage_fn, _prefixed(enc_pparams, "blocks."), x, extras=pad_mask,
        mesh=mesh, n_microbatches=n_microbatches,
    )
    return x, pad_mask, out_lens


def make_pipelined_forward(model: ConformerCTC, mesh, n_microbatches: int) -> Callable:
    """``fwd(pparams, feats, lens) -> (logits, out_lens)`` with the block
    stack as a GPipe pipeline over ``mesh``'s ``pipe`` axis; ``pparams`` is
    pipeline-form (:func:`stack_block_params`). Deterministic (no dropout;
    it warns when the config has some). The same operators as ``model``'s
    deterministic forward."""
    cfg = model.cfg
    _warn_pipeline_dropout(cfg)

    def fwd(pparams, feats, lens):
        x, _, out_lens = pipelined_encoder_forward(cfg, pparams, feats, lens, mesh, n_microbatches)
        logits = F.linear(x.float(), pparams["ctc_head.weight"], pparams["ctc_head.bias"])
        return logits, out_lens

    return fwd


def make_pipeline_train_step(
    model: ConformerCTC,
    optimizer: torch.optim.Optimizer,
    mesh,
    n_microbatches: int,
    augment: Optional[Callable] = None,
) -> Callable:
    """The pipeline-parallel :func:`make_train_step`: ``step(pparams,
    generator, feats, feat_lens, refs, ref_lens) -> loss``, ``pparams`` the
    pipeline-form tensors (:func:`stack_block_params`) that ``optimizer``
    updates. ``augment`` maps ``(generator, feats, lens) -> feats``; the
    forward is deterministic. Every rank calls it with the same batch; the
    backward runs the pipeline's reverse schedule, so every rank's
    ``pparams`` take the same update."""
    blank_id = model.cfg.vocab_size
    fwd = make_pipelined_forward(model, mesh, n_microbatches)

    def step(pparams, generator, feats, feat_lens, refs, ref_lens):
        if augment is not None:
            feats = augment(generator, feats, feat_lens)
        logits, out_lens = fwd(pparams, feats, feat_lens)
        loss = ctc_loss(logits, out_lens, refs, ref_lens, blank_id)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
