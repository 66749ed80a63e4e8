"""Conformer CTC acoustic model for inference (counterpart of
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

Training (dropout, SpecAugment, the backward pass), mixture-of-experts
blocks, rematerialization and sequence sharding are not ported yet.
"""

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import default_device

__all__ = ["ConformerCTC", "ConformerConfig", "state_dict_from_jax"]


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    """Hyperparameters for :class:`ConformerCTC`: the JAX package's
    ``ConformerConfig`` without its training and sharding fields."""

    vocab_size: int = 1024  # excludes the CTC blank (blank = vocab_size)
    num_filts: int = 80
    d_model: int = 256
    num_layers: int = 8
    num_heads: int = 4
    ffn_factor: int = 4
    conv_kernel: int = 15
    subsample_channels: int = 128
    dtype: torch.dtype = torch.bfloat16  # compute dtype; params stay f32
    # limited attention context (left, right) in post-subsampling frames
    attention_context: Tuple[Optional[int], Optional[int]] = (None, None)
    causal_conv: bool = False
    remat: bool = False  # not ported: raises when set
    num_experts: int = 1  # not ported: raises above 1

    def __post_init__(self):
        if self.num_experts > 1:
            raise NotImplementedError(
                "mixture-of-experts blocks are not ported yet"
            )
        if self.remat:
            raise NotImplementedError("remat is a training option, not ported")

    @property
    def subsampling(self) -> int:
        return 4


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

    def forward(self, x):
        return self.wo(F.silu(self.wi(self.ln(x))))


class _Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` as explicit matmuls and a
    softmax: query/key/value/out projections over all heads at once."""

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        d = cfg.d_model
        self.num_heads = cfg.num_heads
        self.dtype = cfg.dtype
        self.query = _Dense(d, d, cfg.dtype)
        self.key = _Dense(d, d, cfg.dtype)
        self.value = _Dense(d, d, cfg.dtype)
        self.out = _Dense(d, d, cfg.dtype)

    def forward(self, y, mask):
        N, T, d = y.shape
        H = self.num_heads
        hd = d // H

        def heads(x):  # (N, T, d) -> (N, H, T, hd)
            return x.view(N, T, H, hd).transpose(1, 2)

        # flax divides the query by sqrt(depth) cast to the compute dtype
        q = heads(self.query(y)) / torch.tensor(
            math.sqrt(hd), dtype=torch.float32
        ).to(self.dtype)
        k, v = heads(self.key(y)), heads(self.value(y))
        scores = torch.matmul(q, k.transpose(-1, -2))  # (N, H, T, T)
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        w = torch.softmax(scores, -1).to(self.dtype)
        o = torch.matmul(w, v).transpose(1, 2).reshape(N, T, d)
        return self.out(o)


class _MHSA(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        self.ln = _LayerNorm(cfg.d_model, cfg.dtype)
        self.attn = _Attention(cfg)

    def forward(self, x, pad_mask):
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
        return self.attn(self.ln(x), mask)


class _DepthwiseConv1D(nn.Module):
    """Depthwise conv over time as K shifted multiply-adds in the compute
    dtype, summed in the JAX package's order; ``kernel (K, C)``."""

    def __init__(self, K: int, C: int, dtype: torch.dtype, causal: bool):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(K, C))
        self.bias = nn.Parameter(torch.zeros(C))
        self.dtype = dtype
        self.causal = causal

    def forward(self, y):
        K = self.kernel.shape[0]
        T = y.shape[1]
        w = self.kernel.to(self.dtype)
        left = K - 1 if self.causal else (K - 1) // 2
        yp = F.pad(y, (0, 0, left, K - 1 - left))
        out = self.bias.to(self.dtype)
        for k in range(K):
            out = out + yp[:, k : k + T] * w[k]
        return out


class _ConvModule(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        d = cfg.d_model
        self.ln = _LayerNorm(d, cfg.dtype)
        self.pw1 = _Dense(d, 2 * d, cfg.dtype)
        self.dw = _DepthwiseConv1D(cfg.conv_kernel, d, cfg.dtype, cfg.causal_conv)
        self.norm = _LayerNorm(d, cfg.dtype)
        self.pw2 = _Dense(d, d, cfg.dtype)

    def forward(self, x, pad_mask):
        y = F.glu(self.pw1(self.ln(x)), -1)
        # zero padded frames so the depthwise conv cannot leak across lengths
        y = y * pad_mask[..., None].to(y.dtype)
        return self.pw2(F.silu(self.norm(self.dw(y))))


class _ConformerBlock(nn.Module):
    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.ffn1 = _FeedForward(cfg)
        self.mhsa = _MHSA(cfg)
        self.conv = _ConvModule(cfg)
        self.ffn2 = _FeedForward(cfg)
        self.ln_out = _LayerNorm(cfg.d_model, cfg.dtype)

    def forward(self, x, pad_mask):
        x = x + 0.5 * self.ffn1(x)
        x = x + self.mhsa(x, pad_mask)
        x = x + self.conv(x, pad_mask)
        x = x + 0.5 * self.ffn2(x)
        return self.ln_out(x)


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


def _sinusoidal_pos_emb(T: int, d: int, dtype, device) -> torch.Tensor:
    pos = torch.arange(T, device=device, dtype=torch.float32)[:, None]
    dim = torch.arange(0, d, 2, device=device, dtype=torch.float32)[None]
    angles = pos / torch.pow(10000.0, dim / d)
    emb = torch.zeros((T, d), dtype=torch.float32, device=device)
    emb[:, 0::2] = torch.sin(angles)
    emb[:, 1::2] = torch.cos(angles[:, : d // 2])
    return emb.to(dtype)


class ConformerCTC(nn.Module):
    """Conformer encoder + CTC head, for inference.

    ``ConformerCTC(cfg, device=None, generator=None)`` builds the model on
    ``device`` (``cuda`` when None; raises without a card) with parameters
    drawn from ``generator`` (a CPU :class:`torch.Generator`, so a seed
    gives the same weights on every device). Call with batch-major
    ``feats (N, T, num_filts)`` and ``lens (N,)``; returns ``(logits
    (N, T', vocab_size + 1) float32, out_lens (N,))`` with the blank at
    index ``vocab_size`` and ``T' = ceil(ceil(T / 2) / 2)``.
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
        self.subsample = _ConvSubsample(cfg)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", _ConformerBlock(cfg))
        self.ctc_head = _Dense(cfg.d_model, cfg.vocab_size + 1, torch.float32)
        self._init_params(generator)
        self.to(device)
        self.eval()

    @torch.no_grad()
    def _init_params(self, generator):
        """LeCun-normal weights, zero biases, unit LayerNorm scales (the
        flax defaults' scales; the draws differ from flax's)."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if isinstance(self.get_submodule(name.rsplit(".", 1)[0]), nn.LayerNorm):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                p.zero_()
            else:
                fan_in = p[0].numel() if p.dim() > 1 else 1
                if leaf == "kernel":  # depthwise (K, C): one input per tap
                    fan_in = p.shape[0]
                p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)

    @property
    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.cfg.num_layers)]

    @torch.no_grad()
    def forward(self, feats: torch.Tensor, lens: torch.Tensor):
        cfg = self.cfg
        dev = self.ctc_head.weight.device
        feats = feats.to(dev)
        lens = lens.to(dev, torch.long)
        in_mask = torch.arange(feats.shape[1], device=dev)[None] < lens[:, None]
        # zero frames past each length so nothing leaks through the
        # subsampling convs into the last valid frame
        feats = feats * in_mask[..., None].to(feats.dtype)
        x = self.subsample(feats.to(cfg.dtype))
        out_lens = (((lens + 1) // 2) + 1) // 2  # ceil-div by 2, twice
        T4 = x.shape[1]
        pad_mask = torch.arange(T4, device=dev)[None] < out_lens[:, None]
        x = x + _sinusoidal_pos_emb(T4, cfg.d_model, cfg.dtype, dev)[None]
        for block in self.blocks:
            x = block(x, pad_mask)
        return self.ctc_head(x.float()), out_lens


def _linear(kernel, bias) -> Dict[str, np.ndarray]:
    return {"weight": np.asarray(kernel).T, "bias": np.asarray(bias)}


def state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A :class:`ConformerCTC` ``state_dict`` from the JAX package's flax
    parameter tree, given as nested dicts of numpy arrays (for example
    ``jax.tree.map(np.asarray, params)``). The result loads with
    ``load_state_dict(..., strict=True)``.

    Dense kernels ``(in, out)`` transpose to ``(out, in)``; attention
    kernels ``(d, H, hd)`` and ``(H, hd, d)`` flatten their head axes;
    conv kernels HWIO become OIHW; LayerNorm ``scale`` becomes ``weight``.
    """
    out: Dict[str, np.ndarray] = {}

    def put(prefix, d):
        for k, v in d.items():
            out[f"{prefix}.{k}"] = v

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
        for f in ("ffn1", "ffn2"):
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
    put("ctc_head", _linear(params["ctc_head"]["kernel"], params["ctc_head"]["bias"]))
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in out.items()}
