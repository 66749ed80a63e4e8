"""The Conformer encoder (Gulati et al. 2020, arXiv:2005.08100) as the
port's configurations state it, in float32.

Per block: a half-step feed-forward (LayerNorm, d -> 4d, SiLU, 4d -> d), a
multi-head self-attention over absolute sinusoidal positions added once
after the subsampler (masked to each utterance's length and, with
``attention_context = [L, R]``, to keys within L frames before and R after
a query), a convolution module (LayerNorm, d -> 2d, GLU, a depthwise
convolution of ``conv_kernel`` taps over time, centred or causal, then
LayerNorm in place of the paper's BatchNorm, SiLU, d -> d), a second
half-step feed-forward and a final LayerNorm. LayerNorm's epsilon is 1e-6.
The subsampler is two 3x3 stride-2 convolutions with ReLU and a projection
of each frame's (frequency, channel) features, channel fastest.

Departures from the port's arithmetic: every product and sum is float32
(the port computes in bfloat16 with float32 LayerNorm statistics), the
dropout scale is ``256 / (256 - cutoff)`` in float32 (the port rounds it to
bfloat16), and masked attention scores are -inf-like in float32.

Dropout, when ``gen`` is given, draws the same bits the port's model
draws: one ``torch.randint(0, 256, shape, uint8)`` from ``gen`` per site,
in the forward's order (the input, then per block the two of the first
feed-forward, the attention's output, the convolution module's output and
the two of the second feed-forward); an element is kept when its byte is
at least ``round(256 * rate)``.
"""

import math

import torch
import torch.nn.functional as F

from .precision import Exact, linear, matmul

EPS = 1e-6


def _ln(W, name, x):
    return F.layer_norm(x, x.shape[-1:], W[name + ".weight"], W[name + ".bias"], EPS)


def _lin(W, name, x, prec):
    return linear(prec, x, W[name + ".weight"], W.get(name + ".bias"))


class Dropout:
    """The port's dropout draws, replayed from ``gen``."""

    def __init__(self, rate: float, gen):
        self.cutoff = min(round(float(rate) * 256.0), 255)
        self.scale = 256.0 / (256.0 - self.cutoff)
        self.gen = gen

    def __call__(self, x):
        if self.gen is None or self.cutoff == 0:
            return x
        bits = torch.randint(
            0, 256, x.shape, dtype=torch.uint8, generator=self.gen, device=x.device
        )
        return torch.where(bits >= self.cutoff, x * self.scale, 0.0)


def out_lengths(lens: torch.Tensor) -> torch.Tensor:
    return ((lens + 1) // 2 + 1) // 2


def sinusoid(T: int, d: int, device, offset: int = 0) -> torch.Tensor:
    pos = (torch.arange(T, device=device, dtype=torch.float64) + offset)[:, None]
    i = torch.arange(0, d, 2, device=device, dtype=torch.float64)[None]
    ang = pos / torch.pow(10000.0, i / d)
    emb = torch.zeros((T, d), dtype=torch.float64, device=device)
    emb[:, 0::2] = torch.sin(ang)
    emb[:, 1::2] = torch.cos(ang[:, : d // 2])
    return emb.float()


def _conv2d(prec, x, w, b):
    return F.conv2d(prec.operand(x), prec.operand(w), b, stride=2, padding=1)


def _attention(W, b, cfg, y, key_ok, band, prec):
    N, T, d = y.shape
    H = cfg["num_heads"]
    hd = d // H

    def heads(z):
        return z.view(N, T, H, hd).transpose(1, 2)

    q = heads(_lin(W, f"{b}.mhsa.attn.query", y, prec)) / math.sqrt(hd)
    k = heads(_lin(W, f"{b}.mhsa.attn.key", y, prec))
    v = heads(_lin(W, f"{b}.mhsa.attn.value", y, prec))
    s = matmul(prec, q, k.transpose(-1, -2))
    mask = key_ok[:, None, None, :]
    if band is not None:
        mask = mask & band
    s = s.masked_fill(~mask, torch.finfo(torch.float32).min)
    o = matmul(prec, torch.softmax(s, -1), v).transpose(1, 2).reshape(N, T, d)
    return _lin(W, f"{b}.mhsa.attn.out", o, prec)


def _depthwise(W, b, y, cfg, prec):
    """Depthwise convolution over time, ``kernel (K, d)``; causal pads
    ``K - 1`` frames on the left, otherwise ``(K - 1) // 2``."""
    K = cfg["conv_kernel"]
    left = K - 1 if cfg["causal_conv"] else (K - 1) // 2
    w = W[f"{b}.conv.dw.kernel"]  # (K, d)
    x = F.pad(y.transpose(1, 2), (left, K - 1 - left))  # (N, d, T + K - 1)
    out = F.conv1d(prec.operand(x), prec.operand(w.t()[:, None, :]), groups=w.shape[1])
    return out.transpose(1, 2) + W[f"{b}.conv.dw.bias"]


def band_mask(T: int, context, device):
    left, right = context if context is not None else (None, None)
    if left is None and right is None:
        return None
    q = torch.arange(T, device=device)[:, None]
    k = torch.arange(T, device=device)[None]
    band = torch.ones((T, T), dtype=torch.bool, device=device)
    if left is not None:
        band &= k >= q - int(left)
    if right is not None:
        band &= k <= q + int(right)
    return band


def encode(W, cfg, feats, lens, prec=Exact, gen=None, prefix="", pos_offset=0):
    """``(x (N, T', d) float32, out_lens (N,))`` of raw ``feats (N, T, F)``
    with lengths ``lens``; ``gen`` replays the port's dropout bits."""
    dev = feats.device
    lens = lens.to(dev).long()
    drop = Dropout(cfg["dropout"], gen)
    x = feats.float() * (torch.arange(feats.shape[1], device=dev)[None] < lens[:, None])[..., None]
    p = prefix + "subsample."
    h = F.relu(_conv2d(prec, x[:, None], W[p + "conv1.weight"], W[p + "conv1.bias"]))
    h = F.relu(_conv2d(prec, h, W[p + "conv2.weight"], W[p + "conv2.bias"]))
    N, C, T4, F4 = h.shape
    x = _lin(W, p + "proj", h.permute(0, 2, 3, 1).reshape(N, T4, F4 * C), prec)
    out_lens = out_lengths(lens)
    key_ok = torch.arange(T4, device=dev)[None] < out_lens[:, None]
    x = drop(x + sinusoid(T4, cfg["d_model"], dev, pos_offset)[None])
    band = band_mask(T4, cfg.get("attention_context"), dev)
    for i in range(cfg["num_layers"]):
        b = f"{prefix}block_{i}"

        def ffn(name, z):
            z = _ln(W, f"{b}.{name}.ln", z)
            z = drop(F.silu(_lin(W, f"{b}.{name}.wi", z, prec)))
            return drop(_lin(W, f"{b}.{name}.wo", z, prec))

        x = x + 0.5 * ffn("ffn1", x)
        x = x + drop(_attention(W, b, cfg, _ln(W, f"{b}.mhsa.ln", x), key_ok, band, prec))
        y = F.glu(_lin(W, f"{b}.conv.pw1", _ln(W, f"{b}.conv.ln", x), prec), -1)
        y = y * key_ok[..., None]
        y = F.silu(_ln(W, f"{b}.conv.norm", _depthwise(W, b, y, cfg, prec)))
        x = x + drop(_lin(W, f"{b}.conv.pw2", y, prec))
        x = _ln(W, f"{b}.ln_out", x + 0.5 * ffn("ffn2", x))
    return x, out_lens
