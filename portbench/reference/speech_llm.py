"""The LLM-decoder recognizer in plain float32: the Conformer encoder
(:mod:`.encoder`), SLAM-ASR's projector (Ma et al. 2024, arXiv:2402.08846)
and DeepSeek-V2's decoder (arXiv:2405.04434; ``modeling_deepseek.py``
without q-LoRA), as the configuration's file states them.

A row's prompt is the configuration's ``prompt_ids``, then one embedding
for each ``audio_stack`` encoder frames (concatenated, frames past the row's
length zeroed; ``Linear``, ReLU, ``Linear``), then ``suffix_ids``; a
hypothesis's tokens follow. The decoder runs over the whole sequence with
no cache: per layer ``h += Attn(RMSNorm(h))`` and ``h += FFN(RMSNorm(h))``.
Attention is MLA in its plain form (per head ``q = [q_nope; rope(q_r)]``,
``k = [k_nope; rope(k_r)]`` from the normed latent ``c``, ``v`` from
``c``), causal and masked past each sequence's length, with YaRN's
frequencies, worked out here in float64 from the published formula, and
its softmax scale. The feed-forward is a dense SwiGLU in the first
``first_k_dense_replace`` layers and otherwise DeepSeekMoE: softmax router
scores, the top ``num_experts_per_tok`` as raw gates (no
renormalization), each expert computed over the tokens routed to it, plus
the shared experts as one SwiGLU. Padded positions are not routed.

Weights come leaf by leaf from ``leaf(name)`` (a float32 tensor; see
:mod:`.llm_layout`), asked for one layer at a time, so only one layer is
held. Departures from the program's arithmetic: every product and sum is
float32 (the program computes in bfloat16, with float32 softmax, RMSNorm
statistics and router), the router ranks with ``torch.topk`` on its own
float32 scores, and attention is not absorbed into the latent space.

Router ties: where a token's 6th and 7th scores lie within rounding, the
reference may route it to another expert than the program did. Its
output then differs by the two experts' difference times a gate of about
1/64; that is covered by the compared numbers' limits (set from sound
runs, which include such tokens), not replayed. :func:`decoder_log_probs`
counts the tokens whose margin is under ``TIE_MARGIN``.
"""

import math

import torch
import torch.nn.functional as F

from . import encoder
from .precision import Exact, linear, matmul

TIE_MARGIN = 1e-4
"""A router margin (6th minus 7th score, in probability) under which a
token counts as a near-tie in ``notes``."""


def yarn_inv_freq(cfg):
    """YaRN's ``inv_freq`` in float64 from the published formula (Peng et
    al. 2023, and DeepSeek-V2's ``rope_scaling``)."""
    rs = cfg["rope_scaling"]
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    i = torch.arange(0, dim, 2, dtype=torch.float64)
    extra = base ** (-i / dim)
    inter = extra / rs["factor"]

    def correction(rot):
        return dim * math.log(rs["original_max_position_embeddings"] / (rot * 2 * math.pi)) \
            / (2 * math.log(base))

    lo = max(math.floor(correction(rs["beta_fast"])), 0)
    hi = min(math.ceil(correction(rs["beta_slow"])), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - lo) / max(hi - lo, 1e-3)).clamp(0, 1)
    return inter * ramp + extra * (1 - ramp)


def _mscale(factor, m):
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def softmax_scale(cfg):
    rs = cfg["rope_scaling"]
    m = _mscale(rs["factor"], rs["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def _rope(x, pos, cfg):
    """Rotate ``x (M, T, ..., rope)`` at positions ``pos (T,)``: pairs
    de-interleaved, then ``x cos + rotate_half(x) sin``."""
    rs = cfg["rope_scaling"]
    ang = pos.double()[:, None] * yarn_inv_freq(cfg).to(pos.device)[None]
    ang = torch.cat([ang, ang], -1)
    scale = _mscale(rs["factor"], rs["mscale"]) / _mscale(rs["factor"], rs["mscale_all_dim"])
    shape = (1, ang.shape[0]) + (1,) * (x.dim() - 3) + (ang.shape[1],)
    cos = (ang.cos() * scale).float().view(shape)
    sin = (ang.sin() * scale).float().view(shape)
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1)
    return x * cos + rot * sin


def _rms(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _swiglu(prec, x, w_gate, w_up, w_down):
    return linear(prec, F.silu(linear(prec, x, w_gate)) * linear(prec, x, w_up), w_down)


def audio_embeddings(W_enc, leaf, cfg, feats, lens, prec=Exact):
    """``(audio (N, A, d), a_lens (N,))``: the encoder over ``feats``, each
    ``audio_stack`` frames concatenated (frames past a row's length zero),
    and the projector."""
    x, out_lens = encoder.encode(W_enc, cfg["encoder"], feats, lens, prec, prefix="encoder.")
    N, E, _ = x.shape
    k = cfg["audio_stack"]
    x = x * (torch.arange(E, device=x.device)[None] < out_lens[:, None])[..., None]
    x = F.pad(x, (0, 0, 0, (-E) % k)).reshape(N, -(-E // k), -1)
    h = F.relu(linear(prec, x, leaf("projector.fc1.weight"), leaf("projector.fc1.bias")))
    return linear(prec, h, leaf("projector.fc2.weight"), leaf("projector.fc2.bias")), \
        -(-out_lens // k)


def _sequences(leaf, cfg, audio, a_lens, tokens):
    """Each row's prompt and then its ``tokens``, right-padded: ``(x (M,
    T, d), prompt_lens (M,))``."""
    pre = torch.tensor(cfg["prompt_ids"], device=audio.device)
    post = torch.tensor(cfg["suffix_ids"], device=audio.device)
    emb = leaf("embed_tokens.weight")
    rows, plens = [], []
    for m in range(audio.shape[0]):
        A = int(a_lens[m])
        rows.append(torch.cat([emb[pre], audio[m, :A], emb[post],
                               emb[tokens[m].clamp(0, emb.shape[0] - 1)]]))
        plens.append(len(pre) + A + len(post))
    T = max(r.shape[0] for r in rows)
    x = torch.stack([F.pad(r, (0, 0, 0, T - r.shape[0])) for r in rows])
    return x, torch.tensor(plens, device=audio.device)


def _attention(leaf, b, cfg, x, mask, pos, prec):
    M, T, d = x.shape
    H, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, v = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
    q = linear(prec, x, leaf(f"{b}.q_proj.weight")).view(M, T, H, -1)
    kva = linear(prec, x, leaf(f"{b}.kv_a_proj_with_mqa.weight"))
    c = _rms(kva[..., :r], leaf(f"{b}.kv_a_layernorm.weight"), cfg["rms_norm_eps"])
    k_r = _rope(kva[..., None, r:], pos, cfg).expand(M, T, H, -1)
    kv = linear(prec, c, leaf(f"{b}.kv_b_proj.weight")).view(M, T, H, nope + v)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], pos, cfg)], -1).transpose(1, 2)
    k = torch.cat([kv[..., :nope], k_r], -1).transpose(1, 2)
    s = matmul(prec, q, k.transpose(-1, -2)) * softmax_scale(cfg)
    s = s.masked_fill(~mask, torch.finfo(torch.float32).min)
    o = matmul(prec, torch.softmax(s, -1), kv[..., nope:].transpose(1, 2))
    return linear(prec, o.transpose(1, 2).reshape(M, T, H * v), leaf(f"{b}.o_proj.weight"))


def _moe(leaf, b, cfg, x, prec, notes):
    """DeepSeekMoE over tokens ``x (S, d)`` (unpadded)."""
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(linear(prec, x, leaf(f"{b}.gate.weight")), -1)
    top = torch.topk(probs, min(k + 1, E), -1)
    if notes is not None and k < E:
        margin = top.values[:, k - 1] - top.values[:, k]
        notes["near_ties"] = notes.get("near_ties", 0) + int((margin < TIE_MARGIN).sum())
        notes["routed"] = notes.get("routed", 0) + x.shape[0]
    chosen = top.indices[:, :k]
    gate_up, down = leaf(f"{b}.gate_up"), leaf(f"{b}.down")
    f = down.shape[-1]
    y = torch.zeros_like(x)
    for e in range(E):
        tok = (chosen == e).any(1).nonzero()[:, 0]
        if tok.numel():
            g = probs[tok, e] * cfg["routed_scaling_factor"]
            y[tok] += g[:, None] * _swiglu(prec, x[tok], gate_up[e, :f], gate_up[e, f:], down[e])
    s = f"{b}.shared_experts"
    return y + _swiglu(prec, x, leaf(f"{s}.gate_proj.weight"), leaf(f"{s}.up_proj.weight"),
                       leaf(f"{s}.down_proj.weight"))


def decoder_log_probs(leaf, cfg, audio, a_lens, tokens, prec=Exact, pick=None, notes=None):
    """The decoder over each sequence's prompt (``audio (M, A, d)``, its
    first ``a_lens`` rows the row's audio) followed by ``tokens (M, U)``.
    Returns the log-softmax ``(M, U + 1, V)`` after the prompt and after
    each prefix of ``tokens``; with ``pick (M, U)`` instead ``(first (M,
    V), picked (M, U))``, the log-softmax after the prompt and the
    log-probability of ``pick[:, u]`` after the prompt and ``tokens[:,
    :u]``. ``notes`` (a dict) gathers the router's near-ties."""
    eps = cfg["rms_norm_eps"]
    x, plens = _sequences(leaf, cfg, audio, a_lens, tokens)
    M, T, _ = x.shape
    U = tokens.shape[1]
    dev = x.device
    pos = torch.arange(T, device=dev)
    ok = pos[None] < (plens + U)[:, None]
    mask = (ok[:, None, :] & (pos[:, None] >= pos[None, :])[None])[:, None]
    for i in range(cfg["num_hidden_layers"]):
        b = f"layers.{i}"
        x = x + _attention(leaf, f"{b}.self_attn", cfg, _rms(x, leaf(f"{b}.input_layernorm.weight"),
                                                            eps), mask, pos, prec)
        y = _rms(x, leaf(f"{b}.post_attention_layernorm.weight"), eps)
        if i < cfg["first_k_dense_replace"]:
            m = f"{b}.mlp"
            x = x + _swiglu(prec, y, leaf(f"{m}.gate_proj.weight"), leaf(f"{m}.up_proj.weight"),
                            leaf(f"{m}.down_proj.weight"))
        else:
            out = torch.zeros_like(y)
            out[ok] = _moe(leaf, f"{b}.mlp", cfg, y[ok], prec, notes)
            x = x + out
    at = plens[:, None] - 1 + torch.arange(U + 1, device=dev)[None]  # (M, U + 1)
    h = torch.gather(x, 1, at[..., None].expand(M, U + 1, x.shape[-1]))
    h = _rms(h, leaf("norm.weight"), eps)
    head = leaf("lm_head.weight")
    if pick is None:
        return torch.log_softmax(linear(prec, h, head), -1)
    first = torch.log_softmax(linear(prec, h[:, 0], head), -1)
    picked = []
    for u in range(U):
        lp = torch.log_softmax(linear(prec, h[:, u], head), -1)
        picked.append(lp.gather(1, pick[:, u:u + 1])[:, 0])
    return first, torch.stack(picked, 1) if picked else first.new_zeros((M, 0))
