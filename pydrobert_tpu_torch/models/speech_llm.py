"""An LLM-decoder speech recognizer: a Conformer encoder whose frames are
stacked and projected into a DeepSeek-V2 decoder's embedding space as a
prompt, the decoder then writing the transcript under the port's
:class:`~pydrobert_tpu_torch.ops.decoding.BeamSearch`.

The pairing is SLAM-ASR's (Ma et al. 2024, arXiv:2402.08846): each
``audio_stack`` consecutive encoder frames are concatenated, then
``Linear -> ReLU -> Linear`` into the decoder's width. A row's prompt is
``prompt_ids``, its ``A = ceil(E / audio_stack)`` audio embeddings (``E``
the encoder frames of its true length; frames past it are zeroed before
stacking) and ``suffix_ids``, contiguous at its own length ``L = 16 + A``
and right-padded to the batch's padded length, so the model sees one shape.
RoPE positions run ``0 .. L - 1`` and decoding continues from ``L``.

The decoder follows DeepSeek-V2's ``modeling_deepseek.py`` (arXiv:2405.04434
section 2.1 for MLA, 2.2 for DeepSeekMoE), without q-LoRA:

- ``h += Attn(RMSNorm(h))``, ``h += FFN(RMSNorm(h))``, a final RMSNorm and
  an untied ``lm_head``; RMSNorm takes float32 statistics.
- MLA: ``q = W_q h`` split per head into ``qk_nope_head_dim`` and
  ``qk_rope_head_dim``; ``[c; k_r] = W_kva h``, ``c`` normed
  (``kv_a_layernorm``) and ``k_r`` shared by every head; ``[k_nope; v] =
  W_kvb c``. RoPE turns the checkpoint's interleaved pairs (kept
  interleaved: see :func:`_rope`) with YaRN's ``inv_freq`` blend; the
  softmax scale is ``(nope + rope) ** -0.5 * m ** 2`` with ``m = 0.1 *
  mscale_all_dim * ln(factor) + 1``, and cos and sin carry ``mscale /
  mscale_all_dim`` (1 for this model). Scores are causal over the prompt,
  the softmax is float32.
- DeepSeekMoE after the first ``first_k_dense_replace`` dense SwiGLU
  layers: softmax router scores in float32, greedy top-k with
  :func:`~pydrobert_tpu_torch.ops.topk.exact_top_k`, the raw scores as
  gates (no renormalization) times ``routed_scaling_factor``, plus the
  shared experts as one SwiGLU of ``n_shared_experts`` times the expert
  width. Every choice is computed (no capacity, nothing dropped): the
  choices are sorted by expert and each expert's rows are one group of
  :func:`torch.nn.functional.grouped_mm` (:func:`_routed_experts`), with
  the group ends taken on the device. Padded positions are routed past the
  last group and reach no expert.

Decoding reads a latent cache: per token and layer the normed ``c`` and the
roped ``k_r`` (``kv_lora_rank + qk_rope_head_dim`` values). The prompt's
part is held once per utterance; the decoded suffix is written in place,
slot ``(utterance, step, beam)``, and each beam keeps, per step, which of
its utterance's ``W`` slots holds its own ancestor (``anc``). A step scores
its query against every slot of its utterance and masks the others, so a
beam reorder moves ``anc`` alone and no cache byte
(:class:`SpeechLLMDecoderLM`). Decoding uses MLA's absorbed form: the query
is taken into the latent space through ``W_UK`` and the output out of it
through ``W_UV``.

Departures from ``modeling_deepseek.py``: the router's product is taken in
float32 (the checkpoint's code takes it in the compute dtype); RMSNorm is
one fused operation that scales in float32 and rounds once, where the
checkpoint's code rounds the normalized value before the scale; RoPE is
computed in float32 and rounded once, where the checkpoint's code rotates
in the compute dtype with cos and sin rounded to it; the encoder computes
in ``encoder.dtype`` with float32 parameters, while the projector and the
decoder hold their weights in ``dtype`` (bfloat16 as the checkpoint serves
them) and compute in it. The weights here are drawn from a seed; loading
the published checkpoint is not done.
"""

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import default_device
from ..lm import ExtractableSequentialLanguageModel
from ..ops.topk import exact_top_k
from ..utils.profiling import span
from .conformer import ConformerConfig, _add_encoder, _encoder_body, _init_params

__all__ = ["SpeechLLM", "SpeechLLMConfig", "SpeechLLMDecoderLM", "yarn_inv_freq"]


@dataclasses.dataclass(frozen=True)
class SpeechLLMConfig:
    """The encoder's :class:`ConformerConfig` and the decoder's sizes under
    DeepSeek-V2's ``config.json`` names (defaults: DeepSeek-V2-Lite), with
    the recognizer's own: ``audio_stack`` frames a projected token, the
    fixed ``prompt_ids`` before and ``suffix_ids`` after the audio, and
    ``dtype``, the decoder's weights and compute."""

    encoder: ConformerConfig = ConformerConfig(
        vocab_size=1, num_filts=80, d_model=512, num_layers=17, num_heads=8, ffn_factor=4,
        conv_kernel=32, subsample_channels=512, dropout=0.0,
    )
    vocab_size: int = 102400
    hidden_size: int = 2048
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 1.0
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    audio_stack: int = 2
    prompt_ids: Tuple[int, ...] = (100000, 100002, 100003, 100004, 100005, 100006, 100007,
                                   100008)
    suffix_ids: Tuple[int, ...] = (100009, 100010, 100011, 100012, 100013, 100014, 100015,
                                   100016)
    dtype: torch.dtype = torch.bfloat16

    @property
    def latent_dim(self) -> int:
        """Values a token and layer keeps in the latent cache."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        m = _yarn_mscale(self.rope_factor, self.rope_mscale_all_dim)
        return (self.qk_nope_head_dim + self.qk_rope_head_dim) ** -0.5 * m * m


def _yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(cfg: SpeechLLMConfig) -> torch.Tensor:
    """YaRN's ``inv_freq`` (float32, ``qk_rope_head_dim // 2``), as
    ``DeepseekV2YarnRotaryEmbedding`` computes it: the extrapolated and the
    interpolated frequencies blended by a linear ramp between the
    correction dimensions of ``beta_fast`` and ``beta_slow`` rotations."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device="cpu") / dim
    freq_extra = 1.0 / (base ** exps)
    freq_inter = 1.0 / (cfg.rope_factor * base ** exps)

    def corr_dim(rotations):
        return (dim * math.log(cfg.rope_original_max_position / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(corr_dim(cfg.rope_beta_fast)), 0)
    high = min(math.ceil(corr_dim(cfg.rope_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = (torch.arange(dim // 2, dtype=torch.float32, device="cpu") - low) / (high - low)
    ramp = ramp.clamp(0, 1)
    extra = 1.0 - ramp
    return freq_inter * (1 - extra) + freq_extra * extra


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x (..., rope)`` in the checkpoint's interleaved layout:
    pair ``(x[2i], x[2i+1])`` turns by angle ``i``, in float32, rounded once
    to ``x``'s dtype. ``modeling_deepseek.py`` de-interleaves the pairs
    first (``rotate_half``); this keeps them interleaved, the same values in
    another order for queries and keys alike, so every score is the same.
    ``cos``/``sin`` broadcast against ``x`` and hold each angle twice, the
    sine signed for the pair's first value."""
    xf = x.float()
    swapped = xf.unflatten(-1, (-1, 2)).flip(-1).flatten(-2)
    return torch.addcmul(xf * cos, swapped, sin).to(x.dtype)


class _RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, dtype=dtype))
        self.eps = eps

    def forward(self, x):
        return F.rms_norm(x, x.shape[-1:], self.weight, self.eps)


def _linear(d_in: int, d_out: int, dtype: torch.dtype, bias: bool = False) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=bias, dtype=dtype)


class _MLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, d: int, f: int, dtype: torch.dtype):
        super().__init__()
        self.gate_proj = _linear(d, f, dtype)
        self.up_proj = _linear(d, f, dtype)
        self.down_proj = _linear(f, d, dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


def _routed_experts(x, experts, gates, valid, gate_up, down):
    """Every routed choice of tokens ``x (T, d)``: ``experts``/``gates (T,
    k)``, ``valid (T,)`` or None. Choices are sorted by expert (an invalid
    token's past the last expert) and each expert's rows are one group of
    two grouped products, ``gate_up (E, 2f, d)`` and ``down (E, d, f)``;
    the group ends are found on the device (a search of the sorted
    experts: nothing waits on the card). Returns the gated sum of each
    token's choices ``(T, d)`` in float32."""
    T, k = experts.shape
    E = gate_up.shape[0]
    flat = experts.reshape(-1)
    if valid is not None:
        flat = torch.where(valid.repeat_interleave(k), flat, E)
    ranked, order = torch.sort(flat, stable=True)
    ends = torch.arange(1, E + 1, device=flat.device, dtype=flat.dtype)
    offs = torch.searchsorted(ranked, ends, out_int32=True)
    # one row past the choices: the groups end strictly inside the operand
    rows = x[F.pad(order // k, (0, 1))]
    h = F.grouped_mm(rows, gate_up.transpose(1, 2), offs=offs)
    f = h.shape[-1] // 2
    y = F.grouped_mm(F.silu(h[:, :f]) * h[:, f:], down.transpose(1, 2), offs=offs)
    y = y[torch.argsort(order)].view(T, k, -1)
    if valid is None:
        return (y * gates[..., None]).sum(1)
    # rows no group covers (invalid tokens) hold junk: select, never multiply
    return torch.where(valid[:, None, None], y * gates[..., None], 0.0).sum(1)


class _MoE(nn.Module):
    """DeepSeekMoE: routed experts over every choice, plus the shared ones."""

    def __init__(self, cfg: SpeechLLMConfig):
        super().__init__()
        d, f, E = cfg.hidden_size, cfg.moe_intermediate_size, cfg.n_routed_experts
        self.cfg = cfg
        self.gate = _linear(d, E, cfg.dtype)
        self.gate_up = nn.Parameter(torch.empty(E, 2 * f, d, dtype=cfg.dtype))
        self.down = nn.Parameter(torch.empty(E, d, f, dtype=cfg.dtype))
        self.shared_experts = _MLP(d, f * cfg.n_shared_experts, cfg.dtype)

    def route(self, x):
        """``(gates (T, k) float32, experts (T, k))`` of tokens ``x (T, d)``:
        the float32 softmax scores at the greedy top-k, unrenormalized."""
        probs = torch.softmax(F.linear(x.float(), self.gate.weight.float()), -1)
        _, experts = exact_top_k(probs, self.cfg.num_experts_per_tok)
        return probs.gather(1, experts) * self.cfg.routed_scaling_factor, experts

    def forward(self, x, valid=None):
        gates, experts = self.route(x)
        with span("moe/experts"):
            y = _routed_experts(x, experts, gates, valid, self.gate_up, self.down)
        return (y + self.shared_experts(x)).to(x.dtype)


class _MLA(nn.Module):
    """Multi-head latent attention, without q-LoRA."""

    def __init__(self, cfg: SpeechLLMConfig):
        super().__init__()
        d, H, r = cfg.hidden_size, cfg.num_attention_heads, cfg.kv_lora_rank
        self.cfg = cfg
        self.q_proj = _linear(d, H * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim), cfg.dtype)
        self.kv_a_proj_with_mqa = _linear(d, r + cfg.qk_rope_head_dim, cfg.dtype)
        self.kv_a_layernorm = _RMSNorm(r, cfg.rms_norm_eps, cfg.dtype)
        self.kv_b_proj = _linear(r, H * (cfg.qk_nope_head_dim + cfg.v_head_dim), cfg.dtype)
        self.o_proj = _linear(H * cfg.v_head_dim, d, cfg.dtype)

    def _project(self, x, cos, sin):
        """``(q_nope, q_rope roped, latent)`` of normed tokens ``x (..., d)``;
        ``cos``/``sin (..., rope)`` at their positions."""
        cfg = self.cfg
        H, nope, r = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
        q = self.q_proj(x).unflatten(-1, (H, -1))
        kva = self.kv_a_proj_with_mqa(x)
        c = self.kv_a_layernorm(kva[..., :r])
        # the shared key's rope part turns with the queries', as one more head
        roped = _rope(torch.cat([q[..., nope:], kva[..., None, r:]], -2),
                      cos[..., None, :], sin[..., None, :])
        return q[..., :nope], roped[..., :H, :], torch.cat([c, roped[..., H, :]], -1)

    def prefill(self, x, cos, sin, mask, cache):
        """Causal attention over normed prompts ``x (N, P, d)``; ``mask (N,
        1, P, P)`` the keys each query sees. Writes each position's latent
        into ``cache (N, P, latent)``."""
        cfg = self.cfg
        H, nope, r = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
        q_n, q_r, lat = self._project(x, cos, sin)
        cache.copy_(lat)
        kv = self.kv_b_proj(lat[..., :r]).unflatten(-1, (H, -1))
        q = torch.cat([q_n, q_r], -1).transpose(1, 2)  # (N, H, P, nope + rope)
        k_r = lat[..., None, r:].expand(-1, -1, H, -1)
        k = torch.cat([kv[..., :nope], k_r], -1).transpose(1, 2)
        s = torch.matmul(q, k.transpose(-1, -2)).float() * cfg.softmax_scale
        s = s.masked_fill(~mask, torch.finfo(torch.float32).min)
        p = torch.softmax(s, -1).to(x.dtype)
        o = torch.matmul(p, kv[..., nope:].transpose(1, 2))  # (N, H, P, v)
        return self.o_proj(o.transpose(1, 2).flatten(2))

    def decode(self, x, cos, sin, prompt, suffix, bias, slot):
        """One new token for each of ``B = N W`` beams, ``x (B, d)`` normed,
        in the absorbed form: its latent goes to ``slot (N, W, latent)`` of
        the suffix cache, then the query is scored in latent space against
        its utterance's ``prompt (N, P, latent)`` and every suffix slot
        ``suffix (N, S' W, latent)``; ``bias (N, W H, P + S' W)``, 0 or the
        float32 minimum, picks the keys each beam's heads see."""
        cfg = self.cfg
        H, nope, r = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
        B = x.shape[0]
        N = prompt.shape[0]
        W = B // N
        q_n, q_r, lat = self._project(x, cos, sin)
        slot.copy_(lat.view(N, W, -1))
        w_kvb = self.kv_b_proj.weight.view(H, nope + cfg.v_head_dim, r)
        q_lat = torch.bmm(q_n.transpose(0, 1), w_kvb[:, :nope])  # (H, B, r)
        q = torch.cat([q_lat.transpose(0, 1), q_r], -1).reshape(N, W * H, -1)
        s = torch.cat([torch.bmm(q, prompt.transpose(1, 2)),
                       torch.bmm(q, suffix.transpose(1, 2))], -1)
        p = torch.softmax(torch.add(bias, s, alpha=cfg.softmax_scale), -1).to(x.dtype)
        P = prompt.shape[1]
        o = (torch.bmm(p[..., :P], prompt[..., :r]) + torch.bmm(p[..., P:], suffix[..., :r]))
        o = torch.bmm(o.view(B, H, r).transpose(0, 1), w_kvb[:, nope:].transpose(1, 2))
        return self.o_proj(o.transpose(0, 1).reshape(B, -1))


class _DecoderLayer(nn.Module):
    def __init__(self, cfg: SpeechLLMConfig, dense: bool):
        super().__init__()
        d = cfg.hidden_size
        self.input_layernorm = _RMSNorm(d, cfg.rms_norm_eps, cfg.dtype)
        self.self_attn = _MLA(cfg)
        self.post_attention_layernorm = _RMSNorm(d, cfg.rms_norm_eps, cfg.dtype)
        self.mlp = _MLP(d, cfg.intermediate_size, cfg.dtype) if dense else _MoE(cfg)

    def ffn(self, h, valid=None):
        x = self.post_attention_layernorm(h)
        if isinstance(self.mlp, _MoE):
            return h + self.mlp(x, valid)
        return h + self.mlp(x)


class _Projector(nn.Module):
    def __init__(self, d_in: int, d: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = _linear(d_in, d, dtype, bias=True)
        self.fc2 = _linear(d, d, dtype, bias=True)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


@torch.no_grad()
def _init_decoder(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """The projector's and the decoder's parameters: LeCun-normal weights
    (drawn in float32, then rounded), zero biases, unit RMSNorm scales,
    unit-normal embeddings."""
    for name, p in module.named_parameters():
        if name.startswith("encoder."):
            continue
        leaf = name.rsplit(".", 1)[-1]
        if "layernorm" in name or name.startswith("norm.") or leaf == "bias":
            p.fill_(1.0 if leaf == "weight" else 0.0)
            continue
        fan_in = 1 if name.startswith("embed_tokens.") else p.shape[-1]
        w = torch.randn(p.shape, generator=generator) / math.sqrt(fan_in)
        p.copy_(w)


class SpeechLLM(nn.Module):
    """The Conformer encoder (``encoder.``), the projector and the
    DeepSeek-V2 decoder. ``SpeechLLM(cfg, device=None, generator=None)``
    builds it on ``device`` (``cuda`` when None) with weights from
    ``generator`` (a CPU generator). :meth:`recognize` is the entry point;
    :class:`SpeechLLMDecoderLM` is the decoder as a sequential LM."""

    def __init__(self, cfg: SpeechLLMConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = default_device(device)
        self.cfg = cfg
        d = cfg.hidden_size
        self.encoder = nn.Module()
        _add_encoder(self.encoder, cfg.encoder)
        self.projector = _Projector(cfg.encoder.d_model * cfg.audio_stack, d, cfg.dtype)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d, dtype=cfg.dtype)
        self.layers = nn.ModuleList(
            _DecoderLayer(cfg, i < cfg.first_k_dense_replace) for i in range(cfg.num_hidden_layers)
        )
        self.norm = _RMSNorm(d, cfg.rms_norm_eps, cfg.dtype)
        self.lm_head = _linear(d, cfg.vocab_size, cfg.dtype)
        self._consts = {}
        if device.type != "meta":
            _init_params(self.encoder, generator)
            _init_decoder(self, generator)
        self.to(device)

    def _const(self, device) -> Dict[str, torch.Tensor]:
        """The YaRN frequencies and the fixed prompt ids on ``device``, made
        once (a host copy each call would wait on the card)."""
        found = self._consts.get(device)
        if found is None:
            cfg = self.cfg
            found = self._consts[device] = {
                "inv_freq": yarn_inv_freq(cfg).to(device),
                "sign": torch.tensor([-1.0, 1.0]).repeat(cfg.qk_rope_head_dim // 2).to(device),
                "ids": torch.tensor(cfg.prompt_ids + cfg.suffix_ids).to(device),
            }
        return found

    def rope_tables(self, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """float32 ``(cos, sin)`` of shape ``positions.shape + (rope,)``."""
        cfg = self.cfg
        m = _yarn_mscale(cfg.rope_factor, cfg.rope_mscale) / _yarn_mscale(
            cfg.rope_factor, cfg.rope_mscale_all_dim)
        ang = positions.float()[..., None] * self._const(positions.device)["inv_freq"]
        ang = ang.repeat_interleave(2, -1)
        sign = self._const(positions.device)["sign"]
        return ang.cos() * m, ang.sin() * (m * sign)

    def encode_prompt(self, feats, lens):
        """``(x (N, P, d), prompt_lens (N,))``: each row's prompt ids, audio
        embeddings and suffix ids, contiguous and right-padded with zeros."""
        cfg = self.cfg
        with span("llm/encode"):
            x, _, out_lens, _ = _encoder_body(self.encoder, cfg.encoder, feats, lens, True, None, 0)
            N, E, _ = x.shape
            k = cfg.audio_stack
            x = x * (torch.arange(E, device=x.device)[None] < out_lens[:, None])[..., None]
            x = F.pad(x, (0, 0, 0, (-E) % k)).reshape(N, -(-E // k), -1)
            audio = self.projector(x.to(cfg.dtype))
        a_lens = -(-out_lens // k)
        n_pre, n_post = len(cfg.prompt_ids), len(cfg.suffix_ids)
        A = audio.shape[1]
        P = n_pre + A + n_post
        dev = audio.device
        fixed = self.embed_tokens(self._const(dev)["ids"])
        j = torch.arange(P, device=dev)[None].expand(N, P)
        rel = j - n_pre - a_lens[:, None]  # index into the suffix ids
        is_audio = (j >= n_pre) & (rel < 0)
        at = (j - n_pre).clamp(0, A - 1)
        out = torch.gather(audio, 1, at[..., None].expand(N, P, audio.shape[-1]))
        fix = fixed[torch.where(j < n_pre, j, (n_pre + rel).clamp(n_pre, n_pre + n_post - 1))]
        out = torch.where(is_audio[..., None], out, fix)
        out = torch.where((rel < n_post)[..., None], out, torch.zeros((), dtype=out.dtype,
                                                                        device=dev))
        return out, a_lens + n_pre + n_post

    def prefill(self, x, prompt_lens, cache):
        """The decoder over prompts ``x (N, P, d)`` of lengths
        ``prompt_lens``, each layer's latents written to ``cache (N, L, P,
        latent)``; returns the logits at each row's last prompt position,
        ``(N, V)`` float32."""
        N, P, _ = x.shape
        dev = x.device
        pos = torch.arange(P, device=dev)
        cos, sin = self.rope_tables(pos)
        ok = pos[None] < prompt_lens[:, None]
        mask = (ok[:, None, :] & (pos[None, :, None] >= pos[None, None, :]))[:, None]
        valid = ok.reshape(-1)
        h = x
        for i, layer in enumerate(self.layers):
            h = h + layer.self_attn.prefill(layer.input_layernorm(h), cos, sin, mask, cache[:, i])
            h = layer.ffn(h.reshape(N * P, -1), valid).view(N, P, -1)
        last = h[torch.arange(N, device=dev), prompt_lens - 1]
        return self.lm_head(self.norm(last)).float()

    def decode_step(self, tokens, positions, state, t):
        """Logits ``(B, V)`` float32 of beams that feed ``tokens (B,)`` at
        ``positions (B,)`` as suffix step ``t - 1``, through ``state``'s
        caches (written in place at that step)."""
        prompt, suffix, anc = state["prompt"], state["suffix"], state["anc"]
        N, W, H = prompt.shape[0], suffix.shape[3], self.cfg.num_attention_heads
        h = self.embed_tokens(tokens)
        cos, sin = self.rope_tables(positions)
        # the keys each beam sees: its prompt's valid positions, and of each
        # suffix step the slot that holds its own ancestor
        mine = anc[:, :t, None] == torch.arange(W, device=anc.device)
        ok = torch.cat([state["prompt_ok"].repeat_interleave(W, 0), mine.flatten(1)], -1)
        bias = torch.zeros(ok.shape, device=ok.device).masked_fill_(
            ~ok, torch.finfo(torch.float32).min)
        bias = bias.view(N, W, 1, -1).expand(N, W, H, -1).reshape(N, W * H, -1)
        for i, layer in enumerate(self.layers):
            h = h + layer.self_attn.decode(
                layer.input_layernorm(h), cos, sin, prompt[:, i],
                suffix[:, i, :t].flatten(1, 2), bias, suffix[:, i, t - 1],
            )
            h = layer.ffn(h)
        return self.lm_head(self.norm(h)).float()

    @torch.no_grad()
    def recognize(self, feats, lens, width: int, max_iters: int, eos: Optional[int] = None,
                  stats: Optional[Dict[str, Any]] = None):
        """Beam search of ``width`` over the decoder, prompted with the
        audio of ``feats (N, T, num_filts)`` of lengths ``lens (N,)``:
        :class:`~pydrobert_tpu_torch.ops.decoding.BeamSearch` over a
        :class:`SpeechLLMDecoderLM`, for at most ``max_iters`` tokens, a
        beam ending at ``eos`` when given. Returns ``(y (max_iters, N,
        width), y_lens (N, width), y_log_probs (N, width))``. ``stats``, when
        given, receives ``steps`` (the decoder's calls after the prefill)
        and ``reorder_bytes`` (bytes the beam reorders and the search's
        freezing of finished elements moved in the LM's state)."""
        from ..ops.decoding import BeamSearch

        lm = SpeechLLMDecoderLM(self)
        state = lm.initial_state(feats, lens, max_iters, width)
        search = BeamSearch(lm, width, eos=eos)
        out = search(state, feats.shape[0], max_iters)
        if stats is not None:
            stats.update(steps=lm.steps, reorder_bytes=lm.moved_bytes + search.frozen_bytes)
        return out


class SpeechLLMDecoderLM(ExtractableSequentialLanguageModel):
    """The decoder of a :class:`SpeechLLM` as a sequential LM over its
    prompt's latent cache. Build the state with :meth:`initial_state`; it
    holds:

    - ``prompt (N, L, P, latent)``, the prompt's latent cache, once per
      utterance, ``prompt_ok (N, P)`` and ``prompt_lens (N,)``;
    - ``first (N, V)``, the log-probabilities after the prompt;
    - ``suffix (N, L, S, W, latent)``, the decoded tokens' latents, slot
      ``(step, beam)``, written in place by each step;
    - ``anc (N W, S)``: for each beam and step, which of its utterance's
      ``W`` slots holds its ancestor's latent (``N`` rows until the search
      spreads the batch over its beams).

    ``extract_by_src`` gathers ``anc`` alone: a reorder, the search's first
    spread of each utterance over its beams included, moves no cache byte.
    Step ``idx`` feeds ``hist[idx - 1]`` at position ``prompt_lens + idx -
    1``; step 0 returns ``first``. The caches are written in place, so a
    state is consumed by the step that takes it (a frozen, finished batch
    element's slots are overwritten with values nothing reads).
    ``moved_bytes`` counts the bytes reorders read and wrote, ``steps``
    the decoder's calls."""

    def __init__(self, model: SpeechLLM):
        super().__init__(model.cfg.vocab_size)
        self.model = model
        self.moved_bytes = 0
        self.steps = 0

    @torch.no_grad()
    def initial_state(self, feats, lens, max_iters: int, width: int = 1) -> Dict[str, Any]:
        model, cfg = self.model, self.model.cfg
        dev = model.lm_head.weight.device
        lens = lens.to(dev)
        x, prompt_lens = model.encode_prompt(feats.to(dev), lens)
        N, P, _ = x.shape
        L = cfg.num_hidden_layers
        prompt = torch.empty((N, L, P, cfg.latent_dim), dtype=cfg.dtype, device=dev)
        with span("llm/prefill"):
            first = torch.log_softmax(model.prefill(x, prompt_lens, prompt), -1)
        S = max(int(max_iters), 1)
        return {
            "prompt": prompt,
            "prompt_ok": torch.arange(P, device=dev)[None] < prompt_lens[:, None],
            "prompt_lens": prompt_lens,
            "first": first,
            "suffix": torch.empty((N, L, S, int(width), cfg.latent_dim), dtype=cfg.dtype,
                                  device=dev),
            "anc": torch.zeros((N, S), dtype=torch.long, device=dev),
        }

    def update_input(self, prev, hist):
        if not all(k in prev for k in ("prompt", "suffix", "anc", "first")):
            raise RuntimeError("initial state must be built with initial_state(feats, lens, ...)")
        return prev

    def extract_by_src(self, prev, src):
        anc = prev["anc"].index_select(0, src.to(prev["anc"].device).reshape(-1))
        self.moved_bytes += anc.numel() * anc.element_size() * 2
        return {**prev, "anc": anc}

    @torch.no_grad()
    def calc_idx_log_probs(self, hist, prev, idx):
        if isinstance(idx, torch.Tensor) and idx.dim():
            raise RuntimeError("SpeechLLMDecoderLM takes one idx for the whole batch")
        t = int(idx)
        with span("llm/step"):
            if t == 0:
                return prev["first"], prev
            prompt, suffix = prev["prompt"], prev["suffix"]
            N, W = prompt.shape[0], suffix.shape[3]
            B = hist.shape[1]
            if B != N * W or prev["anc"].shape[0] != B:
                raise RuntimeError(f"a state of {N} utterances x {W} beams got {B} rows")
            if t > suffix.shape[2]:
                raise RuntimeError(f"step {t} is past the state's {suffix.shape[2]} steps")
            dev = prompt.device
            tokens = hist[t - 1].to(dev).clamp(0, self.vocab_size - 1)
            positions = prev["prompt_lens"].repeat_interleave(W) + (t - 1)
            anc = prev["anc"].clone()
            anc[:, t - 1] = torch.arange(B, device=dev) % W
            state = {**prev, "anc": anc}
            logits = self.model.decode_step(tokens, positions, state, t)
            self.steps += 1
            return torch.log_softmax(logits, -1), state
