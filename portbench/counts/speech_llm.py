"""The LLM-decoder recognizer's work from shapes and true lengths: model
FLOPs (a multiply-add is two) and the least bytes a decode step moves.

Parameters are counted from the configuration (DeepSeek-V2's names):
per layer MLA's four projections (``q_proj``, ``kv_a_proj_with_mqa``,
``kv_b_proj``, ``o_proj``), then a dense SwiGLU (the first
``first_k_dense_replace`` layers) or the router, the routed experts
(SwiGLU of ``moe_intermediate_size``) and the shared ones (one SwiGLU of
``n_shared_experts`` times that); the untied ``lm_head``. A token's
products use the attention projections, the layer's dense SwiGLU or its
router, ``num_experts_per_tok`` experts and the shared ones.

Attention is counted over the keys each query needs at true lengths. The
prefill, in MLA's plain form, scores ``nope + rope`` values a head and
sums ``v_head_dim``; a decode step, in the absorbed form, scores ``latent
= kv_lora_rank + qk_rope_head_dim`` values a head and sums
``kv_lora_rank`` (the absorbed ``W_UK``/``W_UV`` products are the
``kv_b_proj`` parameters a token already counts).

A decode step's least bytes: every non-embedding weight once (with 512
tokens times 6 choices every one of 64 experts is chosen with probability
above 1 - 1e-20), the ``lm_head``, the prompt's latent cache once per
utterance at its true length and each beam's decoded latents, read once,
plus the new latents written; all in the configuration's dtype.
"""

from . import flops

ITEMSIZE = {"bfloat16": 2, "float32": 4}


def _attn_params(cfg):
    d, H, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    return d * H * (nope + rope) + d * (r + rope) + r * H * (nope + v) + H * v * d


def _swiglu(d, f):
    return 3 * d * f


def _moe_layer(i, cfg):
    return i >= cfg["first_k_dense_replace"]


def layer_weights(cfg, i):
    """Every weight of layer ``i`` (the norms' scales included)."""
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    n = _attn_params(cfg) + 2 * d + cfg["kv_lora_rank"]
    if not _moe_layer(i, cfg):
        return n + _swiglu(d, cfg["intermediate_size"])
    return (n + d * cfg["n_routed_experts"] + cfg["n_routed_experts"] * _swiglu(d, f)
            + _swiglu(d, f * cfg["n_shared_experts"]))


def nonembed_weights(cfg):
    """Every weight but the embedding's: the layers, the final norm, the
    ``lm_head``."""
    d = cfg["hidden_size"]
    return (sum(layer_weights(cfg, i) for i in range(cfg["num_hidden_layers"])) + d
            + d * cfg["vocab_size"])


def active_params(cfg):
    """Matrix-product parameters one token uses in the layers (not the
    ``lm_head``)."""
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    total = 0
    for i in range(cfg["num_hidden_layers"]):
        total += _attn_params(cfg)
        if _moe_layer(i, cfg):
            total += (d * cfg["n_routed_experts"] + cfg["num_experts_per_tok"] * _swiglu(d, f)
                      + _swiglu(d, f * cfg["n_shared_experts"]))
        else:
            total += _swiglu(d, cfg["intermediate_size"])
    return total


def latent_dim(cfg):
    return cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]


def audio_tokens(cfg, raw):
    return flops.ceil_div(flops.out_length(raw), cfg["audio_stack"])


def prompt_len(cfg, raw):
    return len(cfg["prompt_ids"]) + audio_tokens(cfg, raw) + len(cfg["suffix_ids"])


def projector_flops(cfg, raw):
    d, k = cfg["hidden_size"], cfg["audio_stack"]
    return 2 * audio_tokens(cfg, raw) * (k * cfg["encoder"]["d_model"] * d + d * d)


def prefill_flops(cfg, L):
    """A prompt of ``L`` tokens: every token through the layers, causal
    attention over its own and earlier keys, the ``lm_head`` at its last."""
    H, layers = cfg["num_attention_heads"], cfg["num_hidden_layers"]
    per_key = 2 * H * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"])
    keys = L * (L + 1) // 2
    return (2 * L * active_params(cfg) + layers * per_key * keys
            + 2 * cfg["hidden_size"] * cfg["vocab_size"])


def decode_flops(cfg, keys):
    """One decoded token that attends to ``keys`` cached tokens (its own
    included) in each layer, and its ``lm_head``."""
    H, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    per_key = 2 * H * (latent_dim(cfg) + r)
    return (2 * active_params(cfg) + cfg["num_hidden_layers"] * per_key * keys
            + 2 * cfg["hidden_size"] * cfg["vocab_size"])


def request_flops(cfg, raws, width, steps):
    """A request of utterances of ``raws`` raw frames: the encoder, the
    projector and the prefill at true lengths, then ``steps`` decode steps
    of ``width`` beams an utterance (step ``t`` attends to ``L + t`` keys)."""
    total = 0
    for raw in raws:
        L = prompt_len(cfg, raw)
        total += (flops.encoder_flops(cfg["encoder"], raw) + projector_flops(cfg, raw)
                  + prefill_flops(cfg, L))
        total += width * sum(decode_flops(cfg, L + t) for t in range(1, steps + 1))
    return total


def step_bytes(cfg, raws, width, t):
    """The least bytes of decode step ``t`` (1-based) of a request."""
    item = ITEMSIZE[cfg["dtype"]]
    tok = cfg["num_hidden_layers"] * latent_dim(cfg) * item
    prompts = sum(prompt_len(cfg, raw) for raw in raws)
    beams = width * len(raws)
    return nonembed_weights(cfg) * item + tok * (prompts + beams * t + beams)
