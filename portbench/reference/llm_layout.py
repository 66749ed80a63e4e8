"""The decoder's parameters (the projector, DeepSeek-V2's embedding,
layers and head) as ``(name, shape, init, fan_in)`` rows under the names
the port's state dict uses, and their seeded draw leaf by leaf.

Each leaf is drawn from a generator of its own (the caller keys it by the
leaf's name), so one layer can be made again without the others: the
decoder is 15.7 billion values, which in one float32 draw would take 63 GB.
A leaf is a float32 standard-normal draw scaled by ``1 / sqrt(fan_in)``
(the embedding's fan-in is 1) and rounded to the decoder's dtype, the
weights the program holds; the reference computes in float32 with those
same values. Biases are zero and RMSNorm scales one.

The routed experts of a layer are two stacked leaves: ``gate_up (E, 2f,
d)``, the gate projection's rows then the up projection's, and ``down (E,
d, f)``.
"""

import math

import torch


def _lin(rows, name, d_in, d_out, bias=False):
    rows.append((f"{name}.weight", (d_out, d_in), "normal", d_in))
    if bias:
        rows.append((f"{name}.bias", (d_out,), "zeros", 0))


def _mlp(rows, name, d, f):
    _lin(rows, f"{name}.gate_proj", d, f)
    _lin(rows, f"{name}.up_proj", d, f)
    _lin(rows, f"{name}.down_proj", f, d)


def projector_rows(cfg):
    d, d_enc = cfg["hidden_size"], cfg["encoder"]["d_model"] * cfg["audio_stack"]
    rows = []
    _lin(rows, "projector.fc1", d_enc, d, bias=True)
    _lin(rows, "projector.fc2", d, d, bias=True)
    return rows


def layer_rows(cfg, i):
    """Layer ``i``: MLA, then a dense SwiGLU (the first
    ``first_k_dense_replace`` layers) or the router, the routed and the
    shared experts."""
    d, H, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    b = f"layers.{i}"
    rows = [(f"{b}.input_layernorm.weight", (d,), "ones", 0)]
    _lin(rows, f"{b}.self_attn.q_proj", d, H * (nope + rope))
    _lin(rows, f"{b}.self_attn.kv_a_proj_with_mqa", d, r + rope)
    rows.append((f"{b}.self_attn.kv_a_layernorm.weight", (r,), "ones", 0))
    _lin(rows, f"{b}.self_attn.kv_b_proj", r, H * (nope + v))
    _lin(rows, f"{b}.self_attn.o_proj", H * v, d)
    rows.append((f"{b}.post_attention_layernorm.weight", (d,), "ones", 0))
    if i < cfg["first_k_dense_replace"]:
        _mlp(rows, f"{b}.mlp", d, cfg["intermediate_size"])
    else:
        E, f = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        _lin(rows, f"{b}.mlp.gate", d, E)
        rows.append((f"{b}.mlp.gate_up", (E, 2 * f, d), "normal", d))
        rows.append((f"{b}.mlp.down", (E, d, f), "normal", f))
        _mlp(rows, f"{b}.mlp.shared_experts", d, f * cfg["n_shared_experts"])
    return rows


def head_rows(cfg):
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    rows = [("embed_tokens.weight", (V, d), "normal", 1), ("norm.weight", (d,), "ones", 0)]
    _lin(rows, "lm_head", d, V)
    return rows


def decoder_rows(cfg):
    rows = projector_rows(cfg) + head_rows(cfg)
    for i in range(cfg["num_hidden_layers"]):
        rows += layer_rows(cfg, i)
    return rows


def draw(row, generator, device, dtype=torch.bfloat16):
    """The leaf of ``row`` in ``dtype``, its normal draw from ``generator``
    (on ``device``)."""
    name, shape, kind, fan_in = row
    if kind == "normal":
        w = torch.randn(shape, generator=generator, device=device)
        return w.mul_(1.0 / math.sqrt(fan_in)).to(dtype)
    if kind == "zeros":
        return torch.zeros(shape, device=device, dtype=dtype)
    if kind == "ones":
        return torch.ones(shape, device=device, dtype=dtype)
    raise ValueError(f"unknown init kind {kind!r} of {name}")
