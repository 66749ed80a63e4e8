"""The port's models built from a configuration file, with the benchmark's
seeded weights. This and the entries are the only files that name the
port (``pydrobert_tpu_torch``); the reference names none of it."""

import torch

from . import weights as wmod
from .reference import layout

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def conformer_config(cfg):
    from pydrobert_tpu_torch.models.conformer import ConformerConfig

    ctx = cfg.get("attention_context") or (None, None)
    return ConformerConfig(
        vocab_size=cfg["vocab_size"], num_filts=cfg["num_filts"], d_model=cfg["d_model"],
        num_layers=cfg["num_layers"], num_heads=cfg["num_heads"],
        ffn_factor=cfg["ffn_factor"], conv_kernel=cfg["conv_kernel"],
        subsample_channels=cfg["subsample_channels"], dropout=cfg["dropout"],
        attn_dropout=cfg.get("attn_dropout", 0.0), dtype=DTYPES[cfg["dtype"]],
        attention_context=tuple(ctx), causal_conv=bool(cfg["causal_conv"]),
    )


def seeded_weights(ctx):
    """The configuration's weights from the run's seed, on its device, with
    the cell's output layer (``head`` in the cell's file)."""
    cfg = ctx.config
    rows = (layout.transducer_layout(cfg) if cfg["model"] == "ConformerTransducer"
            else layout.ctc_layout(cfg))
    weights = wmod.make_weights(rows, ctx.generator("weights"), ctx.device)
    head = ctx.spec.get("head", {})
    wmod.apply_head(weights, head)
    if "blank_emit_share" in head:
        calibrate_blank(weights, ctx, float(head["blank_emit_share"]))
    return weights


@torch.no_grad()
def calibrate_blank(weights, ctx, share):
    """Add to the blank's bias the value that the largest non-blank logit
    exceeds at a ``share`` of the frames of a calibration batch of the run's
    mix (the first 8 utterances), at the first step of each frame: the
    plain reference's encoder and joint in float32 from the prediction
    network's start. Seeded weights of different seeds spread their logits
    differently; this makes greedy decoding emit at about the same rate on
    every seed."""
    from . import traffic
    from .reference import encoder, precision, transducer

    cfg = ctx.config
    b = traffic.make_batch(ctx, "calibration", cfg["num_filts"])
    n = min(8, len(b["lens"]))
    lens = torch.from_numpy(b["lens"][:n]).to(ctx.device)
    with precision.no_tf32():
        enc, enc_lens = encoder.encode(weights, cfg, b["feats"][:n], lens, prefix="encoder.")
        zero = torch.zeros((1, cfg["pred_dim"]), device=ctx.device)
        start = torch.full((1,), cfg["vocab_size"], dtype=torch.long, device=ctx.device)
        pred, _ = transducer.predict(weights, start, (zero, zero))
        lg = transducer.joint(weights, enc, pred[:, None, :])
    valid = torch.arange(enc.shape[1], device=ctx.device)[None] < enc_lens[:, None]
    need = (lg[..., :-1].max(-1).values - lg[..., -1])[valid]
    weights["joint.out.bias"][-1] += torch.quantile(need.double(), 1.0 - share).float()
    ctx.blank_bias = float(weights["joint.out.bias"][-1])


def build_model(ctx):
    """The port's model of ``ctx.config`` holding the seeded weights: built
    on the meta device (no host-side initialisation) and given the weights
    the benchmark drew on the card."""
    cfg = ctx.config
    if cfg["model"] == "ConformerTransducer":
        from pydrobert_tpu_torch.models.transducer import ConformerTransducer, TransducerConfig

        tcfg = TransducerConfig(encoder=conformer_config(cfg), pred_dim=cfg["pred_dim"],
                                joint_dim=cfg["joint_dim"])
        with torch.device("meta"):
            model = ConformerTransducer(tcfg, device="meta")
    else:
        from pydrobert_tpu_torch.models.conformer import ConformerCTC

        with torch.device("meta"):
            model = ConformerCTC(conformer_config(cfg), device="meta")
    model.load_state_dict(seeded_weights(ctx), strict=True, assign=True)
    return model
