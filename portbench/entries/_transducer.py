"""What the two transducer entries share: the judge of served greedy
transcripts (:func:`portbench.reference.transducer.judge`) over the
reference's one-shot encoding of the same features."""

import math

import torch

from portbench import port
from portbench.reference import encoder, precision, transducer


def judge(ctx, batches, control=False, block=8):
    """The widest ``token_gap`` over ``batches``, a list of ``(feats, lens,
    hyps, hyp_lens)`` of served transcripts
    (:func:`portbench.reference.transducer.judge`). With ``control`` it is
    the gap of the token the float8 reference puts first along each
    transcript's best alignment."""
    cfg = ctx.config
    E = int(ctx.spec["max_symbols_per_frame"])
    W = port.seeded_weights(ctx)
    gap = 0.0
    with precision.no_tf32():
        for feats, lens, hyps, hyp_lens in batches:
            if hyps.shape[0] != feats.shape[0]:
                return math.inf  # not the batch that was sent
            for s in range(0, feats.shape[0], block):
                sl = slice(s, s + block)
                enc, enc_lens = encoder.encode(W, cfg, feats[sl], lens[sl], prefix="encoder.")
                other = None
                if control:
                    enc2, _ = encoder.encode(W, cfg, feats[sl], lens[sl], precision.FP8,
                                             prefix="encoder.")
                    other = (enc2, W, precision.FP8)
                g = transducer.judge(W, enc, enc_lens, hyps[sl], hyp_lens[sl], E, other)
                gap = max(gap, float(g.max()))
    return gap


def checks(ctx, gap):
    return [("token_gap", gap, ctx.spec["limits"]["token_gap"])]


def lens_tensor(ctx, lens):
    return torch.from_numpy(lens).to(ctx.device)
