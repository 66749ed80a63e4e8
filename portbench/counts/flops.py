"""Model FLOPs from shapes and true lengths (a multiply-add is two), the
work the inputs need whatever computes it: padding, re-encoded margins and
repeated work are not counted.

A Conformer block over ``n`` frames, with ``keys`` attention keys summed
over its queries, costs ``n (8 d f + 14 d^2 + 2 K d) + 4 d keys``: the two
feed-forwards (``d -> f -> d``), the four attention projections, the
convolution module's ``d -> 2d`` and ``d -> d`` and its depthwise ``K``
taps, and the scores and weighted values. The subsampler's two 3x3
convolutions and its projection are counted over the frames they output.
"""

import numpy as np


def ceil_div(a, b):
    return -(-int(a) // int(b))


def out_length(raw):
    return ceil_div(ceil_div(raw, 2), 2)


def attention_keys(cfg, T):
    """Keys summed over the queries of a ``T``-frame utterance."""
    left, right = cfg.get("attention_context") or (None, None)
    q = np.arange(int(T))
    lo = np.zeros_like(q) if left is None else np.maximum(0, q - int(left))
    hi = np.full_like(q, T - 1) if right is None else np.minimum(T - 1, q + int(right))
    return int(np.sum(hi - lo + 1))


def subsample_flops(cfg, raw_frames, t2=None, t4=None):
    C, d = cfg["subsample_channels"], cfg["d_model"]
    F2 = ceil_div(cfg["num_filts"], 2)
    F4 = ceil_div(F2, 2)
    t2 = ceil_div(raw_frames, 2) if t2 is None else t2
    t4 = ceil_div(t2, 2) if t4 is None else t4
    return 2 * 9 * C * t2 * F2 + 2 * 9 * C * C * t4 * F4 + 2 * F4 * C * d * t4


def blocks_flops(cfg, frames, keys):
    d, K = cfg["d_model"], cfg["conv_kernel"]
    f = d * cfg["ffn_factor"]
    per = frames * (8 * d * f + 14 * d * d + 2 * K * d) + 4 * d * keys
    return cfg["num_layers"] * per


def encoder_flops(cfg, raw):
    T = out_length(raw)
    return subsample_flops(cfg, raw) + blocks_flops(cfg, T, attention_keys(cfg, T))


def ctc_forward_flops(cfg, raw):
    """Encoder and CTC head of one utterance of ``raw`` frames."""
    T = out_length(raw)
    return encoder_flops(cfg, raw) + 2 * cfg["d_model"] * (cfg["vocab_size"] + 1) * T


def transducer_decode_flops(cfg, frames, tokens):
    """Greedy decoding's joint and prediction network: the encoder
    projection once a frame, the LSTM and the prediction projection once
    for the start and once for each emitted token, and the output layer at
    each of the ``frames + tokens`` decisions."""
    d, P, J, V1 = cfg["d_model"], cfg["pred_dim"], cfg["joint_dim"], cfg["vocab_size"] + 1
    return (2 * d * J * frames + (tokens + 1) * (16 * P * P + 2 * P * J)
            + (frames + tokens) * 2 * J * V1)


def transducer_offline_flops(cfg, raw, tokens):
    return encoder_flops(cfg, raw) + transducer_decode_flops(cfg, out_length(raw), tokens)


def stream_push_flops(cfg, new_frames, tokens):
    """One push of one stream: the ``new_frames`` frames it determines,
    each attending to its own left context (``attention_context[0] + 1``
    keys; a causal configuration), the raw frames under them subsampled
    once, and the decisions and emissions on them."""
    n = int(new_frames)
    if n <= 0:
        return 0
    left = (cfg.get("attention_context") or (None, None))[0]
    keys = n * (int(left) + 1)
    return (subsample_flops(cfg, 4 * n, t2=2 * n, t4=n) + blocks_flops(cfg, n, keys)
            + transducer_decode_flops(cfg, n, tokens) - (2 * cfg["pred_dim"] * cfg["joint_dim"]
                                                        + 16 * cfg["pred_dim"] ** 2))


def emission_flops(cfg, tokens):
    """An emitted token beyond a frame's blank: the LSTM step, the
    prediction projection and one more decision of the output layer."""
    P, J, V1 = cfg["pred_dim"], cfg["joint_dim"], cfg["vocab_size"] + 1
    return int(tokens) * (16 * P * P + 2 * P * J + 2 * J * V1)
