"""The parameter layout of each model: ``(name, shape, init, fan_in)`` rows
under the names the port's state dicts use, so one seeded dict serves the
program and the reference."""


def _lin(rows, name, d_in, d_out, bias=True):
    rows.append((f"{name}.weight", (d_out, d_in), "normal", d_in))
    if bias:
        rows.append((f"{name}.bias", (d_out,), "zeros", 0))


def _ln(rows, name, d):
    rows.append((f"{name}.weight", (d,), "ones", 0))
    rows.append((f"{name}.bias", (d,), "zeros", 0))


def encoder_layout(cfg, prefix=""):
    """The Conformer encoder: the stride-4 conv subsampler and the blocks."""
    rows = []
    d, C, K = cfg["d_model"], cfg["subsample_channels"], cfg["conv_kernel"]
    F4 = -(-(-(-cfg["num_filts"] // 2)) // 2)
    rows.append((f"{prefix}subsample.conv1.weight", (C, 1, 3, 3), "normal", 9))
    rows.append((f"{prefix}subsample.conv1.bias", (C,), "zeros", 0))
    rows.append((f"{prefix}subsample.conv2.weight", (C, C, 3, 3), "normal", 9 * C))
    rows.append((f"{prefix}subsample.conv2.bias", (C,), "zeros", 0))
    _lin(rows, f"{prefix}subsample.proj", F4 * C, d)
    f = d * cfg["ffn_factor"]
    for i in range(cfg["num_layers"]):
        b = f"{prefix}block_{i}"
        for ffn in ("ffn1",):
            _ln(rows, f"{b}.{ffn}.ln", d)
            _lin(rows, f"{b}.{ffn}.wi", d, f)
            _lin(rows, f"{b}.{ffn}.wo", f, d)
        _ln(rows, f"{b}.mhsa.ln", d)
        for w in ("query", "key", "value", "out"):
            _lin(rows, f"{b}.mhsa.attn.{w}", d, d)
        _ln(rows, f"{b}.conv.ln", d)
        _lin(rows, f"{b}.conv.pw1", d, 2 * d)
        rows.append((f"{b}.conv.dw.kernel", (K, d), "normal", K))
        rows.append((f"{b}.conv.dw.bias", (d,), "zeros", 0))
        _ln(rows, f"{b}.conv.norm", d)
        _lin(rows, f"{b}.conv.pw2", d, d)
        _ln(rows, f"{b}.ffn2.ln", d)
        _lin(rows, f"{b}.ffn2.wi", d, f)
        _lin(rows, f"{b}.ffn2.wo", f, d)
        _ln(rows, f"{b}.ln_out", d)
    return rows


def ctc_layout(cfg):
    rows = encoder_layout(cfg)
    _lin(rows, "ctc_head", cfg["d_model"], cfg["vocab_size"] + 1)
    return rows


def transducer_layout(cfg):
    """Encoder under ``encoder.``, the embedding and the LSTM (input
    kernels without bias, hidden kernels with one, gates i, f, g, o), and
    the additive joint."""
    rows = encoder_layout(cfg, "encoder.")
    V1, P, J, d = cfg["vocab_size"] + 1, cfg["pred_dim"], cfg["joint_dim"], cfg["d_model"]
    rows.append(("predictor.embed.weight", (V1, P), "normal", V1))
    for g in "ifgo":
        _lin(rows, f"predictor.lstm.i{g}", P, P, bias=False)
        _lin(rows, f"predictor.lstm.h{g}", P, P)
    _lin(rows, "joint.enc_proj", d, J)
    _lin(rows, "joint.pred_proj", P, J)
    _lin(rows, "joint.out", J, V1)
    return rows
