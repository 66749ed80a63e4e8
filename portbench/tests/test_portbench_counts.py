"""The benchmark's arithmetic: FLOP counts against ``FlopCounterMode`` on
tiny shapes, the frozen kernel bounds against ``chip_smoke.py``'s, and the
end-to-end readers over synthetic windows."""

import importlib.util
import os
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench.counts import decode_prologue, flops
from portbench.reference import encoder, layout, transducer
from portbench import weights as wmod

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CFG = dict(num_layers=2, d_model=32, num_heads=4, ffn_factor=4, conv_kernel=5, num_filts=16,
           subsample_channels=8, vocab_size=40, dropout=0.0, causal_conv=False,
           attention_context=[None, None], pred_dim=12, joint_dim=10)


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("raw", [37, 64, 81])
def test_ctc_forward_flops(raw):
    W = wmod.make_weights(layout.ctc_layout(CFG), torch.Generator().manual_seed(0), "cpu")
    feats = torch.randn(1, raw, CFG["num_filts"])

    def fwd():
        x, _ = encoder.encode(W, CFG, feats, torch.tensor([raw]))
        encoder._lin(W, "ctc_head", x, encoder.Exact)

    assert counted(fwd) == flops.ctc_forward_flops(CFG, raw)


def test_limited_context_counts_only_keys_in_context():
    cfg = dict(CFG, attention_context=[3, 0], causal_conv=True)
    raw = 80
    T = flops.out_length(raw)
    W = wmod.make_weights(layout.encoder_layout(cfg), torch.Generator().manual_seed(0), "cpu")
    full = counted(lambda: encoder.encode(W, cfg, torch.randn(1, raw, 16), torch.tensor([raw])))
    need = flops.encoder_flops(cfg, raw)
    # the reference computes every score and masks; the count keeps the
    # keys within (3, 0) of each query
    d, L = cfg["d_model"], cfg["num_layers"]
    assert full - need == L * 4 * d * (T * T - flops.attention_keys(cfg, T))
    assert flops.attention_keys(cfg, T) == sum(min(q, 3) + 1 for q in range(T))


def test_transducer_decode_flops():
    cfg = dict(CFG)
    W = wmod.make_weights(layout.transducer_layout(cfg), torch.Generator().manual_seed(0), "cpu")
    frames, tokens = 7, 3
    enc = torch.randn(frames, cfg["d_model"])
    zero = torch.zeros(1, cfg["pred_dim"])

    def decode():
        pred, carry = transducer.predict(W, torch.tensor([cfg["vocab_size"]]), (zero, zero))
        for u in range(tokens):
            pred, carry = transducer.predict(W, torch.tensor([u]), carry)
        e = torch.nn.functional.linear(enc, W["joint.enc_proj.weight"])  # once a frame
        p = torch.nn.functional.linear(
            torch.randn(tokens + 1, cfg["pred_dim"]), W["joint.pred_proj.weight"])
        z = torch.randn(frames + tokens, cfg["joint_dim"])
        torch.nn.functional.linear(z, W["joint.out.weight"])
        return e, p

    assert counted(decode) == flops.transducer_decode_flops(cfg, frames, tokens)
    assert flops.emission_flops(cfg, 5) == (flops.transducer_decode_flops(cfg, 4, 5)
                                            - flops.transducer_decode_flops(cfg, 4, 0))


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [(500, 32, 1025, 32, 4, 0), (500, 32, 1025, 55, 4, 4096),
                                   (128, 256, 1025, 32, 2, 0)])
def test_prologue_bound_frozen(shape):
    assert decode_prologue.prologue_bound_ms(*shape) == chip_smoke().prologue_bound_ms(*shape)


def test_prologue_bound_true_lengths():
    frames = 12345
    assert decode_prologue.bound_ms_true_lengths(frames, 1025, 32, 4) == \
        decode_prologue.prologue_bound_ms(frames, 1, 1025, 32, 4)[0]


def fake_run(units, window_s, trace=False, plain_units=()):
    return types.SimpleNamespace(units=units, window_s=window_s, setup_s=1.5,
                                 records=object() if trace else None,
                                 plain_units=list(plain_units))


def test_rates_and_tail():
    load = lambda n: harness.load_module("metrics", n)  # noqa: E731
    units = [{"audio_s": 100.0 + i, "ms": float(i), "kind": "push"} for i in range(200)]
    units.append({"audio_s": 0.0, "ms": 1000.0, "kind": "finish"})
    run = fake_run(units, 20.0)
    total = sum(u["audio_s"] for u in units)
    assert load("offline_audio_s_per_s").read(run) == total / 20.0
    # nearest rank: the 191st of 201 calls
    assert load("push_p95_ms").read(run) == 190.0
    assert load("setup_s").read(run) == 1.5
    assert load("offline_audio_s_per_s").read(fake_run(units, 20.0, trace=True)) is None


def test_seeds_taken_whole():
    big = 2 ** 31 + 12345
    assert harness.seed_words(big) != harness.seed_words(big + 2 ** 32)
    assert harness.mixed_seed(big, "feats", 0) == harness.mixed_seed(big, "feats", 0)
    assert harness.mixed_seed(big, "feats", 0) != harness.mixed_seed(big, "feats", 1)
    assert 0 <= harness.mixed_seed(-5, "x") < 2 ** 63


def test_parts_read_from_the_untraced_window():
    load = lambda n: harness.load_module("metrics", n)  # noqa: E731
    plain = [{"enc_ms": 10.0 + i, "loop_ms": 100.0 + 2 * i, "ms": 120.0} for i in range(5)]
    run = fake_run([{"ms": 999.0}], 1.0, trace=True, plain_units=plain)
    assert load("encoder_ms.serve").read(run) == 12.0
    assert load("search_ms.prefix16").read(run) == 104.0
    assert load("greedy_loop_ms").read(run) == 104.0
    assert load("greedy_loop_ms").read(fake_run([], 1.0, trace=True)) is None


@pytest.mark.parametrize("ctx", [None, (16, 0), (3, 2)])
def test_attention_keys(ctx):
    cfg = {"attention_context": ctx}
    for T in (0, 1, 5, 40):
        left, right = ctx or (None, None)
        want = sum(
            (T - 1 if right is None else min(T - 1, q + right))
            - (0 if left is None else max(0, q - left)) + 1
            for q in range(T)
        )
        assert flops.attention_keys(cfg, T) == want
