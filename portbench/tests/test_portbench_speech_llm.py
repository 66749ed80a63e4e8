"""The LLM-decoder recognizer's cell (``dsv2lite_asr.beam4``) end to end on
the CPU at a tiny size through ``harness.run_cell``: sound runs are
correct and report their metrics, planted faults (a renormalized gate, a
dropped shared expert) and the float8 control fail a compared number; and
the cell's counts (``counts/speech_llm.py``) against hand-computed values."""

import json
import os

import pytest
import torch

from portbench.counts import speech_llm as counts
from portbench.tests import tiny

CELL = "dsv2lite_asr.beam4"
CONFIG = "conformer_l_dsv2lite_asr"
ENC = dict(num_layers=2, d_model=32, num_heads=4, ffn_factor=4, conv_kernel=5, num_filts=16,
           subsample_channels=8, dropout=0.0, attn_dropout=0.0, attention_context=[None, None],
           causal_conv=False, dtype="float32", param_dtype="float32")
LLM = dict(vocab_size=97, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
           kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8,
           intermediate_size=96, moe_intermediate_size=24, n_routed_experts=8,
           n_shared_experts=2, num_experts_per_tok=2, first_k_dense_replace=1,
           prompt_ids=list(range(1, 9)), suffix_ids=list(range(9, 17)), eos_token_id=78,
           dtype="float32")
# float32 both ways at this size: the program reads the reference to rounding
LIMITS = {"prefill_lp_gap": 1e-3, "beam_ll_gap": 1e-3}
NEW = ("prefill_ms.llm", "decode_step_ms.llm", "decode_roofline.llm", "reorder_mb.llm",
       "mfu.llm", "idle_share.llm")


def llm_tree(dst):
    """The shrunk benchmark with this cell shrunk too: a three-layer
    decoder of width 64 (one dense layer, then 8 experts, top 2, 2 shared)
    on a two-block encoder, batches of four utterances of 0.4-0.8 s, and
    ten tokens a second (at most eight steps)."""
    tiny.make_tree(dst)
    bench = os.path.join(dst, "portbench")
    path = os.path.join(bench, "configs", CONFIG + ".json")
    with open(path) as f:
        cfg = json.load(f)
    cfg.update(LLM, encoder=ENC)
    tiny.write(path, cfg)
    path = os.path.join(bench, "traffic", "offline_librispeech_b128.json")
    with open(path) as f:
        tr = json.load(f)
    tr.update(batch=4, lengths_s=tiny.TINY_LENGTHS, pad_to=80)
    tiny.write(path, tr)
    path = os.path.join(bench, "workloads", CELL + ".json")
    with open(path) as f:
        spec = json.load(f)
    for name, lim in LIMITS.items():
        spec["judge"][name]["limit"] = lim
    spec.update(decode_tokens_per_s=10.0, judge_rows=tiny.JUDGE_ROWS)
    tiny.write(path, spec)
    return dst


@pytest.fixture(scope="module")
def llm(tmp_path_factory):
    return llm_tree(str(tmp_path_factory.mktemp("llm")))


def test_the_cell_runs_and_is_correct(llm):
    result, checks = tiny.run(llm, CELL)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"offline_audio_s_per_s", "setup_s"}
    assert [c[0] for c in checks] == ["prefill_lp_gap", "beam_ll_gap"]
    traced, _ = tiny.run(llm, CELL, trace=True)
    assert traced["correct"]
    assert set(NEW) <= set(traced["metrics"])
    # anc alone moves: 16 beams of 8 slots of 8 bytes, read and written by
    # a reorder (2) and the freeze (3), and once by the first spread
    assert 0 < traced["metrics"]["reorder_mb.llm"]["value"] <= 7 * 16 * 8 * 8 / 1e6


def _renormalize(entry):
    def setup():
        build()
        for layer in entry.model.layers[1:]:
            route = layer.mlp.route

            def renormalized(x, route=route):
                gates, chosen = route(x)
                return gates / gates.sum(-1, keepdim=True), chosen

            layer.mlp.route = renormalized

    build = entry.setup
    entry.setup = setup


def _drop_shared(entry):
    def setup():
        build()
        for layer in entry.model.layers[1:]:
            layer.mlp.shared_experts.forward = torch.zeros_like

    build = entry.setup
    entry.setup = setup


@pytest.mark.parametrize("fault", [_renormalize, _drop_shared, "control"])
def test_a_planted_fault_fails_a_check(llm, fault):
    if fault == "control":
        result, checks = tiny.run(llm, CELL, control=True)
    else:
        result, checks = tiny.run(llm, CELL, hook=fault)
    assert not result["correct"]
    assert any(v > lim for _, v, lim in checks)


def test_counts_are_the_hand_computed_values():
    with open(os.path.join(tiny.BENCH, "configs", CONFIG + ".json")) as f:
        full = json.load(f)
    # DeepSeek-V2-Lite: 15.71B parameters, 2.45B active a token (lm_head in)
    assert counts.nonembed_weights(full) + 2048 * 102400 == 15_706_484_224
    assert counts.active_params(full) + 2048 * 102400 == 2_451_308_544
    assert counts.nonembed_weights(full) * 2 == 30_993_538_048
    cfg = dict(full, **LLM, encoder=ENC)
    # attention 8704 a layer; layer 0 27,280 weights, an expert layer 55,440
    assert counts.nonembed_weights(cfg) == 27_280 + 2 * 55_440 + 64 + 64 * 97
    assert counts.active_params(cfg) == 27_136 + 2 * 27_648
    assert counts.prefill_flops(cfg, 20) == 2 * 20 * 82_432 + 576 * 210 + 2 * 64 * 97
    assert counts.decode_flops(cfg, 25) == 2 * 82_432 + 3 * 2 * 4 * (24 + 16) * 25 + 2 * 64 * 97
    # raw 40 and 23 frames: 10 and 6 encoder frames, 5 and 3 audio tokens
    assert [counts.prompt_len(cfg, raw) for raw in (40, 23)] == [21, 19]
    assert counts.step_bytes(cfg, [40, 23], 3, 2) == 144_432 * 4 + 3 * 24 * 4 * (40 + 6 * 2 + 6)
    assert counts.request_flops(cfg, [40], 2, 1) == (
        counts.flops.encoder_flops(ENC, 40) + 2 * 5 * (2 * 32 * 64 + 64 * 64)
        + counts.prefill_flops(cfg, 21) + 2 * counts.decode_flops(cfg, 22))
