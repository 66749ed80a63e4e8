"""The LLM-decoder recognizer (``models/speech_llm.py``) against the
benchmark's plain float32 reference (``portbench/reference/speech_llm.py``)
at a tiny size on the CPU: prefill and cached decoding, the beam search
through ``recognize``, the latent caches under beam reorders, the routed
experts, and the YaRN constants."""

import ast
import math
import os
import sys

import pytest
import torch

from pydrobert_tpu_torch.lm import ExtractableSequentialLanguageModel
from pydrobert_tpu_torch.models import SpeechLLM, SpeechLLMConfig, SpeechLLMDecoderLM
from pydrobert_tpu_torch.models import speech_llm as psl
from pydrobert_tpu_torch.models.conformer import ConformerConfig
from pydrobert_tpu_torch.ops.decoding import BeamSearch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.reference import speech_llm as ref  # noqa: E402

ENC = dict(num_layers=2, d_model=32, num_heads=4, ffn_factor=4, conv_kernel=5, num_filts=16,
           subsample_channels=8, dropout=0.0, attention_context=[None, None],
           causal_conv=False)
ROPE = dict(factor=40, original_max_position_embeddings=4096, beta_fast=32, beta_slow=1,
            mscale=0.707, mscale_all_dim=0.707, type="yarn")
LLM = dict(vocab_size=97, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
           kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8,
           intermediate_size=96, moe_intermediate_size=24, n_routed_experts=8,
           n_shared_experts=2, num_experts_per_tok=2, first_k_dense_replace=1,
           routed_scaling_factor=1.0, rms_norm_eps=1e-6, rope_theta=10000, rope_scaling=ROPE,
           audio_stack=2, prompt_ids=list(range(1, 9)), suffix_ids=list(range(9, 17)))
RCFG = dict(LLM, encoder=ENC)
# ends two of the three utterances' best beams before the last step
EOS = 78


def port_config(llm=LLM, dtype=torch.float32):
    rs = llm["rope_scaling"]
    keep = {k: v for k, v in llm.items()
            if k not in ("rope_scaling", "prompt_ids", "suffix_ids", "rope_theta")}
    return SpeechLLMConfig(
        encoder=ConformerConfig(vocab_size=1, num_filts=ENC["num_filts"], d_model=ENC["d_model"],
                                num_layers=ENC["num_layers"], num_heads=ENC["num_heads"],
                                conv_kernel=ENC["conv_kernel"],
                                subsample_channels=ENC["subsample_channels"], dropout=0.0,
                                dtype=dtype),
        rope_theta=float(llm["rope_theta"]), rope_factor=rs["factor"],
        rope_original_max_position=rs["original_max_position_embeddings"],
        rope_beta_fast=rs["beta_fast"], rope_beta_slow=rs["beta_slow"], rope_mscale=rs["mscale"],
        rope_mscale_all_dim=rs["mscale_all_dim"], prompt_ids=tuple(llm["prompt_ids"]),
        suffix_ids=tuple(llm["suffix_ids"]), dtype=dtype, **keep,
    )


@pytest.fixture(scope="module")
def tiny():
    """A float32 model, its weights as the reference reads them, and a
    batch of three utterances (two of odd encoder length, so a stacked
    audio token holds a zeroed frame)."""
    model = SpeechLLM(port_config(), device="cpu", generator=torch.Generator().manual_seed(3))
    sd = model.state_dict()
    g = torch.Generator().manual_seed(7)
    feats = torch.randn(3, 40, ENC["num_filts"], generator=g)
    lens = torch.tensor([40, 23, 31])
    return model, sd, (lambda name: sd[name].float()), feats, lens


class CachelessLM(ExtractableSequentialLanguageModel):
    """The reference as a sequential LM: each step runs the whole prompt
    and history again, with no cache. State: the projected audio of each
    row (gathered along with the beams)."""

    def __init__(self, leaf):
        super().__init__(LLM["vocab_size"])
        self.leaf = leaf

    def calc_idx_log_probs(self, hist, prev, idx):
        t = int(idx)
        lp = ref.decoder_log_probs(self.leaf, RCFG, prev["audio"], prev["a_lens"],
                                   hist[:t].T.clamp(0, self.vocab_size - 1))
        return lp[:, t], prev


def test_prefill_then_cached_decoding_match_the_full_forward(tiny):
    model, sd, leaf, feats, lens = tiny
    S = 6
    hist = torch.randint(0, LLM["vocab_size"], (S, 3), generator=torch.Generator().manual_seed(1))
    state = SpeechLLMDecoderLM(model).initial_state(feats, lens, S)
    got = SpeechLLMDecoderLM(model)(hist, state)  # (S + 1, N, V)
    audio, a_lens = ref.audio_embeddings(sd, leaf, RCFG, feats, lens)
    want = ref.decoder_log_probs(leaf, RCFG, audio, a_lens, hist.T)
    assert got.shape == (S + 1, 3, LLM["vocab_size"])
    # float32 both ways; the sums run in other orders (absorbed attention)
    assert torch.allclose(got.transpose(0, 1), want, atol=2e-5, rtol=0)
    assert torch.equal(state["prompt_lens"], 16 + -(-(((lens + 1) // 2 + 1) // 2) // 2))


@pytest.mark.parametrize("width", [1, 3])
def test_recognize_is_beam_search_over_the_reference(tiny, width):
    model, sd, leaf, feats, lens = tiny
    S = 7
    y, y_lens, y_lp = model.recognize(feats, lens, width, S, eos=EOS)
    audio, a_lens = ref.audio_embeddings(sd, leaf, RCFG, feats, lens)
    ry, ry_lens, ry_lp = BeamSearch(CachelessLM(leaf), width, eos=EOS)(
        {"audio": audio, "a_lens": a_lens}, 3, S)
    assert torch.equal(y_lens, ry_lens)
    assert torch.equal(y, ry)
    assert torch.allclose(y_lp, ry_lp, atol=1e-4, rtol=0)
    # some beam ended at eos, so the freeze of finished elements ran
    if width > 1:
        assert (y == EOS).any()


def test_prompt_cache_held_once_and_never_moved(tiny):
    """The prompt's latent cache keeps leading axis N through the spread
    over the beams and every reorder, no reorder or freeze copies it or the
    suffix cache, and the bytes moved are ``anc``'s alone."""
    model, _, _, feats, lens = tiny
    N, W, S = 3, 4, 6
    lm = SpeechLLMDecoderLM(model)
    state = lm.initial_state(feats, lens, S, W)
    L, P = LLM["num_hidden_layers"], state["prompt"].shape[2]
    assert state["prompt"].shape == (N, L, P, 16 + 8)
    assert state["suffix"].shape == (N, L, S, W, 16 + 8)
    spread = lm.extract_by_src(state, torch.arange(N).repeat_interleave(W))
    assert spread["prompt"] is state["prompt"] and spread["suffix"] is state["suffix"]
    assert spread["anc"].shape == (N * W, S)
    assert lm.moved_bytes == 2 * N * W * S * 8
    stats = {}
    model.recognize(feats, lens, W, S, eos=EOS, stats=stats)
    # per step: the reorder reads and writes anc; the freeze reads two and
    # writes one; the step-0 spread reads and writes it once more
    anc = N * W * S * 8
    assert stats["reorder_bytes"] == 2 * anc + stats["steps"] * 5 * anc
    assert 1 <= stats["steps"] <= S - 1


def test_routing_is_dropless_unrenormalized_with_the_shared_expert(tiny):
    model = tiny[0]
    moe = model.layers[1].mlp
    k = LLM["num_experts_per_tok"]
    g = torch.Generator().manual_seed(4)
    u = torch.nn.functional.normalize(torch.randn(LLM["hidden_size"], generator=g), dim=0)
    x = torch.randn(50, LLM["hidden_size"], generator=g) + 3 * u
    with torch.no_grad():
        # most tokens' top choice is expert 0, far past any capacity
        moe.gate.weight[0] += 1.5 * u
        got = moe(x)
        probs = torch.softmax(x @ moe.gate.weight.T, -1)
        top = torch.topk(probs, k).indices
        assert int((top[:, 0] == 0).sum()) >= 40
        f = LLM["moe_intermediate_size"]
        want = moe.shared_experts(x)
        for t in range(x.shape[0]):
            for e in top[t]:
                h = moe.gate_up[e] @ x[t]
                want[t] += probs[t, e] * (moe.down[e] @ (torch.nn.functional.silu(h[:f]) * h[f:]))
        gates, _ = moe.route(x)
        moe.gate.weight[0] -= 1.5 * u
    # raw scores, not renormalized over the chosen experts
    assert torch.allclose(gates, probs.gather(1, top), atol=1e-6, rtol=0)
    assert (gates.sum(1) < 0.9).any()
    assert torch.allclose(got, want, atol=1e-5, rtol=0)


def test_padded_positions_never_reach_an_expert(tiny, monkeypatch):
    model = tiny[0]
    moe = model.layers[2].mlp
    rows = []
    grouped = torch.nn.functional.grouped_mm

    def counted(a, b, offs):
        rows.append(int(offs[-1]))
        return grouped(a, b, offs=offs)

    monkeypatch.setattr(psl.F, "grouped_mm", counted)
    x = torch.randn(10, LLM["hidden_size"], generator=torch.Generator().manual_seed(5))
    valid = torch.tensor([True] * 6 + [False] * 4)
    junk = x.clone()
    junk[~valid] = float("nan")
    with torch.no_grad():
        got = moe(junk, valid)
        want = moe(x[valid])
    k = LLM["num_experts_per_tok"]
    assert rows == [6 * k, 6 * k, 6 * k, 6 * k]
    assert torch.allclose(got[valid], want, atol=1e-6, rtol=0)


def test_yarn_constants_are_the_formula():
    cfg = SpeechLLMConfig()
    dim, base, s = 64, 10000.0, 40.0

    def corr(rot):
        return dim * math.log(4096 / (rot * 2 * math.pi)) / (2 * math.log(base))

    lo, hi = max(math.floor(corr(32)), 0), min(math.ceil(corr(1)), dim - 1)
    want = []
    for i in range(dim // 2):
        extra = base ** (-2 * i / dim)
        ramp = min(max((i - lo) / (hi - lo), 0.0), 1.0)
        want.append(extra / s * ramp + extra * (1 - ramp))
    got = psl.yarn_inv_freq(cfg).double()
    assert torch.allclose(got, torch.tensor(want, dtype=torch.float64), rtol=1e-6, atol=0)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert abs(m - 1.2608) < 1e-4
    assert cfg.softmax_scale == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    full = dict(RCFG, qk_nope_head_dim=128, qk_rope_head_dim=64)
    assert ref.softmax_scale(full) == pytest.approx(cfg.softmax_scale, rel=1e-12)
    assert torch.allclose(ref.yarn_inv_freq(full), got, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["speech_llm.py", "llm_layout.py"])
def test_reference_imports_nothing_of_the_port(name):
    path = os.path.join(ROOT, "portbench", "reference", name)
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= {"torch", "math"}, names
