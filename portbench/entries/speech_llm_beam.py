"""Offline recognition with the LLM-decoder recognizer,
``SpeechLLM.recognize``: one unit is one request of a batch of utterances,
encoded, projected into the decoder's prompts, prefilled, and searched by
the port's ``BeamSearch`` at the cell's ``width`` for at most
``ceil(decode_tokens_per_s x`` the batch's longest duration``)`` tokens,
a beam ending at the configuration's ``eos_token_id``.

The model is built here from the configuration (the encoder's weights as
the Conformer cells draw them, the decoder's leaf by leaf,
:mod:`portbench.reference.llm_layout`). Each request's parts are timed
on the device's timeline (CUDA events): ``enc_ms`` to the end of the
encoder's last block, ``prefill_ms`` from the projector to the prompts'
logits, ``step_ms`` from one call of the decoder's ``lm_head`` to the next
(one search trip each), with ``steps`` the decoder's calls after the
prefill and ``reorder_bytes`` the bytes that beam reorders and the
freezing of finished utterances moved in the LM's state.

Judged after the window on ``judge_rows`` rows (with the longest) of each
of a sample of the requests, drawn from the seed with the request that
holds the longest utterance among the first ones. The reference
(:mod:`portbench.reference.speech_llm`, float32, no cache) runs the whole
prompt and each of the program's final beams and reads:

- ``prefill_lp_gap``: the widest gap between the program's and the
  reference's log-softmax after the prompt, over the reference's 32 most
  likely tokens of each row;
- ``beam_ll_gap``: for each final beam, the gap between the log-probability
  the search scored it with and the reference's log-probability of the
  same tokens, in nats a token of the beam.

The limits are the cell file's ``judge`` entries, each with its reason
(``limits``, which other entries read, is empty). The control puts the
reference in float8 products (:mod:`portbench.reference.precision`) in the
program's place: its own prefill and its own scores of the program's
beams.
"""

import math

import numpy as np
import torch

from portbench import harness, port, traffic
from portbench import weights as wmod
from portbench.reference import layout, llm_layout, precision
from portbench.reference import speech_llm as ref

SAMPLE_FROM = 4  # the sample is drawn from the first requests of the window
TOP_TOKENS = 32  # the prefill gap is read over the reference's most likely tokens
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(cfg):
    """The port's ``SpeechLLMConfig`` of a configuration file."""
    from pydrobert_tpu_torch.models.speech_llm import SpeechLLMConfig

    enc = dict(cfg["encoder"], vocab_size=1)
    enc.pop("source", None)
    rs = cfg["rope_scaling"]
    keep = ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
            "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
            "intermediate_size", "moe_intermediate_size", "n_routed_experts", "n_shared_experts",
            "num_experts_per_tok", "first_k_dense_replace", "routed_scaling_factor",
            "rms_norm_eps", "audio_stack")
    return SpeechLLMConfig(
        encoder=port.conformer_config(enc), rope_theta=float(cfg["rope_theta"]),
        rope_factor=float(rs["factor"]),
        rope_original_max_position=int(rs["original_max_position_embeddings"]),
        rope_beta_fast=float(rs["beta_fast"]), rope_beta_slow=float(rs["beta_slow"]),
        rope_mscale=float(rs["mscale"]), rope_mscale_all_dim=float(rs["mscale_all_dim"]),
        prompt_ids=tuple(cfg["prompt_ids"]), suffix_ids=tuple(cfg["suffix_ids"]),
        dtype=DTYPES[cfg["dtype"]], **{k: cfg[k] for k in keep},
    )


class Weights:
    """The seeded weights of a run: the encoder's in one float32 draw, the
    decoder's leaf by leaf from generators keyed by each leaf's name."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.rows = {r[0]: r for r in llm_layout.decoder_rows(self.cfg)}

    def encoder(self):
        rows = layout.encoder_layout(self.cfg["encoder"], "encoder.")
        return wmod.make_weights(rows, self.ctx.generator("weights"), self.ctx.device)

    def leaf(self, name, dtype=None):
        dtype = DTYPES[self.cfg["dtype"]] if dtype is None else dtype
        w = llm_layout.draw(self.rows[name], self.ctx.generator("llm", name), self.ctx.device,
                            DTYPES[self.cfg["dtype"]])
        return w.to(dtype)

    def state_dict(self):
        out = self.encoder()
        for name in self.rows:
            out[name] = self.leaf(name)
        return out


class Entry:
    SPAN = "request"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        spec = ctx.spec
        self.width = int(spec["width"])
        if len(self.cfg["prompt_ids"]) + len(self.cfg["suffix_ids"]) != spec["prompt_tokens"] \
                or self.cfg["audio_stack"] != spec["audio_stack"]:
            raise harness.RunError("the cell's prompt_tokens or audio_stack is not the model's")
        rng = ctx.rng("sample")
        lens = [traffic.lengths(ctx.traffic, ctx.rng("batch", i)) for i in range(SAMPLE_FROM)]
        longest = int(np.argmax([max(v) for v in lens]))
        self.sample = sorted({longest} | set(rng.choice(SAMPLE_FROM, 1).tolist()))
        self.rows = {i: ctx.judge_rows(i, lens[i]) for i in self.sample}
        self.stamps = harness.Stamps(ctx.device)
        self.kept = {}
        self.notes_ = {}
        self._marks, self._first, self._want = None, None, {}

    def max_iters(self, lens):
        secs = float(np.max(lens)) * float(self.ctx.traffic["hop_s"])
        return max(1, math.ceil(float(self.ctx.spec["decode_tokens_per_s"]) * secs - 1e-9))

    # marks on the device's timeline, made by hooks on the model's modules
    def _mark(self, kind):
        def hook(module, args, output=None):
            if self._marks is not None:
                self._marks.append((kind, self.stamps.mark()))
                if kind == "head" and self._first is None and "first" in self._want:
                    self._first = torch.log_softmax(output[self._want["first"]].float(), -1)
        return hook

    def setup(self):
        from pydrobert_tpu_torch.models.speech_llm import SpeechLLM

        with torch.device("meta"):
            model = SpeechLLM(model_config(self.cfg), device="meta")
        model.load_state_dict(Weights(self.ctx).state_dict(), strict=True, assign=True)
        self.model = model
        last = getattr(model.encoder, f"block_{self.cfg['encoder']['num_layers'] - 1}")
        self.handles = [
            last.register_forward_hook(self._mark("enc")),
            model.projector.register_forward_pre_hook(self._mark("proj")),
            model.lm_head.register_forward_hook(self._mark("head")),
        ]
        T = int(self.ctx.traffic["pad_to"])
        longest = int(math.floor(float(self.ctx.traffic["lengths_s"]["max"])
                                 / float(self.ctx.traffic["hop_s"]) + 1e-9))
        for i in range(int(self.ctx.spec.get("warmup_units", 1))):
            b = traffic.make_batch(self.ctx, f"warmup{i}", self.cfg["encoder"]["num_filts"])
            # every decode step's shape the window can reach
            self._recognize(b, self.max_iters([min(longest, T)]))

    def _recognize(self, b, steps, stats=None):
        lens = torch.from_numpy(b["lens"]).to(self.ctx.device)
        return self.model.recognize(b["feats"], lens, self.width, steps,
                                    eos=int(self.cfg["eos_token_id"]), stats=stats)

    def unit(self, i):
        b = traffic.make_batch(self.ctx, i, self.cfg["encoder"]["num_filts"])
        keep = i in self.sample
        steps = self.max_iters(b["lens"])
        self._marks, self._first = [], None
        self._want = {"first": self.rows[i]} if keep else {}
        stats = {}
        start = self.stamps.mark()
        y, y_lens, y_lp = self._recognize(b, steps, stats)
        end = self.stamps.mark()
        if keep:
            rows = self.rows[i]
            self.kept[i] = {"y": y[:, rows], "y_lens": y_lens[rows], "y_lp": y_lp[rows],
                            "first": self._first}
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        marks, self._marks = self._marks, None
        at = {k: [m for kind, m in marks if kind == k] for k in ("enc", "proj", "head")}
        heads = at["head"]
        return {
            "lens": b["lens"], "audio_s": traffic.audio_seconds(self.ctx.traffic, b["lens"]),
            "max_iters": steps, "steps": int(stats["steps"]),
            "reorder_bytes": int(stats["reorder_bytes"]),
            "enc_ms": self.stamps.ms(start, at["enc"][0]),
            "prefill_ms": self.stamps.ms(at["proj"][0], at["head"][0]),
            # a trip: from the decoder's logits of one step to the next's
            "step_ms": [self.stamps.ms(h0, h1) for h0, h1 in zip(heads[:-1], heads[1:])],
            "search_ms": self.stamps.ms(at["head"][0], end),
        }

    def release(self):
        for i in self.sample:
            if i not in self.kept:
                self.unit(i)
        for h in self.handles:
            h.remove()
        del self.model

    def compare(self, control=False):
        w = Weights(self.ctx)
        W_enc = w.encoder()

        def leaf(name):
            return w.leaf(name, torch.float32)

        prefill_gap = ll_gap = 0.0
        notes = {}
        with precision.no_tf32():
            for i, kept in sorted(self.kept.items()):
                b = traffic.make_batch(self.ctx, i, self.cfg["encoder"]["num_filts"])
                rows = self.rows[i]
                feats = b["feats"][rows]
                lens = torch.from_numpy(b["lens"][rows]).to(self.ctx.device)
                toks, n_toks = self.hypotheses(kept)
                ref_first, ref_ll = self.score(W_enc, leaf, feats, lens, toks, n_toks,
                                               precision.Exact, notes)
                if control:
                    got_first, got_ll = self.score(W_enc, leaf, feats, lens, toks, n_toks,
                                                   precision.FP8, None)
                else:
                    got_first, got_ll = kept["first"], kept["y_lp"].reshape(-1).double()
                top = ref_first.topk(TOP_TOKENS, -1).indices
                gap = (got_first.gather(1, top) - ref_first.gather(1, top)).abs()
                prefill_gap = max(prefill_gap, float(gap.max()))
                per_tok = (got_ll - ref_ll).abs() / n_toks.clamp_min(1).double()
                ll_gap = max(ll_gap, float(per_tok.max()))
        self.notes_ = notes
        lim = self.ctx.spec["judge"]
        return [
            ("prefill_lp_gap", prefill_gap, lim["prefill_lp_gap"]["limit"]),
            ("beam_ll_gap", ll_gap, lim["beam_ll_gap"]["limit"]),
        ]

    def hypotheses(self, kept):
        """The final beams, row by row: ``(tokens (R W, U), lengths (R W,))``."""
        y, y_lens = kept["y"], kept["y_lens"]  # (S, R, W), (R, W)
        S, R, W = y.shape
        toks = y.permute(1, 2, 0).reshape(R * W, S).clamp(0, self.cfg["vocab_size"] - 1)
        n = y_lens.reshape(-1)
        U = max(1, int(n.max()))
        return toks[:, :U], n

    def score(self, W_enc, leaf, feats, lens, toks, n_toks, prec, notes):
        """The reference's log-softmax after each row's prompt ``(R, V)``
        and its log-probability of each beam ``(R W,)`` float64."""
        audio, a_lens = ref.audio_embeddings(W_enc, leaf, self.cfg, feats, lens, prec)
        W = self.width
        first, picked = ref.decoder_log_probs(
            leaf, self.cfg, audio.repeat_interleave(W, 0), a_lens.repeat_interleave(W),
            toks, prec, pick=toks, notes=notes,
        )
        U = toks.shape[1]
        inside = torch.arange(U, device=toks.device)[None] < n_toks[:, None]
        ll = torch.where(inside, picked.double(), 0.0).sum(1)
        return first[::W], ll

    def notes(self):
        n = self.notes_
        share = n.get("near_ties", 0) / max(1, n.get("routed", 0))
        return [f"portbench: reference router near-ties (margin < {ref.TIE_MARGIN}) "
                f"{n.get('near_ties', 0)} of {n.get('routed', 0)} token-layers ({share!r})"]
