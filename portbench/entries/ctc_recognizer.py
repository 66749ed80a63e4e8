"""Offline CTC decoding through the port's serving head,
``export.ctc_recognizer(model, width)``: one unit is one request of a batch
of utterances, encoded and searched with a width-``width`` prefix search.
Each request's encoder part and search part are timed on the device's
timeline (``enc_ms`` to the end of the model's forward, ``loop_ms`` after).

Judged after the window, on ``judge_rows`` rows (with the longest) of each
of a sample of the requests it finished, drawn from the seed with the
request that holds the longest utterance among those the sample is drawn
from. The reference encodes the same features in float32 and reads:

- ``logit_gap``: at every frame of every row, how far the reference's best
  logit lies above its logit of the token the program's logits put first;
- ``hyp_ll_gap``: its own prefix search over its own logits gives each
  row a best hypothesis; the program's best hypothesis may lie only this
  many nats a frame (of the row's encoder frames) below it in the
  reference's CTC log-likelihood (a hypothesis no alignment fits counts as
  about 1e30 nats);
- over the program's own logits, the search stage alone: its own prefix
  search, against which the program's best hypothesis may lie only
  ``top_hyp_gap`` below the reference's best (in nats of the reference's
  masses; a hypothesis the reference does not hold counts as 1e30) and
  each beam's probability only ``beam_mass_rel`` from the reference's beam
  of the same rank, where the reference's mass is at least 1e-30.

The control puts the reference in float8 (encoder) and bfloat16 (search
masses) in the program's place.
"""

import math

import numpy as np
import torch

from portbench import harness, port, traffic
from portbench.reference import ctc, encoder, precision

SAMPLE_FROM = 8  # the sample is drawn from the first requests of the window
MIN_MASS = 1e-30


class Entry:
    SPAN = "request"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.width = int(ctx.spec["width"])
        rng = ctx.rng("sample")
        lens = [traffic.lengths(ctx.traffic, ctx.rng("batch", i)) for i in range(SAMPLE_FROM)]
        longest = int(np.argmax([max(v) for v in lens]))
        self.sample = sorted({longest} | set(rng.choice(SAMPLE_FROM, 2, replace=False).tolist()))
        self.rows = {i: ctx.judge_rows(i, lens[i]) for i in self.sample}
        self.stamps = harness.Stamps(ctx.device)
        self.kept = {}
        self._keep = None
        self._enc = None
        self._sent = None
        self.ll_gap_nats = 0.0

    def _hook(self, module, inputs, output):
        self._enc = self.stamps.mark()
        if self._keep is not None:
            # rows of the batch that was sent (a forward of another batch
            # is kept whole, and the judge finds it is not that batch)
            rows = self.rows[self._keep] if output[0].shape[0] == self._sent else slice(None)
            self.kept[self._keep]["logits"] = output[0][rows].detach()
            self.kept[self._keep]["out_lens"] = output[1][rows].detach()

    def setup(self):
        from pydrobert_tpu_torch.export import ctc_recognizer

        self.model = port.build_model(self.ctx)
        self.recognize = ctc_recognizer(self.model, width=self.width)
        self.handle = self.model.register_forward_hook(self._hook)
        for i in range(int(self.ctx.spec.get("warmup_units", 2))):
            b = traffic.make_batch(self.ctx, f"warmup{i}", self.cfg["num_filts"])
            self.recognize(b["feats"], torch.from_numpy(b["lens"]).to(self.ctx.device))

    def unit(self, i):
        b = traffic.make_batch(self.ctx, i, self.cfg["num_filts"])
        keep = i in self.sample
        self._sent = len(b["lens"])
        if keep:
            self.kept[i] = {}
            self._keep = i
        start = self.stamps.mark()
        out = self.recognize(b["feats"], torch.from_numpy(b["lens"]).to(self.ctx.device))
        end = self.stamps.mark()
        self._keep = None
        if keep:
            rows = self.rows[i]
            self.kept[i]["out"] = tuple(o[rows] for o in out)
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        return {"lens": b["lens"], "audio_s": traffic.audio_seconds(self.ctx.traffic, b["lens"]),
                "enc_ms": self.stamps.ms(start, self._enc),
                "loop_ms": self.stamps.ms(self._enc, end)}

    def release(self):
        # a sampled request the window did not reach is served now
        for i in self.sample:
            if i not in self.kept:
                self.unit(i)
        self.handle.remove()
        del self.model, self.recognize

    def compare(self, control=False):
        W = port.seeded_weights(self.ctx)
        prec = precision.FP8 if control else precision.Exact
        blank = self.cfg["vocab_size"]
        logit_gap = ll_gap = top_gap = mass_rel = 0.0
        self.ll_gap_nats = 0.0
        with precision.no_tf32():
            for i, kept in sorted(self.kept.items()):
                b = traffic.make_batch(self.ctx, i, self.cfg["num_filts"])
                rows = self.rows[i]
                feats = b["feats"][rows]
                lens = torch.from_numpy(b["lens"][rows]).to(self.ctx.device)
                ref, ref_lens = self.reference_logits(W, feats, lens, precision.Exact)
                y, y_lens, y_probs = kept["out"]
                if control:
                    got, got_lens = self.reference_logits(W, feats, lens, prec)
                else:
                    got, got_lens = kept["logits"].float(), kept["out_lens"]
                if got.shape != ref.shape or y.shape[0] != ref.shape[0]:
                    logit_gap = math.inf  # not the batch that was sent
                    continue
                valid = torch.arange(ref.shape[1], device=ref.device)[None] < ref_lens[:, None]
                first = got.argmax(-1, keepdim=True)
                gap = ref.max(-1).values - torch.gather(ref, -1, first)[..., 0]
                logit_gap = max(logit_gap, float(gap[valid].max()))
                # end to end: the best hypotheses against the reference's own search
                best_ref, _ = ctc.prefix_search(ref.transpose(0, 1), ref_lens, self.width)
                if control:
                    best_got, _ = ctc.prefix_search(got.transpose(0, 1), got_lens, self.width,
                                                    torch.bfloat16)
                    best_got = [beams[0] for beams in best_got]
                else:
                    y0, n0 = y[:, 0].cpu(), y_lens[:, 0].cpu()
                    best_got = [tuple(y0[n, : n0[n]].tolist()) for n in range(y0.shape[0])]
                per_frame, nats = self.ll_gap(ref, ref_lens, [bs[0] for bs in best_ref],
                                              best_got, blank)
                ll_gap = max(ll_gap, per_frame)
                self.ll_gap_nats = max(self.ll_gap_nats, nats)
                # the search stage alone, over the program's logits
                tm = kept["logits"].transpose(0, 1).float()
                ref_toks, ref_lm = ctc.prefix_search(tm, kept["out_lens"], self.width)
                if control:
                    toks, lm = ctc.prefix_search(tm, kept["out_lens"], self.width, torch.bfloat16)
                    probs = lm.exp()
                else:
                    yc, yl = y.cpu(), y_lens.cpu()
                    toks = [[tuple(yc[n, w, : yl[n, w]].tolist()) for w in range(self.width)]
                            for n in range(yc.shape[0])]
                    probs = y_probs.double().cpu()
                t, m = self.search_gaps(toks, probs, ref_toks, ref_lm)
                top_gap, mass_rel = max(top_gap, t), max(mass_rel, m)
        lim = self.ctx.spec["limits"]
        return [
            ("logit_gap", logit_gap, lim["logit_gap"]),
            ("hyp_ll_gap", ll_gap, lim["hyp_ll_gap"]),
            ("top_hyp_gap", top_gap, lim["top_hyp_gap"]),
            ("beam_mass_rel", mass_rel, lim["beam_mass_rel"]),
        ]

    def reference_logits(self, W, feats, lens, prec, block=8):
        outs, out_lens = [], []
        for s in range(0, feats.shape[0], block):
            x, ol = encoder.encode(W, self.cfg, feats[s:s + block], lens[s:s + block], prec)
            outs.append(precision.linear(prec, x, W["ctc_head.weight"], W["ctc_head.bias"]))
            out_lens.append(ol)
        return torch.cat(outs), torch.cat(out_lens)

    def notes(self):
        return [f"portbench: hyp_ll_gap in nats of a row, not over its frames "
                f"{self.ll_gap_nats!r}"]

    @staticmethod
    def ll_gap(ref, ref_lens, want, got, blank):
        """The widest amount by which a row's hypothesis ``got`` lies below
        ``want`` in the CTC log-likelihood under ``ref`` (0 where it lies
        above), over the row's frames, and the widest in nats."""
        hyps = want + got
        U = max(1, max(len(h) for h in hyps))
        toks = torch.zeros((len(hyps), U), dtype=torch.long)
        for n, h in enumerate(hyps):
            toks[n, : len(h)] = torch.tensor(h, dtype=torch.long)
        n_rows = len(want)
        ll = ctc.log_likelihood(
            ref.repeat(2, 1, 1), ref_lens.repeat(2), toks.to(ref.device),
            torch.tensor([len(h) for h in hyps]), blank,
        )
        gap = (ll[:n_rows] - ll[n_rows:]).clamp_min(0)
        return float((gap / ref_lens.double().clamp_min(1)).max()), float(gap.max())

    @staticmethod
    def search_gaps(toks, probs, ref_toks, ref_lm):
        top_gap = mass_rel = 0.0
        for n, (beams, ref_beams) in enumerate(zip(toks, ref_toks)):
            if beams[0] != ref_beams[0]:
                if beams[0] in ref_beams:
                    r = ref_beams.index(beams[0])
                    top_gap = max(top_gap, float(ref_lm[n, 0] - ref_lm[n, r]))
                else:
                    top_gap = 1e30
            for w in range(len(ref_beams)):
                ref_p = math.exp(float(ref_lm[n, w])) if ref_lm[n, w] > -math.inf else 0.0
                if ref_p >= MIN_MASS:
                    mass_rel = max(mass_rel, abs(float(probs[n, w]) - ref_p) / ref_p)
        return top_gap, mass_rel
