"""Offline greedy transducer decoding, ``ConformerTransducer.greedy``: one
unit is one request of a batch of utterances, encoded and decoded with at
most ``max_symbols_per_frame`` emissions a frame. Each request's encoder
part and loop part are timed on the device's timeline (``enc_ms`` to the
end of the encoder's forward, ``loop_ms`` after).

Judged after the window on ``judge_rows`` rows (with the longest) of each
of a sample of the requests it finished, drawn from the seed with the
request that holds the longest utterance: the
reference encodes the same features in float32 and judges each served
transcript (:func:`portbench.reference.transducer.judge`): ``token_gap`` is
the widest gap by which the reference's best logit lies above what a step
took (a served token or the blank), along the alignment of the transcript
where that widest gap is smallest. The control reads, along the same
alignment, the gap of the token the float8 reference puts first."""

import numpy as np

from portbench import harness, port, traffic
from portbench.entries import _transducer

SAMPLE_FROM = 8


class Entry:
    SPAN = "request"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.E = int(ctx.spec["max_symbols_per_frame"])
        lens = [traffic.lengths(ctx.traffic, ctx.rng("batch", i)) for i in range(SAMPLE_FROM)]
        longest = int(np.argmax([max(v) for v in lens]))
        pick = ctx.rng("sample").choice(SAMPLE_FROM, 2, replace=False).tolist()
        self.sample = sorted({longest} | set(pick))
        self.rows = {i: ctx.judge_rows(i, lens[i]) for i in self.sample}
        self.stamps = harness.Stamps(ctx.device)
        self.kept = {}
        self.tokens = self.frames = 0
        self._enc = None

    def _hook(self, module, inputs, output):
        self._enc = self.stamps.mark()

    def setup(self):
        self.model = port.build_model(self.ctx)
        self.handle = self.model.encoder.register_forward_hook(self._hook)
        for i in range(int(self.ctx.spec.get("warmup_units", 2))):
            b = traffic.make_batch(self.ctx, f"warmup{i}", self.cfg["num_filts"])
            self.model.greedy(b["feats"], _transducer.lens_tensor(self.ctx, b["lens"]), self.E)

    def unit(self, i):
        b = traffic.make_batch(self.ctx, i, self.cfg["num_filts"])
        start = self.stamps.mark()
        hyps, hyp_lens = self.model.greedy(
            b["feats"], _transducer.lens_tensor(self.ctx, b["lens"]), self.E
        )
        end = self.stamps.mark()
        hyp_lens = hyp_lens.cpu()  # the transcript's lengths on the host ends the request
        if i in self.sample:
            rows = self.rows[i]
            self.kept[i] = (hyps[rows], hyp_lens[rows])
        tokens = int(hyp_lens.sum())
        self.tokens += tokens
        self.frames += int(((b["lens"] + 3) // 4).sum())
        if self.stamps.cuda:
            end.synchronize()
        return {"lens": b["lens"], "tokens": tokens,
                "audio_s": traffic.audio_seconds(self.ctx.traffic, b["lens"]),
                "enc_ms": self.stamps.ms(start, self._enc),
                "loop_ms": self.stamps.ms(self._enc, end)}

    def release(self):
        # a sampled request the window did not reach is served now
        for i in self.sample:
            if i not in self.kept:
                self.unit(i)
        self.handle.remove()
        del self.model

    def notes(self):
        rate = self.tokens / max(self.frames, 1)
        return [f"portbench: greedy emitted {rate:.4f} tokens an encoder frame, blank bias "
                f"{getattr(self.ctx, 'blank_bias', None)}"]

    def compare(self, control=False):
        batches = []
        for i, (hyps, hyp_lens) in sorted(self.kept.items()):
            b = traffic.make_batch(self.ctx, i, self.cfg["num_filts"])
            rows = self.rows[i]
            batches.append((b["feats"][rows], _transducer.lens_tensor(self.ctx, b["lens"][rows]),
                            hyps, hyp_lens))
        return _transducer.checks(self.ctx, _transducer.judge(self.ctx, batches, control))
