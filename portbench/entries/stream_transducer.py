"""Streaming greedy transducer recognition through the port's
``serving.StreamingTransducerRecognizer``: sessions of ``batch`` concurrent
streams, each pushing ``push_raw_frames`` raw frames a call (zero once it
has ended), the next push sent as soon as the last returns, ``finish`` at
the session's end and the next session at once. One unit is one call,
``push`` or ``finish``, timed until its partial (or final) result is on
the host.

Judged after the window on the final transcripts of ``judge_rows`` streams
(with the longest) of each of a sample of the sessions it finished
(session 0, whose end is awaited past the window when the window closes
first, and one drawn from the seed): the reference
encodes each session's whole features at once in float32 and judges the
transcripts (:func:`portbench.reference.transducer.judge`), so the streamed
encoding, the joint's logits and the hypotheses are held to a one-shot
reference; ``token_gap`` as for ``transducer_greedy``."""

import time

import numpy as np

from portbench import port, traffic
from portbench.entries import _transducer

WARM_PUSHES = 12


class Entry:
    SPAN = "call"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.push_raw = int(ctx.traffic["push_raw_frames"])
        self.sample = {0, int(ctx.rng("sample").integers(1, 3))}
        self.kept = {}
        self.sess = None
        self.index = 0
        self.tokens = self.frames = 0

    def setup(self):
        from pydrobert_tpu_torch.serving import StreamingTransducerRecognizer

        self.model = port.build_model(self.ctx)
        spec = self.ctx.spec
        self.rec = StreamingTransducerRecognizer(
            self.model, chunk=int(spec["chunk"]), mode="greedy",
            max_symbols_per_frame=int(spec["max_symbols_per_frame"]),
            max_frames=int(spec["max_frames"]),
        )
        # a short session: full pushes, streams that end, and a finish
        b = traffic.make_batch(self.ctx, "warmup", self.cfg["num_filts"])
        lens = np.minimum(b["lens"], WARM_PUSHES * self.push_raw - b["lens"] % 97)
        sess = self.rec.start(len(lens))
        for p in range(WARM_PUSHES):
            self._call(sess, b["feats"], lens, p)
        self._call(sess, b["feats"], lens, None)

    def _call(self, sess, feats, lens, p):
        if p is None:
            out = self.rec.finish(sess)
        else:
            new = np.clip(lens - p * self.push_raw, 0, self.push_raw)
            out = self.rec.push(sess, feats[:, p * self.push_raw:(p + 1) * self.push_raw], new)
        hyps, u = out
        return hyps.cpu(), u.cpu()  # the partial result on the host

    def _open(self):
        b = traffic.make_batch(self.ctx, self.index, self.cfg["num_filts"])
        self.sess = self.rec.start(len(b["lens"]))
        self.batch = b
        self.pushes = -(-int(b["lens"].max()) // self.push_raw)
        self.p = 0
        self.u_before = 0

    def unit(self, i):
        if self.sess is None:
            self._open()
        b, lens = self.batch, self.batch["lens"]
        t0 = time.perf_counter()
        if self.p < self.pushes:
            hyps, u = self._call(self.sess, b["feats"], lens, self.p)
            ms = (time.perf_counter() - t0) * 1e3
            before = np.minimum(lens, self.p * self.push_raw) // 4
            after = np.minimum(lens, (self.p + 1) * self.push_raw) // 4
            kind = "push"
            self.p += 1
        else:
            hyps, u = self._call(self.sess, b["feats"], lens, None)
            ms = (time.perf_counter() - t0) * 1e3
            before, after = lens // 4, (lens + 3) // 4
            kind = "finish"
            if self.index in self.sample:
                self.kept[self.index] = (hyps, u)
            self.sess = None
            self.index += 1
        tokens = int(u.sum()) - self.u_before
        self.u_before = int(u.sum())
        self.tokens += tokens
        self.frames += int((after - before).sum())
        return {"kind": kind, "ms": ms, "new_frames": (after - before).tolist(),
                "tokens": tokens}

    def release(self):
        # a sampled session still open when the window closed is finished now
        if self.sess is not None and self.index in self.sample:
            while self.sess is not None:
                self.unit(-1)
        del self.model, self.rec, self.sess

    def notes(self):
        rate = self.tokens / max(self.frames, 1)
        return [f"portbench: greedy emitted {rate:.4f} tokens an encoder frame, blank bias "
                f"{getattr(self.ctx, 'blank_bias', None)}"]

    def compare(self, control=False):
        batches = []
        for i, (hyps, hyp_lens) in sorted(self.kept.items()):
            b = traffic.make_batch(self.ctx, i, self.cfg["num_filts"])
            rows = self.ctx.judge_rows(("session", i), b["lens"])
            batches.append((b["feats"][rows], _transducer.lens_tensor(self.ctx, b["lens"][rows]),
                            hyps[rows], hyp_lens[rows]))
        return _transducer.checks(self.ctx, _transducer.judge(self.ctx, batches, control))
