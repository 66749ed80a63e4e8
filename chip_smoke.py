#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pydrobert_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and ``nvcc``; without a card, or without the package beside it,
it exits non-zero before printing any result. Phases, one JSON line each:

1. environment: the card, torch/CUDA versions, the kernels' build time
   (one nvcc per source, all started together) and ptxas' report;
2. kernels vs their plain PyTorch versions on the card: the decode prologue
   and the top-M at the headline shape and edge cases (ties, infinities,
   mixed signed zeros, rows whose keys all tie, M=64 on V=1024, and the
   ``lm_bias`` cases: M=55 with bench.py's 3-gram LM's ``0.5 * uni`` as the
   bias, float32 and bfloat16), bit-exact
   top values and indices, exact max and blank, ``sm_den`` within rtol
   2e-6;
   SpecAugment's apply bit-exact at (32, 1000, 80) in float32 and bfloat16,
   with and without a warp, a frequency mask over whole vectors and one
   cut inside a vector at both ends, inf/NaN only where masked outputs
   read them and every masked output +0.0; the edit distance exact at
   R=40, H=500, R=100, H=250, R=31, H=500 and R=1000, H=500 (N=32) for
   three sets of finite costs, sub=inf (every distance finite: a match
   adds 0) and a NaN cost (bits equal, or NaN in both) and both values of
   exclude_last; the whole-loop beam
   search at (T=500, N=32, V=1024, W=16) with diffuse, decisive and
   tie-heavy logits, at W=2, W=8 and W=32 and at T=2, ragged lengths with
   0 and 1, lengths, the whole path buffer and probabilities bit-exact;
   its renormalizing variant against its plain version, the per-frame
   scan, at (500, 32, 1025) in bf16 (diffuse, decisive, ties), float32,
   W=2, W=32, T=2 and the offline cell's (875, 256, 1025) with LibriSpeech
   lengths: lengths, tokens up to them and probabilities bit-exact; its
   time at the cell's shape beside the scan's;
3. serving: a seeded d512/L8/H8/V1024 ConformerCTC (bf16) serves three
   requests of 32 utterances through ``ctc_recognizer(width=16)``: one
   decode-prologue and one renormalizing beam-kernel launch a request,
   hypotheses and probabilities bit-equal to the card's own scan
   (``USE_BEAM_KERNEL="0"``), the card's hypotheses for four utterances
   must match a CPU decode of the same logits, and the model on the card
   must match itself on the CPU;
4. serving times (medians of 7 after warm-up): each kernel's own device
   time from a torch.profiler trace, beside its wrapper's, its plain
   version's and ``torch.topk``'s per call from CUDA events around 20
   queued calls, and its bound; wall times of the encoder, the decode and a
   whole request, taken in turn so they share the host's load; peak memory;
4b. raw beam serving: the same three requests with ``DECODE_RENORM`` off;
   one ``top_m`` and one ``ctc_beam_search`` launch each, hypotheses equal
   to the card's own scan with ``DECODE_RENORM`` off (lengths and tokens
   exact, probabilities within rtol 1e-4); encoder, decode and request wall
   times in turn; the beam kernel's own, plain and bound times;
4c. streaming: the same widths as a causal config (``attention_context=
   (16, 0)``, ``causal_conv=True``, R=240) serve 32 streams of 1000-2000
   raw frames through ``StreamingCTCRecognizer``, 32 raw frames a push,
   partials every 16th push, on the default (renormalizing whole-loop)
   route and again with ``DECODE_RENORM`` off (``top_m`` and the raw-mass
   ``ctc_beam_search`` each search); on each, push latency, finish
   latency and launches, and a float32 copy's finish on 4 streams equals
   the one-shot search of its full forward;
4d. LM serving (BASELINE config #3): bench.py's random 3-gram over V=1024,
   built with the port's own code, fused at beta 0.5 into the serve
   phase's three requests through ``ctc_recognizer(model, 16, beta=0.5,
   lm=lm)``: the sparse route, one ``decode_prologue`` launch a request at
   M = 2 * 16 + 23 = 55 with the LM's unigram bias; every utterance's
   hypotheses and lengths equal to a CPU decode of the same logits with a
   CPU copy of the LM (probabilities within rtol 1e-4), the prologue on the
   served logits bit-exact; encoder, decode and request wall times in
   turn, launches a frame, and the prologue's own time at M=55 beside its
   bound; then the three requests again with
   ``config.SPARSE_MEMBERSHIP_GATHER`` on (the order-2 slots answered by
   one gather of the LM's bigram table): still one prologue launch a
   request, every utterance equal to the compare route up to ties (the
   JAX package's rule for its two routes), the first request equal to a
   CPU gather decode (rtol 1e-4), its decode ms and launches a frame
   beside the compare route's, and the table's bytes;
4e. probing tables: ``tests/fixtures/big5.arpa.gz`` (5-gram, V=10,240)
   parsed with the port's ``parse_arpa_lm`` and built on the card, whose
   orders 2-4 have only hash-probing tables: full log-probs and sequence
   scores for 64 histories equal to a CPU copy's; the decode route that
   LM takes (its 3,038 corrections are more than the sparse route's 128);
5. training: the same model with dropout 0.1 takes 5 steps of SpecAugment,
   forward, CTC loss, backward and AdamW at bench_train_mfu's shape (B=32,
   T=1000, U=100), which must launch the SpecAugment kernel 5 times and
   end below the first loss; a float32, dropout-0, 2-layer copy of its
   trained weights, and the seeded weights of that configuration, each
   take one step on the card (twice, and once more with cuDNN off), one
   on the CPU and one in float64 on the CPU, the witness of the true
   gradient, and one in float64 on the card, which must lie within 1e-5
   of the witness: each of the card's float32 gradients must lie no
   farther from the witness's than 2.5e-3, 2.5 times the CPU's float32
   gradient or 1.2 times the card's two reduction orders apart (its own
   float32 spread), whichever is most, over the
   tensor's largest witness entry (and within 1e-3 of the CPU's at the
   seeded weights), its loss and updates agree; then the step's
   wall time (median of 7), its FLOPs by ``FlopCounterMode`` and the
   SpecAugment kernel's times;
6. scoring: the greedy decode of the first served request's logits (32
   utterances, T'=500) scored by ``error_rate`` against 40-token
   references; every hypothesis must hold tokens, the call must launch the
   edit-distance kernel once and equal the CPU's result; its wall time,
   peak memory and the kernel's times;
7. seq2seq serving (BASELINE config #5's model, bench_seq2seq_mer_step's
   shape): a seeded ``AttentionSeq2Seq`` (V=64, 40 filters, hidden 128,
   output layer x4) decodes 16 utterances of 200 frames with
   ``BeamSearch(Seq2SeqDecoderLM, 16, eos=63)`` over 16 steps; lengths and
   tokens equal to a CPU decode with a copy of the weights, log
   probabilities within rtol 1e-4; serve and decode wall times, launches
   a step;
8. n-gram beam search (bench_ngram_beam_search): bench.py's 3-gram with
   ``RandomState(4)`` on the card, ``BeamSearch(lm, 16, eos=7)`` over 32
   rows of 100 steps on the sparse route, equal to a CPU copy's search,
   and bit-equal with ``config.SPARSE_MEMBERSHIP_GATHER`` on (BeamSearch
   does not read it); utterances a second and launches a step;
9. seq2seq MER training (BASELINE config #5): 5 steps of
   ``make_mer_train_step`` (4 samples, 16 steps, eos 63, 12-token
   references, Adam 1e-3), each launching the edit-distance kernel once
   (R=12, H=16, N=64) with results equal to its plain version, losses
   finite; the first step again on the CPU with the card's samples: loss
   within rtol 1e-5, every gradient within 1e-4 of its tensor's largest
   entry (a float64 CPU step reported beside them); step ms, launches a
   step, and the kernel's own time at that shape beside its bound;
10. transducer greedy serving (bench_transducer_greedy): a seeded
   ConformerTransducer (d256/L4/H4/V1024, bf16 encoder, pred/joint 256,
   its joint's output layer x32 with the blank's bias +72, so that it
   emits about 13 tokens in 125 frames and ranks decisively) decodes three
   requests of 32 utterances of 500 raw frames with ``max_symbols_per_frame
   = 2``; every hypothesis equal to a CPU search of the card's encoder
   output; encoder, decode and request ms, utterances a second, launches
   a frame, host syncs and idle share;
11. transducer beam serving: the same requests at width 4, 4 rounds a
   frame, bare and fused with bench.py's 3-gram at weight 0.3, every
   hypothesis and length equal to a CPU search (scores within rtol 1e-5,
   atol 1e-4); the same timings;
12. transducer streaming (bench_streaming_rnnt_chunk): the causal config,
   8 streams, chunk 8, 4 warm and 12 timed pushes of 32 raw frames (the
   push median, launches and syncs); a float32 copy's greedy and width-4
   beam sessions finish equal to its one-shot decodes on the card;
13. transducer training: 5 steps of ``make_transducer_train_step`` (B=32,
   500 raw frames, 8-token references, dropout 0.1, AdamW), losses
   finite, after a float32 step at the seeded weights on the card and on
   the CPU (loss within rtol 1e-4, gradients within 1e-3 of each
   tensor's largest entry); ms a step, launches, syncs and idle share;
14. blank-skip serving (bench_ctc_blankskip): its logits (B=256, T=500,
   V=1024, ``RandomState(8)`` in bench.py's order) through
   ``compress_blank_frames(threshold=0.99, max_frames=128)`` and
   ``CTCPrefixSearch(16)`` on the default route (one prologue and one
   renormalizing beam-kernel launch, bit-equal to the card's scan), the
   compression bit-equal to the CPU's, hypotheses equal to a CPU search of
   the same compressed logits at all 256 rows; the same without the cut
   (the first 32 rows held), and the cut call on the raw route
   (``DECODE_RENORM`` off: one ``top_m`` and one ``ctc_beam_search``
   launch) equal to the card's raw-mass scan, both beam kernels bit-equal
   to their plain versions on those inputs; kept and cut frame shares,
   compress and decode ms,
   utterances a second, and the three kernels' times at these shapes;
15. the feature front end at (16, 1000, 80): ``mean_var_norm``,
   ``feat_deltas`` (true float32: within 1e-6 of a float64 evaluation,
   a bound that TF32 misses), pads, ``random_shift`` from given
   pads and ``chunk_by_slices`` over ``slice_spect_data``'s windows against
   the CPU, and ``sparse_image_warp`` on both routes against a float64
   solve; wall times;
16. sequence losses (BASELINE config #5's others) at the MER cell's
   shapes: ``optimal_completion``, the OCD loss and its gradient, the
   prefix error rates and edit distances, ``error_rate`` at costs (1, 1,
   2), and the two straight-through relaxations given the same uniforms,
   on the card against the CPU; wall times;
17. forced alignment of the first served request's logits (32, 500,
   1025): to its width-16 hypotheses (512 rows), every path collapsing
   back to its hypothesis with a finite score, paths equal to the port's
   alignment on the CPU and scores within rtol 1e-6; to the greedy
   transcripts, every path the per-frame argmax and every score the frame
   maxima's float32 sum within rtol 1e-6; align ms (CUDA events, median of
   7) and launches a frame;
18. REINFORCE (BASELINE config #5 at ``phase_s2s_train``'s width): a
   ``DirectEstimator`` over ``SequentialLanguageModelDistribution(
   RandomWalk(decoder LM), batch_shape=(16,), max_iters=16)`` of the
   negated error rate against 12-token references, 4 samples, and one
   backward pass; one edit-distance launch equal to its plain version,
   the value the mean of the sampled values, and the CPU given the card's
   samples within rtol 1e-5 (value) and 1e-4 of each gradient's largest
   entry; ms and launches;
19. REBAR over the same served logits: ``RelaxEstimator`` with the
   Gumbel REBAR control variate, 4 samples, of ``(b * w).sum((-2,
   -1))``: the estimate within 4 standard errors of its exact mean, and
   on the first 4 rows the value, logits gradient and
   ``relax_variance_loss``'s control-variate gradient equal to the CPU's
   on the same uniforms (rtol 1e-5, or 1e-4 of the largest entry); ms;
20. the training recipe (examples/train_ctc_asr.py's path) through the
   port's entry points at phase 5's model: a SpectDataSet of 128
   utterances (500-1000 frames, 10-60 tokens) written with ``save_tensor``
   and validated by ``get-torch-spect-data-dir-info``; 2 epochs of
   ``SpectDataLoader(batch_size=32, do_mvn=True)`` with SpecAugment (one
   ``spec_augment_apply`` launch a step), the epoch-2 mean below epoch 1's;
   ``TrainingStateController`` checkpoints, resumed into a fresh model and
   AdamW bit for bit; greedy hypotheses written with ``write_hyp`` and
   scored by ``compute-torch-token-data-dir-error-rates`` (one
   ``edit_distance`` launch a 32-utterance batch, equal to the command on
   the CPU; 1.0 for all-blank hypotheses), and references with seeded edits
   scored likewise; epoch s, steps a second, the loader's host share,
   checkpoint ms and bytes, and a traced epoch's idle share; then
   ``examples/train_ctc_asr_torch.py``'s ``main`` at its defaults on the
   card, twice in one directory: 2 epochs, then a call to 3 that resumes
   and trains the third alone (one ``spec_augment_apply`` launch a step,
   ``edit_distance`` launched by each call's scoring);
21. the mixture-of-experts step: phase 5's model with 4 experts, top-2,
   capacity 1.25, aux weight 0.01, 3 steps at B=32, T=1000; a float32
   2-layer copy's step held to the float64 witness (as phase 5's), its
   routing (top-1 experts and dropped counts equal, aux within rtol 1e-5)
   equal to the CPU's at seeded and trained weights; step ms, peak memory,
   the share of choices dropped at capacity;
22. remat: phase 5's dense step with ``remat=True`` against ``remat=False``
   from one generator state, cuDNN deterministic: loss and gradients
   bit-equal (or within the card's own spread), and a planted remat that
   does not set the generator back fails the comparison; both steps' ms
   and peak memory;
23. corpus preparation at phase 20's size and model, through the port's
   commands: a seeded ``ali/`` of runs of 1-30 frames to ``(R, 3)`` refs
   and back exactly; the refs through trn, ctm and TextGrids (10 ms) and
   back, as the formats' arithmetic gives; MVN statistics on the card
   within 1 float32 ulp of the CPU's; a subset chunked (ali policy, and a
   fixed window) with 0 and 2 workers into the CPU's files; both
   length-moment printers equal to the runs' moments; 4 tar shards whose
   ``SpectTarDataSet`` batches equal the directory loader's bit for bit,
   every batch read by the native reader; 2 training steps from them (one
   ``spec_augment_apply`` launch each) and the loader's host share of an
   epoch three ways; the model's logits aligned on the card equal to the
   CPU's, collapsing to the refs, scored at 0.0 with one ``edit_distance``
   launch a 32-utterance batch; big5 compiled to a state dict on the card
   equal to the CPU's; each command's wall seconds;
24. serving artifacts (``export.py``): the serve cell's model exported with
   ``torch.export`` at spec (32, 2000) as a greedy head and as width-16
   heads on the scan route (``USE_BEAM_KERNEL="0"``), with the default
   arguments and with ``DECODE_RENORM`` off (the kernels' registered
   operators recorded: the prologue's on the scan route, the prologue's
   and ``ctc_beam_search_renorm``'s by default, ``top_m``'s and
   ``ctc_beam_search``'s with renorm off), and the transducer cell's
   greedy and width-4 beam heads at (32, 500); all six served in turn by
   one fresh process that imports no model code (``ARTIFACT_SERVER``):
   three requests and a padded call (B=20, T=1500 for CTC), every output
   bit-equal to the live head on the card, ``decode_prologue`` launched
   once a request there on the scan route, it and
   ``ctc_beam_search_renorm`` once each by default, ``top_m`` and
   ``ctc_beam_search`` once each with renorm off;
   export seconds, graph nodes, bytes, load, first-call and request ms
   beside the live request's;
25. ``parallel/`` on a one-rank group (NCCL with gloo for the CPU side):
   ``shard_params`` with ``conformer_partition_rules`` on ``make_mesh(1)``
   (the forward from the gathered shards bit-equal), the pipelined forward
   and SGD step at pp=1, m=4 held to the plain ones by the training
   check's criterion (float32 copy, 2 layers, a float64 CPU witness), a
   sharded (data-parallel) export bit-equal to the live greedy head, and
   the model and AdamW state (0.8 GB) through an asynchronous sharded save
   overlapping a step, restored bit for bit; the multi-rank forms run
   under gloo on the CPU (``tests/test_torch_parallel.py``);
26. profiling (``utils/profiling.py``, ``utils/hlostats.py``):
   ``profile_program`` of a served request (its median beside CUDA
   events, ``measure_sync_overhead``) and the launches of a marked trip of
   its scan decode, held within 1 launch of what a frame adds between two
   short decodes; ``compiled_stats`` of the transducer greedy decode, its
   marked trips' launches a frame within 1 of ``rnnt_greedy``'s traced
   count; the decode prologue's wrapper beside its registered operator.

``python3 chip_smoke.py --train-witness N`` runs phase 1, then trains
phase 5's model N times from N seeds and reports the card-vs-CPU step
check at each one's trained weights, with the float64 witness, and the
card's float32 step again with cuDNN's deterministic algorithms and with
cuDNN off, without raising.

``python3 chip_smoke.py --profile`` runs phase 1, then traces one served
request, one decode alone, one beam-route request and decode, and one
training step with ``torch.profiler``:
wall time, device busy time and idle share, kernel launches, and the
kernels that take the most device time.

The last lines are the ``{"kernels": [...]}`` summary, the card's name and
power limit as ``nvidia-smi`` reports them, and
``{"ok": true, "device": {...}}``. Any failed check raises.
"""

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

SEED = 0
T_RAW, N_BATCH, N_REQUESTS, WIDTH = 2000, 32, 3, 16
HEADLINE = (500, 32, 1025)  # (T, N, V + 1) of the decode at this batch
M_HEADLINE = 2 * WIDTH
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
REPS = 7
INNER = 20  # calls queued between one pair of events


PHASE_ENDS = []  # (phase, perf_counter) at each phase line


def emit(obj):
    if isinstance(obj, dict) and "phase" in obj:
        PHASE_ENDS.append((obj["phase"], time.perf_counter()))
    print(json.dumps(obj), flush=True)


def phase_seconds(start):
    """Seconds from each phase line to the next (from ``start`` for the
    first), summed by phase name."""
    out, last = {}, start
    for name, t in PHASE_ENDS:
        out[name] = out.get(name, 0.0) + (t - last)
        last = t
    return out


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=REPS, inner=INNER, warmup=2):
    """Median milliseconds per call of ``fn()`` on the current stream:
    ``inner`` calls queued back to back between one pair of CUDA events, so
    the host's work for a call overlaps the device's work for the last."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_events(prof):
    """The kernels of a torch.profiler trace, summed by name: events with
    device time that are not user annotations (such as the optimizer's
    ``Optimizer.step#AdamW.step`` range, which spans kernels already
    counted). Each has ``key`` (the name), ``count`` and
    ``self_device_time_total`` (us), as ``key_averages()`` gives them; they
    are read from the trace's raw events, since building ``key_averages()``
    parses every host event too (tens of seconds for a decode of 100k
    launches)."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    sums = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        rec = sums.setdefault(e.name(), [0, 0.0])
        rec[0] += 1
        rec[1] += e.duration_ns() / 1e3
    return [
        SimpleNamespace(key=name, count=n, self_device_time_total=us)
        for name, (n, us) in sums.items() if us > 0
    ]


TRACES = {}  # kernel name -> traces its last device_ms reading took
TRACE_NOTES = {}  # kernel name -> where its last reading's short traces lost launches
TRACE_PAD_S = 0.05  # idle host time on either side of a retaken trace's calls


def launch_notes(prof, kernel):
    """Where a trace's records of ``kernel`` lie: the host's launch records
    (the runtime's ``*LaunchKernel`` calls) in launch order, which of them
    have no device record, and for those that have one, how far (us) the
    kernel's start lies after its launch's start and after the trace's
    start, and how far its end lies after the host's last record ends
    (the ``synchronize`` that closes the calls). A kernel that the device
    ran but whose record lies outside the trace's window is dropped by
    the profiler; these offsets show whether that is where the missing
    ones went."""
    from torch.autograd import DeviceType

    res = prof.profiler.kineto_results
    events = res.events()
    launches = sorted(
        (e for e in events if e.device_type() != DeviceType.CUDA and "LaunchKernel" in e.name()),
        key=lambda e: e.start_ns(),
    )
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA]
    by_corr = {e.correlation_id(): e for e in kernels}  # CUPTI's id, a launch's too
    host_end = max(e.end_ns() for e in events if e.device_type() != DeviceType.CUDA)
    start = res.trace_start_ns()
    missing, after_launch = [], []
    for i, e in enumerate(launches):
        k = by_corr.get(e.correlation_id())
        if k is None:
            missing.append(i)
        elif kernel in k.name():
            after_launch.append((k.start_ns() - e.start_ns()) / 1e3)
    own = [k for k in kernels if kernel in k.name()]
    return {
        "host_launches": len(launches), "device_kernels": len(kernels),
        "launches_without_kernel": missing,
        "kernel_start_after_launch_us": [min(after_launch, default=None),
                                         max(after_launch, default=None)],
        "kernel_start_after_trace_start_us": [
            min(((k.start_ns() - start) / 1e3 for k in own), default=None),
            max(((k.start_ns() - start) / 1e3 for k in own), default=None)],
        "kernel_end_after_host_end_us": max(((k.end_ns() - host_end) / 1e3 for k in own),
                                            default=None),
        "first_launch_after_trace_start_us": (
            (launches[0].start_ns() - start) / 1e3 if launches else None),
    }


def device_ms(fn, kernel=None, calls=INNER, count=None):
    """Device milliseconds per call of ``fn()`` from torch.profiler's CUDA
    trace of ``calls`` calls: the kernels whose name holds ``kernel``, which
    each call must launch once, or every kernel when ``kernel`` is None.
    The traced calls follow a warm-up cycle of as many calls under the
    profiler whose events are dropped. A trace that holds fewer of the
    kernel's launches than ``calls`` is noted (``launch_notes``, kept in
    ``TRACE_NOTES[kernel]``) and taken again, up to five times, with
    ``TRACE_PAD_S`` of idle host time before the first call and after the
    synchronize, so that a device record whose timestamp strays out of the
    calls' window still falls inside the trace's; the traces taken are
    kept in ``TRACES[kernel]`` for the kernels line. ``count`` gives the
    wrapper's launch counter (its ``LAUNCHES`` entry): the traced calls
    must add ``calls`` to it, or this raises. None when all five traces
    missed the kernel, or held only some of its launches while the counter
    shows that every call launched it; a trace holding more launches than
    calls, or some without a counter to vouch for the rest, raises."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(1, 6):
        TRACES[kernel] = attempt
        pad = TRACE_PAD_S if attempt > 1 else 0.0
        traced, notes = [], {}
        if attempt == 1:
            TRACE_NOTES.pop(kernel, None)

        def ready(p):
            traced.extend(device_events(p))
            if kernel is not None:
                notes.update(launch_notes(p, kernel))

        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1),
            on_trace_ready=ready,
        ) as prof:
            for cycle in range(2):
                before = count() if count else None
                time.sleep(pad * cycle)
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                time.sleep(pad * cycle)
                counted = count() - before if count else None
                prof.step()
        if count and counted != calls:
            raise AssertionError(f"{calls} calls counted {counted} launches of {kernel}")
        hits = [a for a in traced if kernel is None or kernel in a.key]
        launched = sum(a.count for a in hits)
        if hits and (kernel is None or launched == calls):
            return sum(a.self_device_time_total for a in hits) / 1e3 / calls
        if not hits and kernel is None:
            return None
        if launched > calls:
            raise AssertionError(f"{calls} calls launched {kernel} {launched} times")
        TRACE_NOTES.setdefault(kernel, []).append(
            dict(notes, trace=attempt, pad_s=pad, held=launched, calls=calls))
    if launched == 0 or count:
        return None
    raise AssertionError(f"{calls} calls launched {kernel} {launched} times")


def worst_rel(triples):
    """Over ``(key, got, expected)`` triples, the largest ``max |got -
    expected|`` over ``max |expected|`` (a tensor whose expected entries
    are all zero is skipped) and the key where it falls: how the card's
    gradients are held against the CPU's, each within a share of its own
    largest entry."""
    worst, at = 0.0, None
    for k, a, b in triples:
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        scale = float(b.abs().max())
        if scale > 0 and float((a - b).abs().max()) / scale > worst:
            worst, at = float((a - b).abs().max()) / scale, k
    return worst, at


def cold(fn):
    """``fn`` after overwriting 64 MB, more than the card's 50 MB L2 cache,
    so that ``fn`` reads its inputs from device memory as a step that has
    just made them elsewhere would. With ``device_ms`` and a kernel name
    the overwrite's own kernel is not counted."""
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def run():
        scratch.zero_()
        return fn()

    return run


def host_ms(fns, reps=REPS, warmup=1):
    """Wall milliseconds of each of ``fns``, every call ending in a device
    synchronize. Each rep runs all of them in turn, so they see the same
    host load. Returns the medians and the runs."""
    for _ in range(warmup):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    runs = [[] for _ in fns]
    for _ in range(reps):
        for fn, times in zip(fns, runs):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return [statistics.median(t) for t in runs], runs


def same_or_both_nan(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def max_abs_err(pairs):
    err = 0.0
    for a, b in pairs:
        d = (a.float() - b.float()).abs()
        d = d[torch.isfinite(d)]
        if d.numel():
            err = max(err, float(d.max()))
    return err


def make_logits(shape, gen, kind, dtype):
    x = torch.randn(shape, generator=gen, device="cuda") * 3
    if kind == "ties":
        x = torch.round(x * 4) / 4
    elif kind == "signed_zeros":  # -0.0 and +0.0 mixed, a few logits among them
        u = torch.rand(shape, generator=gen, device="cuda")
        x = torch.where(u < 0.45, -0.0, torch.where(u < 0.95, 0.0, x))
    elif kind == "all_tie":  # every key of a row ties
        x = torch.full(shape, 0.75, device="cuda")
    elif kind == "inf":
        u = torch.rand(shape, generator=gen, device="cuda")
        x = torch.where(u < 0.02, float("inf"), x)
        x = torch.where(u > 0.95, float("-inf"), x)
    return x.to(dtype).contiguous()


def check_prologue(kernels, x, m, bias):
    got = kernels.decode_prologue(x, m, bias)
    exp = kernels.decode_prologue_reference(x, m, bias)
    vals_ok = torch.equal(got[0].view(torch.int32), exp[0].view(torch.int32))
    idx_ok = torch.equal(got[1], exp[1])
    mx_ok = same_or_both_nan(got[2], exp[2])
    blank_ok = same_or_both_nan(got[4], exp[4])
    den_err = ((got[3] - exp[3]).abs() / exp[3].abs())
    den_ok = bool(
        ((den_err <= 2e-6) | (torch.isnan(got[3]) & torch.isnan(exp[3]))
         | (got[3] == exp[3])).all()
    )
    gv, gi = kernels.top_m(x, m)
    ev, ei = kernels.top_m_reference(x, m)
    tm_ok = torch.equal(gv.view(torch.int32), ev.view(torch.int32)) and torch.equal(gi, ei)
    return {
        "prologue_ok": vals_ok and idx_ok and mx_ok and blank_ok and den_ok,
        "top_m_ok": tm_ok,
        "prologue_err": max_abs_err(zip(got, exp)),
        "top_m_err": max_abs_err([(gv, ev)]),
    }


def phase_kernels(kernels, lm_bias, lm_m):
    """The prologue and the top-M against their plain versions. ``lm_bias``
    is the bench LM's ``0.5 * uni`` and ``lm_m`` its sparse route's M: the
    ``lm_bias`` cases take them at the headline shape, the others a random
    bias where they take one."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for with_bias in (False, True):
            cases.append(("headline", HEADLINE, M_HEADLINE, dtype, with_bias, "normal"))
        cases.append(("lm_bias", HEADLINE, lm_m, dtype, "lm", "normal"))
    cases += [
        ("serving_b256", (500, 256, 1025), M_HEADLINE, torch.float32, False, "normal"),
        ("v1000", (500, 32, 1001), M_HEADLINE, torch.float32, True, "normal"),
        ("m1", HEADLINE, 1, torch.float32, False, "normal"),
        ("m_eq_v", (64, 8, 65), 64, torch.bfloat16, True, "normal"),
        ("ties", HEADLINE, M_HEADLINE, torch.float32, True, "ties"),
        ("ties_bf16", HEADLINE, M_HEADLINE, torch.bfloat16, False, "ties"),
        ("inf", HEADLINE, M_HEADLINE, torch.float32, False, "inf"),
        ("signed_zeros", HEADLINE, M_HEADLINE, torch.float32, False, "signed_zeros"),
        ("all_tie", HEADLINE, M_HEADLINE, torch.float32, False, "all_tie"),
        ("m64_v1024", (500, 32, 1024), 64, torch.float32, False, "normal"),
    ]
    worst = {"decode_prologue": 0.0, "top_m": 0.0}
    for name, shape, m, dtype, with_bias, kind in cases:
        x = make_logits(shape, gen, kind, dtype)
        if with_bias == "lm":
            bias = lm_bias
        elif with_bias:
            bias = torch.randn(shape[-1] - 1, generator=gen, device="cuda")
        else:
            bias = None
        res = check_prologue(kernels, x, m, bias)
        torch.cuda.synchronize()
        emit({
            "phase": "kernels", "case": name, "shape": list(shape), "m": m,
            "dtype": str(dtype).replace("torch.", ""),
            "bias": "0.5 * uni of the bench LM" if with_bias == "lm" else with_bias, **res,
        })
        if not (res["prologue_ok"] and res["top_m_ok"]):
            raise AssertionError(f"kernel parity failed for case {name}: {res}")
        worst["decode_prologue"] = max(worst["decode_prologue"], res["prologue_err"])
        worst["top_m"] = max(worst["top_m"], res["top_m_err"])
    return worst


def phase_main_path(torch_pkg):
    config, ConformerConfig, ConformerCTC, ctc_recognizer, CTCPrefixSearch, kernels = torch_pkg
    cfg, model = make_model(ConformerConfig, ConformerCTC)
    recognize = ctc_recognizer(model, width=WIDTH)
    requests = make_requests(cfg)

    captured = []
    hook = model.register_forward_hook(lambda mod, inp, out: captured.append(out))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    outputs = [recognize(f, l) for f, l in requests]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    hook.remove()
    want = {"decode_prologue": N_REQUESTS, "ctc_beam_search_renorm": N_REQUESTS,
            "top_m": 0, "ctc_beam_search": 0,
            "depthwise_conv1d": N_REQUESTS * cfg.num_layers}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"serve launches {launches}, expected {want}")

    check_served(outputs, captured, cfg)
    # the renormalizing kernel is the card's own scan, bit for bit
    saved = config.USE_BEAM_KERNEL
    config.USE_BEAM_KERNEL = "0"
    try:
        vs_scan = [
            same_search((hyps.permute(2, 0, 1), hlens, probs),
                        CTCPrefixSearch(WIDTH)(logits.transpose(0, 1).contiguous(), out_lens))
            for (hyps, hlens, probs), (logits, out_lens) in zip(outputs, captured)
        ]
    finally:
        config.USE_BEAM_KERNEL = saved
    if not all(c["ok"] for c in vs_scan):
        raise AssertionError(f"served requests vs the card's scan: {vs_scan}")

    # the card's hypotheses against a CPU decode of the same logits
    (hyps, hlens, probs), (logits, out_lens) = outputs[0], captured[0]
    k = 4
    cy, cl, cp = CTCPrefixSearch(WIDTH)(
        logits[:k].transpose(0, 1).contiguous().cpu(), out_lens[:k].cpu()
    )
    gh, gl, gp = hyps[:k].cpu(), hlens[:k].cpu(), probs[:k].cpu()
    if not torch.equal(cl, gl):
        raise AssertionError("y_lens differ between the card and the CPU")
    for n in range(k):
        for w in range(WIDTH):
            L = int(cl[n, w])
            if not torch.equal(cy[:L, n, w], gh[n, w, :L]):
                raise AssertionError(f"hypothesis ({n}, {w}) differs from the CPU's")
    live = cp > 0
    prob_err = float(((cp - gp).abs()[live] / cp[live]).max()) if live.any() else 0.0
    if not torch.allclose(gp, cp, rtol=1e-5, atol=0):
        raise AssertionError(f"y_probs differ from the CPU's (rel err {prob_err})")

    # the model on the card against itself on the CPU, float32, small input
    cfg32 = ConformerConfig(
        vocab_size=1024, num_filts=80, d_model=512, num_layers=8, num_heads=8,
        dtype=torch.float32,
    )
    m_gpu = ConformerCTC(cfg32, device="cuda")
    m_gpu.load_state_dict(model.state_dict())
    m_cpu = ConformerCTC(cfg32, device="cpu")
    m_cpu.load_state_dict(model.state_dict())
    f_small, l_small = requests[0][0][:2, :400], torch.tensor([400, 271])
    with torch.no_grad():
        lg_gpu = m_gpu(f_small, l_small)[0].cpu()
        lg_cpu = m_cpu(f_small.cpu(), l_small)[0]
    model_err = float((lg_gpu - lg_cpu).abs().max())
    if not model_err < 1e-2:
        raise AssertionError(f"f32 model on the card vs the CPU: max abs err {model_err}")

    emit({
        "phase": "main_path", "model": "ConformerCTC d512 L8 H8 V1024 bf16",
        "requests": N_REQUESTS, "batch": N_BATCH, "t_raw": T_RAW, "width": WIDTH,
        "launches": launches, "serve_s_first_pass": serve_s,
        "vs_card_scan_bits": all(c["ok"] for c in vs_scan),
        "cpu_check_utts": k, "y_probs_max_rel_err": prob_err,
        "model_f32_card_vs_cpu_max_abs_err": model_err,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    })
    return model, recognize, requests, launches, captured[0], outputs[0]


def make_model(ConformerConfig, ConformerCTC):
    """The flagship ConformerCTC at full width, seeded."""
    cfg = ConformerConfig(
        vocab_size=1024, num_filts=80, d_model=512, num_layers=8, num_heads=8
    )
    model = ConformerCTC(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        # random weights give diffuse logits whose path masses crowd
        # together; a sharper head makes decisions like a trained model's
        model.ctc_head.weight.mul_(32.0)
    return cfg, model


def make_requests(cfg):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    requests = []
    for _ in range(N_REQUESTS):
        feats = torch.randn((N_BATCH, T_RAW, cfg.num_filts), generator=gen, device="cuda")
        lens = torch.randint(T_RAW // 2, T_RAW + 1, (N_BATCH,), generator=gen, device="cuda")
        requests.append((feats, lens))
    return requests


def trace(fn, warmup=True):
    """Wall ms, device-busy ms, kernel launches and the top kernels of one
    ``fn()`` under torch.profiler (after one untraced call, with
    ``warmup``)."""
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = device_events(prof)
    busy_ms = sum(a.self_device_time_total for a in kern) / 1e3
    kern.sort(key=lambda a: -a.self_device_time_total)
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches": sum(a.count for a in kern),
        "top_kernels": [
            [a.key[:80], a.self_device_time_total / 1e3, a.count] for a in kern[:8]
        ],
    }


def phase_profile(config, ConformerConfig, ConformerCTC, ctc_recognizer, CTCPrefixSearch):
    cfg, model = make_model(ConformerConfig, ConformerCTC)
    recognize = ctc_recognizer(model, width=WIDTH)
    feats, lens = make_requests(cfg)[0]
    encode = torch.no_grad()(model)
    logits, out_lens = encode(feats, lens)
    x = logits.transpose(0, 1).contiguous()
    search = CTCPrefixSearch(WIDTH)
    served = trace(lambda: recognize(feats, lens))
    decode = trace(lambda: search(x, out_lens))
    decode["launches_per_frame"] = decode["kernel_launches"] / x.shape[0]
    encoder = trace(lambda: encode(feats, lens))
    saved = config.USE_BEAM_KERNEL, config.DECODE_RENORM
    try:
        config.USE_BEAM_KERNEL = "0"
        scan_decode = trace(lambda: search(x, out_lens))
        scan_decode["launches_per_frame"] = scan_decode["kernel_launches"] / x.shape[0]
        config.USE_BEAM_KERNEL, config.DECODE_RENORM = "auto", False
        beam_request = trace(lambda: recognize(feats, lens))
        beam_decode = trace(lambda: search(x, out_lens))
    finally:
        config.USE_BEAM_KERNEL, config.DECODE_RENORM = saved
    emit({
        "phase": "profile", "request": served, "encoder": encoder, "decode": decode,
        "scan_decode": scan_decode, "raw_beam_request": beam_request,
        "raw_beam_decode": beam_decode,
    })


def prologue_bound_ms(T, N, Vp1, m, itemsize, bias_bytes=0):
    """The logits (and the bias, once) in, top-M values and indices and
    three stats out; six operations a lane, one more with a bias."""
    rows = T * N
    bytes_ = rows * Vp1 * itemsize + bias_bytes + rows * (2 * m * 4 + 3 * 4)
    # max, subtract, exp, add, key, compare per lane; the bias's add
    ops = rows * Vp1 * 6 + (rows * (Vp1 - 1) if bias_bytes else 0)
    return max(bytes_ / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3, (
        "bytes" if bytes_ / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
    )


def topm_bound_ms(rows, V, m, itemsize):
    bytes_ = rows * V * itemsize + rows * 2 * m * 4
    ops = rows * V * 2  # key, compare per lane
    t_b, t_o = bytes_ / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def phase_times(kernels, model, recognize, requests, CTCPrefixSearch, logits):
    T, N, Vp1 = HEADLINE
    V, m = Vp1 - 1, M_HEADLINE
    x = logits.transpose(0, 1).contiguous()  # the main path's (T, N, V + 1)
    assert tuple(x.shape) == HEADLINE
    xv = beam_inputs(x)[0]  # what the beam route hands hoisted_top_k
    fns = {
        "decode_prologue": (
            lambda: kernels.decode_prologue(x, m),
            lambda: kernels.decode_prologue_reference(x, m),
            lambda: torch.topk(x[..., :V], m),
        ),
        "top_m": (
            lambda: kernels.top_m(xv, m),
            lambda: kernels.top_m_reference(xv, m),
            lambda: torch.topk(xv, m),
        ),
    }
    bounds = {
        "decode_prologue": prologue_bound_ms(T, N, Vp1, m, 4),
        "top_m": topm_bound_ms(T * N, V, m, 4),
    }
    times, line = {}, {"phase": "times", "shape": list(HEADLINE), "m": m}
    for name, (kernel, plain, library) in fns.items():
        wrapper = cuda_ms(kernel)
        own = device_ms(kernel, "prologue_kernel", count=lambda: kernels.LAUNCHES[name])
        times[name] = {
            # the kernel's own device time; the events' time where the
            # profiler saw none
            "ms": wrapper if own is None else own,
            "ms_from": "cuda_events" if own is None else "profiler",
            "traces": TRACES["prologue_kernel"],
            "trace_notes": TRACE_NOTES.get("prologue_kernel"),
            "wrapper_ms": wrapper,
            "plain_ms": cuda_ms(plain),
            "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1],
            "library_ms": cuda_ms(library),
        }
        line[name] = dict(
            times[name],
            plain_device_ms=device_ms(plain),
            library_device_ms=device_ms(library),
        )

    feats, lens = requests[0]
    search = CTCPrefixSearch(WIDTH)
    out_lens = (((lens + 1) // 2) + 1) // 2
    times["ctc_beam_search_renorm"] = renorm_kernel_times(kernels, x, out_lens)
    line["ctc_beam_search_renorm"] = times["ctc_beam_search_renorm"]
    encode = torch.no_grad()(model)
    (enc_ms, dec_ms, req_ms), runs = host_ms([
        lambda: encode(feats, lens),
        lambda: search(x, out_lens),
        lambda: recognize(feats, lens),
    ])
    emit(dict(
        line,
        encoder_ms_per_batch=enc_ms, decode_ms_per_batch=dec_ms,
        request_ms=req_ms, utt_per_s=N_BATCH / (req_ms / 1e3),
        encoder_share_of_request=enc_ms / req_ms,
        decode_share_of_request=dec_ms / req_ms,
        request_minus_parts_ms=req_ms - enc_ms - dec_ms,
        runs_ms={"encoder": runs[0], "decode": runs[1], "request": runs[2]},
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
    ))
    return times


# ---------------------------------------------------------------------------
# The whole-loop beam search (DECODE_RENORM off): its kernel, the beam
# route through ctc_recognizer, and streaming CTC serving through it.

TINY = 1.1754943508222875e-38  # smallest normal float32
BEAM_CASES = (  # name, (T, N, V), width, logit scale, logits on quarter steps
    ("headline_diffuse", (500, 32, 1024), WIDTH, 2.0, False),
    ("headline_decisive", (500, 32, 1024), WIDTH, 32.0, False),
    ("w2", (500, 32, 1024), 2, 32.0, False),
    ("w32", (500, 32, 1024), 32, 32.0, False),
    ("t2", (2, 32, 1024), WIDTH, 2.0, False),
    ("headline_ties", (500, 32, 1024), WIDTH, 3.0, True),
    ("w8", (500, 32, 1024), 8, 32.0, False),
)
# the causal flagship (the context of bench.py:720): R = 8 * (16 + 15 - 1)
STREAM_CONTEXT, STREAM_CHUNK, STREAM_PUSH, STREAM_PARTIALS_EVERY = (16, 0), 8, 32, 16


def beam_inputs(x):
    """``(nonext (T, N, V), blank (T, N))`` probabilities from time-major
    logits ``(T, N, V + 1)``, as ``CTCPrefixSearch``'s beam route makes
    them."""
    V = x.shape[-1] - 1
    lg32 = x.float()
    mx = lg32.amax(2)
    den = torch.exp(lg32 - mx[..., None]).sum(2)
    blank = torch.exp(lg32[..., V] - mx) / den
    return torch.exp(lg32[..., :V] - mx[..., None]) / den[..., None], blank


def search_compare(got, exp, rtol):
    """``(y (T, N, W), y_lens, y_probs)`` triples: lengths, finiteness and
    tokens up to each length exact, finite probabilities within ``rtol``
    (tests/test_pallas.py's _beam_outputs_equal rule, atol 1e-12)."""
    (gy, gl, gp), (ey, el, ep) = got, exp
    S = min(gy.shape[0], ey.shape[0])
    mask = torch.arange(S, device=ey.device)[:, None, None] < el[None]
    fin = torch.isfinite(ep)
    rel = ((gp - ep).abs() / ep.abs())[fin & (ep != 0)]
    res = {
        "lens_exact": torch.equal(gl, el),
        "tokens_exact_to_lens": bool(gl.max() <= S) and torch.equal(
            torch.where(mask, gy[:S], -1), torch.where(mask, ey[:S], -1)
        ),
        "probs_max_rel_err": float(rel.max()) if rel.numel() else 0.0,
    }
    res["ok"] = (
        res["lens_exact"] and res["tokens_exact_to_lens"]
        and torch.equal(fin, torch.isfinite(gp))
        and bool(torch.isclose(gp[fin], ep[fin], rtol=rtol, atol=1e-12).all())
    )
    return res


def same_search(got, exp):
    """:func:`search_compare` with every probability's bits equal."""
    res = search_compare(got, exp, rtol=0.0)
    res["probs_bit_exact"] = same_bits(got[2], exp[2])
    res["ok"] = res["ok"] and res["probs_bit_exact"]
    return res


def renorm_inputs(kernels, x, W):
    """What the default route hands ``ctc_beam_search_renorm`` for
    time-major logits ``x (T, N, V + 1)``: the decode prologue's top-``2W``
    values ``exp(top - max) / den`` and indices, the max, the denominator
    and the blank's probability."""
    tl, ti, mx, den, bl = kernels.decode_prologue(x, min(x.shape[-1] - 1, 2 * W))
    return torch.exp(tl - mx[..., None]) / den[..., None], ti, mx, den, torch.exp(bl - mx) / den


def renorm_bound_ms(lens, T, N, W, M, itemsize):
    """:func:`beam_bound_ms` for the renormalizing kernel: for each frame a
    row runs, the tv/ti rows, the blank, the max and the denominator and W
    gathered logits in, and per beam a rescale (4 operations) and a
    probability (3) besides the ranking; the paths, lengths, masses and
    each row's exponent out once."""
    frames = int(lens.clamp(0, T).sum())
    bytes_ = (frames * (8 * M + itemsize * W + 12) + 4 * N + 8 * T * N * W + 12 * N * W
              + 4 * N)
    ops = frames * (3 * W * (M + 2) + 2 * W * W + 7 * W)
    t_b, t_o = bytes_ / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def renorm_kernel_times(kernels, x, lens, plain_reps=3):
    """The renormalizing kernel on time-major logits ``x`` and ``lens``: its
    device time, its wrapper's, its plain version's (the scan), its bound,
    microseconds a frame of the longest row, and its outputs against the
    plain version's (bit-exact)."""
    T, N, Vp1 = x.shape
    W = WIDTH
    M = min(Vp1 - 1, 2 * W)
    args = (x, *renorm_inputs(kernels, x, W), lens)

    def kernel():
        return kernels.ctc_beam_search_renorm(*args, W)

    def plain():
        return kernels.ctc_beam_search_renorm_reference(*args, W)

    got, exp = kernel(), plain()
    vs_plain = same_search(got[:3], exp[:3])
    vs_plain["ls_exact"] = torch.equal(got[3], exp[3])
    if not (vs_plain["ok"] and vs_plain["ls_exact"]):
        raise AssertionError(f"ctc_beam_search_renorm vs its plain version: {vs_plain}")
    wrapper = cuda_ms(kernel)
    own = device_ms(kernel, "ctc_beam_kernel",
                    count=lambda: kernels.LAUNCHES["ctc_beam_search_renorm"])
    ms = wrapper if own is None else own
    frames = int(lens.clamp(max=T).max())
    bound = renorm_bound_ms(lens, T, N, W, M, x.element_size())
    return {
        "ms": ms, "ms_from": "cuda_events" if own is None else "profiler",
        "traces": TRACES["ctc_beam_kernel"],
        "trace_notes": TRACE_NOTES.get("ctc_beam_kernel"),
        "wrapper_ms": wrapper,
        "plain_ms": cuda_ms(plain, reps=plain_reps, inner=1, warmup=1),
        "bound_ms": bound[0], "bound_by": bound[1],
        "library_ms": None, "library": "none: no PyTorch call runs a CTC beam search",
        "shape": [T, N, Vp1 - 1, W], "dtype": str(x.dtype).split(".")[-1],
        "frames_longest_row": frames, "frames_all_rows": int(lens.clamp(max=T).sum()),
        "us_per_frame": ms * 1e3 / frames, "vs_plain": vs_plain,
    }


# the offline cell's search (portbench ctc_l.prefix16): B=256 of LibriSpeech
# test-clean lengths (a log-normal of mean 7.42 s, log-sd 0.63, in [1, 35]
# s) padded to 35 s, 875 encoder frames a 35 s row
CELL = dict(T=875, N=256, V=1024, mean_s=7.42, log_sd=0.63, seed=19)
RENORM_CASES = (  # name, (T, N, V), width, logit scale, quarter steps, dtype
    ("headline_diffuse", (500, 32, 1024), WIDTH, 0.5, False, torch.bfloat16),
    ("headline_decisive", (500, 32, 1024), WIDTH, 8.0, False, torch.bfloat16),
    ("headline_ties", (500, 32, 1024), WIDTH, 3.0, True, torch.bfloat16),
    ("headline_f32", (500, 32, 1024), WIDTH, 2.0, False, torch.float32),
    ("w2", (500, 32, 1024), 2, 8.0, False, torch.bfloat16),
    ("w32", (500, 32, 1024), 32, 8.0, False, torch.bfloat16),
    ("t2", (2, 32, 1024), WIDTH, 2.0, False, torch.bfloat16),
)


def cell_lengths(cfg, gen):
    """Encoder frames of the cell's utterances: seconds from the
    log-normal, 100 raw frames a second, subsampled by 4."""
    mu = math.log(cfg["mean_s"]) - cfg["log_sd"] ** 2 / 2
    sec = torch.exp(mu + cfg["log_sd"] * torch.randn((cfg["N"],), generator=gen)).clamp(1, 35)
    return torch.ceil(sec * 100 / 4).long().clamp(max=cfg["T"])


def phase_renorm_kernel(kernels, CTCPrefixSearch, config, cell=CELL):
    """The renormalizing beam kernel against its plain version, the scan,
    on the card (``RENORM_CASES``: diffuse logits whose raw masses would
    underflow, decisive ones, bf16 ties, float32, W=2 and 32, T=2; ragged
    lengths with 0, 1 and T), lengths, tokens up to them, every
    probability's bits and each row's exponent exact; the default search's
    launches; then its times at the offline cell's shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    worst = 0.0
    for name, (T, N, V), W, scale, ties, dtype in RENORM_CASES:
        x = torch.randn((T, N, V + 1), generator=gen, device="cuda") * scale
        if ties:
            x = torch.round(x * 4) / 4
        x = x.to(dtype)
        lens = torch.randint(T // 2, T + 1, (N,), generator=gen, device="cuda")
        lens[0], lens[1], lens[2] = T, 0, 1
        args = (x, *renorm_inputs(kernels, x, W), lens)
        got = kernels.ctc_beam_search_renorm(*args, W)
        exp = kernels.ctc_beam_search_renorm_reference(*args, W)
        torch.cuda.synchronize()
        res = same_search(got[:3], exp[:3])
        res.update(ls_exact=torch.equal(got[3], exp[3]), ls_min=int(exp[3].min()))
        kernels.reset_launches()
        served = CTCPrefixSearch(W)(x, lens)
        res["search_launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        saved = config.USE_BEAM_KERNEL
        config.USE_BEAM_KERNEL = "0"
        try:
            res["search_vs_scan"] = same_search(served, CTCPrefixSearch(W)(x, lens))["ok"]
        finally:
            config.USE_BEAM_KERNEL = saved
        emit({"phase": "kernels", "kernel": "ctc_beam_search_renorm", "case": name,
              "shape": [T, N, V, W], "scale": scale, "ties": ties,
              "dtype": str(dtype).split(".")[-1], **res})
        want = {"decode_prologue": 1, "ctc_beam_search_renorm": 1}
        if not (res["ok"] and res["ls_exact"] and res["search_vs_scan"]
                and res["search_launches"] == want):
            raise AssertionError(f"ctc_beam_search_renorm parity failed for case {name}: {res}")
        worst = max(worst, max_abs_err(zip(got, exp)))
    cpu_gen = torch.Generator().manual_seed(cell["seed"])
    lens = cell_lengths(cell, cpu_gen).cuda()
    x = (torch.randn((cell["T"], cell["N"], cell["V"] + 1), generator=cpu_gen) * 8.0).to(
        "cuda", torch.bfloat16)
    times = renorm_kernel_times(kernels, x, lens, plain_reps=2)
    emit({"phase": "renorm_kernel_cell", "nvidia_smi": smi_line(), "cell": dict(cell),
          "lens": {"min": int(lens.min()), "median": float(lens.float().median()),
                   "max": int(lens.max())}, **times})
    return worst, times


def phase_beam_kernel(kernels):
    """The beam kernel against its plain version on the card, at the
    headline shape with diffuse (masses subnormal within some 55 frames,
    then zero), decisive and tie-heavy (x3 on quarter steps) logits, at
    widths 2, 8 and 32, and at T=2; ragged lengths with 0 and 1. Lengths,
    the whole path buffer and every probability's bits must be equal."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    worst = 0.0
    for name, (T, N, V), W, scale, ties in BEAM_CASES:
        x = torch.randn((T, N, V + 1), generator=gen, device="cuda") * scale
        if ties:
            x = torch.round(x * 4) / 4
        nonext, blank = beam_inputs(x)
        lens = torch.randint(T // 2, T + 1, (N,), generator=gen, device="cuda")
        lens[0], lens[1], lens[2] = T, 0, 1
        top = kernels.top_m(nonext, min(V, 2 * W))
        got = kernels.ctc_beam_search(nonext, blank, lens, W, top)
        exp = kernels.ctc_beam_search_reference(nonext, blank, lens, W, top)
        torch.cuda.synchronize()
        res = search_compare(got, exp, rtol=1e-6)
        res.update(
            buffer_exact=torch.equal(got[0], exp[0]), probs_bit_exact=same_bits(got[2], exp[2]),
            zero_probs=int((exp[2] == 0).sum()),
            subnormal_probs=int(((exp[2] > 0) & (exp[2] < TINY)).sum()),
        )
        emit({"phase": "kernels", "kernel": "ctc_beam_search", "case": name,
              "shape": [T, N, V, W], "scale": scale, "ties": ties, **res})
        if not (res["ok"] and res["buffer_exact"] and res["probs_bit_exact"]):
            raise AssertionError(f"ctc_beam_search parity failed for case {name}: {res}")
        worst = max(worst, max_abs_err(zip(got, exp)))
    return worst


def beam_bound_ms(lens, T, N, W, M):
    """What these inputs need: for each frame a row runs (its length, at
    most T), the tv/ti rows, the blank and W gathered probabilities in;
    the paths (int64), lengths (int64) and masses out once; per frame about
    3 operations for each of the W * (M + 2) candidates (score, compare,
    select) and 2 for each of the W * W prefix-matrix entries."""
    frames = int(lens.clamp(0, T).sum())
    bytes_ = frames * (8 * M + 4 * W + 4) + 4 * N + 8 * T * N * W + 12 * N * W
    ops = frames * (3 * W * (M + 2) + 2 * W * W)
    t_b, t_o = bytes_ / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def check_served(outputs, captured, cfg):
    S = -(-(-(-T_RAW // 2)) // 2)
    for (hyps, hlens, probs), (logits, out_lens) in zip(outputs, captured):
        assert hyps.shape == (N_BATCH, WIDTH, S) and hlens.shape == (N_BATCH, WIDTH)
        assert logits.shape == (N_BATCH, S, cfg.vocab_size + 1)
        assert bool(torch.isfinite(logits).all()), "non-finite logits"
        assert bool(((hyps >= 0) & (hyps < cfg.vocab_size)).all())
        assert bool((hlens <= out_lens[:, None]).all())
        assert bool(((probs >= 0) & (probs <= 1)).all()), "probabilities out of [0, 1]"
        assert bool((probs[:, :-1] >= probs[:, 1:]).all()), "beams out of order"


def phase_beam_serve(pkg, kernels, model, requests):
    """The three requests of the serve phase through the raw beam route
    (DECODE_RENORM off): one ``top_m`` and one ``ctc_beam_search`` launch
    each, hypotheses equal to the card's own scan with DECODE_RENORM off
    (the raw masses the kernel carries) by the JAX package's rule; then
    wall times of the encoder, the decode and the request in turn, and the
    kernel's times."""
    config, ctc_recognizer, CTCPrefixSearch = pkg
    saved = config.USE_BEAM_KERNEL, config.DECODE_RENORM
    config.DECODE_RENORM = False
    try:
        recognize = ctc_recognizer(model, width=WIDTH)
        captured = []
        hook = model.register_forward_hook(lambda mod, inp, out: captured.append(out))
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        outputs = [recognize(f, l) for f, l in requests]
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        hook.remove()
        want = {"decode_prologue": 0, "top_m": N_REQUESTS, "ctc_beam_search": N_REQUESTS,
                "ctc_beam_search_renorm": 0,
                "depthwise_conv1d": N_REQUESTS * model.cfg.num_layers}
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"beam route launches {launches}, expected {want}")
        check_served(outputs, captured, model.cfg)

        config.USE_BEAM_KERNEL, config.DECODE_RENORM = "0", False
        scan = CTCPrefixSearch(WIDTH)
        checks = []
        for (hyps, hlens, probs), (logits, out_lens) in zip(outputs, captured):
            exp = scan(logits.transpose(0, 1).contiguous(), out_lens)
            checks.append(search_compare((hyps.permute(2, 0, 1), hlens, probs), exp, 1e-4))
        if not all(c["ok"] for c in checks):
            raise AssertionError(f"beam route vs the card's raw-mass scan: {checks}")
        config.USE_BEAM_KERNEL = saved[0]

        feats, lens = requests[0]
        logits, out_lens = captured[0]
        x = logits.transpose(0, 1).contiguous()
        T, N, Vp1 = x.shape
        M = min(Vp1 - 1, 2 * WIDTH)
        search = CTCPrefixSearch(WIDTH)
        encode = torch.no_grad()(model)
        (enc_ms, dec_ms, req_ms), runs = host_ms([
            lambda: encode(feats, lens),
            lambda: search(x, out_lens),
            lambda: recognize(feats, lens),
        ])
        nonext, blank = beam_inputs(x)
        top = kernels.top_m(nonext, M)

        def kernel():
            return kernels.ctc_beam_search(nonext, blank, out_lens, WIDTH, top)

        wrapper = cuda_ms(kernel)
        own = device_ms(kernel, "ctc_beam_kernel",
                        count=lambda: kernels.LAUNCHES["ctc_beam_search"])
        ms = wrapper if own is None else own
        frames = int(out_lens.clamp(max=T).max())
        bound = beam_bound_ms(out_lens, T, N, WIDTH, M)
        times = {
            "ms": ms, "ms_from": "cuda_events" if own is None else "profiler",
            "traces": TRACES["ctc_beam_kernel"],
            "trace_notes": TRACE_NOTES.get("ctc_beam_kernel"),
            "wrapper_ms": wrapper,
            "plain_ms": cuda_ms(
                lambda: kernels.ctc_beam_search_reference(nonext, blank, out_lens, WIDTH, top),
                reps=3, inner=1, warmup=1,
            ),
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": None, "library": "none: no PyTorch call runs a CTC beam search",
            "shape": [T, N, Vp1 - 1, WIDTH], "frames_longest_row": frames,
            "us_per_frame": ms * 1e3 / frames,
        }
        emit({
            "phase": "beam_serve", "requests": N_REQUESTS, "batch": N_BATCH,
            "width": WIDTH, "launches": launches, "serve_s_first_pass": serve_s,
            "vs_card_scan_raw_masses": checks,
            "encoder_ms_per_batch": enc_ms, "decode_ms_per_batch": dec_ms,
            "request_ms": req_ms, "utt_per_s": N_BATCH / (req_ms / 1e3),
            "decode_share_of_request": dec_ms / req_ms,
            "runs_ms": {"encoder": runs[0], "decode": runs[1], "request": runs[2]},
            "kernel": times, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        })
    finally:
        config.USE_BEAM_KERNEL, config.DECODE_RENORM = saved
    return launches, times


def stream_session(rec, feats, lens, partials_every=0, times=None):
    """Push ``feats`` STREAM_PUSH raw frames at a time (partials every
    ``partials_every``-th push), then finish; each push's and the finish's
    wall ms go to ``times``."""
    sess = rec.start(feats.shape[0])
    for p, t in enumerate(range(0, feats.shape[1], STREAM_PUSH)):
        partial = bool(partials_every) and (p + 1) % partials_every == 0
        t0 = time.perf_counter()
        out = rec.push(
            sess, feats[:, t : t + STREAM_PUSH],
            np.clip(lens - t, 0, STREAM_PUSH), partials=partial,
        )
        torch.cuda.synchronize()
        if times is not None:
            times["partial" if partial else "push"].append((time.perf_counter() - t0) * 1e3)
        assert (out is not None) == partial
    t0 = time.perf_counter()
    res = rec.finish(sess)
    torch.cuda.synchronize()
    if times is not None:
        times["finish"].append((time.perf_counter() - t0) * 1e3)
    return res


def depthwise_calls(model):
    """Forward hooks counting the calls of ``model``'s depthwise convs (one
    ``depthwise_conv1d`` launch each without autograd): ``(count, hooks)``,
    the count a one-item list."""
    n = [0]

    def hook(*args):
        n[0] += 1

    return n, [m.register_forward_hook(hook) for m in model.modules()
               if type(m).__name__ == "_DepthwiseConv1D"]


def stream_route(rec, kernels, feats, lens, want):
    """One timed streaming session of ``rec`` after a short warm one, its
    launches equal to ``want`` a search and one ``depthwise_conv1d`` a
    depthwise conv call (every other kernel's 0); the outputs, the
    launches, the push and finish times and the peak memory."""
    stream_session(rec, feats[:, : 4 * STREAM_PUSH], lens.clip(max=4 * STREAM_PUSH), 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = {"push": [], "partial": [], "finish": []}
    kernels.reset_launches()
    convs, hooks = depthwise_calls(rec.model)
    try:
        out = stream_session(rec, feats, lens, STREAM_PARTIALS_EVERY, times)
    finally:
        for h in hooks:
            h.remove()
    launches = dict(kernels.LAUNCHES)
    searches = len(times["partial"]) + 1
    exp = {k: searches * want.get(k, 0) for k in launches} | {"depthwise_conv1d": convs[0]}
    if launches != exp or not convs[0]:
        raise AssertionError(f"streaming launches {launches}, {searches} searches of {want}, "
                             f"{convs[0]} depthwise convs")
    return out, launches, times, torch.cuda.max_memory_allocated()


def phase_stream(pkg, kernels):
    """Streaming CTC serving: the flagship widths as a causal config, 32
    streams of 1000-2000 raw frames pushed 32 at a time (chunk 8), partials
    every 16th push, on the default route, so every partial and the finish
    launch the prologue and the renormalizing beam kernel; then the same
    streams with DECODE_RENORM off, every search launching ``top_m`` and
    the raw-mass ``ctc_beam_search``. On each route a float32 copy streams
    4 of them, and its finish must equal the one-shot search of its full
    forward on that route (lengths and tokens exact, probabilities within
    rtol 1e-4: the windowed and the one-shot forwards sum in other
    orders)."""
    config, ConformerConfig, ConformerCTC, CTCPrefixSearch, StreamingCTCRecognizer = pkg
    cfg = ConformerConfig(
        vocab_size=1024, num_filts=80, d_model=512, num_layers=8, num_heads=8,
        attention_context=STREAM_CONTEXT, causal_conv=True,
    )
    model = ConformerCTC(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        model.ctc_head.weight.mul_(32.0)  # decisive, as in the serve phase
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    feats = torch.randn((N_BATCH, T_RAW, cfg.num_filts), generator=gen, device="cuda")
    lens = torch.randint(T_RAW // 2, T_RAW + 1, (N_BATCH,), generator=gen, device="cuda")
    lens = lens.cpu().numpy()
    m32 = ConformerCTC(dataclasses.replace(cfg, dtype=torch.float32), device="cuda")
    m32.load_state_dict(model.state_dict())
    k = 4
    rec = StreamingCTCRecognizer(model, chunk=STREAM_CHUNK, width=WIDTH)
    out_lens = torch.from_numpy(-(-lens // 4)).cuda()
    S = -(-int(out_lens.max()) // 32) * 32  # decode_pad_multiple
    routes, launches = {}, {}
    saved = config.DECODE_RENORM
    try:
        for route, renorm, want in (
            ("renorm", True, {"decode_prologue": 1, "ctc_beam_search_renorm": 1}),
            ("raw", False, {"top_m": 1, "ctc_beam_search": 1}),
        ):
            config.DECODE_RENORM = renorm
            (y, y_lens, y_probs), got, times, peak = stream_route(rec, kernels, feats, lens, want)
            for name, v in got.items():
                launches[name] = launches.get(name, 0) + v
            assert tuple(y.shape) == (S, N_BATCH, WIDTH)
            assert tuple(y_lens.shape) == (N_BATCH, WIDTH)
            assert bool((y_lens <= out_lens[:, None]).all())
            assert bool(((y_probs >= 0) & (y_probs <= 1)).all()), "probabilities out of [0, 1]"
            assert bool((y_probs[:, :-1] >= y_probs[:, 1:]).all()), "beams out of order"
            one = stream_session(
                StreamingCTCRecognizer(m32, chunk=STREAM_CHUNK, width=WIDTH), feats[:k], lens[:k]
            )
            with torch.no_grad():
                lg, ol = m32(feats[:k], torch.from_numpy(lens[:k]).cuda())
            exp = CTCPrefixSearch(WIDTH)(lg.transpose(0, 1).contiguous(), ol)
            parity = search_compare(one, exp, rtol=1e-4)
            if not parity["ok"]:
                raise AssertionError(
                    f"streaming finish vs one-shot ({route}, f32, {k} streams): {parity}")
            routes[route] = {
                "pushes": len(times["push"]) + len(times["partial"]),
                "partials": len(times["partial"]),
                "launches": {name: v for name, v in got.items() if v},
                "push_ms_median": statistics.median(times["push"]),
                "push_ms_max": max(times["push"]),
                "partial_push_ms_median": (
                    statistics.median(times["partial"]) if times["partial"] else None
                ),
                "finish_ms": times["finish"][0], "peak_mem_bytes": peak,
                "finish_vs_one_shot_f32": dict(parity, streams=k),
            }
    finally:
        config.DECODE_RENORM = saved
    emit({
        "phase": "stream", "model": "ConformerCTC d512 L8 H8 V1024 bf16, causal",
        "attention_context": list(STREAM_CONTEXT), "causal_conv": True, "R": rec.R,
        "window_raw_frames": rec.Lw, "streams": N_BATCH,
        "raw_frames_min": int(lens.min()), "raw_frames_max": int(lens.max()),
        "push_raw_frames": STREAM_PUSH, "chunk": STREAM_CHUNK, "width": WIDTH,
        "routes": routes,
    })
    return launches


# ---------------------------------------------------------------------------
# LM-fused serving (BASELINE config #3): the prologue's g_bias route.

LM_BETA = 0.5
BIG5 = os.path.join("tests", "fixtures", "big5.arpa.gz")
BIG5_V = 10240  # tests/fixtures/gen_big_arpa.py: ids 0..V-1, <s> is V


def bench_lm(LookupLanguageModel, V=1024, seed=2, device="cuda"):
    """bench.py's random backoff 3-gram over V=1024 (``_bench_lm``,
    bench.py:425-440), built with the port's own code: the unigrams, 10,000
    bigrams and 15,000 trigrams drawn from ``RandomState(seed)``, sos = V."""
    rng = np.random.RandomState(seed)
    uni = {w: (float(-rng.rand() * 5 - 0.1), float(-rng.rand())) for w in range(V)}
    uni[V] = (float("-inf"), float(-rng.rand()))  # sos
    bi, tri = {}, {}
    ctx = list(range(V)) + [V]
    for _ in range(10000):
        key2 = (int(rng.choice(ctx)), int(rng.randint(V)))
        bi[key2] = (float(-rng.rand() * 5 - 0.1), float(-rng.rand()))
    for _ in range(15000):
        key3 = (int(rng.choice(ctx)), int(rng.randint(V)), int(rng.randint(V)))
        tri[key3] = float(-rng.rand() * 5 - 0.1)
    return LookupLanguageModel(V, sos=V, prob_dicts=[uni, bi, tri], device=device)


def cpu_copy(LookupLanguageModel, lm):
    """The same LM on the CPU, carried by its state dict."""
    out = LookupLanguageModel(lm.vocab_size, sos=lm.sos, device="cpu")
    out.load_state_dict(lm.state_dict())
    return out


def phase_lm_serve(pkg, kernels, model, requests, lm):
    """The serve cell's three requests through ``ctc_recognizer(model, 16,
    beta=0.5, lm=lm)`` with bench.py's 3-gram: the sparse route, one
    ``decode_prologue`` launch a request at M = 2W + 23 = 55 with the LM's
    unigram bias. The card's hypotheses and lengths for every utterance
    must equal a CPU decode of the same logits with a CPU copy of the LM,
    probabilities within rtol 1e-4; the prologue on the served logits with
    that bias bit-exact against its plain version. Then the encoder, decode
    and request wall times in turn, the decode's launches a frame from a
    trace, and the prologue's own time at M=55 beside its bound."""
    LookupLanguageModel, ctc_recognizer, CTCPrefixSearch, lm_bias, config = pkg
    V = lm.vocab_size
    search = CTCPrefixSearch(WIDTH, beta=LM_BETA, lm=lm)
    route = search.lm_route()
    M = min(V, 2 * WIDTH + lm.max_corrections)
    if route != "sparse":
        raise AssertionError(f"the bench LM takes the {route} route, not sparse")
    recognize = ctc_recognizer(model, WIDTH, beta=LM_BETA, lm=lm)
    captured = []
    hook = model.register_forward_hook(lambda mod, inp, out: captured.append(out))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    outputs = [recognize(f, l) for f, l in requests]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    hook.remove()
    want = dict.fromkeys(launches, 0) | {
        "decode_prologue": N_REQUESTS, "depthwise_conv1d": N_REQUESTS * model.cfg.num_layers}
    if launches != want:
        raise AssertionError(f"lm serve launches {launches}, expected {want}")
    check_served(outputs, captured, model.cfg)

    # every utterance against a CPU decode of the same logits
    cpu_search = CTCPrefixSearch(WIDTH, beta=LM_BETA, lm=cpu_copy(LookupLanguageModel, lm))
    checks = []
    for (hyps, hlens, probs), (logits, out_lens) in zip(outputs, captured):
        exp = cpu_search(logits.transpose(0, 1).contiguous().cpu(), out_lens.cpu())
        got = (hyps.permute(2, 0, 1).cpu(), hlens.cpu(), probs.cpu())
        checks.append(search_compare(got, exp, 1e-4))
    if not all(c["ok"] for c in checks):
        raise AssertionError(f"lm serve: the card's hypotheses vs the CPU's: {checks}")
    hyp_tokens = int(sum(int(o[1][:, 0].sum()) for o in outputs))

    logits, out_lens = captured[0]
    x = logits.transpose(0, 1).contiguous()
    T, N, Vp1 = x.shape
    g_bias = lm_bias(lm._uni_t, LM_BETA)
    served_case = check_prologue(kernels, x, M, g_bias)
    if not served_case["prologue_ok"]:
        raise AssertionError(f"prologue with the LM bias on the served logits: {served_case}")

    feats, lens = requests[0]
    encode = torch.no_grad()(model)
    decode = torch.no_grad()(lambda: search(x, out_lens))
    (enc_ms, dec_ms, req_ms), runs = host_ms([
        lambda: encode(feats, lens), decode, lambda: recognize(feats, lens),
    ], reps=5)
    profiled = trace(decode)

    wrapper = cuda_ms(lambda: kernels.decode_prologue(x, M, g_bias))
    counted = dict(count=lambda: kernels.LAUNCHES["decode_prologue"])
    own = device_ms(lambda: kernels.decode_prologue(x, M, g_bias), "prologue_kernel", **counted)
    bound = prologue_bound_ms(T, N, Vp1, M, x.element_size(), bias_bytes=4 * V)
    prologue = {
        "ms": wrapper if own is None else own,
        "ms_from": "cuda_events" if own is None else "profiler",
        "traces": TRACES["prologue_kernel"],
        "trace_notes": TRACE_NOTES.get("prologue_kernel"),
        "wrapper_ms": wrapper,
        "plain_ms": cuda_ms(lambda: kernels.decode_prologue_reference(x, M, g_bias)),
        "bound_ms": bound[0], "bound_by": bound[1],
        "library_ms": cuda_ms(lambda: torch.topk(x[..., :V] + g_bias, M)),
        "library": "torch.topk of the biased logits",
        "shape": [T, N, Vp1], "m": M, "dtype": str(x.dtype).replace("torch.", ""),
        "bias": "0.5 * uni of the bench LM", "launches": launches["decode_prologue"],
    }
    # which of the two moved the time: M past a warp's 32, or the bias
    prologue["m55_no_bias_ms"] = device_ms(lambda: kernels.decode_prologue(x, M),
                                           "prologue_kernel", **counted)
    prologue["m32_bias_ms"] = device_ms(
        lambda: kernels.decode_prologue(x, M_HEADLINE, g_bias), "prologue_kernel", **counted
    )
    gather = lm_gather(config, kernels, model, recognize, search, cpu_search, requests,
                       (outputs, captured, dec_ms, profiled["kernel_launches"] / T))
    emit({
        "phase": "lm_serve", "nvidia_smi": smi_line(),
        "model": "ConformerCTC d512 L8 H8 V1024 bf16", "width": WIDTH, "beta": LM_BETA,
        "lm": {"kind": "bench.py 3-gram, RandomState(2)", "vocab": V,
               "max_ngram": lm.max_ngram, "max_corrections": lm.max_corrections},
        "route": route, "m": M, "requests": N_REQUESTS, "batch": N_BATCH,
        "launches": launches, "serve_s_first_pass": serve_s, "peak_mem_bytes": peak,
        "vs_cpu_decode": {"utterances": N_REQUESTS * N_BATCH,
                          "best_hyp_tokens": hyp_tokens, "checks": checks},
        "prologue_on_served_logits": served_case,
        "encoder_ms_per_batch": enc_ms, "decode_ms_per_batch": dec_ms,
        "request_ms": req_ms, "utt_per_s": N_BATCH / (req_ms / 1e3),
        "decode_share_of_request": dec_ms / req_ms,
        "runs_ms": {"encoder": runs[0], "decode": runs[1], "request": runs[2]},
        "decode_trace": {k: profiled[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                                   "kernel_launches", "top_kernels")},
        "launches_per_frame": profiled["kernel_launches"] / T,
        "prologue": prologue,
        "gather": gather,
    })
    launches["decode_prologue"] += gather["launches"]["decode_prologue"]
    return launches, prologue


def ties_compare(got, exp, rtol=3e-5):
    """tests/test_decoding.py's "up to ties" rule (:783-800) for ``(y (T,
    N, W), y_lens, y_probs)`` triples: each row's sorted probabilities
    within ``rtol`` (atol 1e-7), and every finite beam of ``exp`` found in
    ``got`` among the beams whose probability lies within 1e-4 (relative)
    of its own, with the same length and tokens."""
    (gy, gl, gp), (ey, el, ep) = (tuple(t.cpu() for t in x) for x in (got, exp))
    sorted_ok = bool(torch.isclose(gp.sort(-1).values, ep.sort(-1).values,
                                   rtol=rtol, atol=1e-7).all())
    missing = []
    N, W = ep.shape
    for n in range(N):
        for k in range(W):
            p = float(ep[n, k])
            if math.isinf(p):
                continue
            L = int(el[n, k])
            near = ((gp[n] - p).abs() < 1e-4 * max(1.0, abs(p))).tolist()
            if not any(
                near[kk] and int(gl[n, kk]) == L and torch.equal(gy[:L, n, kk], ey[:L, n, k])
                for kk in range(W)
            ):
                missing.append([n, k])
    same = torch.equal(gl, el) and torch.equal(gp, ep) and torch.equal(gy, ey)
    return {"sorted_probs_ok": sorted_ok, "beams_missing": missing[:8],
            "bit_equal": same, "ok": sorted_ok and not missing}


def lm_gather(config, kernels, model, recognize, search, cpu_search, requests, compare):
    """The LM serve's three requests again with ``config.
    SPARSE_MEMBERSHIP_GATHER`` on (set here, restored after): the order-2
    slots answered by one gather of the LM's bigram table. Still one
    ``decode_prologue`` launch a request; every utterance's beams equal
    the compare route's on the same logits up to ties (the JAX package's
    rule for its own two routes); the first request's decode equal to a
    CPU gather decode (lengths and tokens exact, probabilities within rtol
    1e-4); the encoder's logits bit-equal to the compare pass's; the
    decode's wall ms beside the compare route's, the two taken
    in turn, launches a frame beside the compare route's (``compare``: its
    outputs, logits, decode ms and launches a frame), and the table's
    bytes."""
    outputs, captured, cmp_ms, cmp_per_frame = compare
    old = config.SPARSE_MEMBERSHIP_GATHER
    config.SPARSE_MEMBERSHIP_GATHER = True
    try:
        table = search.lm._order2_table()
        if table is None:
            raise AssertionError("the LM has no bigram table: the gather route would compare")
        again = []
        hook = model.register_forward_hook(lambda mod, inp, out: again.append(out))
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        served = [recognize(f, l) for f, l in requests]
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        hook.remove()
        want = dict.fromkeys(launches, 0) | {
            "decode_prologue": len(requests),
            "depthwise_conv1d": len(requests) * model.cfg.num_layers,
        }
        if launches != want:
            raise AssertionError(f"lm gather launches {launches}, expected {want}")

        def as_search(out):
            hyps, hlens, probs = out
            return hyps.permute(2, 0, 1), hlens, probs

        # the same requests give the same logits, so the compare pass's
        # outputs are the compare route's on these logits
        if not all(torch.equal(a[0], b[0]) for a, b in zip(again, captured)):
            raise AssertionError("lm gather: the encoder's logits differ from the compare pass's")
        checks = [ties_compare(as_search(g), as_search(c)) for g, c in zip(served, outputs)]
        if not all(c["ok"] for c in checks):
            raise AssertionError(f"lm gather vs the compare route: {checks}")
        logits, out_lens = again[0]
        x = logits.transpose(0, 1).contiguous()
        cpu = search_compare(
            tuple(t.cpu() for t in as_search(served[0])),
            cpu_search(x.cpu(), out_lens.cpu()), 1e-4,
        )
        if not cpu["ok"]:
            raise AssertionError(f"lm gather: the card vs a CPU gather decode: {cpu}")
        decode = torch.no_grad()(lambda: search(x, out_lens))
        profiled = trace(decode)

        def route(on):
            def run():
                config.SPARSE_MEMBERSHIP_GATHER = on
                return decode()
            return run

        # the two routes in turn, so they see the same host load
        (cmp_turn_ms, dec_ms), runs = host_ms([route(False), route(True)], reps=5)
    finally:
        config.SPARSE_MEMBERSHIP_GATHER = old
    T = x.shape[0]
    return {
        "launches": launches, "serve_s_first_pass": serve_s,
        "table_bytes": table.numel() * table.element_size(),
        "table_rows": table.numel() // search.lm.vocab_size,
        "vs_compare_route": checks, "vs_cpu_gather_decode": cpu,
        "decode_ms_per_batch": dec_ms, "runs_ms": runs[1],
        "compare_decode_ms_per_batch": cmp_turn_ms, "compare_runs_ms": runs[0],
        "compare_decode_ms_lm_serve_phase": cmp_ms,
        "decode_trace": {k: profiled[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                                   "kernel_launches", "top_kernels")},
        "launches_per_frame": profiled["kernel_launches"] / T,
        "compare_launches_per_frame": cmp_per_frame,
    }


def phase_lm_probing(pkg):
    """tests/fixtures/big5.arpa.gz (a 5-gram over 10,240 tokens) parsed
    with the port's ``parse_arpa_lm`` and built on the card: its orders 2-4
    have only the probing hash table. ``calc_full_log_probs`` and
    ``score_sequences`` on the card must equal a CPU copy's for 64
    histories of 8 tokens (576 prefixes), some of them a stored 5-gram's
    context, ``<unk>`` and ``</s>``. Also which decode route the LM takes."""
    import gzip

    LookupLanguageModel, parse_arpa_lm, CTCPrefixSearch, config = pkg
    sys.path.insert(0, os.path.join("tests", "fixtures"))
    try:
        import gen_big_arpa
    finally:
        sys.path.pop(0)
    t0 = time.perf_counter()
    with gzip.open(BIG5, "rt") as f:
        prob_dicts = parse_arpa_lm(f, gen_big_arpa.token2id(), to_base_e=True, ftype=np.float32)
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm = LookupLanguageModel(BIG5_V, sos=BIG5_V, prob_dicts=prob_dicts, device="cuda")
    build_s = time.perf_counter() - t0
    cpu = cpu_copy(LookupLanguageModel, lm)
    layouts = ["dense" if t.dense_packed is not None else "probing" for t in lm._ctx_tables]
    if layouts[1:] != ["probing"] * 3:
        raise AssertionError(f"big5's context tables: {layouts}")
    rng = np.random.RandomState(gen_big_arpa.SEED)
    S, B = 8, 64
    hist = rng.randint(0, BIG5_V, (S, B))
    for b, key in enumerate(list(prob_dicts[4])[:16]):
        hist[:4, b] = key[:4]  # a stored 5-gram's context
    hist[4, 0], hist[5, 1] = 1, 0  # </s>, <unk>
    th = torch.from_numpy(hist)
    got = lm(th.cuda()).cpu()
    exp = cpu(th)
    scored, scored_cpu = lm.score_sequences(th.cuda()).cpu(), cpu.score_sequences(th)
    res = {
        "full_log_probs_equal": same_bits(got, exp),
        "score_sequences_equal": same_bits(scored, scored_cpu),
        "full_log_probs_max_abs_err": max_abs_err([(got, exp)]),
        "finite_share": float(torch.isfinite(exp).float().mean()),
    }
    emit({
        "phase": "lm_probing", "arpa": BIG5, "vocab": BIG5_V, "max_ngram": lm.max_ngram,
        "tables": layouts, "max_probe": [t.max_probe for t in lm._ctx_tables],
        "max_corrections": lm.max_corrections,
        "sparse_fusion_max_corrections": config.SPARSE_FUSION_MAX_CORRECTIONS,
        "decode_route": CTCPrefixSearch(WIDTH, beta=LM_BETA, lm=lm).lm_route(),
        "histories": [S + 1, B], "parse_s": parse_s, "build_s": build_s, **res,
    })
    if not (res["full_log_probs_equal"] and res["score_sequences_equal"]):
        raise AssertionError(f"big5 on the card vs the CPU: {res}")


# ---------------------------------------------------------------------------
# The training path (SpecAugment, forward, CTC loss, backward, AdamW) and the
# scoring path (greedy decode, error_rate), with their two kernels.

B_TRAIN, T_TRAIN, U_TRAIN, TRAIN_STEPS, LR = 32, 1000, 100, 5, 1e-3
# bench_train_mfu's SpecAugment (bench.py:622-626); the rest park2020's
SA_ARGS = dict(max_time_warp=80.0, max_time_mask=100, max_freq_mask=27)
SA_DRAW = (80.0, 0.0, 100, 27, 0.04, 20, 0.04, 2)
R_SCORE = 40  # BASELINE config #2: refs (40, 32), T' = 500
BF16_OPS_PER_S = 989e12  # H100 SXM, dense tensor cores


def same_bits(a, b):
    """Equal bit patterns, or NaN in both."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return bool(((a.view(view) == b.view(view)) | (torch.isnan(a) & torch.isnan(b))).all())


def sa_case(img, shape, gen, warp=True, fspan=(7, 9)):
    """SpecAugment's apply arguments at ``shape`` with ragged lengths, a
    time mask across each length, a frequency mask over ``fspan`` (start,
    width; columns 7-15 by default), and inf/NaN where only masked outputs
    read them: in three of those columns, and in the time-masked rows that
    no kept row's lerp reads."""
    N, T, F = shape
    feats = torch.randn(shape, generator=gen, device="cuda")
    lens = torch.randint(T // 2, T + 1, (N,), generator=gen, device="cuda")
    lens[0] = T
    p = list(img.spec_augment_draw_parameters(gen, feats, *SA_DRAW, lengths=lens))
    p[4][:, 0], p[5][:, 0] = (lens - 5).int(), 10
    p[6][:, 0], p[7][:, 0] = fspan
    tmask = img._span_mask(p[4], p[5], T)
    fmask = img._span_mask(p[6], p[7], F)
    warp_args = [None] * 4
    read = (~tmask).float()
    if warp:
        grid = img.warp_1d_grid(p[0], p[1], lens, T)
        warp_args = list(img._axis_lerp_weights(grid, T))
        read = torch.zeros((N, T), device="cuda")
        for idx in warp_args[:2]:
            read.scatter_add_(1, idx.long(), (~tmask).float())
    poison = tmask & (read == 0)
    special = torch.tensor([float("inf"), float("-inf"), float("nan")], device="cuda")
    feats = torch.where(
        poison[..., None], special[torch.arange(T, device="cuda") % 3][None, :, None], feats
    )
    feats[:, :, fspan[0] + 2 : fspan[0] + 5] = special
    return feats, warp_args + [tmask, fmask], lens, p, int(poison.sum())


def phase_new_kernels(kernels, img):
    """Both new kernels against their plain versions on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst = {"spec_augment_apply": 0.0, "edit_distance": 0.0}
    shape = (B_TRAIN, T_TRAIN, 80)
    # columns 7-15 (whole vectors after a cut one), then 5-10, cut inside
    # a vector at both ends for 4 floats and for 8 bfloat16
    sa_cases = [(d, w, (7, 9)) for d in (torch.float32, torch.bfloat16) for w in (True, False)]
    sa_cases += [(d, True, (5, 6)) for d in (torch.float32, torch.bfloat16)]
    for dtype, warp, fspan in sa_cases:
        feats, args, _, _, poisoned = sa_case(img, shape, gen, warp, fspan)
        x = feats.to(dtype)
        got = kernels.spec_augment_apply(x, *args)
        exp = kernels.spec_augment_apply_reference(x, *args)
        torch.cuda.synchronize()
        masked = (args[4][:, :, None] | args[5][:, None, :]).expand(shape)
        zeros = got[masked].float()
        res = {
            "bit_exact": same_bits(got, exp),
            "masked_all_pos_zero": bool((zeros == 0).all())
            and not bool(torch.signbit(zeros).any()),
            "t0_eq_t1_rows": int((args[0] == args[1]).sum()) if warp else 0,
            "poisoned_rows": poisoned,
        }
        emit({"phase": "kernels", "kernel": "spec_augment_apply", "shape": list(shape),
              "dtype": str(dtype).replace("torch.", ""), "warp": warp,
              "fmask_columns": [fspan[0], fspan[0] + fspan[1] - 1], **res})
        if not (res["bit_exact"] and res["masked_all_pos_zero"]):
            raise AssertionError(f"spec_augment_apply parity failed: {res}")
        worst["spec_augment_apply"] = max(
            worst["spec_augment_apply"], max_abs_err([(got, exp)])
        )
    for R, H, N in ((40, 500, 32), (100, 250, 32), (31, 500, 32), (1000, 500, 32)):
        # inf and NaN costs take the kernels' NaN-aware instantiations
        for costs in ((1.0, 1.0, 1.0), (3.0, 3.0, 4.0), (0.5, 1.25, 2.0),
                      (1.0, 1.0, math.inf), (math.nan, 1.0, 1.0)):
            for exclude_last in (False, True):
                ref = torch.randint(0, 8, (R, N), generator=gen, device="cuda", dtype=torch.int32)
                hyp = torch.randint(0, 8, (H, N), generator=gen, device="cuda", dtype=torch.int32)
                rl = torch.randint(0, R + 1, (N,), generator=gen, device="cuda", dtype=torch.int32)
                hl = torch.randint(0, H + 1, (N,), generator=gen, device="cuda", dtype=torch.int32)
                rl[0], hl[1], rl[2], hl[2] = 0, 0, R, H  # empty ones, full ones
                args = (ref, hyp, rl, hl, *costs)
                got = kernels.edit_distance(*args, exclude_last=exclude_last)
                exp = kernels.edit_distance_reference(*args, exclude_last=exclude_last)
                torch.cuda.synchronize()
                ok = same_bits(got, exp)
                # a match adds 0 at sub=inf, so those distances stay finite
                finite_ok = not math.isinf(costs[2]) or bool(torch.isfinite(got).all())
                emit({"phase": "kernels", "kernel": "edit_distance", "shape": [R, H, N],
                      "costs": [str(c) for c in costs], "exclude_last": exclude_last,
                      "exact": ok, "nan_outputs": int(torch.isnan(got).sum()),
                      "finite_at_sub_inf": finite_ok})
                if not (ok and finite_ok):
                    raise AssertionError(f"edit_distance parity failed at {(R, H, N, costs)}")
                worst["edit_distance"] = max(worst["edit_distance"], max_abs_err([(got, exp)]))
    return worst


# The depthwise conv's kernel at the three cells' shapes: (N, T, C, causal)
# of ctc_l.prefix16's encoder (centered), rnnt_m.greedy's and rnnt_m.stream's
# cached step ([31 cached || 8 new] rows), all bfloat16 at K = 32.
DEPTHWISE = (("ctc_l", 256, 875, 512, False), ("rnnt_m", 512, 875, 256, True),
             ("rnnt_m.stream", 128, 39, 256, True))


def phase_depthwise(kernels, cases=DEPTHWISE, K=32, dev="cuda"):
    """``depthwise_conv1d`` against its plain version, the tap loop, on the
    card at each case's shape (every output bit), then timed: the kernel's
    device time, its wrapper's (CUDA events), its byte bound (the input
    read once and the output written once at 3.35 TB/s), the plain loop
    and ``F.conv1d(groups=C)`` on the same bfloat16 rows as the one-call
    library yardstick (only measured: nothing calls it). Returns the
    largest difference of the outputs compared and the times by case."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    out, worst = {}, 0.0
    for name, N, T, C, causal in cases:
        y = torch.randn((N, T, C), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((K, C), generator=gen, device=dev) / math.sqrt(K)
        b = torch.randn((C,), generator=gen, device=dev) * 0.1
        left = K - 1 if causal else (K - 1) // 2
        got = kernels.depthwise_conv1d(y, w, b, left)
        exp = kernels.depthwise_conv1d_reference(y, w, b, left)
        torch.cuda.synchronize()
        exact = torch.equal(got.view(torch.int16), exp.view(torch.int16))
        worst = max(worst, max_abs_err([(got, exp)]))
        emit({"phase": "kernels", "kernel": "depthwise_conv1d", "case": name,
              "shape": [N, T, C, K], "causal": causal, "bit_exact": exact})
        if not exact:
            raise AssertionError(f"depthwise_conv1d differs from the tap loop at {name}")
        yp = F.pad(y, (0, 0, left, K - 1 - left)).transpose(1, 2).contiguous()
        wc, bc = w.t()[:, None, :].to(torch.bfloat16).contiguous(), b.to(torch.bfloat16)
        t = {
            "ms": device_ms(lambda: kernels.depthwise_conv1d(y, w, b, left), "pydt_dw::",
                            count=lambda: kernels.LAUNCHES["depthwise_conv1d"]),
            "wrapper_ms": cuda_ms(lambda: kernels.depthwise_conv1d(y, w, b, left)),
            "bound_ms": 2 * y.numel() * y.element_size() / 3.35e12 * 1e3,
            "plain_ms": cuda_ms(lambda: kernels.depthwise_conv1d_reference(y, w, b, left),
                                reps=3, inner=2),
            "library_ms": cuda_ms(lambda: F.conv1d(yp, wc, bc, groups=C)),
        }
        t["roofline_pct"] = 100.0 * t["bound_ms"] / t["ms"] if t["ms"] else None
        emit({"phase": "depthwise", "case": name, "shape": [N, T, C, K],
              "nvidia_smi": smi_line(), **t})
        out[name] = t
        del y, got, exp, yp
    return worst, out


def make_train_batch(cfg, dev="cuda", B=B_TRAIN, T=T_TRAIN, U=U_TRAIN):
    """bench_train_mfu's batch: B=32 utterances of 1000 frames, 100 random
    tokens each (other sizes for a rehearsal on the CPU)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    feats = torch.randn((B, T, cfg.num_filts), generator=gen, device=dev)
    feat_lens = torch.full((B,), T, device=dev)
    refs = torch.randint(0, cfg.vocab_size, (B, U), generator=gen, device=dev)
    ref_lens = torch.full((B,), U, device=dev)
    return feats, feat_lens, refs, ref_lens


def sa_bound_ms(x, t0, t1, w0, w1, tmask, fmask):
    """What these inputs need: every output written once; of ``x``, the
    columns outside the frequency mask of each distinct row that a frame
    outside the time mask reads; t0, t1, w0 and w1 of those frames, the
    time mask of every frame and the frequency mask once; two products and
    a sum per output outside both masks."""
    N, T, F = x.shape
    kept = ~tmask
    read = torch.zeros((N, T), device=x.device)
    for idx in (t0, t1):
        read.scatter_add_(1, idx.long(), kept.float())
    cols = (~fmask).sum(1)
    rows_read = int(((read > 0).sum(1) * cols).sum())
    outputs_kept = int((kept.sum(1) * cols).sum())
    bytes_ = x.element_size() * (N * T * F + rows_read) + 16 * int(kept.sum()) + N * T + N * F
    ops = 3 * outputs_kept
    t_b, t_o = bytes_ / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def ed_wavefront_steps(lib, R, hyp_lens):
    """Wavefront steps of the edit-distance kernel's longest sequence (no
    exclude_last): its hypothesis rows plus the lanes that hold a strip of
    the row, less one, with the library's own strip width."""
    strip = lib.pydt_edit_distance_strip(R)
    steps = int(hyp_lens.clamp(min=0).max())
    return steps + (R + strip) // strip - 1 if steps > 0 else 0


def ed_bound_ms(R, N, hyp_lens):
    """What this data needs: each reference and the hypothesis tokens its
    DP reads once, lengths in, a distance out; about 9 operations per DP
    cell over the steps each sequence takes."""
    steps = int(hyp_lens.clamp(min=0).sum())
    bytes_ = 4 * (R * N + steps + 3 * N)
    ops = 9 * (R + 1) * steps
    t_b, t_o = bytes_ / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def adamw_first_step(p0, g):
    """The parameters after AdamW's first step (``adamw``'s defaults, as
    optax's), in float64: the bias-corrected moments are ``g`` and ``g**2``,
    so the step is ``lr * g / (|g| + eps)`` plus the weight decay."""
    p0, g = p0.double(), g.double()
    return p0 * (1 - LR * 1e-4) - LR * g / (g.abs() + 1e-8)


@contextlib.contextmanager
def float64_casts():
    """``Tensor.float`` as ``Tensor.double`` while it lasts, so that a
    float64 model keeps float64 where the model casts to float32 (LayerNorm
    statistics, the CTC head's input, the loss's log-softmax)."""
    float_ = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        yield
    finally:
        torch.Tensor.float = float_


def one_step(pkg, cfg, sd, batch, augment, dev, dtype=torch.float32):
    """``cfg``'s model, loaded from ``sd``, takes one training step on
    ``dev`` with parameters and compute in ``dtype``: the loss, and the
    parameters after the step and the gradients, on the CPU."""
    _, ConformerCTC, adamw, make_train_step, _ = pkg
    m = ConformerCTC(dataclasses.replace(cfg, dtype=dtype), device=dev).to(dtype)
    m.ctc_head.dtype = dtype
    m.load_state_dict(sd)
    step = make_train_step(m, adamw(m.parameters(), LR), augment)
    with float64_casts() if dtype == torch.float64 else contextlib.nullcontext():
        loss = step(None, *(a.to(dev) for a in batch))
    return (
        float(loss),
        {k: v.detach().cpu() for k, v in m.named_parameters()},
        {k: v.grad.cpu() for k, v in m.named_parameters()},
    )


# The card's float32 gradient against a float64 witness: each device's
# distance from the witness, over the tensor's largest witness entry, is
# float32's own error at those weights. Two parts:
# - the card's own float64 step must lie within GRAD64_LIMIT of the
#   witness: its recorded readings ran 8.7e-8 to 2.5e-7 (PERF.md), so a
#   card that computes the step wrong shows there, whatever float32 does;
# - each float32 distance must be at most max(GRAD_FLOOR, GRAD_K times the
#   CPU's at the tensor, GRAD_S times the card's own float32 spread there).
#   The spread is the distance between two card float32 steps that reduce
#   in different orders (the default algorithms, and cuDNN off), over the
#   same witness scale. A rounding outlier of one algorithm shows as
#   spread; a fault in the port's code sits in both steps alike and does
#   not widen it. GRAD_FLOOR and GRAD_K are sized from every float32
#   distance recorded in PERF.md (largest 2.13e-3 on both devices alike;
#   1.049e-3 on the card where the CPU read 1.31e-4). GRAD_S is sized from
#   the one outlier whose spread was read (subsample.conv2.weight: card
#   4.37e-3, cuDNN off 1.93e-4, so a spread of 4.18e-3 to 4.56e-3): 1.2
#   times the least spread covers the card's distance, and a tensor
#   scaled by 1.01 in both card steps (at least 5.59e-3 from the witness,
#   its spread 1.01 times as wide) exceeds 1.2 times the widest.
GRAD_K, GRAD_FLOOR, GRAD_S, GRAD64_LIMIT = 2.5, 2.5e-3, 1.2, 1e-5


def grad_distances(grads, witness, other=None):
    """Per tensor, ``max |g - other| / max |witness|`` (``other`` is the
    witness when None), for the tensors whose witness gradient is not all
    zero."""
    other = witness if other is None else other
    out = {}
    for k, w in witness.items():
        scale = float(w.abs().max())
        if scale > 0:
            out[k] = float((grads[k].double() - other[k].double()).abs().max()) / scale
    return out


def grad_criterion(card, cpu, card64=None, spread=None, k=GRAD_K, floor=GRAD_FLOOR,
                   s=GRAD_S, limit64=GRAD64_LIMIT):
    """The card's gradient holds if its own float64 step (``card64``, when
    given) lies within ``limit64`` of the witness at every tensor, and each
    float32 distance is at most ``max(floor, k * cpu, s * spread)``.
    ``card``, ``cpu``, ``card64`` and ``spread`` (the card's two float32
    steps apart, when given) map tensor names to :func:`grad_distances`.
    Returns ``(ok, readings)``: the worst card/CPU ratio and the worst
    share of the float32 limit used, each with its tensor, the tensor of
    the worst limit use with its distance, the CPU's, the spread and the
    limit there (``grad_vs_f64_worst``), the tensors that failed, and the
    float64 step's worst distance with whether it held."""
    res = {"grad_vs_f64_ratio": 0.0, "grad_vs_f64_ratio_at": None,
           "grad_vs_f64_limit_use": 0.0, "grad_vs_f64_limit_use_at": None,
           "grad_vs_f64_worst": None, "grad_vs_f64_failed": []}
    for name, d in card.items():
        sp = spread[name] if spread is not None else 0.0
        limit = max(floor, k * cpu[name], s * sp)
        ratio = d / cpu[name] if cpu[name] > 0 else (0.0 if d == 0 else math.inf)
        if ratio > res["grad_vs_f64_ratio"]:
            res["grad_vs_f64_ratio"], res["grad_vs_f64_ratio_at"] = ratio, name
        if d / limit > res["grad_vs_f64_limit_use"] or res["grad_vs_f64_worst"] is None:
            res["grad_vs_f64_limit_use"], res["grad_vs_f64_limit_use_at"] = d / limit, name
            res["grad_vs_f64_worst"] = {"tensor": name, "card": d, "cpu": cpu[name],
                                        "spread": sp, "limit": limit}
        if not d <= limit:
            res["grad_vs_f64_failed"].append(name)
    ok64 = True
    if card64 is not None:
        at = max(card64, key=card64.get)
        ok64 = card64[at] <= limit64
        res.update(grad_card64_vs_f64=card64[at], grad_card64_vs_f64_at=at,
                   grad_card64_ok=ok64)
    return ok64 and not res["grad_vs_f64_failed"], res


# The card's float32 step under other cuDNN settings: the second one
# (cuDNN off) is the other reduction order of grad_criterion's spread;
# --train-witness also reports the first, to see whether the outliers
# follow cuDNN's choice of algorithm
CUDNN_VARIANTS = (
    ("cudnn_deterministic", dict(enabled=True, deterministic=True)),
    ("cudnn_off", dict(enabled=False)),
)
SPREAD_VARIANT = CUDNN_VARIANTS[1]


def step_check(pkg, kernels, cfg, sd, batch, sa_args, hold_gap=True, variants=(), dev="cuda"):
    """One float32 step from ``sd`` on the card, twice, and on the CPU,
    and a float64 step on the CPU as the witness of the true gradient, all
    on the same SpecAugment'ed input. The readings, and the checks that
    failed: loss within rtol 1e-4; the card's float64 step within
    ``GRAD64_LIMIT`` of the witness and each of its float32 gradients no
    farther from it than :func:`grad_criterion` allows (``GRAD_K`` times
    the CPU's float32 distance, ``GRAD_S`` times the card's own float32
    spread, at least ``GRAD_FLOOR``, each over the tensor's largest
    witness entry), and with ``hold_gap`` within 1e-3
    of its tensor's largest from the CPU's (an attention key bias, whose
    true gradient is 0 since
    softmax is blind to it, within 1e-3 of the model's largest gradient on
    both devices); each device's update AdamW's first step from its own
    gradient (within 1e-6); and the parameters after it within atol 1e-4
    where both devices' gradients are at least 10 times the gradient
    tolerance and 1e-6.

    Both float32 gradients lie up to about 5e-4 of a tensor's largest
    entry from the float64 one, on either device, and past 2e-3 at some
    trained weights (the weights and biases of LayerNorms and
    convolutions, summed over every frame), so two of them may part by up
    to twice that: at weights a training run made, which differ from run
    to run, the card is held to the float64 witness, by its own float64
    step and by a float32 bound sized from the recorded float32 errors and
    from the card's own spread: its float32 step is taken once more under
    ``SPREAD_VARIANT`` (cuDNN off, another reduction order), and the two
    card steps' distance apart is the spread.

    Adam's first step is ``lr * g / (|g| + eps)``, about ``lr`` times the
    sign of ``g`` whatever its size, so where a gradient is rounding noise
    (an attention key bias) the two devices' steps may part by up to 2
    ``lr``; where it is well above the noise they agree far inside 1e-4.

    Beside the card-vs-CPU gap, each float32 gradient's distance from the
    float64 one, over that tensor's largest float64 entry: the card's
    (``grad_card_vs_f64``), the CPU's (``grad_cpu_vs_f64``) and the second
    card step's from the first (``grad_card_vs_card``), each with the
    tensor where it is largest (``_at``); and the card's own float64 step's
    (``grad_card64_vs_f64``): where it lies far inside the float32
    distances, the card computes the step right and its float32
    gradient's distance is rounding. Each of ``variants``, ``(name,
    cudnn flags)``, takes the card's float32 step again under those flags
    (not held to a bound; ``SPREAD_VARIANT``'s step is reused): its worst
    distance from the witness, with its tensor, and its distance at the
    default step's worst tensor, beside the default's and the CPU's there
    (``grad_at_worst``). ``dev`` is the card (the CPU in a rehearsal)."""
    feats = batch[0]
    aug = kernels.spec_augment_apply(feats, *sa_args).double()
    card_args = [a.to(dev) for a in sa_args]
    on_card = lambda g, f, l: kernels.spec_augment_apply(f, *card_args)  # noqa: E731
    on_cpu = lambda g, f, l: kernels.spec_augment_apply(f, *sa_args)  # noqa: E731
    lc, pc, gc = one_step(pkg, cfg, sd, batch, on_cpu, "cpu")
    lg, pg, gg = one_step(pkg, cfg, sd, batch, on_card, dev)
    _, _, gg2 = one_step(pkg, cfg, sd, batch, on_card, dev)
    l64, _, g64 = one_step(pkg, cfg, sd, batch, lambda g, f, l: aug, "cpu", torch.float64)
    _, _, gg64 = one_step(pkg, cfg, sd, batch, lambda g, f, l: aug.to(dev), dev, torch.float64)
    stepped = {}
    for name, flags in (SPREAD_VARIANT,) + tuple(v for v in variants if v != SPREAD_VARIANT):
        with torch.backends.cudnn.flags(**{"allow_tf32": False, **flags}):
            stepped[name] = one_step(pkg, cfg, sd, batch, on_card, dev)[2]
    res = {
        "loss_cpu": lc, "loss_card": lg, "loss_f64": l64,
        "loss_rel_err": abs(lg - lc) / abs(lc),
        "grad_max_rel_err": 0.0, "grad_max_rel_err_at": None,
        "grad_card_vs_f64": 0.0, "grad_card_vs_f64_at": None,
        "grad_cpu_vs_f64": 0.0, "grad_cpu_vs_f64_at": None,
        "grad_card_vs_card": 0.0, "grad_card_vs_card_at": None,
        "key_bias_grad_rel": 0.0, "update_max_abs_err": 0.0,
        "param_max_abs_err": 0.0, "param_entries": 0, "entries": 0,
    }

    def worst(key, value, k):
        if value > res[key]:
            res[key], res[key + "_at"] = value, k

    g_max = max(float(g.abs().max()) for g in gc.values())
    for k in pc:
        scale, scale64 = float(gc[k].abs().max()), float(g64[k].abs().max())
        res["entries"] += pc[k].numel()
        if k.endswith("attn.key.bias"):
            noise = max(scale, float(gg[k].abs().max())) / g_max
            res["key_bias_grad_rel"] = max(res["key_bias_grad_rel"], noise)
        elif scale > 0:
            worst("grad_max_rel_err", float((gg[k] - gc[k]).abs().max()) / scale, k)
            worst("grad_card_vs_f64", float((gg[k] - g64[k]).abs().max()) / scale64, k)
            worst("grad_cpu_vs_f64", float((gc[k] - g64[k]).abs().max()) / scale64, k)
            worst("grad_card_vs_card", float((gg2[k] - gg[k]).abs().max()) / scale, k)
            held = torch.minimum(gc[k].abs(), gg[k].abs()) >= max(1e-2 * scale, 1e-6)
            res["param_entries"] += int(held.sum())
            if held.any():
                d = float((pg[k] - pc[k]).abs()[held].max())
                res["param_max_abs_err"] = max(res["param_max_abs_err"], d)
        own_c, own_g = adamw_first_step(sd[k], gc[k]), adamw_first_step(sd[k], gg[k])
        res["update_max_abs_err"] = max(
            res["update_max_abs_err"],
            float((pc[k].double() - own_c).abs().max()),
            float((pg[k].double() - own_g).abs().max()),
        )
    witness = {k: v for k, v in g64.items() if not k.endswith("attn.key.bias")}
    d_card, d_cpu = grad_distances(gg, witness), grad_distances(gc, witness)
    spread = grad_distances(gg, witness, stepped[SPREAD_VARIANT[0]])
    grad_ok, readings = grad_criterion(
        d_card, d_cpu, grad_distances(gg64, witness), spread
    )
    res.update(readings)
    at = max(d_card, key=d_card.get)
    res["grad_at_worst"] = {
        "tensor": at, "card": d_card[at], "cpu": d_cpu[at], "spread": spread[at],
    }
    for name, _ in variants:
        dv = grad_distances(stepped[name], witness)
        worst_v = max(dv, key=dv.get)
        res[f"grad_{name}_vs_f64"], res[f"grad_{name}_vs_f64_at"] = dv[worst_v], worst_v
        res["grad_at_worst"][name] = dv[at]
    failed = [
        name for name, ok in (
            ("loss", res["loss_rel_err"] <= 1e-4),
            ("grad", res["grad_max_rel_err"] <= 1e-3 or not hold_gap),
            ("grad_vs_f64", grad_ok),
            ("key_bias", res["key_bias_grad_rel"] <= 1e-3),
            ("update", res["update_max_abs_err"] <= 1e-6),
            ("params", res["param_max_abs_err"] <= 1e-4 and res["param_entries"] > 0),
        ) if not ok
    ]
    return res, failed


def train_inputs(img, cfg, dev="cuda", T=T_TRAIN, U=U_TRAIN):
    """The step's batch: the first 8 utterances of the training batch, made
    ragged, and SpecAugment's apply arguments for it. The warp grid is
    solved once, on the CPU, and every step applies its lerp indices and
    weights through ``spec_augment_apply`` (on the card, the kernel): each
    device's own solve rounds differently, and at 1000 frames that moves a
    lerp by up to about 1e-3, enough to move the gradients of a loss this
    large by more than the float32 products do."""
    feats, feat_lens, refs, ref_lens = (
        a[:8].cpu() for a in make_train_batch(cfg, dev, T=T, U=U)
    )
    feat_lens = feat_lens - torch.arange(8) * (T // 16)  # ragged
    ref_lens = ref_lens - torch.arange(8) * (U // 12)
    gen = torch.Generator().manual_seed(SEED + 6)
    p = img.spec_augment_draw_parameters(gen, feats, *SA_DRAW, lengths=feat_lens)
    T, F = feats.shape[1:]
    grid = img.warp_1d_grid(p[0], p[1], feat_lens, T)
    sa_args = list(img._axis_lerp_weights(grid, T)) + [
        img._span_mask(p[4], p[5], T), img._span_mask(p[6], p[7], F)
    ]
    return (feats, feat_lens, refs, ref_lens), sa_args


def train_step_check(pkg, kernels, model, seeded=True, variants=(), dev="cuda", T=T_TRAIN,
                     U=U_TRAIN, replay=None):
    """A float32, dropout-0, 2-layer copy of ``model`` (its subsampler,
    first two blocks and CTC head, as the card trained them) takes one step
    on the card and one on the CPU, with a float64 witness
    (:func:`step_check`, the card's gradients held to the witness); so do,
    with ``seeded``, the seeded weights of that configuration (held to the
    CPU's gradients as well). The readings of each, with the checks that
    failed under ``failed``. ``dev``, ``T`` and ``U`` shrink it to a
    rehearsal on the CPU. ``replay``, when given, makes a context for each
    weight set's steps (``ReplayedRouting``), whose ``flips`` join the
    readings."""
    _, ConformerCTC, _, _, img = pkg
    cfg = dataclasses.replace(model.cfg, num_layers=2, dropout=0.0, dtype=torch.float32)
    keep = ("subsample.", "block_0.", "block_1.", "ctc_head.")
    weights = {
        "trained": {k: v.cpu() for k, v in model.state_dict().items() if k.startswith(keep)},
    }
    if seeded:
        weights["seeded"] = ConformerCTC(
            cfg, device="cpu", generator=torch.Generator().manual_seed(SEED)
        ).state_dict()
    batch, sa_args = train_inputs(img, model.cfg, dev, T, U)
    out = {}
    for name, sd in weights.items():
        ctx = replay() if replay else None
        with ctx or contextlib.nullcontext():
            res, failed = step_check(
                pkg, kernels, cfg, sd, batch, sa_args, name == "seeded", variants, dev
            )
        if ctx is not None:
            res["routing_flips"] = ctx.flips
        out[name] = {"batch": 8, **res, "failed": failed}
    return out


def phase_train_witness(pkg, kernels, runs):
    """``--train-witness N``: phase 5's model trained N times, from seeds
    SEED, SEED + 1, ..., each time followed by the step check at its
    trained weights, with the card's step again under each of
    ``CUDNN_VARIANTS``; one line each, and no check raises, so that every
    run's readings show."""
    sets = []
    for i in range(runs):
        model, *_, losses, _, _, _ = trained_model(pkg, kernels, SEED + i)
        check = train_step_check(pkg, kernels, model, seeded=False, variants=CUDNN_VARIANTS)
        emit({"phase": "train_witness", "seed": SEED + i, "losses": losses, **check})
        trained = check["trained"]
        sets.append({"seed": SEED + i, "failed": trained["failed"],
                     "card64": trained["grad_card64_vs_f64"],
                     "card_worst": trained["grad_card_vs_f64"],
                     "card_worst_at": trained["grad_card_vs_f64_at"],
                     **trained["grad_vs_f64_worst"]})
        del model
    emit({"phase": "train_witness_summary", "sets": runs,
          "passed": sum(not st["failed"] for st in sets), "worst_per_set": sets})


def trained_model(pkg, kernels, seed=SEED):
    """Phase 5's model, seeded from ``seed``, after ``TRAIN_STEPS`` steps;
    its step, batch and generator, the losses, the launches in those steps,
    their wall seconds and the peak memory."""
    ConformerConfig, ConformerCTC, adamw, make_train_step, img = pkg
    cfg = ConformerConfig(
        vocab_size=1024, num_filts=80, d_model=512, num_layers=8, num_heads=8,
        dropout=0.1, attn_dropout=0.0,
    )
    model = ConformerCTC(cfg, device="cuda", generator=torch.Generator().manual_seed(seed))
    step = make_train_step(
        model, adamw(model.parameters(), LR),
        lambda g, f, l: img.spec_augment(g, f, lengths=l.float(), **SA_ARGS),
    )
    batch = make_train_batch(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    losses = [float(step(gen, *batch)) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    first_pass_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    return model, step, batch, gen, losses, launches, first_pass_s, peak


def phase_train(pkg, kernels):
    model, step, batch, gen, losses, launches, first_pass_s, peak = trained_model(pkg, kernels)
    if launches["spec_augment_apply"] != TRAIN_STEPS:
        raise AssertionError(f"spec_augment_apply launches {launches}, expected {TRAIN_STEPS}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite and falling: {losses}")
    check = train_step_check(pkg, kernels, model)
    failed = {name: res["failed"] for name, res in check.items() if res["failed"]}
    if failed:
        raise AssertionError(f"train step on the card vs the CPU: {failed} failed: {check}")

    from torch.utils.flop_counter import FlopCounterMode

    (step_ms,), runs = host_ms([lambda: step(gen, *batch)])
    with FlopCounterMode(display=False) as counter:
        step(gen, *batch)
    flops = counter.get_total_flops()
    emit({
        "phase": "train", "model": "ConformerCTC d512 L8 H8 V1024 bf16, dropout 0.1",
        "batch": B_TRAIN, "t_raw": T_TRAIN, "u": U_TRAIN, "spec_augment": SA_ARGS,
        "lr": LR, "losses": losses, "launches": launches,
        "first_steps_s": first_pass_s, "peak_mem_bytes": peak,
        "card_vs_cpu_step": check,
        "step_ms": step_ms, "step_runs_ms": runs[0], "steps_per_s": 1e3 / step_ms,
        "flops_per_step": flops, "model_tflops_per_s": flops / step_ms / 1e9,
        "bf16_peak_share": flops / step_ms / 1e9 / (BF16_OPS_PER_S / 1e12),
    })
    return model, step, batch, gen, launches


def sa_times(kernels, img):
    """The SpecAugment kernel at the training shape, float32 feats, and its
    own time with the same inputs in bfloat16."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    N, T, F = B_TRAIN, T_TRAIN, 80
    feats = torch.randn((N, T, F), generator=gen, device="cuda")
    lens = torch.full((N,), T, device="cuda")
    p = img.spec_augment_draw_parameters(gen, feats, *SA_DRAW, lengths=lens)
    grid = img.warp_1d_grid(p[0], p[1], lens, T)
    args = list(img._axis_lerp_weights(grid, T)) + [
        img._span_mask(p[4], p[5], T), img._span_mask(p[6], p[7], F)
    ]
    wrapper = cuda_ms(lambda: kernels.spec_augment_apply(feats, *args))
    counted = dict(count=lambda: kernels.LAUNCHES["spec_augment_apply"])
    own = device_ms(cold(lambda: kernels.spec_augment_apply(feats, *args)), "sa_kernel",
                    **counted)
    traces, notes = TRACES["sa_kernel"], TRACE_NOTES.get("sa_kernel")
    bf16 = feats.bfloat16()
    own_bf16 = device_ms(cold(lambda: kernels.spec_augment_apply(bf16, *args)), "sa_kernel",
                         **counted)
    bound = sa_bound_ms(feats, *args)
    bound_bf16 = sa_bound_ms(bf16, *args)
    return {
        "ms": wrapper if own is None else own,
        "ms_from": "cuda_events" if own is None else "profiler, L2 flushed",
        "traces": traces, "trace_notes": notes,
        "wrapper_ms": wrapper,
        "plain_ms": cuda_ms(lambda: kernels.spec_augment_apply_reference(feats, *args)),
        "bound_ms": bound[0], "bound_by": bound[1],
        "library_ms": None, "library": "none: no single PyTorch call warps and masks",
        "shape": [N, T, F], "dtype": "float32",
        "time_masked_share": float(args[4].float().mean()),
        "bf16_ms": own_bf16, "bf16_traces": TRACES["sa_kernel"],
        "bf16_bound_ms": bound_bf16[0],
    }


def phase_score(pkg, kernels, logits, out_lens):
    """BASELINE config #2's scoring: greedy decode of the model's logits
    for the first served request (32 utterances, T' = 500, V = 1024),
    hypotheses padded with -1, then error_rate against 40-token
    references. Every hypothesis must hold tokens, so that the DP runs.
    (The trained model, after 5 steps on random data, emits only blanks.)"""
    ctc_greedy_search, error_rate = pkg
    V = logits.shape[-1] - 1
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    refs = torch.randint(0, V, (R_SCORE, B_TRAIN), generator=gen, device="cuda", dtype=torch.int32)

    def score():
        _, y, y_lens = ctc_greedy_search(logits, out_lens, batch_first=True)
        y = y.T  # (S, N)
        S = y.shape[0]
        y = torch.where(torch.arange(S, device=y.device)[:, None] < y_lens[None], y, -1)
        return error_rate(refs, y, eos=-1, norm=False, warn=False), y, y_lens

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    er, y, y_lens = score()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if launches["edit_distance"] != 1:
        raise AssertionError(f"edit_distance launches {launches}, expected 1")
    assert tuple(logits.shape) == (B_TRAIN, 500, V + 1)
    if not int(y_lens.min()) > 0:
        raise AssertionError(f"empty hypotheses leave the DP nothing to do: {y_lens.tolist()}")
    assert er.shape == (B_TRAIN,) and bool(torch.isfinite(er).all()) and bool((er >= 0).all())
    cpu = error_rate(refs.cpu(), y.cpu(), eos=-1, norm=False, warn=False)
    if not torch.equal(er.cpu(), cpu):
        raise AssertionError("error_rate on the card differs from the CPU's")
    (score_ms,), runs = host_ms([score])

    ref_lens = torch.full((B_TRAIN,), R_SCORE, device="cuda", dtype=torch.int32)
    hyp_lens = y_lens.int()
    ed = (refs, y.int(), ref_lens, hyp_lens, 1.0, 1.0, 1.0)  # as the kernel takes them
    wrapper = cuda_ms(lambda: kernels.edit_distance(*ed))
    own = device_ms(cold(lambda: kernels.edit_distance(*ed)), "ed_wave",
                    count=lambda: kernels.LAUNCHES["edit_distance"])
    bound = ed_bound_ms(R_SCORE, B_TRAIN, hyp_lens)
    times = {
        "ms": wrapper if own is None else own,
        "ms_from": "cuda_events" if own is None else "profiler, L2 flushed",
        "traces": TRACES["ed_wave"],
        "trace_notes": TRACE_NOTES.get("ed_wave"),
        "wrapper_ms": wrapper,
        "plain_ms": cuda_ms(lambda: kernels.edit_distance_reference(*ed), inner=2),
        "bound_ms": bound[0], "bound_by": bound[1],
        "library_ms": None, "library": "none: no single PyTorch call computes edit distances",
        "shape": [R_SCORE, int(y.shape[0]), B_TRAIN],
        "dp_steps": int(hyp_lens.sum()),
        "critical_path_cells": int(hyp_lens.max()) + R_SCORE,
        "wavefront_steps": ed_wavefront_steps(kernels.load_library(), R_SCORE, hyp_lens),
    }
    times["us_per_wavefront_step"] = times["ms"] * 1e3 / times["wavefront_steps"]
    emit({
        "phase": "score", "utterances": B_TRAIN, "t_prime": int(logits.shape[1]),
        "refs": [R_SCORE, B_TRAIN], "launches": launches,
        "hyp_len_min": int(y_lens.min()), "hyp_len_mean": float(y_lens.float().mean()),
        "hyp_len_max": int(y_lens.max()),
        "error_rate_sum": float(er.sum()), "equals_cpu": True,
        "score_ms": score_ms, "score_runs_ms": runs[0], "peak_mem_bytes": peak,
    })
    return launches, times


# BASELINE config #5: bench.py's bench_seq2seq_mer_step (bench.py:749-788)
# and bench_ngram_beam_search (bench.py:462-494)
S2S_B, S2S_T, S2S_F, S2S_V = 16, 200, 40, 64
S2S_WIDTH, S2S_ITERS, S2S_EOS, S2S_HEAD = 16, 16, 63, 4.0
MER_SAMPLES, MER_R, MER_STEPS = 4, 12, 5
NGRAM_B, NGRAM_W, NGRAM_S, NGRAM_EOS = 32, 16, 100, 7


def s2s_inputs():
    """bench_seq2seq_mer_step's batch: feats (16, 200, 40) and 12-token
    references from ``RandomState(13)``, in that order."""
    rng = np.random.RandomState(13)
    feats = torch.from_numpy(rng.randn(S2S_B, S2S_T, S2S_F).astype(np.float32))
    refs = torch.from_numpy(rng.randint(0, S2S_V - 1, (S2S_B, MER_R)).astype(np.int64))
    feat_lens = torch.full((S2S_B,), S2S_T)
    ref_lens = torch.full((S2S_B,), MER_R)
    return feats, feat_lens, refs, ref_lens


def s2s_model(s2s, device, seed=SEED):
    """``Seq2SeqConfig(vocab_size=64, num_filts=40)`` (hidden 128, embed 64,
    attention 128), seeded."""
    AttentionSeq2Seq, Seq2SeqConfig = s2s[:2]
    cfg = Seq2SeqConfig(vocab_size=S2S_V, num_filts=S2S_F)
    return AttentionSeq2Seq(cfg, device=device, generator=torch.Generator().manual_seed(seed))


def counting(obj, name):
    """Count the calls of ``obj.name`` (an instance attribute shadows the
    method); returns the counter, a one-item list."""
    n = [0]
    fn = getattr(obj, name)

    def wrapped(*args, **kwargs):
        n[0] += 1
        return fn(*args, **kwargs)

    setattr(obj, name, wrapped)
    return n


def phase_s2s_serve(s2s, kernels):
    """Attention seq2seq served: bench_seq2seq_mer_step's model (output
    layer x4, so decisions are decisive as a trained model's), 16
    utterances of 200 frames, ``BeamSearch(Seq2SeqDecoderLM, 16,
    eos=63)`` over 16 steps. The card's hypotheses and lengths must equal
    a CPU decode's with a copy of the weights, log probabilities within
    rtol 1e-4. The serve (encode and search) and decode wall times, and
    the search's launches a step from a trace."""
    _, _, Seq2SeqDecoderLM, BeamSearch = s2s[:4]
    model = s2s_model(s2s, "cuda")
    with torch.no_grad():
        model.decoder_step.out.weight.mul_(S2S_HEAD)
    cpu_model = s2s_model(s2s, "cpu")
    cpu_model.load_state_dict(model.state_dict())
    feats, lens, _, _ = s2s_inputs()

    def serve(m, f, l):
        lm = Seq2SeqDecoderLM(m)
        state = lm.initial_state(f, l)
        return BeamSearch(lm, S2S_WIDTH, eos=S2S_EOS)(state, S2S_B, S2S_ITERS)

    feats_c, lens_c = feats.cuda(), lens.cuda()
    with torch.no_grad():
        kernels.reset_launches()
        got = serve(model, feats_c, lens_c)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        exp = serve(cpu_model, feats, lens)
    check = search_compare(tuple(t.cpu() for t in got), exp, 1e-4)
    if not check["ok"]:
        raise AssertionError(f"seq2seq serve: the card's beams vs the CPU's: {check}")
    y, y_lens, lp = got
    if not (bool(torch.isfinite(lp[:, 0]).all()) and int(y_lens[:, 0].min()) > 0):
        raise AssertionError("seq2seq serve: a best path is empty or not finite")

    lm = Seq2SeqDecoderLM(model)
    with torch.no_grad():
        state = lm.initial_state(feats_c, lens_c)
        search = BeamSearch(lm, S2S_WIDTH, eos=S2S_EOS)
        steps = counting(lm, "calc_idx_log_probs")
        search(state, S2S_B, S2S_ITERS)
        n_steps = steps[0]
        decode = lambda: search(state, S2S_B, S2S_ITERS)  # noqa: E731
        (serve_ms, dec_ms), runs = host_ms(
            [lambda: serve(model, feats_c, lens_c), decode], reps=5
        )
        profiled = trace(decode)
    emit({
        "phase": "s2s_serve", "nvidia_smi": smi_line(),
        "model": "AttentionSeq2Seq V64 F40 hidden 128 embed 64 attention 128, output x4",
        "batch": S2S_B, "frames": S2S_T, "width": S2S_WIDTH, "eos": S2S_EOS,
        "max_iters": S2S_ITERS, "steps": n_steps, "launches": launches,
        "vs_cpu_decode": check, "best_len_mean": float(y_lens[:, 0].float().mean()),
        "serve_ms": serve_ms, "decode_ms": dec_ms, "utt_per_s": S2S_B / (serve_ms / 1e3),
        "runs_ms": {"serve": runs[0], "decode": runs[1]},
        "decode_trace": {k: profiled[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                                   "kernel_launches", "top_kernels")},
        "launches_per_step": profiled["kernel_launches"] / n_steps,
    })


def phase_ngram_beam(LookupLanguageModel, BeamSearch, kernels, config):
    """bench_ngram_beam_search's case: bench.py's 3-gram built with
    ``RandomState(4)`` on the card, ``BeamSearch(lm, 16, eos=7)`` over 32
    rows of 100 steps: the sparse route. Lengths and tokens must equal a CPU
    copy's search, log probabilities within rtol 1e-5; with
    ``config.SPARSE_MEMBERSHIP_GATHER`` on, which BeamSearch does not read
    (ROADMAP C12), every output bit-equal to the flag off.
    Utterances a second and launches a step."""
    lm = bench_lm(LookupLanguageModel, seed=4)
    search = BeamSearch(lm, NGRAM_W, eos=NGRAM_EOS)
    if not search.takes_sparse_route():
        raise AssertionError("the bench 3-gram does not take BeamSearch's sparse route")
    kernels.reset_launches()
    got = search(batch_size=NGRAM_B, max_iters=NGRAM_S)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    exp = BeamSearch(cpu_copy(LookupLanguageModel, lm), NGRAM_W, eos=NGRAM_EOS)(
        batch_size=NGRAM_B, max_iters=NGRAM_S
    )
    check = search_compare(tuple(t.cpu() for t in got), exp, 1e-5)
    if not check["ok"]:
        raise AssertionError(f"n-gram beam search: the card's beams vs the CPU's: {check}")
    old, config.SPARSE_MEMBERSHIP_GATHER = config.SPARSE_MEMBERSHIP_GATHER, True
    try:
        flagged = search(batch_size=NGRAM_B, max_iters=NGRAM_S)
    finally:
        config.SPARSE_MEMBERSHIP_GATHER = old
    if not all(torch.equal(a, b) for a, b in zip(flagged, got)):
        raise AssertionError("n-gram beam search: the gather flag changed BeamSearch's output")
    steps = counting(lm, "sparse_corrections_ext")
    run = lambda: search(batch_size=NGRAM_B, max_iters=NGRAM_S)  # noqa: E731
    run()
    n_steps = steps[0]
    (ms,), runs = host_ms([run], reps=5)
    profiled = trace(run)
    emit({
        "phase": "ngram_beam", "nvidia_smi": smi_line(),
        "lm": {"kind": "bench.py 3-gram, RandomState(4)", "vocab": lm.vocab_size,
               "max_corrections": lm.max_corrections},
        "route": "sparse", "batch": NGRAM_B, "width": NGRAM_W, "max_iters": NGRAM_S,
        "eos": NGRAM_EOS, "steps": n_steps, "launches": launches, "vs_cpu": check,
        "gather_flag_bit_equal": True,
        "best_len_mean": float(got[1][:, 0].float().mean()),
        "search_ms": ms, "runs_ms": runs[0], "utt_per_s": NGRAM_B / (ms / 1e3),
        "trace": {k: profiled[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                            "kernel_launches", "top_kernels")},
        "launches_per_step": profiled["kernel_launches"] / n_steps,
    })


@contextlib.contextmanager
def recording(decoding, kernels, replay=None):
    """Record, while it lasts, every sample the MER step draws and every
    edit-distance kernel call (its arguments and result); with ``replay``,
    a list of samples, the sampler returns those instead of drawing."""
    walks, eds = [], []
    walk_cls, ed = decoding.RandomWalk, kernels.edit_distance

    class Walk(walk_cls):
        def __call__(self, generator, initial_state=None, batch_size=None, max_iters=None):
            if replay is not None:
                y, y_lens = replay[len(walks)]
                out = (y, y_lens, torch.zeros(batch_size))
            else:
                out = super().__call__(generator, initial_state, batch_size, max_iters)
            walks.append((out[0].cpu(), out[1].cpu()))
            dev = initial_state["hidden"].device
            return tuple(t.to(dev) for t in out)

    def edit_distance(*args):
        out = ed(*args)
        eds.append((args, out))
        return out

    decoding.RandomWalk, kernels.edit_distance = Walk, edit_distance
    try:
        yield walks, eds
    finally:
        decoding.RandomWalk, kernels.edit_distance = walk_cls, ed


def mer_step_on(s2s, decoding, kernels, sd, batch, replay, dtype=torch.float32):
    """One MER step on the CPU from weights ``sd`` with the card's samples:
    its loss and gradients."""
    make_mer_train_step, adam = s2s[4:6]
    model = s2s_model(s2s, "cpu").to(dtype)
    model.load_state_dict(sd)
    step = make_mer_train_step(model, adam(model.parameters(), LR), MER_SAMPLES,
                               S2S_ITERS, S2S_EOS)
    feats, *rest = batch
    with recording(decoding, kernels, replay):
        loss = step(None, feats.to(dtype), *rest)
    return float(loss), {k: p.grad.clone() for k, p in model.named_parameters()}


def phase_s2s_train(s2s, decoding, kernels):
    """BASELINE config #5, bench_seq2seq_mer_step's step: 4 samples an
    utterance from ``RandomWalk`` (eos 63, 16 steps), the model's
    log-probabilities, the MER loss against 12-token references (its error
    rates through the edit-distance kernel, R=12, H=16, N=64) and Adam at
    1e-3, 5 steps. Each step must launch the kernel once and give a finite
    loss; every kernel call's result must equal its plain version on the
    same inputs, bit for bit. The first step, given the card's samples,
    runs again on the CPU from the same weights: loss within rtol 1e-5 and
    every gradient within 1e-4 of its tensor's largest entry (a float64
    CPU step beside them, the witness). Then step ms, launches a step, and
    the kernel's own time at that shape beside its bound."""
    make_mer_train_step, adam = s2s[4:6]
    model = s2s_model(s2s, "cuda", SEED + 1)
    step = make_mer_train_step(model, adam(model.parameters(), LR), MER_SAMPLES,
                               S2S_ITERS, S2S_EOS)
    batch = s2s_inputs()
    batch_c = [a.cuda() for a in batch]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    sd0 = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    losses, per_step = [], []
    with recording(decoding, kernels) as (walks, eds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(MER_STEPS):
            kernels.reset_launches()
            losses.append(float(step(gen, *batch_c)))
            per_step.append(kernels.LAUNCHES["edit_distance"])
            if i == 0:
                grads_card = {k: p.grad.cpu() for k, p in model.named_parameters()}
        first_steps_s = time.perf_counter() - t0
    launches = {"edit_distance": sum(per_step)}
    if per_step != [1] * MER_STEPS or len(eds) != MER_STEPS:
        raise AssertionError(f"edit_distance launches a step {per_step}, expected 1 each")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"MER losses not finite: {losses}")
    for args, out in eds:
        cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
        if not torch.equal(out.cpu(), kernels.edit_distance_reference(*cpu_args)):
            raise AssertionError("edit_distance in the MER step differs from its plain version")

    # the first step again on the CPU, with the card's samples
    lc, gc = mer_step_on(s2s, decoding, kernels, sd0, batch, walks[:1])
    sd64 = {k: v.double() for k, v in sd0.items()}
    l64, g64 = mer_step_on(s2s, decoding, kernels, sd64, batch, walks[:1], torch.float64)
    grad_err, grad_err_at = worst_rel((k, grads_card[k], g) for k, g in gc.items())
    card64, cpu64 = 0.0, 0.0
    for k, g in gc.items():
        s64 = float(g64[k].abs().max())
        if s64 > 0:
            card64 = max(card64, float((grads_card[k].double() - g64[k]).abs().max()) / s64)
            cpu64 = max(cpu64, float((g.double() - g64[k]).abs().max()) / s64)
    check = {
        "loss_card": losses[0], "loss_cpu": lc, "loss_f64": l64,
        "loss_rel_err": abs(losses[0] - lc) / abs(lc),
        "grad_max_rel_err": grad_err, "grad_max_rel_err_at": grad_err_at,
        "grad_card_vs_f64": card64, "grad_cpu_vs_f64": cpu64,
    }
    if not (check["loss_rel_err"] <= 1e-5 and grad_err <= 1e-4):
        raise AssertionError(f"MER step on the card vs the CPU: {check}")

    (step_ms,), runs = host_ms([lambda: step(gen, *batch_c)])
    profiled = trace(lambda: step(gen, *batch_c))
    args = eds[-1][0]
    ref, hyp, ref_lens, hyp_lens = args[:4]
    wrapper = cuda_ms(lambda: kernels.edit_distance(*args))
    own = device_ms(cold(lambda: kernels.edit_distance(*args)), "ed_wave",
                    count=lambda: kernels.LAUNCHES["edit_distance"])
    bound = ed_bound_ms(ref.shape[0], ref.shape[1], hyp_lens)
    times = {
        "ms": wrapper if own is None else own,
        "ms_from": "cuda_events" if own is None else "profiler, L2 flushed",
        "traces": TRACES["ed_wave"],
        "trace_notes": TRACE_NOTES.get("ed_wave"),
        "wrapper_ms": wrapper,
        "plain_ms": cuda_ms(lambda: kernels.edit_distance_reference(*args), inner=2),
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
        "shape": [int(ref.shape[0]), int(hyp.shape[0]), int(ref.shape[1])],
        "dp_steps": int(hyp_lens.sum()),
        "critical_path_cells": int(ref.shape[0]) + int(hyp.shape[0]) - 1,
        "wavefront_steps": ed_wavefront_steps(kernels.load_library(), ref.shape[0], hyp_lens),
        "launches": launches["edit_distance"],
    }
    emit({
        "phase": "s2s_train", "nvidia_smi": smi_line(),
        "model": "AttentionSeq2Seq V64 F40 hidden 128 embed 64 attention 128",
        "batch": S2S_B, "frames": S2S_T, "samples": MER_SAMPLES, "refs": MER_R,
        "max_iters": S2S_ITERS, "eos": S2S_EOS, "lr": LR, "losses": losses,
        "launches": launches, "edit_distance_launches_per_step": per_step,
        "edit_distance_equals_plain": True, "first_steps_s": first_steps_s,
        "card_vs_cpu_step": check,
        "step_ms": step_ms, "step_runs_ms": runs[0], "steps_per_s": 1e3 / step_ms,
        "step_trace": {k: profiled[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                                 "kernel_launches", "top_kernels")},
        "edit_distance": times,
    })
    return launches, times


# ---------------------------------------------------------------------------
# The Conformer-Transducer: bench_transducer_greedy's model (bench.py:670-705)
# served greedily and by beam search (bare and LM-fused), the causal config
# of bench_streaming_rnnt_chunk (bench.py:708-746) streamed, and the model's
# training step. No hand-written kernel lies on these paths: each phase
# reports launches and host syncs, since the loops are eager.

RNNT_V, RNNT_B, RNNT_T, RNNT_REQUESTS, RNNT_U = 1024, 32, 500, 3, 8
RNNT_GREEDY_E, RNNT_W, RNNT_BEAM_E, RNNT_LM_WEIGHT = 2, 4, 4, 0.3
RNNT_CHUNK, RNNT_WARM, RNNT_TIMED = 8, 4, 12
RNNT_STEPS = 5
# The decoding phases' joint output layer, scaled as the CTC phases scale
# their head, with the blank's bias raised: the seeded layer emits a token
# at almost every decision (2 a frame greedily, 4 in the beam), so beams
# carry scores near -7,000 whose float32 rounding (card and CPU apart by up
# to 0.08) is wider than the gaps between them, and the beams part. Scaled
# and biased, the greedy search emits about 12 tokens in 125 frames (the
# bench's references hold 8) and the beams rank decisively, as a trained
# model's would.
RNNT_JOINT_SCALE, RNNT_BLANK_BIAS = 32.0, 72.0


def rnnt_cfg(pkg, causal=False, dtype=torch.bfloat16, dropout=0.1):
    """bench.py's transducer: d256, 4 layers, 4 heads, V=1024, 80 filters,
    ``pred_dim = joint_dim = 256``, the encoder in ``dtype`` (the config's
    default, bfloat16); causal as bench_streaming_rnnt_chunk's."""
    ConformerConfig, TransducerConfig = pkg[:2]
    extra = dict(attention_context=STREAM_CONTEXT, causal_conv=True) if causal else {}
    enc = ConformerConfig(vocab_size=RNNT_V, num_filts=80, d_model=256, num_layers=4,
                          num_heads=4, dtype=dtype, dropout=dropout, **extra)
    return TransducerConfig(encoder=enc, pred_dim=256, joint_dim=256)


def rnnt_model(pkg, cfg, device, sd=None, decisive=False):
    """The model, seeded, or loaded from ``sd``; with ``decisive`` its
    joint's output layer scaled by ``RNNT_JOINT_SCALE`` and the blank's
    bias raised by ``RNNT_BLANK_BIAS``."""
    model = pkg[2](cfg, device=device, generator=torch.Generator().manual_seed(SEED))
    if sd is not None:
        model.load_state_dict(sd)
    if decisive:
        with torch.no_grad():
            model.joint.out.weight.mul_(RNNT_JOINT_SCALE)
            model.joint.out.bias[cfg.vocab_size] += RNNT_BLANK_BIAS
    return model


def rnnt_requests():
    """``RNNT_REQUESTS`` requests of B=32 utterances of 500 raw frames
    (bench_transducer_greedy's full lengths), made on the card from a
    seed."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    return [
        (torch.randn((RNNT_B, RNNT_T, 80), generator=gen, device="cuda"),
         torch.full((RNNT_B,), RNNT_T, device="cuda"))
        for _ in range(RNNT_REQUESTS)
    ]


def syncs(fn):
    """``fn()``'s result and the host syncs it made, counted by CUDA's
    synchronization debug mode."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def hyps_compare(got, exp, score_rtol=None):
    """Lengths and every emitted token exact, beam scores within
    ``score_rtol`` and atol 1e-4; the first utterance that differs."""
    lens_g, lens_e = got[1].cpu(), exp[1].cpu()
    res = {"utterances": int(lens_e.shape[0]), "ok": True, "first_mismatch": None,
           "tokens": int(lens_e.sum())}
    pos = torch.arange(got[0].shape[-1])
    for n in range(lens_e.shape[0]):
        hg, he = got[0][n].cpu(), exp[0][n].cpu()
        mask = pos < lens_e[n][..., None]
        if not (torch.equal(lens_g[n], lens_e[n])
                and torch.equal(torch.where(mask, hg, -1), torch.where(mask, he, -1))):
            res.update(ok=False, first_mismatch=n)
            break
    if score_rtol is not None:
        d = (got[2].cpu() - exp[2].cpu()).abs()
        res["score_max_abs_err"] = float(d.max())
        res["score_max_rel_err"] = float((d / exp[2].cpu().abs()).max())
        res["ok"] = res["ok"] and bool((d <= score_rtol * exp[2].cpu().abs() + 1e-4).all())
    return res


def rnnt_decoders(model):
    """The model's search callables on its own device."""
    return model.predictor.stepper(), model.joint, model.predictor.init_carry


def phase_rnnt_greedy(pkg):
    """bench_transducer_greedy: three requests of 32 utterances (500 raw
    frames, 125 encoded) through ``model.greedy(feats, lens, 2)``; every
    utterance's hypothesis and length (the card's search of the card's
    encoder output) must equal a CPU greedy search of that output with a
    copy of the weights. The joint's output layer is made decisive
    (``RNNT_JOINT_SCALE``, ``RNNT_BLANK_BIAS``). Then the
    encoder, decode and request wall times in turn, utterances a second,
    and the decode's launches a frame, host syncs and idle share."""
    greedy = pkg[4]
    cfg = rnnt_cfg(pkg, dropout=0.0)
    model = rnnt_model(pkg, cfg, "cuda", decisive=True)
    cpu = rnnt_model(pkg, cfg, "cpu", model.state_dict())
    requests = rnnt_requests()
    checks = []
    with torch.no_grad():
        for feats, lens in requests:
            enc, enc_lens = model.encode(feats, lens)
            step, joint, init = rnnt_decoders(model)
            got = greedy(enc, enc_lens, step, joint, init(RNNT_B), RNNT_V, RNNT_GREEDY_E)
            step, joint, init = rnnt_decoders(cpu)
            exp = greedy(enc.cpu(), enc_lens.cpu(), step, joint, init(RNNT_B), RNNT_V,
                         RNNT_GREEDY_E)
            checks.append(hyps_compare(got, exp))
        if not all(c["ok"] for c in checks):
            raise AssertionError(f"rnnt greedy: the card's hypotheses vs the CPU's: {checks}")
        feats, lens = requests[0]
        enc, enc_lens = model.encode(feats, lens)
        step, joint, init = rnnt_decoders(model)
        decode = lambda: greedy(enc, enc_lens, step, joint, init(RNNT_B), RNNT_V,  # noqa: E731
                                RNNT_GREEDY_E)
        (enc_ms, dec_ms, req_ms), runs = host_ms([
            lambda: model.encode(feats, lens), decode,
            lambda: model.greedy(feats, lens, RNNT_GREEDY_E),
        ])
        hyps, n_syncs = syncs(decode)
        profiled = trace(decode)
    frames = enc.shape[1]
    emit({
        "phase": "rnnt_greedy", "nvidia_smi": smi_line(),
        "model": "ConformerTransducer d256 L4 H4 V1024 bf16 encoder, pred/joint 256, seeded",
        "joint_out": {"scale": RNNT_JOINT_SCALE, "blank_bias": RNNT_BLANK_BIAS},
        "requests": RNNT_REQUESTS, "batch": RNNT_B,
        "raw_frames": RNNT_T, "frames": frames, "max_symbols_per_frame": RNNT_GREEDY_E,
        "vs_cpu_decode": checks, "hyp_len_mean": float(hyps[1].float().mean()),
        "encoder_ms": enc_ms, "decode_ms": dec_ms, "request_ms": req_ms,
        "utt_per_s": RNNT_B / (req_ms / 1e3),
        "runs_ms": {"encoder": runs[0], "decode": runs[1], "request": runs[2]},
        "decode_syncs": n_syncs,
        "decode_trace": {k: profiled[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                                   "kernel_launches", "top_kernels")},
        "launches_per_frame": profiled["kernel_launches"] / frames,
    })
    return profiled["kernel_launches"] / frames


def phase_rnnt_beam(pkg, LookupLanguageModel):
    """The same model and requests through ``model.beam(width=4,
    max_symbols_per_frame=4)``, bare and fused with bench.py's 3-gram
    (``bench_lm``) at weight 0.3: every utterance's hypotheses and lengths
    must equal a CPU beam search of the card's encoder output (a copy of
    the LM with it), scores within rtol 1e-5 and atol 1e-4 (sums of 500
    rounds of float32 log-probabilities), the joint's output layer made
    decisive as in rnnt_greedy. Then encoder, decode and request wall times,
    and the decode's launches a frame, syncs and idle share, in each
    mode."""
    beam = pkg[5]
    cfg = rnnt_cfg(pkg, dropout=0.0)
    model = rnnt_model(pkg, cfg, "cuda", decisive=True)
    cpu = rnnt_model(pkg, cfg, "cpu", model.state_dict())
    lm = bench_lm(LookupLanguageModel)
    lm_cpu = cpu_copy(LookupLanguageModel, lm)
    fusion = pkg[6]
    requests = rnnt_requests()
    out = {}
    with torch.no_grad():
        for mode, (lm_c, lm_h) in (("bare", (None, None)), ("lm", (lm, lm_cpu))):
            checks = []
            for feats, lens in requests:
                enc, enc_lens = model.encode(feats, lens)
                step, joint, init = rnnt_decoders(model)
                got = beam(enc, enc_lens, step, joint, init(RNNT_B), RNNT_V, RNNT_W,
                           RNNT_BEAM_E, None if lm_c is None else fusion(lm_c, RNNT_B),
                           RNNT_LM_WEIGHT)
                step, joint, init = rnnt_decoders(cpu)
                exp = beam(enc.cpu(), enc_lens.cpu(), step, joint, init(RNNT_B), RNNT_V,
                           RNNT_W, RNNT_BEAM_E,
                           None if lm_h is None else fusion(lm_h, RNNT_B), RNNT_LM_WEIGHT)
                checks.append(hyps_compare(got, exp, 1e-5))
            if not all(c["ok"] for c in checks):
                raise AssertionError(f"rnnt beam ({mode}): the card's beams vs the CPU's: {checks}")
            feats, lens = requests[0]
            enc, enc_lens = model.encode(feats, lens)
            step, joint, init = rnnt_decoders(model)
            decode = lambda: beam(  # noqa: E731
                enc, enc_lens, step, joint, init(RNNT_B), RNNT_V, RNNT_W, RNNT_BEAM_E,
                None if lm_c is None else fusion(lm_c, RNNT_B), RNNT_LM_WEIGHT,
            )
            (enc_ms, dec_ms, req_ms), runs = host_ms([
                lambda: model.encode(feats, lens), decode,
                lambda: model.beam(feats, lens, RNNT_W, RNNT_BEAM_E, lm=lm_c,
                                   lm_weight=RNNT_LM_WEIGHT),
            ], reps=5)
            res, n_syncs = syncs(decode)
            profiled = trace(decode)
            frames = enc.shape[1]
            out[mode] = {
                "vs_cpu_decode": checks, "best_len_mean": float(res[1][:, 0].float().mean()),
                "encoder_ms": enc_ms, "decode_ms": dec_ms, "request_ms": req_ms,
                "utt_per_s": RNNT_B / (req_ms / 1e3),
                "runs_ms": {"encoder": runs[0], "decode": runs[1], "request": runs[2]},
                "decode_syncs": n_syncs,
                "decode_trace": {k: profiled[k] for k in (
                    "wall_ms", "device_busy_ms", "idle_share", "kernel_launches", "top_kernels")},
                "launches_per_frame": profiled["kernel_launches"] / frames,
                "launches_per_round": profiled["kernel_launches"] / (frames * RNNT_BEAM_E),
            }
    emit({
        "phase": "rnnt_beam", "nvidia_smi": smi_line(),
        "model": "ConformerTransducer d256 L4 H4 V1024 bf16 encoder, pred/joint 256, seeded",
        "joint_out": {"scale": RNNT_JOINT_SCALE, "blank_bias": RNNT_BLANK_BIAS},
        "requests": RNNT_REQUESTS, "batch": RNNT_B,
        "raw_frames": RNNT_T, "width": RNNT_W,
        "max_symbols_per_frame": RNNT_BEAM_E,
        "lm": {"kind": "bench.py 3-gram, RandomState(2)", "weight": RNNT_LM_WEIGHT},
        **out,
    })


def rnnt_stream_session(rec, blocks, pushes, times=None):
    """``pushes`` pushes of the raw-frame ``blocks`` in turn, then finish;
    each push's wall ms go to ``times`` after the warm-up pushes."""
    sess = rec.start(blocks[0].shape[0])
    for i in range(pushes):
        t0 = time.perf_counter()
        rec.push(sess, blocks[i % len(blocks)])
        torch.cuda.synchronize()
        if times is not None and i >= RNNT_WARM:
            times.append((time.perf_counter() - t0) * 1e3)
    return rec.finish(sess)


def phase_rnnt_stream(pkg, Recognizer):
    """bench_streaming_rnnt_chunk: the causal config (``attention_context
    = (16, 0)``, ``causal_conv``, R=120) serves 8 streams, chunk 8, pushes
    of 32 raw frames: 4 warm pushes, then 12 timed ones (the push median,
    launches and syncs of one push), then finish. A float32 copy's greedy
    session over the same pushes must finish equal to its one-shot greedy
    decode on the card, and its beam session (W=4) equal to its one-shot
    beam search (scores within rtol 1e-5): the session's state-cached
    chunk encoder and the one-shot encoder sum in other orders, which the
    bfloat16 encoder would round apart. The joint's output layer is made decisive as in rnnt_greedy."""
    cfg = rnnt_cfg(pkg, causal=True, dropout=0.0)
    model = rnnt_model(pkg, cfg, "cuda", decisive=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    B, raw = 8, 4 * RNNT_CHUNK
    blocks = [torch.randn((B, raw, 80), generator=gen, device="cuda") for _ in range(3)]
    pushes = RNNT_WARM + RNNT_TIMED
    max_frames = RNNT_CHUNK * (RNNT_TIMED + 8)
    rec = Recognizer(model, chunk=RNNT_CHUNK, mode="greedy", max_frames=max_frames)
    times = []
    rnnt_stream_session(rec, blocks, pushes, times)
    sess = rec.start(B)
    for i in range(RNNT_WARM):
        rec.push(sess, blocks[i % 3])
    torch.cuda.synchronize()
    _, push_syncs = syncs(lambda: rec.push(sess, blocks[RNNT_WARM % 3]))
    profiled = trace(lambda: rec.push(sess, blocks[0]))

    m32 = rnnt_model(pkg, rnnt_cfg(pkg, causal=True, dtype=torch.float32, dropout=0.0),
                     "cuda", model.state_dict())
    feats = torch.cat([blocks[i % 3] for i in range(pushes)], 1)
    lens = torch.full((B,), feats.shape[1], device="cuda")
    parity = {}
    with torch.no_grad():
        for mode, kw in (("greedy", {}), ("beam", dict(width=RNNT_W))):
            rec32 = Recognizer(m32, chunk=RNNT_CHUNK, mode=mode, max_frames=max_frames, **kw)
            got = rnnt_stream_session(rec32, blocks, pushes)
            if mode == "greedy":
                exp = m32.greedy(feats, lens, rec32.E)
                got = (got[0][:, : exp[0].shape[1]], got[1])
                parity[mode] = hyps_compare(got, exp)
            else:
                exp = m32.beam(feats, lens, RNNT_W, rec32.E)
                got = (got[0][..., : exp[0].shape[2]],) + tuple(got[1:])
                parity[mode] = hyps_compare(got, exp, 1e-5)
    if not all(p["ok"] for p in parity.values()):
        raise AssertionError(f"rnnt stream: finish vs one-shot (float32): {parity}")
    emit({
        "phase": "rnnt_stream", "nvidia_smi": smi_line(),
        "model": "ConformerTransducer d256 L4 H4 V1024 bf16 encoder, causal, seeded",
        "joint_out": {"scale": RNNT_JOINT_SCALE, "blank_bias": RNNT_BLANK_BIAS},
        "attention_context": list(STREAM_CONTEXT), "causal_conv": True, "R": rec.R,
        "cached_encoder": rec.cached, "streams": B, "chunk": RNNT_CHUNK,
        "push_raw_frames": raw, "warm_pushes": RNNT_WARM, "timed_pushes": RNNT_TIMED,
        "push_ms_median": statistics.median(times), "push_ms_max": max(times),
        "push_runs_ms": times, "push_syncs": push_syncs,
        "push_trace": {k: profiled[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                                 "kernel_launches", "top_kernels")},
        "launches_per_frame": profiled["kernel_launches"] / RNNT_CHUNK,
        "finish_vs_one_shot_f32": parity,
    })


def phase_rnnt_train(pkg, adamw):
    """``make_transducer_train_step`` at rnnt_greedy's config: B=32, 500
    raw frames, 8-token references, dropout 0.1, AdamW at 1e-3, 5 steps
    (losses finite; ms a step, launches, syncs and idle share). First the
    seeded weights in float32 at dropout 0 take one step on the card and
    one on the CPU: loss within rtol 1e-4, every gradient within 1e-3 of
    its tensor's largest entry (the bounds of the Conformer step's check
    at seeded weights), an attention key bias, whose true gradient is 0,
    within 1e-3 of the model's largest gradient on both devices."""
    make_step = pkg[3]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    feats = torch.randn((RNNT_B, RNNT_T, 80), generator=gen, device="cuda")
    lens = torch.full((RNNT_B,), RNNT_T, device="cuda")
    refs = torch.randint(0, RNNT_V, (RNNT_B, RNNT_U), generator=gen, device="cuda")
    ref_lens = torch.full((RNNT_B,), RNNT_U, device="cuda")
    batch = (feats, lens, refs, ref_lens)

    cfg32 = rnnt_cfg(pkg, dtype=torch.float32, dropout=0.0)
    check, grads = {}, {}
    for dev in ("cuda", "cpu"):
        m = rnnt_model(pkg, cfg32, dev)
        step = make_step(m, adamw(m.parameters(), LR))
        check[f"loss_{dev}"] = float(step(None, *(a.to(dev) for a in batch)))
        grads[dev] = {k: p.grad.cpu() for k, p in m.named_parameters()}
    check["loss_rel_err"] = abs(check["loss_cuda"] - check["loss_cpu"]) / abs(check["loss_cpu"])
    check["grad_max_rel_err"], check["grad_max_rel_err_at"] = worst_rel(
        (k, grads["cuda"][k], g) for k, g in grads["cpu"].items()
        if not k.endswith("attn.key.bias"))
    check["key_bias_grad_rel"] = 0.0
    g_max = max(float(g.abs().max()) for g in grads["cpu"].values())
    for k, g in grads["cpu"].items():
        if k.endswith("attn.key.bias"):  # rounding noise: softmax is blind to it
            noise = max(float(g.abs().max()), float(grads["cuda"][k].abs().max())) / g_max
            check["key_bias_grad_rel"] = max(check["key_bias_grad_rel"], noise)
    if not (check["loss_rel_err"] <= 1e-4 and check["grad_max_rel_err"] <= 1e-3
            and check["key_bias_grad_rel"] <= 1e-3):
        raise AssertionError(f"rnnt train step on the card vs the CPU: {check}")

    model = rnnt_model(pkg, rnnt_cfg(pkg), "cuda")
    step = make_step(model, adamw(model.parameters(), LR))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(step(gen, *batch)) for _ in range(RNNT_STEPS)]
    first_steps_s = time.perf_counter() - t0
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"rnnt training losses not finite: {losses}")
    (step_ms,), runs = host_ms([lambda: step(gen, *batch)], reps=5)
    _, n_syncs = syncs(lambda: step(gen, *batch))
    profiled = trace(lambda: step(gen, *batch))
    emit({
        "phase": "rnnt_train", "nvidia_smi": smi_line(),
        "model": "ConformerTransducer d256 L4 H4 V1024 bf16 encoder, dropout 0.1",
        "batch": RNNT_B, "raw_frames": RNNT_T, "u": RNNT_U, "lr": LR, "losses": losses,
        "first_steps_s": first_steps_s, "card_vs_cpu_seeded_f32": check,
        "step_ms": step_ms, "step_runs_ms": runs[0], "steps_per_s": 1e3 / step_ms,
        "step_syncs": n_syncs,
        "step_trace": {k: profiled[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                                 "kernel_launches", "top_kernels")},
    })


# ---------------------------------------------------------------------------
# The rest of the ops layer: blank-skip serving (bench_ctc_blankskip), the
# feature front end and BASELINE config #5's other losses.

BLANKSKIP = dict(B=256, T=500, V=1024, max_frames=128, threshold=0.99, seed=8)


def blankskip_inputs(B, T, V, seed=8):
    """bench_ctc_blankskip's logits ``(T, B, V + 1)`` and lengths, made with
    numpy in bench.py's order (bench.py:371-377): standard normals, the
    blank raised by 9, 18 added at ``T // 6`` random frames of each
    utterance to a random token, then the lengths."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(T, B, V + 1).astype(np.float32)
    logits[..., V] += 9.0
    for n in range(B):
        idx = rng.choice(T, size=T // 6, replace=False)
        logits[idx, n, rng.randint(V, size=T // 6)] += 18.0
    lens = rng.randint(T // 2, T + 1, (B,)).astype(np.int32)
    return logits, lens


def phase_blankskip(pkg, kernels, cfg=BLANKSKIP, dev="cuda", cpu_rows=32):
    """bench_ctc_blankskip's cell: ``compress_blank_frames(threshold=0.99,
    max_frames=128)`` then ``CTCPrefixSearch(16)`` (the default route: the
    prologue and the renormalizing beam kernel) at B=256, T=500, V=1024.
    The card's compression must be bit-equal to the CPU's, its hypotheses
    and lengths equal to a CPU search of the same compressed logits at
    every row and bit-equal to the card's scan (``USE_BEAM_KERNEL="0"``);
    the same decode without the cut is held at the first ``cpu_rows``
    rows; the cut call through the raw beam route (DECODE_RENORM off) must
    equal the card's raw-mass scan, and each beam kernel its plain version
    on the same inputs (path buffer and probability bits exact, as in
    ``phase_beam_kernel``). Prints the kept and cut shares of the frames
    (at 0.99 few blanks dominate, so the cut, not the compression, does the
    shortening) and times. Returns the launches of the default call and of
    the raw beam call, and the kernels' times at this cell's shapes."""
    config, CTCPrefixSearch, compress_blank_frames = pkg
    B, T, V, F, thr = cfg["B"], cfg["T"], cfg["V"], cfg["max_frames"], cfg["threshold"]
    logits_np, lens_np = blankskip_inputs(B, T, V, cfg["seed"])
    x_cpu, lens_cpu = torch.from_numpy(logits_np), torch.from_numpy(lens_np)
    x, lens = x_cpu.to(dev), lens_cpu.to(dev)
    search = CTCPrefixSearch(WIDTH)
    saved = config.USE_BEAM_KERNEL, config.DECODE_RENORM
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        clg, clens = compress_blank_frames(x, lens, threshold=thr, max_frames=F)
        got = search(clg, clens)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        want = {"decode_prologue": 1, "ctc_beam_search_renorm": 1, "top_m": 0,
                "ctc_beam_search": 0}
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"blank-skip call launches {launches}, expected {want}")
        config.USE_BEAM_KERNEL = "0"
        scan_check = same_search(got, search(clg, clens))
        config.USE_BEAM_KERNEL = saved[0]
        if not scan_check["ok"]:
            raise AssertionError(f"blank-skip decode vs the card's scan: {scan_check}")
        full, full_lens = compress_blank_frames(x, lens, threshold=thr)
        ref_c, ref_lens = compress_blank_frames(x_cpu, lens_cpu, threshold=thr, max_frames=F)
        ref_full, ref_full_lens = compress_blank_frames(x_cpu, lens_cpu, threshold=thr)
        compress_ok = (
            same_bits(clg.cpu(), ref_c) and torch.equal(clens.cpu(), ref_lens)
            and same_bits(full.cpu(), ref_full) and torch.equal(full_lens.cpu(), ref_full_lens)
        )
        if not compress_ok:
            raise AssertionError("compress_blank_frames on the card differs from the CPU's")
        exp = search(ref_c, ref_lens)
        cut_check = search_compare(tuple(t.cpu() for t in got), exp, 1e-4)
        if not cut_check["ok"]:
            raise AssertionError(f"blank-skip cut decode vs the CPU's: {cut_check}")
        got_full = search(full, full_lens)
        exp_full = search(ref_full[:, :cpu_rows].contiguous(), ref_full_lens[:cpu_rows])
        full_check = search_compare(
            tuple(t[:, :cpu_rows].cpu() if t.dim() == 3 else t[:cpu_rows].cpu() for t in got_full),
            exp_full, 1e-4,
        )
        if not full_check["ok"]:
            raise AssertionError(f"blank-skip uncut decode vs the CPU's: {full_check}")
        (comp_ms, dec_ms, full_ms), runs = host_ms([
            lambda: compress_blank_frames(x, lens, threshold=thr, max_frames=F),
            lambda: search(clg, clens),
            lambda: search(full, full_lens),
        ], reps=5)

        config.DECODE_RENORM = False
        torch.cuda.synchronize()
        kernels.reset_launches()
        beam = search(clg, clens)
        torch.cuda.synchronize()
        beam_launches = dict(kernels.LAUNCHES)
        want = {"decode_prologue": 0, "top_m": 1, "ctc_beam_search": 1,
                "ctc_beam_search_renorm": 0}
        if any(beam_launches[k] != v for k, v in want.items()):
            raise AssertionError(f"blank-skip beam route launches {beam_launches}, expected {want}")
        config.USE_BEAM_KERNEL, config.DECODE_RENORM = "0", False
        raw = search(clg, clens)
        beam_check = search_compare(beam, raw, 1e-4)
        if not beam_check["ok"]:
            raise AssertionError(f"blank-skip beam route vs the card's raw-mass scan: {beam_check}")
        config.USE_BEAM_KERNEL = saved[0]
        (beam_ms,), beam_runs = host_ms([lambda: search(clg, clens)], reps=5)
    finally:
        config.USE_BEAM_KERNEL, config.DECODE_RENORM = saved

    # the kernels at this cell's shapes: the prologue over the kept frames,
    # the beam route's top-M and whole-loop search
    Tc, N, Vp1 = clg.shape
    m = min(V, 2 * WIDTH)
    xc = clg.contiguous()
    nonext, blank = beam_inputs(xc)
    top = kernels.top_m(nonext, m)
    # the beam kernel against its plain version on these inputs, held as
    # phase_beam_kernel holds it: this is its first shape at N=256 (rows in
    # two waves over the SMs)
    got_k = kernels.ctc_beam_search(nonext, blank, clens, WIDTH, top)
    exp_k = kernels.ctc_beam_search_reference(nonext, blank, clens, WIDTH, top)
    torch.cuda.synchronize()
    vs_plain = search_compare(got_k, exp_k, rtol=1e-6)
    vs_plain.update(buffer_exact=torch.equal(got_k[0], exp_k[0]),
                    probs_bit_exact=same_bits(got_k[2], exp_k[2]),
                    max_abs_err=max_abs_err(zip(got_k, exp_k)))
    if not (vs_plain["ok"] and vs_plain["buffer_exact"] and vs_plain["probs_bit_exact"]):
        raise AssertionError(f"ctc_beam_search vs its plain version at the blank-skip shape: "
                             f"{vs_plain}")
    renorm_args = (xc, *renorm_inputs(kernels, xc, WIDTH), clens)
    got_r = kernels.ctc_beam_search_renorm(*renorm_args, WIDTH)
    exp_r = kernels.ctc_beam_search_renorm_reference(*renorm_args, WIDTH)
    renorm_vs_plain = same_search(got_r[:3], exp_r[:3])
    renorm_vs_plain["ls_exact"] = torch.equal(got_r[3], exp_r[3])
    if not (renorm_vs_plain["ok"] and renorm_vs_plain["ls_exact"]):
        raise AssertionError(f"ctc_beam_search_renorm vs its plain version at the blank-skip "
                             f"shape: {renorm_vs_plain}")
    calls = {
        "decode_prologue": (lambda: kernels.decode_prologue(xc, m), "prologue_kernel"),
        "top_m": (lambda: kernels.top_m(nonext, m), "prologue_kernel"),
        "ctc_beam_search": (lambda: kernels.ctc_beam_search(nonext, blank, clens, WIDTH, top),
                            "ctc_beam_kernel"),
        "ctc_beam_search_renorm": (
            lambda: kernels.ctc_beam_search_renorm(*renorm_args, WIDTH), "ctc_beam_kernel"),
    }
    times = {
        "decode_prologue": dict(bound=prologue_bound_ms(Tc, N, Vp1, m, 4), shape=[Tc, N, Vp1],
                                m=m),
        "top_m": dict(bound=topm_bound_ms(Tc * N, V, m, 4), shape=[Tc, N, V], m=m),
        "ctc_beam_search": dict(bound=beam_bound_ms(clens, Tc, N, WIDTH, m),
                                shape=[Tc, N, V, WIDTH], vs_plain=vs_plain),
        "ctc_beam_search_renorm": dict(
            bound=renorm_bound_ms(clens, Tc, N, WIDTH, m, xc.element_size()),
            shape=[Tc, N, V, WIDTH], vs_plain=renorm_vs_plain),
    }
    for name, t in times.items():
        fn, kernel = calls[name]
        # the trace's device time (None when the traces missed the kernel,
        # or some launches the counter vouches for), where the short traces
        # lost them, and CUDA events around the wrapper
        t["ms"] = device_ms(fn, kernel, count=lambda: kernels.LAUNCHES[name])
        t["traces"] = TRACES.get(kernel)
        t["trace_notes"] = TRACE_NOTES.get(kernel)
        t["wrapper_ms"] = cuda_ms(fn)
        t["bound_ms"], t["bound_by"] = t.pop("bound")
    valid = int(lens_cpu.sum())
    kept = int(ref_full_lens.sum())
    p64 = torch.softmax(x_cpu.double(), -1)[..., V]  # the blank's probability, float64
    in_len = torch.arange(T)[:, None] < lens_cpu[None]
    emit({
        "phase": "blankskip", "nvidia_smi": smi_line(), "cell": "bench_ctc_blankskip",
        "batch": B, "frames": T, "vocab": V, "threshold": thr, "max_frames": F, "width": WIDTH,
        "valid_frames": valid, "kept_frames": kept, "kept_share": kept / valid,
        "dominant_frames": int((p64 >= thr)[in_len].sum()),
        "frames_within_1e-6_of_threshold": int(((p64 - thr).abs() < 1e-6)[in_len].sum()),
        "kept_per_row": {"min": int(ref_full_lens.min()),
                         "median": float(ref_full_lens.float().median()),
                         "max": int(ref_full_lens.max())},
        "cut_frames": kept - int(ref_lens.sum()), "cut_share": 1 - int(ref_lens.sum()) / kept,
        "compress_equals_cpu_bits": compress_ok,
        "vs_card_scan_cut": scan_check, "vs_cpu_cut": cut_check, "vs_cpu_uncut_rows": cpu_rows, "vs_cpu_uncut": full_check,
        "launches": launches, "prologue_launches_per_call": launches["decode_prologue"],
        "compress_ms": comp_ms, "decode_ms": dec_ms,
        "utt_per_s": B / ((comp_ms + dec_ms) / 1e3),
        "uncut": {"frames": int(full.shape[0]), "decode_ms": full_ms,
                  "utt_per_s": B / ((comp_ms + full_ms) / 1e3)},
        "beam_route": {"launches": beam_launches, "decode_ms": beam_ms,
                       "vs_card_scan_raw_masses": beam_check,
                       "utt_per_s": B / ((comp_ms + beam_ms) / 1e3)},
        "runs_ms": {"compress": runs[0], "decode": runs[1], "uncut": runs[2],
                    "beam": beam_runs[0]},
        "kernels": times,
    })
    return launches, beam_launches, times


def spline_f64(c, f, x, order):
    """The polyharmonic spline solved in float64 with numpy, one system a
    batch row (the full-matrix form, no regularization)."""
    eps = float(np.finfo(np.float32).eps)
    c, f, x = (np.asarray(a, np.float64) for a in (c, f, x))

    def phi(r):
        return r**order if order % 2 else r**order * np.log(np.maximum(r, eps))

    out = []
    for cn, fn, xn in zip(c, f, x):
        A = phi(np.linalg.norm(cn[:, None] - cn[None], axis=-1))
        B = np.concatenate([cn, np.ones((len(cn), 1))], 1)
        k = B.shape[1]
        lhs = np.block([[A, B], [B.T, np.zeros((k, k))]])
        wv = np.linalg.solve(lhs, np.concatenate([fn, np.zeros((k, fn.shape[1]))]))
        Phi = phi(np.linalg.norm(xn[:, None] - cn[None], axis=-1))
        out.append(Phi @ wv[:len(cn)] + np.concatenate([xn, np.ones((len(xn), 1))], 1) @ wv[len(cn):])
    return np.array(out)


FRONT_END = dict(N=16, T=1000, F=80, max_time_warp=80, lobe=10, order=2, width=2)


def deltas_f64(feats, x, order, width):
    """feat_deltas of ``x (N, T, F)`` (time on dim 1, replicate padding) in
    float64, with the same float32 filter taps, as ``(N, T, (order + 1) *
    F)``."""
    N, T, F = x.shape
    filt = torch.from_numpy(feats.feat_delta_filters(order, width)).double()
    p = width * order
    padded = x.double()[:, torch.arange(-p, T + p).clamp(0, T - 1)]
    out = [sum(padded[:, j:j + T] * filt[k, j] for j in range(filt.shape[1]))
           for k in range(order + 1)]
    return torch.cat(out, -1)


def phase_front_end(pkg, cfg=FRONT_END, dev="cuda"):
    """The port's feature ops on the card against the CPU at
    bench_spec_augment's shape ``(16, 1000, 80)``: ``mean_var_norm``
    (rtol and atol 1e-6); ``feat_deltas`` of order 2, width 2 of its output
    against a float64 evaluation of the same filters (rtol and atol 1e-6, a
    bound that a TF32 convolution misses); ``pad_variable`` in its three modes and
    ``random_shift_apply`` from pads drawn on the host, and
    ``chunk_by_slices`` over ``slice_spect_data``'s fixed 21-frame windows
    (exact); then ``sparse_image_warp`` (BASELINE config #1's warp) over
    ``(16, 1, 1000, 80)``: one control point an utterance moved along time
    by up to 80 frames, the four corners pinned, order 2, both
    ``include_flow`` routes. The flow and both routes' images must lie no
    farther from a float64 CPU solve than twice the CPU's float32 (plus
    1e-6 for the flow, 1e-5 for the images), and the card's dense warp of
    one CPU-solved flow must equal the CPU's within atol 1e-5. Wall times
    of each."""
    feats, pad, img = pkg
    N, T, F, lobe = cfg["N"], cfg["T"], cfg["F"], cfg["lobe"]
    order, width = cfg["order"], cfg["width"]
    rng = np.random.RandomState(SEED + 21)
    x_cpu = torch.from_numpy((rng.randn(N, T, F) * 3 + 1).astype(np.float32))
    lens_cpu = torch.from_numpy(rng.randint(T // 2, T + 1, N).astype(np.int64))
    lens_cpu[0] = T
    x, lens = x_cpu.to(dev), lens_cpu.to(dev)
    res, fails = {}, []

    def close(name, got, exp, rtol, atol):
        d = (got.cpu().double() - exp.double()).abs()
        lim = atol + rtol * exp.double().abs()
        res[name] = {"max_abs_err": float(d.max()), "limit_use": float((d / lim).max())}
        if not bool((d <= lim).all()):
            fails.append(name)

    def equal(name, got, exp):
        res[name] = torch.equal(got.cpu(), exp)
        if not res[name]:
            fails.append(name)

    mvn_cpu = feats.mean_var_norm(x_cpu)
    close("mean_var_norm", feats.mean_var_norm(x), mvn_cpu, 1e-6, 1e-6)
    exact = deltas_f64(feats, mvn_cpu, order, width)
    close("feat_deltas_vs_f64", feats.feat_deltas(mvn_cpu.to(dev), order=order, width=width),
          exact, 1e-6, 1e-6)

    u = torch.rand((2, N), generator=torch.Generator().manual_seed(SEED + 22))
    pads = img.random_shift_pads(lens_cpu, (0.1, 0.1), u)
    out_len = int((lens_cpu + pads.sum(0)).max())
    for mode in ("constant", "reflect", "replicate"):
        equal(f"pad_variable_{mode}", pad.pad_variable(x, lens, pads.to(dev), mode, 0.5, out_len),
              pad.pad_variable(x_cpu, lens_cpu, pads, mode, 0.5, out_len))
    shifted = img.random_shift_apply(x, lens, pads.to(dev))
    exp_shift = img.random_shift_apply(x_cpu, lens_cpu, pads)
    equal("random_shift_apply", shifted[0], exp_shift[0])
    equal("random_shift_lens", shifted[1], exp_shift[1])
    slices, sources = feats.slice_spect_data(x_cpu, lens_cpu, lobe_size=lobe, valid_only=False)

    def chunk(x, lens, d):
        src = sources.to(d)
        return pad.chunk_by_slices(x[src], slices.to(d), lens[src], "reflect",
                                   out_len=2 * lobe + 1)

    got_chunks, exp_chunks = chunk(x, lens, dev), chunk(x_cpu, lens_cpu, "cpu")
    equal("chunk_by_slices", got_chunks[0], exp_chunks[0])
    equal("chunk_lens", got_chunks[1], exp_chunks[1])
    res["slices"] = int(slices.shape[0])

    # sparse_image_warp over the utterances as (N, 1, T, F) images
    image_cpu = x_cpu[:, None]
    image = image_cpu.to(dev)
    warp = cfg["max_time_warp"]
    t0 = rng.uniform(warp, T - warp, N)
    src_pts = np.stack([t0, np.full(N, F / 2)], 1)[:, None].astype(np.float32)
    dst_pts = np.stack([t0 + rng.uniform(-warp, warp, N), np.full(N, F / 2)], 1)[:, None]
    sp, dp = torch.from_numpy(src_pts), torch.from_numpy(dst_pts.astype(np.float32))
    kw = dict(field_interpolation_order=2, pinned_boundary_points=1)

    def sparse(image, d, **extra):
        return img.sparse_image_warp(image, sp.to(d), dp.to(d), **kw, **extra)

    (warped, flow), (warped_cpu, flow_cpu) = sparse(image, dev), sparse(image_cpu, "cpu")
    bypass = sparse(image, dev, include_flow=False)
    bypass_cpu = sparse(image_cpu, "cpu", include_flow=False)
    # the float64 solve, in the (w, h) = (F, T) order the warp solves in
    WH = np.array([F, T], np.float64)
    pins = img._pinned_points(1, torch.from_numpy(np.tile(WH, (N, 1)))).numpy()
    s64 = np.concatenate([src_pts[..., ::-1].astype(np.float64), pins], 1)
    d64 = np.concatenate([dst_pts[..., ::-1].astype(np.float32).astype(np.float64), pins], 1)
    hg, wg = np.meshgrid(np.arange(T), np.arange(F), indexing="ij")
    query = np.broadcast_to(np.stack([wg.ravel(), hg.ravel()], 1)[None], (N, T * F, 2))
    flow64 = spline_f64(d64, d64 - s64, query, 2).reshape(N, T, F, 2)
    grid64 = spline_f64(d64, (2 * s64 + 1) / WH - 1, query, 2).reshape(N, T, F, 2)
    hw = np.stack([wg, hg], 2)[None]
    image64 = image_cpu.double()
    truths = {
        "flow": torch.from_numpy(flow64[..., ::-1].copy()),  # back to (h, w)
        "warped": img.grid_sample(
            image64, torch.from_numpy((2 * hw - 2 * flow64 + 1) / WH - 1), padding_mode="border"),
        "warped_bypass": img.grid_sample(image64, torch.from_numpy(grid64), padding_mode="border"),
    }
    for name, got, cpu, slack in (
        ("flow", flow, flow_cpu, 1e-6),
        ("warped", warped, warped_cpu, 1e-5),
        ("warped_bypass", bypass, bypass_cpu, 1e-5),
    ):
        card_d = float((got.cpu().double() - truths[name]).abs().max())
        cpu_d = float((cpu.double() - truths[name]).abs().max())
        res[f"sparse_{name}"] = {"card_vs_f64": card_d, "cpu_vs_f64": cpu_d,
                                 "limit": 2 * cpu_d + slack}
        if card_d > 2 * cpu_d + slack:
            fails.append(f"sparse_{name}")
    again = img.dense_image_warp(image, flow_cpu.to(dev))
    exp_again = img.dense_image_warp(image_cpu, flow_cpu)
    close("dense_warp_given_cpu_flow", again, exp_again, 0.0, 1e-5)
    res["dense_warp_given_cpu_flow"]["bits_equal"] = same_bits(again.cpu(), exp_again)
    if fails:
        raise AssertionError(f"front end on the card vs the CPU failed {fails}: {res}")

    names = ("mean_var_norm", "feat_deltas", "random_shift_apply", "chunk_by_slices",
             "sparse_image_warp", "sparse_image_warp_bypass")
    ms, runs = host_ms([
        lambda: feats.mean_var_norm(x),
        lambda: feats.feat_deltas(x, order=order, width=width),
        lambda: img.random_shift_apply(x, lens, pads.to(dev), out_len=out_len),
        lambda: chunk(x, lens, dev),
        lambda: sparse(image, dev),
        lambda: sparse(image, dev, include_flow=False),
    ])
    emit({
        "phase": "front_end", "nvidia_smi": smi_line(), "shape": [N, T, F], "checks": res,
        "ms": dict(zip(names, ms)), "runs_ms": dict(zip(names, runs)),
    })
    return res


def phase_seq_losses(pkg, s2s, dev="cuda", rtol=1e-6, atol=1e-6):
    """BASELINE config #5's other losses at the seq2seq MER cell's shapes
    (bench.py:749-770): 16 utterances x 4 samples = 64 hypotheses of 16
    steps drawn by ``RandomWalk`` over the cell's seeded model, 12-token
    references with the eos (63) after them, V=64. On the card against a
    CPU copy of the same tensors: ``optimal_completion``,
    ``prefix_error_rates``, ``prefix_edit_distances`` and ``error_rate``
    with costs (1, 1, 2) exactly; the OCD loss over the model's step
    log-probabilities and its gradient, and ``LogisticBernoulli`` and
    ``GumbelOneHotCategorical`` over the first step's ``(64, 64)`` logits
    given the same uniforms (samples, densities, conditional samples, and
    the straight-through gradient), within ``rtol`` and ``atol``. Wall
    times of each."""
    string, st, decoding = pkg
    Seq2SeqDecoderLM = s2s[2]
    model = s2s_model(s2s, dev)
    feats, feat_lens, refs, _ = s2s_inputs()
    M, eos = MER_SAMPLES, S2S_EOS
    lm = Seq2SeqDecoderLM(model)
    with torch.no_grad():
        state = lm.initial_state(feats.to(dev), feat_lens.to(dev))
        tiled = {k: v.repeat_interleave(M, 0) for k, v in state.items()}
        gen = torch.Generator(device=dev).manual_seed(SEED + 23)
        hyp, hyp_lens, _ = decoding.RandomWalk(lm, eos=eos)(gen, dict(tiled), S2S_B * M, S2S_ITERS)
        logits = lm(hyp, prev=dict(tiled))[:-1].float()  # (16, 64, 64)
    ref = torch.cat([refs, torch.full((S2S_B, 1), eos)], 1).repeat_interleave(M, 0).T  # (13, 64)
    hyp = hyp.long()
    ref_d, hyp_d = ref.to(dev), hyp.to(dev)
    ref_c, hyp_c, logits_c = ref, hyp.cpu(), logits.cpu()
    res, fails = {"hyp_lens": [int(hyp_lens.min()), int(hyp_lens.max())]}, []

    def equal(name, got, exp):
        res[name] = torch.equal(got.cpu(), exp)
        if not res[name]:
            fails.append(name)

    def close(name, got, exp):
        fin = torch.isfinite(exp)
        same_inf = torch.equal(fin, torch.isfinite(got.cpu())) and torch.equal(
            got.cpu()[~fin], exp[~fin])
        d = (got.detach().cpu().double() - exp.detach().double())[fin].abs()
        lim = atol + rtol * exp.detach().double()[fin].abs()
        res[name] = {"max_abs_err": float(d.max()) if d.numel() else 0.0,
                     "limit_use": float((d / lim).max()) if d.numel() else 0.0}
        if not (same_inf and bool((d <= lim).all())):
            fails.append(name)

    kw = dict(eos=eos, warn=False)
    calls = {
        "optimal_completion": lambda r, h: string.optimal_completion(r, h, **kw),
        "prefix_error_rates": lambda r, h: string.prefix_error_rates(r, h, **kw),
        "prefix_edit_distances": lambda r, h: string.prefix_edit_distances(r, h, **kw),
        "error_rate_1_1_2": lambda r, h: string.error_rate(
            r, h, eos=eos, include_eos=True, warn=False, ins_cost=1.0, del_cost=1.0,
            sub_cost=2.0),
    }
    for name, fn in calls.items():
        equal(name, fn(ref_d, hyp_d), fn(ref_c, hyp_c))

    def ocd(lg, r, h):
        lg = lg.detach().clone().requires_grad_(True)
        loss = string.hard_optimal_completion_distillation_loss(lg, r, h, eos=eos, warn=False)
        loss.backward()
        return loss, lg.grad

    (loss, grad), (loss_c, grad_c) = ocd(logits, ref_d, hyp_d), ocd(logits_c, ref_c, hyp_c)
    close("ocd_loss", loss, loss_c)
    close("ocd_grad", grad, grad_c)

    step0 = logits[0]  # (64, 64)
    ug = torch.Generator().manual_seed(SEED + 24)
    u, v = torch.rand(step0.shape, generator=ug), torch.rand(step0.shape, generator=ug)
    weights = torch.randn(step0.shape, generator=ug)
    for cls in ("LogisticBernoulli", "GumbelOneHotCategorical"):
        outs = []
        for lg, d in ((step0, dev), (step0.cpu(), "cpu")):
            lg = lg.detach().clone().requires_grad_(True)
            dist = getattr(st, cls)(logits=lg)
            z = dist.rsample(u=u.to(d))
            b = dist.threshold(z, straight_through=True)
            zc = dist.csample(b.detach(), u=v.to(d))
            total = ((b * weights.to(d)).sum() + dist.log_prob(z).sum()
                     + dist.clog_prob(zc, b.detach()).sum())
            total.backward()
            outs.append(dict(z=z, b=b.detach(), log_prob=dist.log_prob(z),
                             tlog_prob=dist.tlog_prob(b.detach()), zcond=zc,
                             clog_prob=dist.clog_prob(zc, b.detach()), grad=lg.grad))
        got, exp = outs
        equal(f"{cls}_threshold", got["b"], exp["b"])
        for key in ("z", "log_prob", "tlog_prob", "zcond", "clog_prob", "grad"):
            close(f"{cls}_{key}", got[key], exp[key])
    if fails:
        raise AssertionError(f"sequence losses on the card vs the CPU failed {fails}: {res}")

    names = list(calls) + ["ocd_loss_and_grad"]
    ms, runs = host_ms([lambda fn=fn: fn(ref_d, hyp_d) for fn in calls.values()]
                       + [lambda: ocd(logits, ref_d, hyp_d)], reps=5)
    emit({
        "phase": "seq_losses", "nvidia_smi": smi_line(),
        "shapes": {"ref": list(ref.shape), "hyp": list(hyp.shape), "logits": list(logits.shape),
                   "vocab": S2S_V, "eos": eos},
        "tolerance": {"rtol": rtol, "atol": atol}, "checks": res,
        "ms": dict(zip(names, ms)), "runs_ms": dict(zip(names, runs)),
    })
    return res


# ---------------------------------------------------------------------------
# Forced alignment, REINFORCE over the seq2seq decoder and REBAR over the
# served logits: eager paths of the port's ops, held against the port on the
# CPU. The alignments read logits the decode-prologue kernel's request
# produced, REINFORCE scores its samples through the edit-distance kernel.


def collapse(path, blank):
    """A frame-level CTC path's label sequence: repeats merged, blanks
    dropped."""
    keep = path != blank
    keep[1:] &= path[1:] != path[:-1]
    return path[keep]


def seq_f32_sum(m, lens):
    """Per row, ``m[:, 0] + m[:, 1] + ...`` over each row's first ``lens``
    frames, one float32 addition a frame: the order in which the Viterbi
    pass adds a path's emissions."""
    acc = m[:, 0].clone()
    for t in range(1, m.shape[1]):
        acc = torch.where(t < lens, acc + m[:, t], acc)
    return acc


def phase_align(decoding, logits, out_lens, served, dev="cuda", width=WIDTH, cpu_rows=None):
    """Forced alignment of the main path's served request (BASELINE config
    #1's logits, ``(32, 500, 1025)`` batch-first, the blank last): (a) to
    its width-``width`` hypotheses, every path collapsing back to its
    hypothesis with a finite score, paths equal to the port's alignment of
    the same logits on the CPU and scores within rtol 1e-6; (b) to
    ``ctc_greedy_search``'s transcripts, each path the per-frame argmax at
    every valid frame and each score the float32 sum, in frame order, of
    the frame maxima of the log-softmax, within rtol 1e-6 (the greedy path
    is the global maximum); (c) the align time of the B=32 request (CUDA
    events, median of 7), of the width-``width`` batch, and the launches
    a frame."""
    hyps, hyp_lens = served[0], served[1]
    N, T, Vp1 = logits.shape
    blank = Vp1 - 1
    W = hyps.shape[1]
    refs = hyps.reshape(N * W, -1)
    ref_lens = hyp_lens.reshape(-1)
    rep = logits.repeat_interleave(W, 0)
    rep_lens = out_lens.repeat_interleave(W)
    paths, scores = decoding.ctc_forced_align(rep, refs, rep_lens, ref_lens, batch_first=True)
    res, fails = {}, []
    paths_c, scores_c, refs_c = paths.cpu(), scores.cpu(), refs.cpu()
    lens_c, rlens_c = rep_lens.cpu(), ref_lens.cpu()
    bad = [i for i in range(N * W) if not torch.equal(
        collapse(paths_c[i, :int(lens_c[i])], blank),
        refs_c[i, :int(rlens_c[i])].to(paths_c.dtype))]
    res["hyps_collapse_back"] = not bad
    res["hyp_scores_finite"] = bool(torch.isfinite(scores_c).all())
    rows = N * W if cpu_rows is None else cpu_rows
    cp, cs = decoding.ctc_forced_align(rep[:rows].cpu(), refs_c[:rows], lens_c[:rows],
                                       rlens_c[:rows], batch_first=True)
    res["hyp_paths_equal_cpu"] = torch.equal(cp, paths_c[:rows])
    rel = ((scores_c[:rows] - cs).abs() / cs.abs()).max()
    res["hyp_scores_vs_cpu_max_rel_err"] = float(rel)
    for name in ("hyps_collapse_back", "hyp_scores_finite", "hyp_paths_equal_cpu"):
        if not res[name]:
            fails.append(name)
    if not float(rel) <= 1e-6:
        fails.append("hyp_scores_vs_cpu")

    _, g, g_lens = decoding.ctc_greedy_search(logits, out_lens, batch_first=True)

    def align_b32():
        return decoding.ctc_forced_align(logits, g, out_lens, g_lens, batch_first=True)

    gpaths, gscores = align_b32()
    lp = torch.log_softmax(logits, -1)
    m = lp.amax(-1)
    valid = torch.arange(T, device=logits.device)[None] < out_lens[:, None]
    argmax_ok = torch.where(valid, gpaths == lp.argmax(-1), True)
    res["greedy_paths_are_argmax"] = bool(argmax_ok.all())
    ref_sum = seq_f32_sum(m, out_lens)
    rel = float(((gscores - ref_sum).abs() / ref_sum.abs()).max())
    f64 = torch.where(valid, m.double(), 0.0).sum(1)
    res["greedy_score_vs_frame_max_sum_max_rel_err"] = rel
    res["greedy_score_vs_f64_sum_max_rel_err"] = float(
        ((gscores.double() - f64).abs() / f64.abs()).max())
    if not res["greedy_paths_are_argmax"]:
        fails.append("greedy_paths_are_argmax")
    if not rel <= 1e-6:
        fails.append("greedy_score")
    if fails:
        raise AssertionError(f"forced alignment failed {fails}: {res}")

    align_ms = cuda_ms(align_b32, reps=REPS, inner=1)
    wide_ms = cuda_ms(lambda: decoding.ctc_forced_align(rep, refs, rep_lens, ref_lens,
                                                        batch_first=True), reps=REPS, inner=1)
    profiled = trace(align_b32)
    emit({
        "phase": "align", "nvidia_smi": smi_line(),
        "logits": [N, T, Vp1], "width": W, "checks": res,
        "hyp_len_max": int(ref_lens.max()), "greedy_len_max": int(g_lens.max()),
        "align_b32_ms": align_ms,
        "align_width_ms": wide_ms, "align_width_rows": N * W,
        "trace": {k: profiled[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                            "kernel_launches", "top_kernels")},
        "launches_per_frame": profiled["kernel_launches"] / T,
    })
    return res


def phase_reinforce(s2s, pkg, kernels, dev="cuda"):
    """REINFORCE over BASELINE config #5's decoder at ``phase_s2s_train``'s
    width: ``DirectEstimator(SequentialLanguageModelDistribution(
    RandomWalk(Seq2SeqDecoderLM, eos=63), batch_shape=(16,),
    initial_state=<encoder state>, max_iters=16), -error_rate(refs, b),
    mc_samples=4)`` and one backward pass. The error rates go through the
    edit-distance kernel, one launch a call, each result equal to its
    plain version bit for bit; the value equals the mean of the sampled
    ``-error_rate`` values (within 1e-5: the surrogate adds and removes the
    REINFORCE term); the card's samples moved to the CPU give the port's
    value there within rtol 1e-5 and every gradient within 1e-4 of its
    tensor's largest entry. Then the call's time and launches."""
    Seq2SeqDecoderLM = s2s[2]
    decoding, mc, string = pkg
    feats, feat_lens, refs, _ = s2s_inputs()
    M, eos = MER_SAMPLES, S2S_EOS
    drawn, rates = [], []

    def run(model, samples=None, gen=None):
        d = next(model.parameters()).device
        lm = Seq2SeqDecoderLM(model)
        state = lm.initial_state(feats.to(d), feat_lens.to(d))
        dist = decoding.SequentialLanguageModelDistribution(
            decoding.RandomWalk(lm, eos=eos), (S2S_B,), state, max_iters=S2S_ITERS)
        if samples is not None:
            dist.sample = lambda shape=(), generator=None: samples.to(d)
        else:
            sample = dist.sample

            def recorded(shape=(), generator=None):
                out = sample(shape, generator)
                drawn.append(out.detach().cpu())
                return out

            dist.sample = recorded
        tiled = refs.to(d).repeat(M, 1)

        def func(b):
            er = string.error_rate(tiled, b.reshape(-1, S2S_ITERS), eos=eos, batch_first=True,
                                   warn=False)
            rates.append(er.detach().cpu())
            return -er.reshape(b.shape[:-1])

        model.zero_grad(set_to_none=True)
        v = mc.DirectEstimator(dist, func, M)(gen)
        v.sum().backward()
        return v.detach(), [p.grad for p in model.parameters()]

    model = s2s_model(s2s, dev, SEED + 1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    eds = []
    ed = kernels.edit_distance

    def edit_distance(*args):
        out = ed(*args)
        eds.append((args, out))
        return out

    kernels.edit_distance = edit_distance
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        v, g = run(model, gen=gen)
        torch.cuda.synchronize()
        launches = {"edit_distance": kernels.LAUNCHES["edit_distance"]}
    finally:
        kernels.edit_distance = ed
    res = {"launches": launches["edit_distance"], "kernel_calls": len(eds)}
    fails = []
    if launches["edit_distance"] != 1 or len(eds) != 1:
        fails.append("edit_distance_launches")
    res["edit_distance_equals_plain"] = all(
        torch.equal(out.cpu(), kernels.edit_distance_reference(
            *[a.cpu() if isinstance(a, torch.Tensor) else a for a in args]))
        for args, out in eds)
    if not res["edit_distance_equals_plain"]:
        fails.append("edit_distance_equals_plain")
    mean = (-rates[0]).reshape(M, S2S_B).mean(0)
    res["value_vs_sample_mean_max_abs_err"] = float((v.cpu() - mean).abs().max())
    if not res["value_vs_sample_mean_max_abs_err"] <= 1e-5:
        fails.append("value_vs_sample_mean")
    cpu = s2s_model(s2s, "cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    vc, gc = run(cpu, samples=drawn[0])
    res["value_vs_cpu_max_rel_err"] = float(
        ((v.cpu() - vc).abs() / vc.abs().clamp_min(1e-30)).max())
    if not torch.allclose(v.cpu(), vc, rtol=1e-5, atol=0):
        fails.append("value_vs_cpu")
    names = [k for k, _ in model.named_parameters()]
    res["grad_vs_cpu_max_rel_err"], res["grad_vs_cpu_max_rel_err_at"] = worst_rel(zip(names, g, gc))
    if not res["grad_vs_cpu_max_rel_err"] <= 1e-4:
        fails.append("grad_vs_cpu")
    if fails:
        raise AssertionError(f"reinforce failed {fails}: {res}")
    (call_ms,), runs = host_ms([lambda: run(model, gen=gen)])
    profiled = trace(lambda: run(model, gen=gen))
    emit({
        "phase": "reinforce", "nvidia_smi": smi_line(),
        "model": "AttentionSeq2Seq V64 F40 hidden 128 embed 64 attention 128",
        "batch": S2S_B, "samples": M, "max_iters": S2S_ITERS, "eos": eos, "refs": MER_R,
        "checks": res, "value_mean": float(v.mean()),
        "call_ms": call_ms, "call_runs_ms": runs[0], "call_includes": "estimate + backward",
        "trace": {k: profiled[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                            "kernel_launches", "top_kernels")},
    })
    return launches


REBAR_SAMPLES, REBAR_ROWS = 4, 4


def phase_rebar(st, mc, logits, dev="cuda", rows=REBAR_ROWS):
    """REBAR over the served logits: ``RelaxEstimator`` with
    ``GumbelOneHotCategoricalRebarControlVariate`` over
    ``GumbelOneHotCategorical(logits=<the served logits, batch-first>)``,
    each utterance's frames one event, ``mc_samples=4``, ``func(b) = (b *
    w).sum((-2, -1))`` for a seeded ``w`` of ``V + 1`` entries, whose
    exact mean is ``sum_t softmax(logits_t) . w``. (a) Summed over the
    batch, the estimate lies within 4 standard errors of the exact mean
    (the per-sample values' variance, pooled over the batch's independent
    rows); (b) on the first ``rows``
    rows and the same uniforms, the card's value, logits gradient and
    ``relax_variance_loss``'s control-variate gradient equal the port's on
    the CPU within rtol 1e-5, or 1e-4 of the tensor's largest entry; (c)
    the estimate-and-backward time and ``relax_variance_loss``'s."""
    N, T, Vp1 = logits.shape
    wg = torch.Generator().manual_seed(SEED + 41)
    w = torch.randn(Vp1, generator=wg)
    draws = {}

    class Recorded(st.GumbelOneHotCategorical):
        """An utterance's frames as one event: log-probabilities summed
        over time, so they match ``func``'s value per utterance. Draws its
        uniforms from the generator in the open and keeps them, or replays
        the kept ones (``draws``) on the given rows."""

        replay = None

        def tlog_prob(self, b):
            return super().tlog_prob(b).sum(-1)

        def clog_prob(self, zcond, b):
            return super().clog_prob(zcond, b).sum(-1)

        def rsample(self, sample_shape=(), generator=None, u=None):
            shape = tuple(sample_shape) + tuple(self.logits.shape)
            if self.replay is not None:
                u = self.replay["z"][:, : shape[1]].to(self.logits.device)
            else:
                u = torch.rand(shape, generator=generator, device=self.logits.device)
                draws["z"] = u
            return super().rsample(sample_shape, u=u)

        def csample(self, b, generator=None, u=None):
            if self.replay is not None:
                u = self.replay["c"][:, : b.shape[1]].to(b.device)
            else:
                u = torch.rand(b.shape, generator=generator, device=b.device)
                draws["c"] = u
            return super().csample(b, u=u)

    def func_on(d):
        wd = w.to(d)
        return lambda b: (b * wd).sum((-2, -1))

    def estimate(lg, cv, gen=None, replay=None):
        prop = Recorded(logits=lg)
        prop.replay = replay
        return mc.RelaxEstimator(prop, func_on(lg.device), REBAR_SAMPLES, cv)(gen)

    cv = mc.GumbelOneHotCategoricalRebarControlVariate(func_on(dev), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    lg = logits.detach().clone().requires_grad_(True)
    v = estimate(lg, cv, gen)
    v.sum().backward()
    v = v.detach()
    res, fails = {}, []
    # (a) the exact mean against the per-sample values on the same draws
    with torch.no_grad():
        prop = st.GumbelOneHotCategorical(logits=logits)
        f = func_on(logits.device)
        z = prop.rsample((REBAR_SAMPLES,), u=draws["z"])
        b = prop.threshold(z)
        x = f(b) - cv(prop.csample(b, u=draws["c"])) + cv(z)  # (samples, N)
        exact = (torch.softmax(logits.double(), -1) * w.to(logits.device).double()).sum((-2, -1))
    se = float(torch.sqrt((x.double().var(0) / REBAR_SAMPLES).sum()))
    err = float(v.double().sum() - exact.sum())
    res.update(estimate_sum=float(v.double().sum()), exact_sum=float(exact.sum()),
               std_error=se, z_score=err / se, value_vs_sample_mean_max_abs_err=float(
                   (v - x.mean(0)).abs().max()))
    if not abs(err) <= 4 * se:
        fails.append("estimate_within_4_std_errors")

    # (b) the first rows on the card and on the CPU, the same uniforms
    def on(d, lg0, cv0):
        lgr = lg0[:rows].detach().clone().to(d).requires_grad_(True)
        val = estimate(lgr, cv0, replay=draws)
        val.sum().backward()

        def build(pp, cvm):
            prop = Recorded(logits=pp)
            prop.replay = draws
            return mc.RelaxEstimator(prop, func_on(d), REBAR_SAMPLES, cvm)

        loss = mc.relax_variance_loss(build, lgr, cv0)
        g_cv = torch.autograd.grad(loss, [cv0.log_temp, cv0.eta])
        return [val, lgr.grad, loss, *g_cv]

    cv_cpu = mc.GumbelOneHotCategoricalRebarControlVariate(func_on("cpu"), device="cpu")
    cv_cpu.load_state_dict({k: t.cpu() for k, t in cv.state_dict().items()})
    card, cpu = on(dev, logits, cv), on("cpu", logits.cpu(), cv_cpu)
    names = ["value", "logits_grad", "variance_loss", "cv_grad_log_temp", "cv_grad_eta"]
    for name, a, c in zip(names, card, cpu):
        res[f"{name}_vs_cpu"] = worst_rel([(name, a, c)])[0]
        if not (torch.allclose(a.detach().cpu(), c.detach(), rtol=1e-5, atol=0)
                or res[f"{name}_vs_cpu"] <= 1e-4):
            fails.append(f"{name}_vs_cpu")
    if fails:
        raise AssertionError(f"rebar failed {fails}: {res}")

    def step():
        lgs = logits.detach().clone().requires_grad_(True)
        estimate(lgs, cv, gen).sum().backward()

    def variance_loss():
        def build(pp, cvm):
            return mc.RelaxEstimator(Recorded(logits=pp), func_on(dev), REBAR_SAMPLES, cvm)

        loss = mc.relax_variance_loss(build, logits, cv, gen)
        torch.autograd.grad(loss, [cv.log_temp, cv.eta])

    (est_ms, rvl_ms), runs = host_ms([step, variance_loss])
    emit({
        "phase": "rebar", "nvidia_smi": smi_line(), "logits": [N, T, Vp1],
        "samples": REBAR_SAMPLES, "cpu_rows": rows, "checks": res,
        "estimate_backward_ms": est_ms, "relax_variance_loss_grad_ms": rvl_ms,
        "runs_ms": {"estimate_backward": runs[0], "relax_variance_loss_grad": runs[1]},
        "peak_mem_bytes": torch.cuda.max_memory_allocated() if dev == "cuda" else None,
    })
    return res


# ---------------------------------------------------------------------------
# The training recipe (examples/train_ctc_asr.py's path through the port's
# entry points), the mixture-of-experts step and the remat step.

# phase_train's model: bench.py:606's config, d512/L8/H8, V=1024, bf16
RECIPE_MODEL = dict(vocab_size=1024, num_filts=80, d_model=512, num_layers=8, num_heads=8,
                    dropout=0.1, attn_dropout=0.0)
RECIPE = dict(utts=128, t_min=500, t_max=1000, u_min=10, u_max=60, batch=32, epochs=2,
              score_batch=32, model=RECIPE_MODEL, sa=SA_ARGS)
MOE = dict(model=dict(RECIPE_MODEL, num_experts=4, expert_top_k=2, expert_capacity_factor=1.25,
                      moe_aux_weight=0.01),
           B=B_TRAIN, T=T_TRAIN, U=U_TRAIN, steps=3, sa=SA_ARGS)
REMAT = dict(model=RECIPE_MODEL, B=B_TRAIN, T=T_TRAIN, U=U_TRAIN, sa=SA_ARGS)


def peak_reset(dev):
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(dev):
    return torch.cuda.max_memory_allocated() if dev == "cuda" else None


def recipe_data(save_tensor, root, cfg):
    """``cfg["utts"]`` utterances of ``t_min``-``t_max`` frames of 80 (the
    model's) float32 features and ``u_min``-``u_max`` reference tokens, from
    ``RandomState(SEED + 50)``, written with the port's ``save_tensor``;
    returns the frame and token counts."""
    rng = np.random.RandomState(SEED + 50)
    F, V = cfg["model"]["num_filts"], cfg["model"]["vocab_size"]
    frames = tokens = 0
    for n in range(cfg["utts"]):
        T = int(rng.randint(cfg["t_min"], cfg["t_max"] + 1))
        U = int(rng.randint(cfg["u_min"], cfg["u_max"] + 1))
        save_tensor(torch.from_numpy(rng.randn(T, F).astype(np.float32)),
                    os.path.join(root, "feat", f"utt{n:03d}.pt"))
        save_tensor(torch.from_numpy(rng.randint(0, V, U).astype(np.int64)),
                    os.path.join(root, "ref", f"utt{n:03d}.pt"))
        frames, tokens = frames + T, tokens + U
    return frames, tokens


def noisy_hyps(load_tensor, save_tensor, ref_dir, out_dir, V):
    """Each reference with seeded substitutions, deletions and insertions
    (each token: kept 80%, substituted 10%, deleted 10%, and an inserted
    token after it 10% of the time), written to ``out_dir``."""
    rng = np.random.RandomState(SEED + 52)
    for name in sorted(os.listdir(ref_dir)):
        hyp = []
        for t in load_tensor(os.path.join(ref_dir, name)).tolist():
            r = rng.rand()
            if r < 0.1:
                hyp.append(int(rng.randint(V)))
            elif r < 0.9:
                hyp.append(t)
            if rng.rand() < 0.1:
                hyp.append(int(rng.randint(V)))
        save_tensor(torch.tensor(hyp, dtype=torch.int64), os.path.join(out_dir, name))


def phase_recipe(pkg, kernels, cfg=RECIPE, dev="cuda"):
    """The training recipe of examples/train_ctc_asr.py through the port's
    entry points, at the bench model's width: (a) a SpectDataSet of 128
    utterances written with ``save_tensor`` into a temporary directory and
    validated by ``get-torch-spect-data-dir-info --strict``; (b) 2 epochs
    of ``SpectDataLoader(batch_size=32, do_mvn=True, seed=7,
    init_epoch=epoch)`` on the card, SpecAugment at ``SA_ARGS`` (one
    ``spec_augment_apply`` launch a step), losses finite and epoch 2's mean
    below epoch 1's; (c) ``TrainingStateController(num_epochs=3, seed=1)``
    updated after each epoch; a fresh controller reports epoch 2 and loads
    its checkpoint into a fresh model and AdamW, whose parameters and state
    equal the live ones bit for bit; (d) greedy hypotheses of all 128
    utterances written with ``write_hyp`` and scored by
    ``compute-torch-token-data-dir-error-rates --batch-size 32`` (one
    ``edit_distance`` launch a batch): exactly 1.0 when every hypothesis is
    empty, and equal to the command on the CPU (the plain DP); the same for
    the references with seeded edits. (e) Epoch seconds, steps a second,
    the loader's host share of an epoch (time in ``next(loader)``),
    checkpoint save and load ms and bytes, and the device idle share over
    a third, traced epoch. Returns the launches."""
    (ConformerConfig, ConformerCTC, adamw, make_train_step, img, data, training,
     command_line, serial, ctc_greedy_search) = pkg
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_recipe_")
    try:
        root = os.path.join(work, "data")
        t0 = time.perf_counter()
        frames, tokens = recipe_data(serial.save_tensor, root, cfg)
        write_s = time.perf_counter() - t0
        data_bytes = sum(
            os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs
        )
        info_path = os.path.join(work, "info.txt")
        if command_line.get_torch_spect_data_dir_info([root, info_path, "--strict"]) != 0:
            raise AssertionError("get-torch-spect-data-dir-info failed on the recipe's data")
        with open(info_path) as f:
            info = dict(line.split() for line in f)
        expect = {"num_utterances": cfg["utts"], "num_filts": cfg["model"]["num_filts"],
                  "total_frames": frames, "total_tokens": tokens}
        if {k: int(info[k]) for k in expect} != expect:
            raise AssertionError(f"data dir info {info} != {expect}")

        mcfg = ConformerConfig(**cfg["model"])
        model = ConformerCTC(mcfg, device=dev, generator=torch.Generator().manual_seed(SEED))
        optim = adamw(model.parameters(), LR)
        step = make_train_step(
            model, optim, lambda g, f, l: img.spec_augment(g, f, lengths=l.float(), **cfg["sa"])
        )
        gen = torch.Generator(device=dev).manual_seed(SEED + 51)
        tparams = training.TrainingStateParams(num_epochs=3, seed=1)
        hist, states = os.path.join(work, "hist.csv"), os.path.join(work, "states")
        ctl = training.TrainingStateController(tparams, hist, states)
        lp = data.SpectDataLoaderParams(batch_size=cfg["batch"], do_mvn=True)

        reads = {}

        def epoch_run(epoch):
            loader = data.SpectDataLoader(root, lp, seed=7, init_epoch=epoch, device=dev)
            reads["last"] = loader.reads  # batches read natively and item by item
            batches = iter(loader)
            losses, host_s = [], 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            while True:
                h0 = time.perf_counter()
                batch = next(batches, None)
                host_s += time.perf_counter() - h0
                if batch is None:
                    break
                feats, refs, feat_lens, ref_lens = batch
                losses.append(step(gen, feats, feat_lens, refs.clamp(min=0), ref_lens))
            torch.cuda.synchronize()
            return [float(v) for v in losses], time.perf_counter() - t0, host_s

        torch.cuda.synchronize()
        peak_reset(dev)
        kernels.reset_launches()
        epochs, save_ms = [], []
        for epoch in range(cfg["epochs"]):
            losses, wall_s, host_s = epoch_run(epoch)
            mean = float(np.mean(losses))
            t0 = time.perf_counter()
            ctl.update_for_epoch(model, optim, mean, mean)
            save_ms.append((time.perf_counter() - t0) * 1e3)
            epochs.append({"losses": losses, "mean_loss": mean, "s": wall_s,
                           "steps_per_s": len(losses) / wall_s, "loader_host_s": host_s,
                           "loader_host_share": host_s / wall_s,
                           "loader_reads": dict(reads["last"])})
        train_launches = dict(kernels.LAUNCHES)
        peak = peak_bytes(dev)
        steps = sum(len(e["losses"]) for e in epochs)
        if train_launches["spec_augment_apply"] != steps:
            raise AssertionError(f"recipe training launches {train_launches}, expected "
                                 f"{steps} spec_augment_apply")
        if not all(math.isfinite(v) for e in epochs for v in e["losses"]):
            raise AssertionError(f"recipe losses not finite: {epochs}")
        if not epochs[-1]["mean_loss"] < epochs[0]["mean_loss"]:
            raise AssertionError(f"epoch means did not fall: {[e['mean_loss'] for e in epochs]}")

        # resume into a fresh model and optimizer
        ctl2 = training.TrainingStateController(tparams, hist, states)
        if ctl2.get_last_epoch() != cfg["epochs"]:
            raise AssertionError(f"a fresh controller reports epoch {ctl2.get_last_epoch()}")
        model2 = ConformerCTC(mcfg, device=dev, generator=torch.Generator().manual_seed(SEED + 1))
        optim2 = adamw(model2.parameters(), LR)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctl2.load_model_and_optimizer_for_epoch(model2, optim2)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        same_params = all(
            torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                              model2.state_dict().values())
        )
        s1, s2 = optim.state_dict(), optim2.state_dict()
        same_state = (
            s1["param_groups"] == s2["param_groups"]
            and set(s1["state"]) == set(s2["state"])
            and all(torch.equal(s1["state"][i][k].cpu(), s2["state"][i][k].cpu())
                    for i in s1["state"] for k in s1["state"][i])
        )
        if not (same_params and same_state):
            raise AssertionError(f"resume: parameters equal {same_params}, AdamW state equal "
                                 f"{same_state}")
        info_ckpt = ctl.get_info(cfg["epochs"])
        ckpt_bytes = {
            "model": os.path.getsize(ctl.get_model_path_with_info(info_ckpt)),
            "optimizer": os.path.getsize(ctl.get_optimizer_path_with_info(info_ckpt)),
        }
        del model2, optim2

        # decode, write hyps, score
        ds = data.SpectDataSet(root, params=lp)
        eval_loader = data.SpectDataLoader(
            root, lp, shuffle=False, device=dev, suppress_uttids=False
        )
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hyp_lens = []
        with torch.no_grad():
            for feats, _, feat_lens, _, utt_ids in eval_loader:
                logits, out_lens = model(feats, feat_lens)
                _, y, y_lens = ctc_greedy_search(logits, out_lens, batch_first=True)
                y, y_lens = y.cpu(), y_lens.cpu()
                for n, utt in enumerate(utt_ids):
                    ds.write_hyp(utt, y[n, : int(y_lens[n])])
                    hyp_lens.append(int(y_lens[n]))
        decode_ms = (time.perf_counter() - t0) * 1e3
        ref_dir = os.path.join(root, "ref")
        noisy_dir = os.path.join(work, "noisy")
        noisy_hyps(serial.load_tensor, serial.save_tensor, ref_dir, noisy_dir,
                   cfg["model"]["vocab_size"])
        batches = -(-cfg["utts"] // cfg["score_batch"])
        scores = {}
        for name, hyp_dir in (("trained", os.path.join(root, "hyp")), ("noisy", noisy_dir)):
            out = {}
            for side, where in (("card", dev), ("cpu", "cpu")):
                path = os.path.join(work, f"{name}_{side}.txt")
                kernels.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rc = command_line.compute_torch_token_data_dir_error_rates(
                    [ref_dir, hyp_dir, path, "--quiet", "--batch-size", str(cfg["score_batch"]),
                     "--device", where])
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if rc != 0:
                    raise AssertionError(f"the error-rate command exited {rc} ({name}, {where})")
                with open(path) as f:
                    out[side] = (f.read(), ms, kernels.LAUNCHES["edit_distance"])
            rate = float(out["card"][0])
            if out["card"][2] != batches:
                raise AssertionError(f"{name} scoring launched edit_distance {out['card'][2]} "
                                     f"times, expected {batches}")
            if out["card"][0] != out["cpu"][0]:
                raise AssertionError(f"{name} error rate on the card {out['card'][0]!r} != the "
                                     f"CPU's {out['cpu'][0]!r}")
            if not (math.isfinite(rate) and rate >= 0):
                raise AssertionError(f"{name} error rate {rate}")
            scores[name] = {"error_rate": rate, "ms": out["card"][1], "cpu_ms": out["cpu"][1],
                            "launches": out["card"][2], "equals_cpu": True}
        all_blank = max(hyp_lens) == 0
        if all_blank and scores["trained"]["error_rate"] != 1.0:
            raise AssertionError(f"empty hypotheses scored {scores['trained']['error_rate']}")
        if not 0 < scores["noisy"]["error_rate"] < 1:
            raise AssertionError(f"seeded edits scored {scores['noisy']['error_rate']}")
        score_launches = {"edit_distance": sum(v["launches"] for v in scores.values())}

        # a third epoch, traced: the device's idle share
        kernels.reset_launches()
        traced = trace(lambda: epoch_run(cfg["epochs"]), warmup=False)
        if kernels.LAUNCHES["spec_augment_apply"] != len(epochs[0]["losses"]):
            raise AssertionError(f"traced epoch launches {dict(kernels.LAUNCHES)}")
        train_launches["spec_augment_apply"] += kernels.LAUNCHES["spec_augment_apply"]
        script = recipe_script(kernels, os.path.join(work, "script"), dev)
        train_launches["spec_augment_apply"] += script["launches"]["spec_augment_apply"]
        score_launches["edit_distance"] += script["launches"]["edit_distance"]
        emit({
            "phase": "recipe", "model": "ConformerCTC d512 L8 H8 V1024 bf16, dropout 0.1",
            "utterances": cfg["utts"], "frames": frames, "tokens": tokens,
            "data_bytes": data_bytes, "write_s": write_s, "batch": cfg["batch"],
            "epochs": epochs, "peak_mem_bytes": peak,
            "checkpoint_save_ms": save_ms, "checkpoint_load_ms": load_ms,
            "checkpoint_bytes": ckpt_bytes, "resume_bit_equal": True,
            "decode_ms": decode_ms, "hyp_len_max": max(hyp_lens), "all_blank": all_blank,
            "scores": scores, "traced_epoch": traced, "script": script,
            "launches": {"spec_augment_apply": train_launches["spec_augment_apply"],
                         **score_launches},
        })
        return {"spec_augment_apply": train_launches["spec_augment_apply"], **score_launches}
    finally:
        shutil.rmtree(work, ignore_errors=True)


RECIPE_SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                             "train_ctc_asr_torch.py")


def recipe_script(kernels, work, dev):
    """examples/train_ctc_asr_torch.py's ``main`` at its defaults (16
    synthesized utterances, batch 4) on ``dev``, twice in ``work``: 2
    epochs, then ``--num-epochs 3``, which must resume from the second
    checkpoint and train the third epoch alone. Both calls return 0, every
    training step launches ``spec_augment_apply`` once and each scoring
    launches ``edit_distance``; returns the launches of both calls, their
    seconds, the history's epochs, the error rate and what the script
    printed."""
    import importlib.util
    import io

    spec = importlib.util.spec_from_file_location("train_ctc_asr_torch", RECIPE_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    hist = os.path.join(work, "hist.csv")
    calls, total = [], {"spec_augment_apply": 0, "edit_distance": 0}
    for epochs in (2, 3):
        kernels.reset_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = mod.main(["--work-dir", work, "--device", dev, "--num-epochs", str(epochs)])
        if dev == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: kernels.LAUNCHES[k] for k in total}
        with open(hist) as f:
            rows = [int(line.split(",")[0]) for line in f.read().splitlines()[1:]]
        trained = [line for line in out.getvalue().splitlines() if line.startswith("epoch ")]
        calls.append({"num_epochs": epochs, "rc": rc, "s": seconds, "launches": launches,
                      "hist_epochs": rows, "trained": trained})
        if rc != 0:
            raise AssertionError(f"the recipe script returned {rc}: {calls}")
        for k in total:
            total[k] += launches[k]
    first, second = calls
    steps = first["launches"]["spec_augment_apply"] // 2
    if (
        first["hist_epochs"] != [1, 2] or second["hist_epochs"] != [1, 2, 3]
        or [len(c["trained"]) for c in calls] != [2, 1]
        or not second["trained"][0].startswith("epoch 3:")
        or steps == 0 or second["launches"]["spec_augment_apply"] != steps
        or min(c["launches"]["edit_distance"] for c in calls) < 1
    ):
        raise AssertionError(f"the recipe script did not train, resume and score: {calls}")
    with open(os.path.join(work, "wer.txt")) as f:
        rate = float(f.read())
    if not (math.isfinite(rate) and rate >= 0):
        raise AssertionError(f"the recipe script scored {rate}")
    return {"script": os.path.relpath(RECIPE_SCRIPT), "calls": calls, "error_rate": rate,
            "steps_per_epoch": steps, "launches": total}


def moe_layers(model):
    return [m for m in model.modules() if type(m).__name__ == "_MoEFeedForward"]


def moe_layer_inputs(model, feats, lens):
    """Each mixture-of-experts layer's input ``(x, pad_mask)`` in one
    deterministic forward of ``model``, on the CPU."""
    got = []
    handles = [m.register_forward_hook(
        lambda module, args, out: got.append((args[0].detach().cpu(), args[1].cpu())))
        for m in moe_layers(model)]
    try:
        with torch.no_grad():
            model(feats, lens)
    finally:
        for h in handles:
            h.remove()
    return got


def moe_routes(layers, inputs, dev):
    """Each layer's routing of its given input on ``dev``: every token's
    top-1 expert, each expert's count of choices dropped at capacity, the
    choices routed and kept, and the layer's aux loss."""
    routes = []
    for layer, (x, pad_mask) in zip(layers, inputs):
        x, pad_mask = x.to(dev), pad_mask.to(dev)
        with torch.no_grad():
            r = layer.route(layer.ln(x), pad_mask)
            aux = layer(x, pad_mask)[1]
        routed = r["gates"] > 0
        dropped = routed & ~r["keep"]
        routes.append({
            "top1": r["experts"][:, 0].cpu(),
            "dropped": torch.bincount(r["experts"][dropped], minlength=layer.wi.shape[0]).cpu(),
            "routed": int(routed.sum()), "kept": int(r["keep"].sum()), "aux": float(aux),
        })
    return routes


class ReplayedRouting:
    """Within ``with``, every mixture-of-experts layer routes as in the
    first forward run inside it: that forward's layers record their top-k
    experts, and each later forward's layers take them in place of their
    own (``route(..., experts=)``), their gates still from their own router
    probabilities. ``flips`` counts, for each later forward, the choices
    whose own expert differed from the recorded one.

    A routing decision is discrete. A token whose router probabilities lie
    within rounding of each other can pick another expert on another
    device or in float64, and that moves every later token's capacity slot
    and which choices drop, so the gradients part far more than float32
    rounding parts them. The step check holds the arithmetic to the
    float64 witness, so it replays one run's decisions (the CPU's float32
    step, the first) on every step, as it applies one CPU-solved
    SpecAugment grid; the routing itself is compared on its own
    (``moe_routes``)."""

    def __init__(self, moe_cls, layers):
        self.cls, self.layers = moe_cls, layers
        self.recorded, self.flips, self.calls = [], [], 0

    def __enter__(self):
        real = self.real = self.cls.route
        replay = self

        def route(module, y, pad_mask):
            own = real(module, y, pad_mask)
            i = replay.calls % replay.layers
            replay.calls += 1
            if len(replay.recorded) < replay.layers:
                replay.recorded.append(own["experts"].cpu())
                return own
            experts = replay.recorded[i].to(own["experts"].device)
            if i == 0:
                replay.flips.append(0)
            replay.flips[-1] += int((experts != own["experts"]).sum())
            return real(module, y, pad_mask, experts=experts)

        self.cls.route = route
        return self

    def __exit__(self, *exc):
        self.cls.route = self.real


def phase_moe(pkg, kernels, cfg=MOE, dev="cuda"):
    """The mixture-of-experts step: the recipe's model with ``num_experts=4,
    expert_top_k=2, expert_capacity_factor=1.25, moe_aux_weight=0.01`` takes
    3 steps at B=32, T=1000 (one ``spec_augment_apply`` launch a step,
    losses finite). A float32, dropout-0, 2-layer copy at its seeded and at
    its trained weights takes the step check of ``train_step_check`` (the
    card's gradients held to a float64 witness by ``grad_criterion``), with
    the CPU float32 step's routing replayed on every step
    (``ReplayedRouting``; the choices that flipped are reported); on
    the same copies, each layer given the input the CPU's forward gave it,
    the card's routing equals the CPU's: every token's top-1 expert and
    each expert's count of dropped choices equal, each layer's aux loss
    within rtol 1e-5. Step ms, peak memory and the share
    of routed choices dropped at capacity. Returns the launches."""
    ConformerConfig, ConformerCTC, adamw, make_train_step, img = pkg
    mcfg = ConformerConfig(**cfg["model"])
    model = ConformerCTC(mcfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    step = make_train_step(
        model, adamw(model.parameters(), LR),
        lambda g, f, l: img.spec_augment(g, f, lengths=l.float(), **cfg["sa"]),
    )
    batch = make_train_batch(mcfg, dev, cfg["B"], cfg["T"], cfg["U"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 55)
    seeded_routes = moe_routes(
        moe_layers(model), moe_layer_inputs(model, batch[0], batch[1]), dev
    )
    torch.cuda.synchronize()
    peak_reset(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    losses = [step(gen, *batch) for _ in range(cfg["steps"])]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = peak_bytes(dev)
    losses = [float(v) for v in losses]
    if launches["spec_augment_apply"] != cfg["steps"]:
        raise AssertionError(f"moe steps launches {launches}, expected {cfg['steps']}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"moe losses not finite: {losses}")
    (step_ms,), runs = host_ms([lambda: step(gen, *batch)])
    routed = sum(r["routed"] for r in seeded_routes)
    dropped = sum(int(r["dropped"].sum()) for r in seeded_routes)

    moe_cls = type(model.block_0.moe)
    check = train_step_check(pkg, kernels, model, dev=dev, T=cfg["T"], U=cfg["U"],
                             replay=lambda: ReplayedRouting(moe_cls, 2))
    failed = {name: res["failed"] for name, res in check.items() if res["failed"]}
    # routing of the same float32 copies, card against CPU, each layer on
    # the input the CPU's forward gave it (the forwards' own rounding would
    # otherwise reach the routers as different inputs)
    copy_cfg = dataclasses.replace(mcfg, num_layers=2, dropout=0.0, dtype=torch.float32)
    keep = ("subsample.", "block_0.", "block_1.", "ctc_head.")
    (feats, feat_lens, _, _), _ = train_inputs(img, mcfg, dev, cfg["T"], cfg["U"])
    routing = {}
    for name, sd in (
        ("seeded", ConformerCTC(copy_cfg, device="cpu",
                                generator=torch.Generator().manual_seed(SEED)).state_dict()),
        ("trained", {k: v.cpu() for k, v in model.state_dict().items() if k.startswith(keep)}),
    ):
        copies = {}
        for where in (dev, "cpu"):
            copies[where] = ConformerCTC(copy_cfg, device=where)
            copies[where].load_state_dict(sd)
        inputs = moe_layer_inputs(copies["cpu"], feats, feat_lens)
        card, cpu = (moe_routes(moe_layers(copies[w]), inputs, w) for w in (dev, "cpu"))
        res = {
            "top1_equal": all(torch.equal(a["top1"], b["top1"]) for a, b in zip(card, cpu)),
            "dropped_equal": all(torch.equal(a["dropped"], b["dropped"])
                                 for a, b in zip(card, cpu)),
            "aux_max_rel_err": max(abs(a["aux"] - b["aux"]) / abs(b["aux"])
                                   for a, b in zip(card, cpu)),
            "dropped_per_expert": [a["dropped"].tolist() for a in card],
        }
        routing[name] = res
        if not (res["top1_equal"] and res["dropped_equal"] and res["aux_max_rel_err"] <= 1e-5):
            failed.setdefault(name, []).append("routing")
    if failed:
        raise AssertionError(f"moe step on the card vs the CPU: {failed} failed: "
                             f"{check} {routing}")
    emit({
        "phase": "moe", "model": "ConformerCTC d512 L8 H8 V1024 bf16, dropout 0.1, "
                                 "E=4 top-2 capacity 1.25 aux 0.01",
        "batch": cfg["B"], "t_raw": cfg["T"], "u": cfg["U"], "losses": losses,
        "launches": launches, "first_steps_s": first_s, "step_ms": step_ms,
        "step_runs_ms": runs[0], "peak_mem_bytes": peak,
        "tokens_routed": routed, "dropped_at_capacity": dropped,
        "dropped_share": dropped / max(routed, 1),
        "dropped_per_block_expert": [r["dropped"].tolist() for r in seeded_routes],
        "card_vs_cpu_step": check, "card_vs_cpu_routing": routing,
    })
    return {"spec_augment_apply": launches["spec_augment_apply"]}


def remat_compare(ref, spread_run, other):
    """``other``'s loss and gradients against ``ref``'s: bit-equal when the
    card's two plain steps (``ref``, ``spread_run``) are; otherwise the
    loss and each gradient within 4 times the two plain steps' largest
    distance apart (each over its tensor's largest entry)."""
    (l0, g0), (l1, g1), (l2, g2) = ref, spread_run, other

    def rel(a, b):
        scale = float(b.abs().max())
        return float((a - b).abs().max()) / scale if scale > 0 else float((a - b).abs().max())

    spread = max((rel(g1[k], g0[k]) for k in g0), default=0.0)
    dist = {k: rel(g2[k], g0[k]) for k in g0}
    at = max(dist, key=dist.get)
    bit_spread = l1 == l0 and all(torch.equal(g1[k], g0[k]) for k in g0)
    if bit_spread:
        ok = l2 == l0 and all(torch.equal(g2[k], g0[k]) for k in g0)
    else:
        ok = abs(l2 - l0) <= 4 * abs(l1 - l0) and dist[at] <= 4 * spread
    return {"ok": ok, "plain_steps_bit_equal": bit_spread, "loss": l2, "loss_plain": l0,
            "grad_spread": spread, "grad_max_rel_err": dist[at], "grad_max_rel_err_at": at}


def phase_remat(pkg, kernels, conformer, cfg=REMAT, dev="cuda"):
    """Remat on the dense d512/L8 step (B=32, T=1000, dropout 0.1): one step
    with ``remat=True`` against ``remat=False`` from the same weights and
    generator state, under ``torch.backends.cudnn.deterministic``: the loss
    and every gradient bit-equal when two plain steps are, else within
    ``remat_compare``'s bound of the card's own spread. A planted fault, a
    remat that does not set the generator back for the recomputation, must
    fail the comparison. Both steps' ms and peak memory. Returns the
    launches (one ``spec_augment_apply`` a step)."""
    ConformerConfig, ConformerCTC, adamw, make_train_step, img = pkg
    mcfg = ConformerConfig(**cfg["model"])
    batch = make_train_batch(mcfg, dev, cfg["B"], cfg["T"], cfg["U"])
    augment = lambda g, f, l: img.spec_augment(g, f, lengths=l.float(), **cfg["sa"])  # noqa: E731

    def build(remat):
        model = ConformerCTC(dataclasses.replace(mcfg, remat=remat), device=dev,
                             generator=torch.Generator().manual_seed(SEED))
        return model, make_train_step(model, adamw(model.parameters(), LR), augment)

    def one(remat):
        model, step = build(remat)
        gen = torch.Generator(device=dev).manual_seed(SEED + 61)
        torch.cuda.synchronize()
        peak_reset(dev)
        t0 = time.perf_counter()
        loss = float(step(gen, *batch))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
        return (loss, grads), ms, peak_bytes(dev)

    real = conformer._remat_block

    def planted(block, *args):  # a plain checkpoint: the generator is not replayed
        return torch.utils.checkpoint.checkpoint(block, *args, use_reentrant=False)

    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        kernels.reset_launches()
        plain, plain_ms, plain_peak = one(False)
        again, _, _ = one(False)
        remat, remat_ms, remat_peak = one(True)
        conformer._remat_block = planted
        try:
            fault, _, _ = one(True)
        finally:
            conformer._remat_block = real
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    if launches["spec_augment_apply"] != 4:
        raise AssertionError(f"remat steps launches {launches}, expected 4 spec_augment_apply")
    res = remat_compare(plain, again, remat)
    res_fault = remat_compare(plain, again, fault)
    if not res["ok"]:
        raise AssertionError(f"remat step differs from the plain step: {res}")
    if res_fault["ok"]:
        raise AssertionError(f"the planted generator fault passed the remat check: {res_fault}")
    del plain, again, remat, fault
    steps = {}
    for remat in (False, True):
        model, step = build(remat)
        gen = torch.Generator(device=dev).manual_seed(SEED + 62)
        (steps[remat],), _ = host_ms([lambda: step(gen, *batch)])
        del model, step
    emit({
        "phase": "remat", "model": "ConformerCTC d512 L8 H8 V1024 bf16, dropout 0.1",
        "batch": cfg["B"], "t_raw": cfg["T"], "launches": launches,
        "vs_plain": res, "planted_fault": res_fault,
        "step_ms": {"plain": steps[False], "remat": steps[True]},
        "first_step_ms": {"plain": plain_ms, "remat": remat_ms},
        "peak_mem_bytes": {"plain": plain_peak, "remat": remat_peak},
    })
    return {"spec_augment_apply": launches["spec_augment_apply"]}


# ---------------------------------------------------------------------------
# Corpus preparation: the commands a user runs to turn alignments,
# transcripts and features into training data, the tar shards read through
# the native reader, and alignment and scoring of a model's outputs.

CORPUS = dict(RECIPE, run_max=30, shift_ms=10.0, shard=32, train_steps=2, subset=16,
              fixed_lobe=50, ali_lobe=2, share_rounds=2, head_scale=32.0, arpa=BIG5)


def corpus_alis(serial, root, V, run_max):
    """A seeded ``ali/`` beside ``root/feat``: each utterance's frames in
    runs of 1-``run_max`` frames, each run's label (of ``V``) unlike the one
    before it, from ``RandomState(SEED + 60)``. Returns each utterance's
    runs ``[(label, start, end), ...]``."""
    rng = np.random.RandomState(SEED + 60)
    runs = {}
    for name in sorted(os.listdir(os.path.join(root, "feat"))):
        T = serial.tensor_entry(os.path.join(root, "feat", name)).shape[0]
        ali, rs, lab = [], [], -1
        while len(ali) < T:
            n = min(int(rng.randint(1, run_max + 1)), T - len(ali))
            lab = (lab + 1 + int(rng.randint(V - 1))) % V if lab >= 0 else int(rng.randint(V))
            rs.append((lab, len(ali), len(ali) + n))
            ali += [lab] * n
        serial.save_tensor(torch.tensor(ali, dtype=torch.int64),
                           os.path.join(root, "ali", name))
        runs[name] = rs
    return runs


def ctm_frames(s, e, shift):
    """Frames ``(s, e)`` after a ctm round trip: written as ``str`` of the
    seconds and the duration, read back and turned into frames by the
    JAX package's rules (``transcript_to_token``). Seconds that land a hair
    below a frame's start move it one frame earlier."""
    st = s * shift / 1000
    st2 = float(str(st))
    en2 = st2 + float(str(e * shift / 1000 - st))
    return ctm_tg_rule(st2, en2, shift)


def tg_frames(s, e, shift, precision=3):
    """Frames ``(s, e)`` after a TextGrid round trip: seconds written with
    ``precision`` decimals, read back, and turned into frames."""
    st = float(f"{s * shift / 1000:0.{precision}f}")
    en = float(f"{e * shift / 1000:0.{precision}f}")
    return ctm_tg_rule(st, en, shift)


def ctm_tg_rule(st, en, shift):
    if st == en:
        a = b = (1000 * st) // shift
    else:
        a = (1000 * st) // shift
        b = max((1000 * en + 0.5 * shift) // shift, a + 1)
    return int(a), int(b)


def same_tensor_dirs(load_tensor, a, b):
    """The names under ``a`` and ``b`` (recursively), and every ``.pt``
    file's tensor (dtype, shape, values), are equal; files with equal bytes
    are not loaded."""
    na, nb = sorted(os.listdir(a)), sorted(os.listdir(b))
    if na != nb or not na:
        return False
    for name in na:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if os.path.isdir(pa):
            if not same_tensor_dirs(load_tensor, pa, pb):
                return False
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                if fa.read() == fb.read():
                    continue
            x, y = load_tensor(pa), load_tensor(pb)
            if x.dtype != y.dtype or not torch.equal(x, y):
                return False
    return True


def ulps_apart(a, b):
    """The largest distance in float32 units in the last place."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def arpa_token2id(path):
    """Ids for an ARPA file's unigrams: the regular tokens sorted, then
    ``<s>``, so the commands' defaults make ``<s>`` the sos id."""
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    toks, in_uni = [], False
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line == "\\1-grams:":
                in_uni = True
            elif in_uni and line.startswith("\\"):
                break
            elif in_uni and line:
                toks.append(line.split()[1])
    regular = sorted(t for t in toks if t != "<s>")
    return {t: i for i, t in enumerate(regular + ["<s>"])}


def phase_corpus(pkg, kernels, cfg=CORPUS, dev="cuda"):
    """Corpus preparation through the port's commands, at the recipe's size
    (128 utterances of 500-1,000 x 80 float32 frames, V=1024) and model
    (d512/L8/H8 bf16 ConformerCTC): (a) a seeded ``ali/`` of runs of 1-30
    frames beside the recipe's ``feat/``;
    ``torch-ali-data-dir-to-torch-token-data-dir`` gives ``(R, 3)`` refs
    equal to the runs and ``torch-token-data-dir-to-torch-ali-data-dir``
    the ``ali/`` back exactly; (b) those refs through trn (tokens equal),
    ctm and TextGrids at 10 ms (equal to what the formats' arithmetic
    gives, ``ctm_frames``/``tg_frames``), with a 1,024-line token2id;
    (c) ``torch-spect-data-dir-to-wds`` into 4 shards, whose
    ``SpectTarDataSet`` batches through ``SpectDataLoader(batch_size=32)``
    on the card equal the directory loader's bit for bit, every batch read
    natively (the phase fails on a batch read item by item, or if the
    native reader did not build); (d)
    ``compute-mvn-stats-for-torch-feat-data-dir`` on the card within 1
    float32 ulp of the CPU's; ``subset-torch-spect-data-dir`` (the first
    16); ``chunk-torch-spect-data-dir`` (the ali policy, and a fixed
    101-frame window) giving the same files on the card as on the CPU,
    with 0 and 2 workers; both length-moment printers equal to the runs'
    own moments; (e) 2 training steps from the tar loader (one
    ``spec_augment_apply`` launch each); the loader's host share of an
    epoch read three ways in turn (directory item by item, directory
    native, tar native); the model's logits (head x32, as the serve
    phase's) written as a logit dir, aligned by
    ``torch-logit-data-dir-to-torch-ali-data-dir`` on the card equal to
    the CPU's, every path collapsing to its reference; those alignments
    turned into refs and scored against the references by
    ``compute-torch-token-data-dir-error-rates`` (blank ignored): 0.0 on
    the card and the CPU, one ``edit_distance`` launch a 32-utterance
    batch; (f) ``arpa-lm-to-state-dict`` of big5 on the card equal to the
    CPU's, array for array, and ``print-arpa-lm-state-dict-info`` equal.
    Each command's wall seconds. Returns the launches."""
    (ConformerConfig, ConformerCTC, adamw, make_train_step, img, data, command_line, serial,
     native) = pkg
    import glob
    import pickle
    import shutil
    import tempfile

    if not native.available():
        raise AssertionError("the native reader did not build")
    V, shift = cfg["model"]["vocab_size"], cfg["shift_ms"]
    sh = f"{shift:g}"
    work = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    secs, checks = {}, {}

    def run(name, args, key=None):
        fn = getattr(command_line, name.replace("-", "_"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rc = fn([str(a) for a in args])
        torch.cuda.synchronize()
        secs[key or name] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"{name} {args} exited {rc}")

    def w(*parts):
        return os.path.join(work, *parts)

    def check(name, ok):
        checks[name] = bool(ok)
        if not ok:
            raise AssertionError(f"corpus: {name} failed ({checks})")

    try:
        root = w("data")
        t0 = time.perf_counter()
        frames, _ = recipe_data(serial.save_tensor, root, cfg)
        shutil.rmtree(os.path.join(root, "ref"))
        runs = corpus_alis(serial, root, V, cfg["run_max"])
        write_s = time.perf_counter() - t0
        names = sorted(runs)
        refs = {n: torch.tensor(r, dtype=torch.int64) for n, r in runs.items()}

        # (a) alignments and references
        ref_dir, ali_dir = os.path.join(root, "ref"), os.path.join(root, "ali")
        run("torch-ali-data-dir-to-torch-token-data-dir", [ali_dir, ref_dir])
        check("ali_to_ref_equals_runs", all(
            torch.equal(serial.load_tensor(os.path.join(ref_dir, n)), refs[n]) for n in names))
        run("torch-token-data-dir-to-torch-ali-data-dir",
            [ref_dir, w("ali_back"), "--feat-dir", os.path.join(root, "feat")])
        check("ref_to_ali_round_trip", same_tensor_dirs(serial.load_tensor, ali_dir,
                                                        w("ali_back")))

        # (b) transcripts
        t2i = w("token2id.txt")
        with open(t2i, "w") as f:
            f.writelines(f"w{i:04d} {i}\n" for i in range(V))
        run("torch-token-data-dir-to-trn", [ref_dir, t2i, w("refs.trn"), "--swap"])
        run("trn-to-torch-token-data-dir", [w("refs.trn"), t2i, w("trn_ref"),
                                            "--skip-frame-times"])
        check("trn_round_trip", all(torch.equal(
            serial.load_tensor(w("trn_ref", n)), refs[n][:, 0]) for n in names))
        moved = {"ctm": 0, "textgrid": 0}
        run("torch-token-data-dir-to-ctm", [ref_dir, t2i, w("refs.ctm"), "--swap",
                                            "--frame-shift-ms", sh])
        run("ctm-to-torch-token-data-dir", [w("refs.ctm"), t2i, w("ctm_ref"),
                                            "--frame-shift-ms", sh])
        run("torch-token-data-dir-to-textgrids", [ref_dir, t2i, w("tg"), "--swap",
                                                  "--feat-dir", os.path.join(root, "feat"),
                                                  "--frame-shift-ms", sh])
        run("textgrids-to-torch-token-data-dir", [w("tg"), t2i, w("tg_ref"),
                                                  "--frame-shift-ms", sh])
        for fmt, sub, rule in (("ctm", "ctm_ref", ctm_frames), ("textgrid", "tg_ref",
                                                                    tg_frames)):
            ok = True
            for n in names:
                exp = torch.tensor([(t, *rule(s, e, shift)) for t, s, e in runs[n]])
                moved[fmt] += int((exp[:, 1:] != refs[n][:, 1:]).sum())
                ok &= torch.equal(serial.load_tensor(w(sub, n)), exp)
            check(f"{fmt}_round_trip", ok)

        # (c) tar shards, read natively
        run("torch-spect-data-dir-to-wds", [root, w("shards", "corpus.tar"), "--shard",
                                            "--max-samples-per-shard", cfg["shard"]])
        shards = sorted(glob.glob(w("shards", "corpus.tar.*")))
        check("shards", len(shards) == -(-cfg["utts"] // cfg["shard"]))
        lp = data.SpectDataLoaderParams(batch_size=cfg["batch"], do_mvn=True)

        def loaders(seed, epoch=0):
            tar = data.SpectDataLoader(data.SpectTarDataSet(shards, params=lp), lp, seed=seed,
                                       init_epoch=epoch, device=dev)
            return tar, data.SpectDataLoader(root, lp, seed=seed, init_epoch=epoch, device=dev)

        tar_loader, dir_loader = loaders(7)
        tb, db = list(tar_loader), list(dir_loader)
        check("tar_batches_equal_directory", len(tb) == len(db) and all(
            len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
            for a, b in zip(tb, db)))
        n_batches = len(tb)
        check("tar_read_natively", tar_loader.reads == {"native": n_batches, "per_item": 0})
        check("directory_read_natively",
              dir_loader.reads == {"native": n_batches, "per_item": 0})
        del tb, db

        # (d) MVN statistics, subset, chunks, length moments
        feat_dir = os.path.join(root, "feat")
        stats = {}
        for side, where in (("card", dev), ("cpu", "cpu")):
            run("compute-mvn-stats-for-torch-feat-data-dir",
                [feat_dir, w(f"mvn_{side}.pkl"), "--device", where], f"mvn_{side}")
            with open(w(f"mvn_{side}.pkl"), "rb") as f:
                stats[side] = pickle.load(f)
        mvn_ulps = max(ulps_apart(stats["card"][k], stats["cpu"][k]) for k in ("mean", "std"))
        check("mvn_card_vs_cpu_within_1_ulp", mvn_ulps <= 1)
        run("subset-torch-spect-data-dir", [root, w("sub"), "--first-n", cfg["subset"]])
        check("subset_first_n", sorted(os.listdir(w("sub", "feat"))) == names[:cfg["subset"]])
        chunks = {}
        for policy, opts in (("ali", ["--policy", "ali", "--lobe-size", cfg["ali_lobe"]]),
                             ("fixed", ["--policy", "fixed", "--lobe-size", cfg["fixed_lobe"]])):
            for side, where, workers in (("cpu", "cpu", 0), ("card", dev, 0), ("card_w2", dev, 2)):
                out = w(f"chunk_{policy}_{side}")
                run("chunk-torch-spect-data-dir",
                    [w("sub"), out, "--quiet", "--device", where, "--num-workers", workers]
                    + opts, f"chunk_{policy}_{side}")
                if side != "cpu":
                    check(f"chunk_{policy}_{side}_equals_cpu", same_tensor_dirs(
                        serial.load_tensor, w(f"chunk_{policy}_cpu"), out))
            chunks[policy] = len(os.listdir(os.path.join(out, "feat")))
        lens = [e - s for n in names for _, s, e in runs[n]]
        c, s1, s2 = len(lens), sum(lens), sum(x * x for x in lens)
        mean = s1 / c
        expect_moments = f"{mean:0.03f} ({s2 / c - mean ** 2:0.03f})\n"
        for name, sub in (("print-torch-ali-data-dir-length-moments", "ali"),
                          ("print-torch-ref-data-dir-length-moments", "ref")):
            run(name, [os.path.join(root, sub), w(f"moments_{sub}.txt")])
            with open(w(f"moments_{sub}.txt")) as f:
                check(f"{sub}_moments", f.read() == expect_moments)

        # training from the tar shards
        mcfg = ConformerConfig(**cfg["model"])
        model = ConformerCTC(mcfg, device=dev, generator=torch.Generator().manual_seed(SEED + 3))
        optim = adamw(model.parameters(), LR)
        step = make_train_step(
            model, optim, lambda g, f, l: img.spec_augment(g, f, lengths=l.float(), **cfg["sa"])
        )
        gen = torch.Generator(device=dev).manual_seed(SEED + 61)

        def train_on(batches):
            losses = []
            for feats, refs_b, feat_lens, ref_lens in batches:
                losses.append(step(gen, feats, feat_lens, refs_b.clamp(min=0), ref_lens))
            return [float(v) for v in losses]

        torch.cuda.synchronize()
        kernels.reset_launches()
        tar_loader, _ = loaders(8)
        it = iter(tar_loader)
        losses = train_on(next(it) for _ in range(cfg["train_steps"]))
        del it
        check("tar_steps_finite", all(math.isfinite(v) for v in losses))
        check("tar_steps_native", tar_loader.reads["per_item"] == 0)

        def epoch(kind, ep):
            tar, direct = loaders(9, ep)
            loader = tar if kind == "tar_native" else direct
            old = os.environ.get("PYDROBERT_TPU_NATIVE_IO")
            if kind == "dir_per_item":
                os.environ["PYDROBERT_TPU_NATIVE_IO"] = "0"
            try:
                batches, host_s, n = iter(loader), 0.0, 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                while True:
                    h0 = time.perf_counter()
                    batch = next(batches, None)
                    host_s += time.perf_counter() - h0
                    if batch is None:
                        break
                    train_on([batch])
                    n += 1
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                if old is None:
                    os.environ.pop("PYDROBERT_TPU_NATIVE_IO", None)
                else:
                    os.environ["PYDROBERT_TPU_NATIVE_IO"] = old
            want = "per_item" if kind == "dir_per_item" else "native"
            if loader.reads[want] != n:
                raise AssertionError(f"corpus: the {kind} epoch read {loader.reads}")
            return {"host_s": host_s, "s": wall, "host_share": host_s / wall, "steps": n}

        share = {k: [] for k in ("dir_per_item", "dir_native", "tar_native")}
        for r in range(cfg["share_rounds"]):
            for kind in share:
                share[kind].append(epoch(kind, r))
        steps = cfg["train_steps"] + sum(e["steps"] for v in share.values() for e in v)

        # (e) alignment of the model's logits, and scoring
        with torch.no_grad():
            model.ctc_head.weight.mul_(cfg["head_scale"])
        logit_dir = w("logit")
        os.makedirs(logit_dir)
        eval_loader = data.SpectDataLoader(root, lp, shuffle=False, device=dev,
                                           suppress_uttids=False)
        model.eval()
        t0 = time.perf_counter()
        with torch.no_grad():
            for feats, _, feat_lens, _, utt_ids in eval_loader:
                logits, out_lens = model(feats, feat_lens)
                logits, out_lens = logits.float().cpu(), out_lens.cpu()
                for n, utt in enumerate(utt_ids):
                    serial.save_tensor(logits[n, : int(out_lens[n])],
                                       os.path.join(logit_dir, utt + ".pt"))
        logit_s = time.perf_counter() - t0
        Vp1 = logits.shape[-1]
        for side, where in (("card", dev), ("cpu", "cpu")):
            run("torch-logit-data-dir-to-torch-ali-data-dir",
                [logit_dir, ref_dir, w(f"aligned_{side}"), "--device", where],
                f"align_{side}")
        check("aligned_card_equals_cpu", same_tensor_dirs(serial.load_tensor, w("aligned_cpu"),
                                                          w("aligned_card")))
        check("aligned_paths_collapse_to_refs", all(torch.equal(
            collapse(serial.load_tensor(w("aligned_card", n)), Vp1 - 1), refs[n][:, 0])
            for n in names))
        run("torch-ali-data-dir-to-torch-token-data-dir", [w("aligned_card"), w("hyp")],
            "aligned_to_ref")
        with open(w("ignore.txt"), "w") as f:
            f.write(f"{Vp1 - 1}\n")
        rates = {}
        for side, where in (("card", dev), ("cpu", "cpu")):
            before = kernels.LAUNCHES["edit_distance"]
            run("compute-torch-token-data-dir-error-rates",
                [ref_dir, w("hyp"), w(f"er_{side}.txt"), "--ignore", w("ignore.txt"),
                 "--batch-size", cfg["score_batch"], "--quiet", "--device", where],
                f"error_rates_{side}")
            with open(w(f"er_{side}.txt")) as f:
                rates[side] = (f.read(), kernels.LAUNCHES["edit_distance"] - before)
        launches = dict(kernels.LAUNCHES)
        # the CPU run takes the plain version, which counts no launch on a
        # card (a CPU rehearsal counts the calls of both)
        launches["edit_distance"] -= rates["cpu"][1]
        check("error_rate_card_equals_cpu", rates["card"][0] == rates["cpu"][0])
        check("error_rate_zero", float(rates["card"][0]) == 0.0)
        check("spec_augment_launches", launches["spec_augment_apply"] == steps)
        check("edit_distance_launches", launches["edit_distance"] == rates["card"][1]
              == -(-cfg["utts"] // cfg["score_batch"]))

        # (f) ARPA
        arpa = cfg["arpa"]
        if arpa.endswith(".gz"):
            import gzip

            with gzip.open(arpa, "rb") as fi, open(w("lm.arpa"), "wb") as fo:
                shutil.copyfileobj(fi, fo)
            arpa = w("lm.arpa")
        with open(w("lm_token2id.txt"), "w") as f:
            f.writelines(f"{t} {i}\n" for t, i in arpa_token2id(arpa).items())
        arrays, infos = {}, {}
        for side, where in (("card", dev), ("cpu", "cpu")):
            run("arpa-lm-to-state-dict", [arpa, w("lm_token2id.txt"), w(f"lm_{side}.npz"),
                                          "--device", where], f"arpa_{side}")
            arrays[side] = dict(np.load(w(f"lm_{side}.npz")))
            run("print-arpa-lm-state-dict-info", [w(f"lm_{side}.npz"), w(f"lm_{side}.txt")],
                f"arpa_info_{side}")
            with open(w(f"lm_{side}.txt")) as f:
                infos[side] = f.read()
        check("arpa_state_dict_card_equals_cpu", sorted(arrays["card"]) == sorted(arrays["cpu"])
              and all(arrays["card"][k].dtype == arrays["cpu"][k].dtype
                      and np.array_equal(arrays["card"][k], arrays["cpu"][k])
                      for k in arrays["cpu"]))
        check("arpa_info_card_equals_cpu", infos["card"] == infos["cpu"])

        emit({
            "phase": "corpus", "nvidia_smi": smi_line(),
            "model": "ConformerCTC d512 L8 H8 V1024 bf16, dropout 0.1",
            "utterances": cfg["utts"], "frames": frames, "write_s": write_s,
            "ali_runs": sum(len(r) for r in runs.values()), "moved_boundaries": moved,
            "mvn_card_vs_cpu_ulps": mvn_ulps, "chunks": chunks, "shards": len(shards),
            "tar_batches": n_batches, "train_losses": losses,
            "loader_host_share": share, "logit_write_s": logit_s,
            "error_rate": float(rates["card"][0]), "arpa": cfg["arpa"],
            "arpa_info": dict(line.split() for line in infos["card"].splitlines()),
            "command_s": secs, "checks": checks,
            "launches": {"spec_augment_apply": launches["spec_augment_apply"],
                         "edit_distance": launches["edit_distance"]},
        })
        return {"spec_augment_apply": launches["spec_augment_apply"],
                "edit_distance": launches["edit_distance"]}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# Serving artifacts, the parallel package and the profiling utilities
# ---------------------------------------------------------------------------

ARTIFACT = dict(
    model=dict(vocab_size=1024, num_filts=80, d_model=512, num_layers=8, num_heads=8),
    head_scale=32.0, spec=(N_BATCH, T_RAW), width=WIDTH, requests=N_REQUESTS,
    pad_call=(20, 1500), rnnt=None, rnnt_spec=(RNNT_B, RNNT_T), rnnt_requests=RNNT_REQUESTS,
    reps=3, heads=("ctc_greedy", "ctc_w16_scan", "ctc_w16_beam", "ctc_w16_raw", "rnnt_greedy",
                   "rnnt_beam"),
)

# The artifacts served in one fresh process that imports torch, the
# kernels' module and the loader, and no model code: ``python -c
# ARTIFACT_SERVER JOBS DEVICE REPS``, JOBS a JSON list of ``[name, ART_DIR,
# IN, OUT]``. IN holds the requests (the last one a padded call); OUT gets
# the outputs, the launches of the requests, the load, first-call and
# request times, and the modules of model code the process had imported.
# The card is initialised first and timed on its own.
ARTIFACT_SERVER = r"""
import json, statistics, sys, time
import torch
import pydrobert_tpu_torch.ops.kernels as kernels
from pydrobert_tpu_torch.export import ServingArtifact

jobs, dev, reps = json.loads(sys.argv[1]), sys.argv[2], int(sys.argv[3])
cuda = dev == "cuda"
sync = torch.cuda.synchronize if cuda else (lambda: None)
t0 = time.perf_counter()
torch.zeros((1,), device=dev).add_(1)
sync()
init_ms = (time.perf_counter() - t0) * 1e3
for name, path, src, dst in jobs:
    requests = [(f.to(dev), l.to(dev)) for f, l in torch.load(src)]
    t0 = time.perf_counter()
    art = ServingArtifact.load(path, device=dev)
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    art(*requests[0])
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    kernels.reset_launches()
    outs = [tuple(y.cpu() for y in art(f, l)) for f, l in requests[:-1]]
    sync()
    launches = dict(kernels.LAUNCHES)
    outs.append(tuple(y.cpu() for y in art(*requests[-1])))
    times = []
    for _ in range(reps):
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            art(*requests[0])
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            art(*requests[0])
            times.append((time.perf_counter() - t0) * 1e3)
    del art
    model_code = sorted(
        m for m in sys.modules
        if m.startswith(("pydrobert_tpu_torch.models", "pydrobert_tpu_torch.lm"))
        or m in ("pydrobert_tpu_torch.ops.decoding", "pydrobert_tpu_torch.ops.transducer",
                 "pydrobert_tpu_torch.serving", "jax", "pydrobert_tpu")
    )
    torch.save({"outs": outs, "launches": launches, "init_ms": init_ms, "load_ms": load_ms,
                "first_call_ms": first_ms, "request_ms": statistics.median(times),
                "request_runs_ms": times, "model_code": model_code}, dst)
"""


def artifact_stats(art, path, count_body_kernels):
    """Nodes of the exported program (its graph and its loop bodies), the
    kernels' operator nodes in it, and the artifact's bytes on disk."""
    bodies = count_body_kernels(art._programs[0])
    return {
        "graph_nodes": sum(sum(b["ops"].values()) for b in bodies.values()),
        "loop_body_nodes": {k: sum(b["ops"].values()) for k, b in bodies.items() if k != "main"},
        "kernel_ops": {
            op.split("::")[1]: n for b in bodies.values() for op, n in b["ops"].items()
            if op.startswith("pydrobert_tpu_torch::")
        },
        "bytes": sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)),
    }


def serve_artifacts(jobs, work, dev, reps):
    """``ARTIFACT_SERVER`` in one fresh process for the ``(name, path,
    requests)`` of ``jobs``, in turn; their records by name, and the
    process's wall seconds."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    spec = []
    for name, path, requests in jobs:
        src, dst = os.path.join(work, f"{name}_in.pt"), os.path.join(work, f"{name}_out.pt")
        torch.save([(f.cpu(), l.cpu()) for f, l in requests], src)
        spec.append([name, path, src, dst])
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", ARTIFACT_SERVER, json.dumps(spec), dev, str(reps)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
    )
    try:
        err = proc.communicate(timeout=900)[1]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the artifact server failed:\n{err[-4000:]}")
    recs = {}
    for name, _, _, dst in spec:
        recs[name] = torch.load(dst)
        if recs[name]["model_code"]:
            raise AssertionError(
                f"the artifact server imported model code: {recs[name]['model_code']}"
            )
    return recs, wall_s


def same_outputs(got, exp):
    """Every output bit-equal (shapes, dtypes and values)."""
    return len(got) == len(exp) and all(
        a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
        for a, b in zip(got, exp)
    )


def padded_live(head, call, spec):
    """The live head on ``call`` zero-padded to ``spec`` (batch and time),
    its outputs sliced back to the call's rows: what an artifact that pads
    and slices must give."""
    f, l = call
    N, T = spec
    pf = f.new_zeros((N, T) + tuple(f.shape[2:]))
    pf[: f.shape[0], : f.shape[1]] = f
    pl = l.new_zeros((N,))
    pl[: l.shape[0]] = l
    return tuple(y[: f.shape[0]] for y in head(pf, pl))


def served_check(name, rec, live, expect):
    """The server's outputs bit-equal to ``live`` (the requests', then the
    padded call's), and its launches of the requests equal to ``expect``."""
    bad = [i for i, (g, e) in enumerate(zip(rec["outs"], live)) if not same_outputs(g, e)]
    if bad or len(rec["outs"]) != len(live):
        raise AssertionError(f"artifact {name}: calls {bad} differ from the live head")
    for kernel, n in expect.items():
        if rec["launches"][kernel] != n:
            raise AssertionError(
                f"artifact {name}: {kernel} launched {rec['launches'][kernel]} times, "
                f"expected {n}"
            )


def phase_artifact(pkg, kernels, cfg=ARTIFACT, dev="cuda"):
    """Serving artifacts of the serve cell's ConformerCTC (d512/L8/H8/V1024,
    bf16, head x32) at spec (32, 2000): greedy, width 16 on the scan route
    (``USE_BEAM_KERNEL="0"``), width 16 with the default arguments (the
    renormalizing whole-loop route) and width 16 with ``DECODE_RENORM``
    off (the raw-mass whole-loop route), each exported with the kernels'
    operators recorded; then the
    transducer cell's greedy (2 symbols a frame) and width-4 beam (4 rounds)
    heads at (32, 500). Each is exported (seconds, graph nodes, the
    kernels' operator nodes, bytes) and served by ``ARTIFACT_SERVER``, one
    fresh process that loads and serves the six in turn: three requests
    and a B=20, T=1500 call padded to the spec and sliced back, every
    output bit-equal to the live head on the card (the padded call's to the
    live head on the same zero-padded batch, sliced to its 20 rows), the
    kernels' launches counted there (one ``decode_prologue`` a request on
    the scan route, one ``decode_prologue`` and one
    ``ctc_beam_search_renorm`` by default, one ``top_m`` and one
    ``ctc_beam_search`` on the raw route); load, first-call and request
    times beside the live request's."""
    import shutil
    import tempfile

    config, export, ConformerConfig, ConformerCTC, rnnt, count_body_kernels = pkg
    on_card = dev == "cuda"
    mcfg = ConformerConfig(**cfg["model"])
    model = ConformerCTC(mcfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        model.ctc_head.weight.mul_(cfg["head_scale"])
    N, T = cfg["spec"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    requests = [
        (torch.randn((N, T, mcfg.num_filts), generator=gen, device=dev),
         torch.randint(T // 2, T + 1, (N,), generator=gen, device=dev).to(torch.int32))
        for _ in range(cfg["requests"])
    ]
    pn, pt = cfg["pad_call"]
    calls = requests + [(requests[0][0][:pn, :pt].contiguous(), requests[0][1][:pn].clamp(max=pt))]
    work = tempfile.mkdtemp(prefix="pdt_artifacts_")
    heads, out = {}, {}
    try:
        for name, width, route, renorm in (
            ("ctc_greedy", None, "auto", True),
            ("ctc_w16_scan", cfg["width"], "0", True),
            ("ctc_w16_beam", cfg["width"], "auto", True),
            ("ctc_w16_raw", cfg["width"], "auto", False),
        ):
            if name not in cfg["heads"]:
                continue
            saved = config.USE_BEAM_KERNEL, config.DECODE_RENORM
            config.USE_BEAM_KERNEL, config.DECODE_RENORM = route, renorm
            try:
                path = os.path.join(work, name)
                t0 = time.perf_counter()
                art = export.export_ctc_recognizer(path, model, specs=[cfg["spec"]], width=width)
                export_s = time.perf_counter() - t0
                recognize = export.ctc_recognizer(model, width)
                live = [recognize(f, l) for f, l in requests]
                live.append(padded_live(recognize, calls[-1], cfg["spec"]))
                live_ms = cuda_ms(lambda: recognize(*requests[0]), reps=cfg["reps"], inner=1)
            finally:
                config.USE_BEAM_KERNEL, config.DECODE_RENORM = saved
            stats = artifact_stats(art, path, count_body_kernels)
            heads[name] = (path, live, live_ms, export_s, stats)
            del art
        ConformerConfigR, TransducerConfig, ConformerTransducer = rnnt[:3]
        rcfg = cfg["rnnt"] or rnnt_cfg(rnnt, dropout=0.0)
        rmodel = rnnt_model(rnnt, rcfg, dev, decisive=True)
        rn, rt = cfg["rnnt_spec"]
        rgen = torch.Generator(device=dev).manual_seed(SEED + 20)
        rreq = [
            (torch.randn((rn, rt, rcfg.encoder.num_filts), generator=rgen, device=dev),
             torch.full((rn,), rt, dtype=torch.int32, device=dev))
            for _ in range(cfg["rnnt_requests"])
        ]
        rcalls = rreq + [(rreq[0][0][: rn // 2 + 1, : rt * 3 // 4].contiguous(),
                          torch.full((rn // 2 + 1,), rt * 3 // 4, dtype=torch.int32, device=dev))]
        for name, mode, args in (
            ("rnnt_greedy", "greedy", dict(max_symbols_per_frame=RNNT_GREEDY_E)),
            ("rnnt_beam", "beam", dict(width=RNNT_W, max_symbols_per_frame=RNNT_BEAM_E)),
        ):
            if name not in cfg["heads"]:
                continue
            path = os.path.join(work, name)
            t0 = time.perf_counter()
            art = export.export_transducer_recognizer(
                path, rmodel, specs=[cfg["rnnt_spec"]], mode=mode, **args
            )
            export_s = time.perf_counter() - t0
            if mode == "greedy":
                head = lambda f, l: rmodel.greedy(f, l, RNNT_GREEDY_E)  # noqa: E731
            else:
                head = lambda f, l: rmodel.beam(f, l, RNNT_W, RNNT_BEAM_E)  # noqa: E731
            live = [head(f, l) for f, l in rreq]
            live.append(padded_live(head, rcalls[-1], cfg["rnnt_spec"]))
            live_ms = cuda_ms(lambda: head(*rreq[0]), reps=cfg["reps"], inner=1)
            stats = artifact_stats(art, path, count_body_kernels)
            heads[name] = (path, live, live_ms, export_s, stats)
            del art
        # the operators each program records, wherever it is served: each
        # encoder block's depthwise conv, and the search's kernels
        convs = {"depthwise_conv1d": mcfg.num_layers}
        rconvs = {"depthwise_conv1d": rcfg.encoder.num_layers}
        recorded = {
            "ctc_greedy": convs, "rnnt_greedy": rconvs, "rnnt_beam": rconvs,
            "ctc_w16_scan": {"decode_prologue": 1, **convs},
            "ctc_w16_beam": {"decode_prologue": 1, "ctc_beam_search_renorm": 1, **convs},
            "ctc_w16_raw": {"top_m": 1, "ctc_beam_search": 1, **convs},
        }
        expect = {
            name: {k: n * (cfg["rnnt_requests"] if name.startswith("rnnt") else cfg["requests"])
                   for k, n in ops.items()} if on_card else {}
            for name, ops in recorded.items()
        }
        for name, h in heads.items():
            if h[4]["kernel_ops"] != recorded[name]:
                raise AssertionError(
                    f"artifact {name} records the operators {h[4]['kernel_ops']}, "
                    f"expected {recorded[name]}"
                )
        launches = {"decode_prologue": 0, "top_m": 0, "ctc_beam_search": 0,
                    "ctc_beam_search_renorm": 0, "depthwise_conv1d": 0}
        recs, servers_s = serve_artifacts(
            [(name, h[0], calls if name.startswith("ctc") else rcalls)
             for name, h in heads.items()],
            work, dev, cfg["reps"],
        )
        for name, (path, live, live_ms, export_s, stats) in heads.items():
            rec = recs[name]
            served_check(name, rec, live, expect[name])
            for k in launches:
                launches[k] += rec["launches"].get(k, 0)
            out[name] = {
                "export_s": export_s, **stats, "load_ms": rec["load_ms"],
                "first_call_ms": rec["first_call_ms"],
                "request_ms": rec["request_ms"], "live_request_ms": live_ms,
                "launches": {k: v for k, v in rec["launches"].items() if v},
                "bit_equal_calls": len(live),
            }
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({
        "phase": "artifact", "nvidia_smi": smi_line(),
        "ctc_model": "ConformerCTC d512 L8 H8 V1024 bf16, head x32, seeded",
        "rnnt_model": "ConformerTransducer d256 L4 H4 V1024 bf16 encoder, decisive joint",
        "ctc_spec": list(cfg["spec"]), "rnnt_spec": list(cfg["rnnt_spec"]),
        "padded_call": list(cfg["pad_call"]), "requests": cfg["requests"],
        "server": {"artifacts": len(out), "wall_s": servers_s,
                   "card_init_ms": next(iter(recs.values()))["init_ms"] if recs else None,
                   "load": "one fresh process, the artifacts loaded and served in turn"},
        "heads": out,
    })
    return launches


PARALLEL = dict(
    model=dict(vocab_size=1024, num_filts=80, d_model=512, num_layers=8, num_heads=8),
    step_layers=2, step_batch=(8, 400, 40), microbatches=4, export_spec=(8, 400), lr=1e-2,
)


def _init_group(dev):
    """A one-rank process group (NCCL with a gloo side for the CPU on the
    card, gloo on the CPU), unless one is open; whether this made it."""
    import socket

    dist = torch.distributed
    if dist.is_initialized():
        return False
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group(
        "cpu:gloo,cuda:nccl" if dev == "cuda" else "gloo",
        init_method=f"tcp://localhost:{port}", rank=0, world_size=1,
    )
    return True


def _grads(named):
    return {k: v.grad.detach().cpu() for k, v in named.items()}


def phase_parallel(pkg, cfg=PARALLEL, dev="cuda"):
    """The parallel package on a one-rank group (the multi-rank forms run
    under gloo on the CPU against the JAX package: tests/test_torch_parallel.py,
    world sizes 2 and 4). The serve cell's model placed by ``shard_params``
    with ``conformer_partition_rules`` on ``make_mesh(1)``: its forward
    from the gathered shards bit-equal to the plain forward. A float32,
    2-layer, dropout-0 copy: the pipelined forward (pp=1, m=4) and one
    pipelined SGD step against the plain step, each card gradient held to a
    float64 CPU witness by the training check's criterion (C5: max(2.5e-3,
    2.5 x the CPU's, 1.2 x the card's spread, cuDNN off)). A sharded greedy
    export (data-parallel, the parameters replicated) bit-equal to the live
    greedy head, which the artifact phase holds the unsharded artifact to. The model and AdamW state (params,
    gradients, both moments) saved with ``save_sharded(async_save=True)``,
    one training step taken while it writes, waited for and restored bit
    for bit; a synchronous save's time beside it."""
    import shutil
    import tempfile

    ConformerConfig, ConformerCTC, conformer, make_train_step, export, parallel = pkg
    made = _init_group(dev)
    try:
        mesh = parallel.make_mesh(1)
        mcfg = ConformerConfig(**cfg["model"])
        model = ConformerCTC(mcfg, device=dev, generator=torch.Generator().manual_seed(SEED))
        sd = model.state_dict()
        sp = parallel.shard_params(sd, mesh, conformer.conformer_partition_rules)
        full = parallel.gather_params(sp)
        B, T, U = cfg["step_batch"]
        g = torch.Generator().manual_seed(SEED + 40)
        feats = torch.randn((B, T, mcfg.num_filts), generator=g)
        lens = torch.randint(T // 2, T + 1, (B,), generator=g)
        refs = torch.randint(0, mcfg.vocab_size, (B, U), generator=g)
        ref_lens = torch.randint(U // 2, U + 1, (B,), generator=g)
        with torch.no_grad():
            plain = model(feats.to(dev), lens.to(dev))
            sharded = torch.func.functional_call(model, full, (feats.to(dev), lens.to(dev)))
        if not all(torch.equal(a, b) for a, b in zip(plain, sharded)):
            raise AssertionError("parallel: the forward from gathered shards differs")
        n_sharded = sum(
            any(type(p).__name__ == "Shard" for p in v.placements) for v in sp.values()
        )

        # pp=1 pipeline against the plain forward and step, float32
        scfg = dataclasses.replace(mcfg, num_layers=cfg["step_layers"], dropout=0.0,
                                   dtype=torch.float32)
        blocks = tuple(f"block_{i}." for i in range(scfg.num_layers))
        keep = ("subsample.",) + blocks + ("ctc_head.",)
        ssd = {k: v.detach().cpu() for k, v in sd.items() if k.startswith(keep)}
        pmesh = parallel.make_pipeline_mesh(1)
        m = cfg["microbatches"]

        def plain_step(device, dtype, cudnn=True):
            net = ConformerCTC(dataclasses.replace(scfg, dtype=dtype), device=device).to(dtype)
            net.ctc_head.dtype = dtype
            net.load_state_dict(ssd)
            opt = torch.optim.SGD(net.parameters(), lr=cfg["lr"])
            with torch.backends.cudnn.flags(enabled=cudnn):
                loss = make_train_step(net, opt)(None, feats.to(device, dtype), lens.to(device),
                                                 refs.to(device), ref_lens.to(device))
            return net, float(loss), _grads(dict(net.named_parameters()))

        _, loss_card, g_card = plain_step(dev, torch.float32)
        _, _, g_spread = plain_step(dev, torch.float32, cudnn=False)
        _, loss_cpu, g_cpu = plain_step("cpu", torch.float32)
        with float64_casts():
            _, _, witness = plain_step("cpu", torch.float64)
        ref_net = ConformerCTC(scfg, device=dev)
        ref_net.load_state_dict(ssd)
        pparams = conformer.stack_block_params(
            {k: v.detach().clone().to(dev).requires_grad_() for k, v in ssd.items()}, 1
        )
        with torch.no_grad():
            lg_plain, ol_plain = ref_net(feats.to(dev), lens.to(dev))
            lg_pipe, ol_pipe = conformer.make_pipelined_forward(ref_net, pmesh, m)(
                pparams, feats.to(dev), lens.to(dev)
            )
            with torch.backends.cudnn.flags(enabled=False):
                lg_off, _ = ref_net(feats.to(dev), lens.to(dev))
        scale = float(lg_plain.abs().max())
        fwd_err = float((lg_pipe - lg_plain).abs().max()) / scale
        fwd_spread = float((lg_off - lg_plain).abs().max()) / scale
        fwd_limit = max(GRAD_FLOOR, GRAD_S * fwd_spread)
        opt = torch.optim.SGD(list(pparams.values()), lr=cfg["lr"])
        loss_pipe = float(conformer.make_pipeline_train_step(ref_net, opt, pmesh, m)(
            pparams, None, feats.to(dev), lens.to(dev), refs.to(dev), ref_lens.to(dev)
        ))
        g_pipe = {}
        for k, v in pparams.items():
            gk = v.grad.detach().cpu()
            if k.startswith("blocks."):
                gk = gk.reshape((-1,) + gk.shape[2:])
                for i in range(gk.shape[0]):
                    g_pipe[f"block_{i}.{k[7:]}"] = gk[i]
            else:
                g_pipe[k] = gk
        card_d = grad_distances(g_pipe, witness)
        ok, worst = grad_criterion(
            card_d, grad_distances(g_cpu, witness), spread=grad_distances(g_spread, g_card)
        )
        failed = []
        if not (torch.equal(ol_pipe, ol_plain) and fwd_err <= fwd_limit):
            failed.append(f"pipelined forward: {fwd_err} > {fwd_limit}")
        if not ok:
            failed.append(f"pipelined step gradients: {worst}")
        if not math.isclose(loss_pipe, loss_card, rel_tol=1e-4):
            failed.append(f"pipelined loss {loss_pipe} vs plain {loss_card}")
        if failed:
            raise AssertionError(f"parallel: {failed}")

        # a sharded export against the live greedy head (which the artifact
        # phase holds the unsharded artifact to, bit for bit)
        work = tempfile.mkdtemp(prefix="pdt_parallel_")
        try:
            spec = cfg["export_spec"]
            export.export_ctc_recognizer(
                os.path.join(work, "sharded"), model, specs=[spec], mesh=mesh,
                partition_rules=conformer.conformer_partition_rules,
            )
            art = export.ServingArtifact.load(os.path.join(work, "sharded"), device=dev)
            f_e = feats[: spec[0], : spec[1]].to(dev)
            l_e = lens[: spec[0]].clamp(max=spec[1]).to(dev, torch.int32)
            got, exp = art(f_e, l_e), export.ctc_recognizer(model)(f_e, l_e)
            if not same_outputs(got, exp):
                raise AssertionError("parallel: the sharded artifact differs from the live head")
            mesh_meta = art.meta["mesh"]
            del art

            # the train cell's state through an asynchronous sharded save
            opt = torch.optim.AdamW(model.parameters(), lr=LR)
            step = make_train_step(model, opt)
            batch = [a.to(dev) for a in (feats, lens, refs, ref_lens)]
            step(None, *batch)
            state = {
                "params": {k: v.detach() for k, v in model.named_parameters()},
                "grads": {k: v.grad.detach() for k, v in model.named_parameters()},
                "exp_avg": {k: opt.state[v]["exp_avg"] for k, v in model.named_parameters()},
                "exp_avg_sq": {k: opt.state[v]["exp_avg_sq"] for k, v in model.named_parameters()},
            }
            state = {g: parallel.shard_params(t, mesh, conformer.conformer_partition_rules)
                     for g, t in state.items()}
            snapshot = {
                g: {k: v.to_local().clone() for k, v in t.items()} for g, t in state.items()
            }
            n_bytes = sum(
                v.numel() * v.element_size() for t in snapshot.values() for v in t.values()
            )
            path = os.path.join(work, "ckpt")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parallel.save_sharded(path + "_sync", state)
            torch.cuda.synchronize()
            sync_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            parallel.save_sharded(path, state, async_save=True)
            call_ms = (time.perf_counter() - t0) * 1e3
            t1 = time.perf_counter()
            step(None, *batch)  # the next step, while the files are written
            torch.cuda.synchronize()
            overlap_step_ms = (time.perf_counter() - t1) * 1e3
            t2 = time.perf_counter()
            parallel.wait_for_saves()
            wait_ms = (time.perf_counter() - t2) * 1e3
            back = parallel.restore_sharded(path, state)
            exact = all(
                torch.equal(back[g][k].to_local(), snapshot[g][k]) for g in snapshot
                for k in snapshot[g]
            )
            placed = all(back[g][k].placements == state[g][k].placements
                         for g in state for k in state[g])
            if not (exact and placed):
                raise AssertionError("parallel: the restored checkpoint differs from the save")
        finally:
            shutil.rmtree(work, ignore_errors=True)
    finally:
        if made:
            torch.distributed.destroy_process_group()
    emit({
        "phase": "parallel", "nvidia_smi": smi_line(),
        "group": "one rank, " + ("NCCL with gloo for the CPU" if dev == "cuda" else "gloo"),
        "multi_rank": "pp=2/tp=1, pp=2/tp=2, pp=4, m=4 and 8, shard_params, async checkpoint "
                      "and a (2, 2) mesh artifact: gloo at world sizes 2 and 4 on the CPU "
                      "against the JAX package (tests/test_torch_parallel.py)",
        "mesh": list(mesh.mesh.shape), "sharded_params": n_sharded,
        "sharded_forward_bit_equal": True,
        "pipeline": {"pp": 1, "microbatches": m, "layers": scfg.num_layers,
                     "batch": [B, T, U], "fwd_rel_err": fwd_err, "fwd_spread": fwd_spread,
                     "loss_plain": loss_card, "loss_pipe": loss_pipe, "loss_cpu": loss_cpu,
                     "grad_worst": worst},
        "sharded_export": {"spec": list(cfg["export_spec"]), "mesh": mesh_meta,
                           "bit_equal_to": "the live greedy head"},
        "checkpoint": {"bytes": n_bytes, "sync_save_ms": sync_ms, "async_call_ms": call_ms,
                       "overlap_step_ms": overlap_step_ms, "async_wait_ms": wait_ms,
                       "restore_bit_exact": exact},
    })


PROFILE_SLACK = 1.0  # launches a frame between a marked trip and a count
PROFILE_FRAMES = 16  # frames between the two short decodes that count a frame


def phase_profiling(pkg, kernels, rnnt_per_frame, cfg=ARTIFACT, dev="cuda"):
    """``profile_program`` on a served request (the serve cell, width 16):
    its median beside a CUDA-event time and ``measure_sync_overhead``, and
    from its ``compiled_stats`` the launches a trip of the scan decode's
    marked loop (``USE_BEAM_KERNEL="0"`` for the CTC head while it runs);
    ``compiled_stats`` of the transducer greedy decode (the
    transducer cell, 2 symbols a frame, ``rnnt_greedy``'s first request);
    and the decode prologue's wrapper, which launches directly, beside its
    registered operator, which exported programs call.
    It fails when a decode's loop is not marked on every trip (a scan decode
    advances every frame but the first; a greedy decode takes at least a
    trip a frame), or when the launches a frame that the marked trips give
    differ by more than ``PROFILE_SLACK`` from a count that does not read
    the marks: for the scan decode, the launches of a decode of the served
    logits' first ``2 * PROFILE_FRAMES`` frames less those of its first
    ``PROFILE_FRAMES``, over ``PROFILE_FRAMES``; for the greedy decode, the
    launches a frame that ``rnnt_greedy`` traced of the same decode
    (``rnnt_per_frame``; None skips it), where the slack covers the
    launches before and after the loop, spread over the frames, and the
    trips that launch more or less than the median one."""
    from pydrobert_tpu_torch import config

    ConformerConfig, ConformerCTC, ctc_recognizer, CTCPrefixSearch, rnnt, profiling, hlostats = pkg
    mcfg = ConformerConfig(**cfg["model"])
    model = ConformerCTC(mcfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        model.ctc_head.weight.mul_(cfg["head_scale"])
    N, T = cfg["spec"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    feats = torch.randn((N, T, mcfg.num_filts), generator=gen, device=dev)
    lens = torch.randint(T // 2, T + 1, (N,), generator=gen, device=dev)
    recognize = ctc_recognizer(model, cfg["width"])
    encode = torch.no_grad()(model)
    logits, out_lens = encode(feats, lens)
    x = logits.transpose(0, 1).contiguous()
    frames = x.shape[0]
    # one profile of a served request: its stats, and the scan decode's
    # loop inside it
    sync_s = profiling.measure_sync_overhead()
    saved = config.USE_BEAM_KERNEL
    config.USE_BEAM_KERNEL = "0"
    try:
        ctc = profiling.profile_program(recognize, feats, lens, calls=2, reps=2)
        events_ms = cuda_ms(lambda: recognize(feats, lens), reps=cfg["reps"], inner=1)
        F = min(PROFILE_FRAMES, frames // 2)
        search = CTCPrefixSearch(cfg["width"])
        with torch.no_grad():
            short = [
                hlostats.compiled_stats(
                    search, x[:n].contiguous(), out_lens.clamp(max=n)
                )["kernel_launches"]
                for n in (F, 2 * F)
            ]
    finally:
        config.USE_BEAM_KERNEL = saved
    decode_per_frame = (short[1] - short[0]) / F
    out = {"ctc_scan_decode": {
        "frames": frames, "loop_kernels": ctc["loop_kernels"],
        "loop_trip_count": ctc["loop_trip_count"], "loop_op_histogram": ctc["loop_op_histogram"],
        "request_flops": ctc["flops"], "request_bytes_accessed": ctc["bytes_accessed"],
        "request_transcendentals": ctc["transcendentals"],
        "request_launches": ctc["kernel_launches"],
        "short_decode_launches": {str(F): short[0], str(2 * F): short[1]},
        "decode_launches_per_frame": decode_per_frame,
        "outside_loop": ctc["kernel_launches"] - ctc["loop_kernels"] * ctc["loop_trip_count"],
    }, "served_request": {
        "sync_overhead_ms": sync_s * 1e3, "profile_program_ms": ctc["seconds_per_call"] * 1e3,
        "cuda_events_ms": events_ms, "us_per_kernel": ctc.get("us_per_kernel"),
    }}
    greedy = rnnt[4]
    rcfg = cfg["rnnt"] or rnnt_cfg(rnnt, dropout=0.0)
    rmodel = rnnt_model(rnnt, rcfg, dev, decisive=True)
    rn, rt = cfg["rnnt_spec"]
    rgen = torch.Generator(device=dev).manual_seed(SEED + 20)
    rf = torch.randn((rn, rt, rcfg.encoder.num_filts), generator=rgen, device=dev)
    rl = torch.full((rn,), rt, device=dev)
    with torch.no_grad():
        enc, enc_lens = rmodel.encode(rf, rl)
    step, joint, init = rnnt_decoders(rmodel)
    decode = lambda: greedy(enc, enc_lens, step, joint, init(rn), rcfg.vocab_size,  # noqa: E731
                            RNNT_GREEDY_E)
    with torch.no_grad():
        rs = hlostats.compiled_stats(decode)
    rframes = enc.shape[1]
    loop_per_frame = rs["loop_kernels"] * rs["loop_trip_count"] / rframes
    out["rnnt_greedy_decode"] = {
        "frames": rframes, "loop_kernels": rs["loop_kernels"],
        "loop_trip_count": rs["loop_trip_count"], "loop_op_histogram": rs["loop_op_histogram"],
        "trips_per_frame": rs["loop_trip_count"] / rframes,
        "loop_launches_per_frame": loop_per_frame,
        "trace_launches": rs["kernel_launches"],
        "trace_launches_per_frame": rs["kernel_launches"] / rframes,
        "rnnt_greedy_launches_per_frame": rnnt_per_frame,
    }
    out["slack_launches_per_frame"] = PROFILE_SLACK
    failed = []
    if not (ctc["loop_trip_count"] == frames - 1 and ctc["loop_kernels"] > 0):
        failed.append(f"scan decode: {ctc['loop_trip_count']} marked trips of "
                      f"{ctc['loop_kernels']} launches, {frames - 1} frames to advance")
    if abs(ctc["loop_kernels"] - decode_per_frame) > PROFILE_SLACK:
        failed.append(f"scan decode: {ctc['loop_kernels']} launches a marked trip, "
                      f"{decode_per_frame} a frame between two short decodes")
    if not (rs["loop_trip_count"] >= rframes and rs["loop_kernels"] > 0):
        failed.append(f"greedy decode: {rs['loop_trip_count']} marked trips, {rframes} frames")
    if rnnt_per_frame is not None and abs(loop_per_frame - rnnt_per_frame) > PROFILE_SLACK:
        failed.append(f"greedy decode: its marked trips give {loop_per_frame} launches a "
                      f"frame, rnnt_greedy traced {rnnt_per_frame}")
    if failed:
        raise AssertionError(f"profiling: {failed}")
    # the decode prologue's wrapper (its checks, then the launch) beside
    # its registered operator, at the headline shape
    if dev == "cuda":
        op = torch.ops.pydrobert_tpu_torch.decode_prologue
        m = M_HEADLINE
        out["prologue_dispatch"] = {
            "wrapper_ms": cuda_ms(lambda: kernels.decode_prologue(x, m)),
            "operator_ms": cuda_ms(lambda: op(x, m, None)),
            "wrapper_host_us": host_us(lambda: kernels.decode_prologue(x, m)),
            "operator_host_us": host_us(lambda: op(x, m, None)),
        }
    emit({"phase": "profiling", "nvidia_smi": smi_line(), **out})
    return out


def host_us(fn, calls=200):
    """Host microseconds a call of ``fn`` takes to queue its work: the
    median of 5 runs of ``calls`` calls, without a synchronize."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        from pydrobert_tpu_torch import command_line, config, native, training
        from pydrobert_tpu_torch import data as tdata
        from pydrobert_tpu_torch.data import parse_arpa_lm
        from pydrobert_tpu_torch.models import conformer
        from pydrobert_tpu_torch.utils import serial
        from pydrobert_tpu_torch.export import ctc_recognizer
        from pydrobert_tpu_torch.lm import LookupLanguageModel
        from pydrobert_tpu_torch.models import (
            AttentionSeq2Seq, ConformerConfig, ConformerCTC, Seq2SeqConfig,
            Seq2SeqDecoderLM, adam, adamw, make_mer_train_step, make_train_step,
        )
        from pydrobert_tpu_torch.ops import (
            _build, decoding, feats, img, kernels, mc, pad, straight_through, string,
        )
        from pydrobert_tpu_torch.ops.decoding import (
            BeamSearch, CTCPrefixSearch, _lm_bias, compress_blank_frames, ctc_greedy_search,
        )
        from pydrobert_tpu_torch.ops.string import error_rate
        from pydrobert_tpu_torch.models.transducer import (
            ConformerTransducer, TransducerConfig, lookup_lm_fusion,
            make_transducer_train_step,
        )
        from pydrobert_tpu_torch.ops.transducer import (
            transducer_beam_search, transducer_greedy_search,
        )
        from pydrobert_tpu_torch.serving import (
            StreamingCTCRecognizer, StreamingTransducerRecognizer,
        )
        from pydrobert_tpu_torch import export, parallel
        from pydrobert_tpu_torch.utils import hlostats, profiling
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    # stated, not assumed: no TF32 in float32 products or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train_pkg = (ConformerConfig, ConformerCTC, adamw, make_train_step, img)

    smi = smi_line()
    t_start = t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    log = _build.build_log()
    emit({
        "phase": "env", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "build_s": build_s,
        "nvcc_s": log["seconds"], "library": os.path.relpath(log["path"]),
        "ptxas": [
            l.strip() for l in (log["stderr"] or "").splitlines()
            if "registers" in l or "spill" in l or "Compiling entry" in l
        ],
    })

    if "--train-witness" in argv:
        phase_train_witness(train_pkg, kernels, int(argv[argv.index("--train-witness") + 1]))
        print(smi, flush=True)
        emit(ok_line())
        return 0
    if "--profile" in argv:
        phase_profile(config, ConformerConfig, ConformerCTC, ctc_recognizer, CTCPrefixSearch)
        model, step, batch, gen, _ = phase_train(train_pkg, kernels)
        emit({"phase": "profile", "train_step": trace(lambda: step(gen, *batch))})
        print(smi, flush=True)
        emit(ok_line())
        return 0

    lm = bench_lm(LookupLanguageModel)
    lm_m = min(lm.vocab_size, 2 * WIDTH + lm.max_corrections)
    errs = phase_kernels(kernels, _lm_bias(lm._uni_t, LM_BETA), lm_m)
    errs.update(phase_new_kernels(kernels, img))
    errs["ctc_beam_search"] = phase_beam_kernel(kernels)
    errs["ctc_beam_search_renorm"], renorm_cell = phase_renorm_kernel(
        kernels, CTCPrefixSearch, config)
    errs["depthwise_conv1d"], dw_times = phase_depthwise(kernels)
    model, recognize, requests, launches, (logits, out_lens), served = phase_main_path(
        (config, ConformerConfig, ConformerCTC, ctc_recognizer, CTCPrefixSearch, kernels)
    )
    times = phase_times(kernels, model, recognize, requests, CTCPrefixSearch, logits)
    times["depthwise_conv1d"] = {
        "cases": dw_times,
        "library": "F.conv1d(groups=C) on the padded rows, channels first, bfloat16"}
    times["ctc_beam_search_renorm"]["offline_cell"] = renorm_cell
    beam_launches, times["ctc_beam_search"] = phase_beam_serve(
        (config, ctc_recognizer, CTCPrefixSearch), kernels, model, requests
    )
    lm_launches, times["decode_prologue"]["lm_serve"] = phase_lm_serve(
        (LookupLanguageModel, ctc_recognizer, CTCPrefixSearch, _lm_bias, config),
        kernels, model, requests, lm,
    )
    del model, recognize, requests, lm
    phase_lm_probing((LookupLanguageModel, parse_arpa_lm, CTCPrefixSearch, config))
    stream_launches = phase_stream(
        (config, ConformerConfig, ConformerCTC, CTCPrefixSearch, StreamingCTCRecognizer),
        kernels,
    )
    *_, train_launches = phase_train(train_pkg, kernels)
    times["spec_augment_apply"] = sa_times(kernels, img)
    score_launches, times["edit_distance"] = phase_score(
        (ctc_greedy_search, error_rate), kernels, logits, out_lens
    )
    s2s = (AttentionSeq2Seq, Seq2SeqConfig, Seq2SeqDecoderLM, BeamSearch,
           make_mer_train_step, adam)
    phase_s2s_serve(s2s, kernels)
    phase_ngram_beam(LookupLanguageModel, BeamSearch, kernels, config)
    mer_launches, times["edit_distance"]["seq2seq_train"] = phase_s2s_train(
        s2s, decoding, kernels
    )
    rnnt = (ConformerConfig, TransducerConfig, ConformerTransducer, make_transducer_train_step,
            transducer_greedy_search, transducer_beam_search, lookup_lm_fusion)
    rnnt_per_frame = phase_rnnt_greedy(rnnt)
    phase_rnnt_beam(rnnt, LookupLanguageModel)
    phase_rnnt_stream(rnnt, StreamingTransducerRecognizer)
    phase_rnnt_train(rnnt, adamw)
    skip_launches, skip_beam_launches, skip_times = phase_blankskip(
        (config, CTCPrefixSearch, compress_blank_frames), kernels
    )
    for name, t in skip_times.items():
        times[name]["blankskip"] = t
    errs["ctc_beam_search"] = max(errs["ctc_beam_search"],
                                  skip_times["ctc_beam_search"]["vs_plain"]["max_abs_err"])
    phase_front_end((feats, pad, img))
    phase_seq_losses((string, straight_through, decoding), s2s)
    phase_align(decoding, logits, out_lens, served)
    del served
    reinforce_launches = phase_reinforce(s2s, (decoding, mc, string), kernels)
    phase_rebar(straight_through, mc, logits)
    recipe_launches = phase_recipe(
        train_pkg + (tdata, training, command_line, serial, ctc_greedy_search), kernels
    )
    moe_launches = phase_moe(train_pkg, kernels)
    remat_launches = phase_remat(train_pkg, kernels, conformer)
    corpus_launches = phase_corpus(train_pkg + (tdata, command_line, serial, native), kernels)
    kernels.reset_launches()
    artifact_launches = phase_artifact(
        (config, export, ConformerConfig, ConformerCTC, rnnt, hlostats.count_body_kernels),
        kernels,
    )
    phase_parallel((ConformerConfig, ConformerCTC, conformer, make_train_step, export, parallel))
    phase_profiling(
        (ConformerConfig, ConformerCTC, ctc_recognizer, CTCPrefixSearch, rnnt, profiling,
         hlostats),
        kernels, rnnt_per_frame,
    )

    csrc = "pydrobert_tpu_torch/csrc/"
    rows = []
    times["decode_prologue"]["launches_by_path"] = {
        "serve": launches["decode_prologue"], "lm serve": lm_launches["decode_prologue"],
        "stream": stream_launches["decode_prologue"],
        "blankskip": skip_launches["decode_prologue"],
        "artifact": artifact_launches["decode_prologue"],
    }
    times["ctc_beam_search_renorm"]["launches_by_path"] = {
        "serve": launches["ctc_beam_search_renorm"],
        "stream": stream_launches["ctc_beam_search_renorm"],
        "blankskip": skip_launches["ctc_beam_search_renorm"],
        "artifact": artifact_launches["ctc_beam_search_renorm"],
    }
    for name in ("top_m", "ctc_beam_search"):
        times[name]["launches_by_path"] = {
            "beam serve": beam_launches[name], "stream": stream_launches[name],
            "blankskip": skip_beam_launches[name], "artifact": artifact_launches[name],
        }
    times["depthwise_conv1d"]["launches_by_path"] = {
        "serve": launches["depthwise_conv1d"], "beam serve": beam_launches["depthwise_conv1d"],
        "lm serve": lm_launches["depthwise_conv1d"], "stream": stream_launches["depthwise_conv1d"],
        "artifact": artifact_launches["depthwise_conv1d"],
    }
    times["edit_distance"]["launches_by_path"] = {
        "score": score_launches["edit_distance"],
        "seq2seq train": mer_launches["edit_distance"],
        "reinforce": reinforce_launches["edit_distance"],
        "recipe": recipe_launches["edit_distance"],
        "corpus": corpus_launches["edit_distance"],
    }
    sa_paths = {"train": train_launches, "recipe": recipe_launches, "moe": moe_launches,
                "remat": remat_launches, "corpus": corpus_launches}
    times["spec_augment_apply"]["launches_by_path"] = {
        k: v["spec_augment_apply"] for k, v in sa_paths.items()
    }
    for name, src, replaces, path, n in (
        ("decode_prologue", "prologue.cu", 1664, "serve, lm serve, stream, blankskip, artifact",
         launches["decode_prologue"] + lm_launches["decode_prologue"]
         + stream_launches["decode_prologue"]
         + skip_launches["decode_prologue"] + artifact_launches["decode_prologue"]),
        ("top_m", "prologue.cu", 1359, "beam serve, stream, blankskip, artifact",
         sum(times["top_m"]["launches_by_path"].values())),
        ("spec_augment_apply", "spec_augment.cu", 180, "train, recipe, moe, remat, corpus",
         sum(v["spec_augment_apply"] for v in sa_paths.values())),
        ("edit_distance", "edit_distance.cu", 49,
         "score, seq2seq train, reinforce, recipe, corpus",
         score_launches["edit_distance"] + mer_launches["edit_distance"]
         + reinforce_launches["edit_distance"] + recipe_launches["edit_distance"]
         + corpus_launches["edit_distance"]),
        ("ctc_beam_search", "ctc_beam.cu", 649, "beam serve, stream, blankskip, artifact",
         sum(times["ctc_beam_search"]["launches_by_path"].values())),
        ("ctc_beam_search_renorm", "ctc_beam.cu", 649, "serve, stream, blankskip, artifact",
         sum(times["ctc_beam_search_renorm"]["launches_by_path"].values())),
        ("depthwise_conv1d", "depthwise_conv.cu", None,
         "serve, beam serve, lm serve, stream, artifact",
         sum(times["depthwise_conv1d"]["launches_by_path"].values())),
    ):
        rows.append({
            "name": name, "route": "cuda", "source": csrc + src,
            "replaces": f"pydrobert_tpu/ops/pallas.py:{replaces}" if replaces else "none",
            "path": path,
            "launches": n, "max_abs_err": errs[name], **times[name],
        })
    emit({"phase_seconds": phase_seconds(t_start),
          "total_s": time.perf_counter() - t_start})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit(ok_line())
    return 0


def ok_line():
    return {
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
