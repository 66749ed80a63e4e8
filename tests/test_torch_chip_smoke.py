"""chip_smoke.py's training-step gradient criterion, on the
CPU: the card's float32 gradient may lie no farther from a float64 witness
than ``GRAD_K`` (2.5) times the CPU's float32 gradient does, ``GRAD_S``
(1.2) times the card's own float32 spread (its default step and a step
with cuDNN off apart), or ``GRAD_FLOOR`` (2.5e-3), whichever is most,
each distance over the tensor's largest witness entry, and the card's own
float64 step must lie within ``GRAD64_LIMIT`` (1e-5) of the witness. It
must pass every reading that PERF.md records for the trained weight sets
it was sized from (the set where the card read 1.049e-3 and the CPU
1.31e-4, and the one where the card read 4.37e-3, cuDNN off 1.93e-4 and
the CPU 2.05e-4, among them) and fail on a planted fault, one tensor's
gradient scaled by 1.01 in both card float32 steps, at each of them."""

import importlib.util
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (card, CPU) distances from the witness that the card gave without a
# fault (PERF.md): the three sets that failed the old fixed 1e-3 bound, at
# subsample.conv1/conv2.weight, the ends of the earlier card/CPU ratios,
# and the set at ratio 8.0, which failed the criterion before this one
RECORDED = [
    (1.18e-3, 9.35e-4),
    (2.13e-3, 2.13e-3),
    (1.169e-3, 1.157e-3),
    (5.1e-4, 5.1e-4 / 1.77),
    (1.0e-4, 1.0e-4 / 0.76),
    (1.049e-3, 1.31e-4),
]
# 16 more sets (--train-witness 8, two calls; PERF.md): each set's
# largest card distance and its worst card/CPU ratio, paired as if they
# met at one tensor, which asks more than any of its tensors did
PR7_SETS = [
    (2.677e-4, 1.21), (3.260e-4, 2.27), (2.363e-4, 1.86), (8.41e-5, 1.60),
    (2.515e-4, 1.48), (2.952e-4, 1.18), (1.049e-3, 8.00), (2.804e-4, 2.43),
    (2.421e-4, 1.17), (3.366e-4, 1.37), (1.587e-4, 0.99), (1.331e-4, 2.79),
    (1.110e-4, 1.21), (3.088e-4, 1.14), (3.892e-4, 1.12), (4.379e-4, 1.28),
]
ALL_READINGS = RECORDED + [(c, c / r) for c, r in PR7_SETS]
CARD64_RECORDED = (9.4e-8, 2.5e-7)  # the card's float64 step (PERF.md)
# (card, CPU, cuDNN off) distances at sets where the card's step was also
# taken with cuDNN off (PERF.md, PR 8): seed 2 at subsample.conv2.weight,
# which failed the criterion before this one; and seed 10, where cuDNN off
# read 3.29e-3 at that tensor while the default step's worst tensor read
# 4.68e-4 (the default's own distance there was not recorded, nor the
# CPU's: the test takes the default's worst, and a CPU at 0, the case
# that asks most of the other two terms). Only each step's distance from
# the witness was recorded, not the two steps' distance apart, so the
# spread is bounded by the triangle inequality: at least the difference
# of the two distances, at most their sum
SPREAD_READINGS = [
    (4.37e-3, 2.05e-4, 1.93e-4),
    (4.68e-4, 0.0, 3.29e-3),
]


@pytest.mark.parametrize("card,cpu", RECORDED)
def test_grad_criterion_passes_recorded_readings(smoke, card, cpu):
    ok, res = smoke.grad_criterion({"w": card}, {"w": cpu})
    assert ok and res["grad_vs_f64_failed"] == []
    assert res["grad_vs_f64_ratio"] == pytest.approx(card / cpu)
    assert res["grad_vs_f64_limit_use"] <= 1.0


@pytest.mark.parametrize("card,cpu", ALL_READINGS)
def test_grad_criterion_fails_the_planted_fault_at_each_reading(smoke, card, cpu):
    """A card gradient scaled by 1.01 lies at least ``1e-2 * (1 - card) -
    card`` from the witness, over its tensor's largest entry, where the
    unscaled one lay ``card``; the criterion fails it, and passes the
    reading itself with the card's float64 step at its recorded worst."""
    planted = 1e-2 * (1 - card) - card
    ok, res = smoke.grad_criterion({"w": planted}, {"w": cpu}, {"w": CARD64_RECORDED[1]})
    assert not ok and res["grad_vs_f64_failed"] == ["w"] and res["grad_card64_ok"]
    ok, res = smoke.grad_criterion({"w": card}, {"w": cpu}, {"w": CARD64_RECORDED[1]})
    assert ok


@pytest.mark.parametrize("card,cpu,other", SPREAD_READINGS)
def test_grad_criterion_passes_readings_by_their_spread(smoke, card, cpu, other):
    """Each reading passes with the least spread its two distances allow;
    the seed-2 reading failed without the spread term and passes with
    it."""
    spread = abs(card - other)
    ok, res = smoke.grad_criterion({"w": card}, {"w": cpu}, {"w": CARD64_RECORDED[1]},
                                   {"w": spread})
    assert ok and res["grad_vs_f64_limit_use"] <= 1.0
    worst = res["grad_vs_f64_worst"]
    assert worst["spread"] == spread and worst["limit"] == max(
        smoke.GRAD_FLOOR, smoke.GRAD_K * cpu, smoke.GRAD_S * spread
    )
    if card > smoke.GRAD_FLOOR:
        assert not smoke.grad_criterion({"w": card}, {"w": cpu})[0]


@pytest.mark.parametrize(
    "card,cpu,other",
    [r + (None,) for r in ALL_READINGS] + SPREAD_READINGS,
)
def test_grad_criterion_fails_a_fault_in_both_card_steps(smoke, card, cpu, other):
    """One tensor's gradient scaled by 1.01 in both card float32 steps,
    as a fault in the code would be: the card's distance becomes at least
    ``1e-2 * (1 - card) - card`` and the spread 1.01 times the widest the
    reading allows (the two distances' sum; the CPU's distance stands in
    for the other step's where that was not read). The criterion fails it
    at every recorded reading."""
    widest = card + (cpu if other is None else other)
    planted = 1e-2 * (1 - card) - card
    ok, res = smoke.grad_criterion({"w": planted}, {"w": cpu}, {"w": CARD64_RECORDED[1]},
                                   {"w": 1.01 * widest})
    assert not ok and res["grad_vs_f64_failed"] == ["w"] and res["grad_card64_ok"]


@pytest.mark.parametrize("card64,ok", [(CARD64_RECORDED[0], True), (CARD64_RECORDED[1], True),
                                       (1e-4, False)])
def test_grad_criterion_holds_the_card_float64_step(smoke, card64, ok):
    """A card whose own float64 step strays from the witness fails, even
    where its float32 distances pass."""
    got, res = smoke.grad_criterion({"w": 1e-4}, {"w": 1e-4}, {"w": card64, "v": 1e-9})
    assert got == ok and res["grad_card64_ok"] == ok and res["grad_card64_vs_f64_at"] == "w"


def test_grad_criterion_reports_the_worst_tensor(smoke):
    card = {f"t{i}": c for i, (c, _) in enumerate(RECORDED)}
    cpu = {f"t{i}": c for i, (_, c) in enumerate(RECORDED)}
    ok, res = smoke.grad_criterion(card, cpu)
    assert ok
    assert res["grad_vs_f64_ratio_at"] == "t5"  # 8.0
    assert res["grad_vs_f64_limit_use_at"] == "t0"  # 1.18e-3 of the 2.5e-3 floor
    card["t1"] = 5.4e-3
    ok, res = smoke.grad_criterion(card, cpu)
    assert not ok and res["grad_vs_f64_failed"] == ["t1"]


def _witness():
    """A float64 witness of a few tensors at different scales."""
    gen = torch.Generator().manual_seed(0)
    shapes = {"conv.weight": (16, 1, 3, 3), "ln.bias": (32,), "head.weight": (12, 32)}
    return {
        name: torch.randn(shape, generator=gen, dtype=torch.float64) * 10.0 ** (i - 2)
        for i, (name, shape) in enumerate(shapes.items())
    }


def _noisy(witness, seed, rel_noise):
    """A float32 gradient off ``witness`` by ``rel_noise`` of each tensor's
    largest entry."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, w in witness.items():
        n = torch.randn(w.shape, generator=gen, dtype=torch.float64)
        out[name] = (w + n * rel_noise * w.abs().max() / n.abs().max()).float()
    return out


@pytest.mark.parametrize("rel_noise", [1e-4, 5e-4, 2.13e-3])
def test_grad_criterion_fails_a_planted_fault(smoke, rel_noise):
    """At float32 errors from the usual 1e-4 up to the largest recorded
    (2.13e-3), both devices and both card steps off the witness by as much
    pass; a gradient scaled by 1.01 in both card steps (about a 1e-2
    relative distance, the spread scaled with it) fails, at its
    tensor."""
    witness = _witness()
    cpu, card = _noisy(witness, 1, rel_noise), _noisy(witness, 2, rel_noise)
    other = _noisy(witness, 3, rel_noise)
    d_cpu = smoke.grad_distances(cpu, witness)
    spread = smoke.grad_distances(card, witness, other)
    ok, _ = smoke.grad_criterion(smoke.grad_distances(card, witness), d_cpu, spread=spread)
    assert ok
    planted, planted_other = (
        dict(g, **{"ln.bias": g["ln.bias"] * 1.01}) for g in (card, other)
    )
    d_card = smoke.grad_distances(planted, witness)
    assert d_card["ln.bias"] >= 7e-3
    spread = smoke.grad_distances(planted, witness, planted_other)
    ok, res = smoke.grad_criterion(d_card, d_cpu, spread=spread)
    assert not ok and res["grad_vs_f64_failed"] == ["ln.bias"]


def test_grad_criterion_passes_an_outlier_of_one_reduction_order(smoke):
    """The card's default step 4.4e-3 off the witness at one tensor, its
    step with cuDNN off and the CPU's 2e-4 off (PR 8's seed 2 in shape):
    the spread carries it, and the same tensor scaled by 1.01 in both
    card steps still fails."""
    witness = _witness()
    cpu, card, other = (_noisy(witness, seed, 2e-4) for seed in (1, 2, 3))
    w = witness["conv.weight"]
    card["conv.weight"] = (w + 4.4e-3 * w.abs().max() * torch.sign(w)).float()
    d_card, d_cpu = smoke.grad_distances(card, witness), smoke.grad_distances(cpu, witness)
    assert not smoke.grad_criterion(d_card, d_cpu)[0]
    ok, res = smoke.grad_criterion(d_card, d_cpu, spread=smoke.grad_distances(card, witness, other))
    assert ok and res["grad_vs_f64_worst"]["tensor"] == "conv.weight"
    planted, planted_other = (
        dict(g, **{"conv.weight": g["conv.weight"] * 1.01}) for g in (card, other)
    )
    ok, res = smoke.grad_criterion(
        smoke.grad_distances(planted, witness), d_cpu,
        spread=smoke.grad_distances(planted, witness, planted_other),
    )
    assert not ok and res["grad_vs_f64_failed"] == ["conv.weight"]


# Rehearsals of chip_smoke.py's blankskip, front_end and seq_losses phases
# on the CPU at reduced sizes: torch.cuda's synchronize, the timing helpers
# and nvidia-smi are stubbed, and the kernel wrappers the searches call are
# wrapped to count their calls as the card's launches (their plain
# versions count none).

BENCH = os.path.join(REPO, "bench.py")


def _bench_blankskip_copy(B, T, V):
    """bench_ctc_blankskip's data, copied from bench.py:371-377."""
    import numpy as np

    rng = np.random.RandomState(8)
    logits = rng.randn(T, B, V + 1).astype(np.float32)
    logits[..., V] += 9.0
    for n in range(B):
        idx = rng.choice(T, size=T // 6, replace=False)
        logits[idx, n, rng.randint(V, size=T // 6)] += 18.0
    lens = rng.randint(T // 2, T + 1, (B,)).astype(np.int32)
    return logits, lens


def _draws(body):
    """The statements of ``body`` from the ``RandomState`` through the
    lengths, with ``jnp.asarray(x)`` read as ``x`` and ``x = x`` dropped."""
    import ast

    class Strip(ast.NodeTransformer):
        def visit_Call(self, node):
            self.generic_visit(node)
            if ast.unparse(node.func) == "jnp.asarray":
                return node.args[0]
            return node

    lines = [ast.unparse(Strip().visit(s)) for s in body]
    lines = [l for l in lines if l.split(" = ") != [l.split(" = ")[0]] * 2]
    start = next(i for i, l in enumerate(lines) if "RandomState" in l)
    end = next(i for i, l in enumerate(lines) if l.startswith("lens = "))
    return lines[start:end + 1]


def test_blankskip_inputs_are_bench_py_draws(smoke):
    """The phase's data are bench.py's: the copy above makes the same
    draws as bench.py's function, statement for statement, and the same
    arrays as the phase's generator."""
    import ast
    import inspect

    import numpy as np

    tree = ast.parse(open(BENCH).read())
    bench = next(n for n in tree.body if getattr(n, "name", "") == "bench_ctc_blankskip")
    copy = ast.parse(inspect.getsource(_bench_blankskip_copy)).body[0]
    assert _draws(copy.body) == _draws(bench.body)
    for B, T, V in ((4, 30, 16), (256, 12, 8)):
        got, got_lens = smoke.blankskip_inputs(B, T, V)
        exp, exp_lens = _bench_blankskip_copy(B, T, V)
        np.testing.assert_array_equal(got, exp)
        np.testing.assert_array_equal(got_lens, exp_lens)
    assert smoke.BLANKSKIP == dict(B=256, T=500, V=1024, max_frames=128, threshold=0.99, seed=8)


@pytest.fixture
def rehearse(smoke, monkeypatch):
    """chip_smoke stubbed for the CPU; yields the kernels module, whose
    LAUNCHES count the wrapped calls."""
    from pydrobert_tpu_torch.ops import decoding, kernels

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(smoke, "smi_line", lambda: "stub")
    monkeypatch.setattr(smoke, "device_ms",
                        lambda fn, kernel=None, calls=1, count=None: fn() and 0.0)
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, **kw: fn() and 0.0)

    def host_ms(fns, reps=1, warmup=0):
        for fn in fns:
            fn()
        return [1.0] * len(fns), [[1.0] for _ in fns]

    monkeypatch.setattr(smoke, "host_ms", host_ms)
    lines = []
    monkeypatch.setattr(smoke, "emit", lines.append)

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapped(*args, **kwargs):
            kernels.LAUNCHES[name] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(mod, name, wrapped)

    counted(decoding, "decode_prologue")
    counted(decoding, "ctc_beam_search")
    counted(decoding, "ctc_beam_search_renorm")
    counted(kernels, "top_m")
    counted(kernels, "depthwise_conv1d")
    kernels.lines = lines
    yield kernels
    del kernels.lines


def test_blankskip_phase_rehearsal(smoke, rehearse):
    from pydrobert_tpu_torch import config
    from pydrobert_tpu_torch.ops.decoding import CTCPrefixSearch, compress_blank_frames

    cfg = dict(B=5, T=40, V=16, max_frames=12, threshold=0.99, seed=8)
    saved = config.USE_BEAM_KERNEL, config.DECODE_RENORM
    launches, beam_launches, times = smoke.phase_blankskip(
        (config, CTCPrefixSearch, compress_blank_frames), rehearse, cfg, dev="cpu", cpu_rows=3)
    assert (config.USE_BEAM_KERNEL, config.DECODE_RENORM) == saved
    assert launches == {"decode_prologue": 1, "top_m": 0, "spec_augment_apply": 0,
                        "edit_distance": 0, "ctc_beam_search": 0, "ctc_beam_search_renorm": 1,
                        "depthwise_conv1d": 0}
    assert beam_launches == {"decode_prologue": 0, "top_m": 1, "spec_augment_apply": 0,
                             "edit_distance": 0, "ctc_beam_search": 1,
                             "ctc_beam_search_renorm": 0, "depthwise_conv1d": 0}
    line = rehearse.lines[-1]
    assert line["phase"] == "blankskip" and line["compress_equals_cpu_bits"]
    assert line["cut_frames"] >= 0 and line["kept_frames"] <= line["valid_frames"]
    assert line["vs_cpu_cut"]["ok"] and line["beam_route"]["vs_card_scan_raw_masses"]["ok"]
    assert line["vs_card_scan_cut"]["ok"]
    assert set(times) == {"decode_prologue", "top_m", "ctc_beam_search", "ctc_beam_search_renorm"}
    vs_plain = times["ctc_beam_search"]["vs_plain"]
    assert vs_plain["ok"] and vs_plain["buffer_exact"] and vs_plain["probs_bit_exact"]
    vs_plain = times["ctc_beam_search_renorm"]["vs_plain"]
    assert vs_plain["ok"] and vs_plain["probs_bit_exact"] and vs_plain["ls_exact"]
    assert all(t["bound_ms"] > 0 for t in times.values())


def _front_end_pkg():
    from pydrobert_tpu_torch.ops import feats, img, pad

    return feats, pad, img


SMALL_FRONT_END = dict(N=3, T=60, F=8, max_time_warp=5, lobe=2, order=2, width=2)


def test_front_end_phase_rehearsal(smoke, rehearse):
    res = smoke.phase_front_end(_front_end_pkg(), SMALL_FRONT_END, dev="cpu")
    assert res["feat_deltas_vs_f64"]["limit_use"] <= 1.0
    line = rehearse.lines[-1]
    assert line["phase"] == "front_end" and set(line["ms"]) == {
        "mean_var_norm", "feat_deltas", "random_shift_apply", "chunk_by_slices",
        "sparse_image_warp", "sparse_image_warp_bypass"}


def _tf32_round(x):
    """float32 ``x`` with its mantissa cut to TF32's 10 bits (to nearest),
    as a tensor core reads a float32 input."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def test_front_end_phase_fails_tf32_deltas(smoke, rehearse, monkeypatch):
    """Deltas computed from TF32-rounded features, as a TF32 convolution
    computes them, fail the phase."""
    feats, pad, img = _front_end_pkg()
    deltas = feats.feat_deltas
    monkeypatch.setattr(feats, "feat_deltas",
                        lambda x, **kw: deltas(_tf32_round(x), **kw))
    with pytest.raises(AssertionError, match="feat_deltas_vs_f64"):
        smoke.phase_front_end((feats, pad, img), SMALL_FRONT_END, dev="cpu")


def test_seq_losses_phase_rehearsal(smoke, rehearse):
    from pydrobert_tpu_torch.models import (
        AttentionSeq2Seq, Seq2SeqConfig, Seq2SeqDecoderLM, adam, make_mer_train_step,
    )
    from pydrobert_tpu_torch.ops import decoding, straight_through, string

    s2s = (AttentionSeq2Seq, Seq2SeqConfig, Seq2SeqDecoderLM, decoding.BeamSearch,
           make_mer_train_step, adam)
    res = smoke.phase_seq_losses((string, straight_through, decoding), s2s, dev="cpu")
    assert res["optimal_completion"] and res["error_rate_1_1_2"]
    assert res["ocd_grad"]["max_abs_err"] == 0.0
    line = rehearse.lines[-1]
    assert line["phase"] == "seq_losses"
    assert line["shapes"] == {"ref": [13, 64], "hyp": [16, 64], "logits": [16, 64, 64],
                              "vocab": 64, "eos": 63}


def _stub_trace(fn):
    fn()
    return {"wall_ms": 1.0, "device_busy_ms": 0.0, "idle_share": 1.0, "kernel_launches": 0,
            "top_kernels": []}


def test_align_phase_rehearsal(smoke, rehearse, monkeypatch):
    """The align phase on the CPU at a small shape: a width-4 search's
    hypotheses and the greedy transcripts of random logits."""
    from pydrobert_tpu_torch.ops import decoding

    monkeypatch.setattr(smoke, "trace", _stub_trace)
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(3, 40, 9, generator=g) * 4
    lens = torch.tensor([40, 31, 22])
    y, y_lens, _ = decoding.CTCPrefixSearch(4)(logits.transpose(0, 1).contiguous(), lens)
    res = smoke.phase_align(decoding, logits, lens, (y.permute(1, 2, 0), y_lens), dev="cpu")
    assert res["hyps_collapse_back"] and res["hyp_paths_equal_cpu"]
    assert res["greedy_paths_are_argmax"]
    assert res["greedy_score_vs_frame_max_sum_max_rel_err"] == 0.0
    line = rehearse.lines[-1]
    assert line["phase"] == "align" and line["width"] == 4 and line["align_width_rows"] == 12


def test_align_phase_fails_a_wrong_path(smoke, rehearse, monkeypatch):
    """A path one frame off its hypothesis fails the phase."""
    from pydrobert_tpu_torch.ops import decoding

    monkeypatch.setattr(smoke, "trace", _stub_trace)
    align = decoding.ctc_forced_align

    class Shifted:
        def __getattr__(self, name):
            return getattr(decoding, name)

        @staticmethod
        def ctc_forced_align(*args, **kwargs):
            paths, scores = align(*args, **kwargs)
            return torch.roll(paths, 1, 1), scores

    logits = torch.randn(2, 30, 7, generator=torch.Generator().manual_seed(1)) * 4
    lens = torch.tensor([30, 20])
    y, y_lens, _ = decoding.CTCPrefixSearch(2)(logits.transpose(0, 1).contiguous(), lens)
    with pytest.raises(AssertionError, match="hyps_collapse_back"):
        smoke.phase_align(Shifted(), logits, lens, (y.permute(1, 2, 0), y_lens), dev="cpu")


def _s2s():
    from pydrobert_tpu_torch.models import (
        AttentionSeq2Seq, Seq2SeqConfig, Seq2SeqDecoderLM, adam, make_mer_train_step,
    )
    from pydrobert_tpu_torch.ops import decoding

    return (AttentionSeq2Seq, Seq2SeqConfig, Seq2SeqDecoderLM, decoding.BeamSearch,
            make_mer_train_step, adam)


def test_reinforce_phase_rehearsal(smoke, rehearse, monkeypatch):
    """The reinforce phase on the CPU at its full (small) size: one
    edit-distance call, whose plain version the CPU runs."""
    from pydrobert_tpu_torch.ops import decoding, kernels, mc, string

    monkeypatch.setattr(smoke, "trace", _stub_trace)
    ed = kernels.edit_distance

    def counted(*args):
        kernels.LAUNCHES["edit_distance"] += 1
        return ed(*args)

    monkeypatch.setattr(kernels, "edit_distance", counted)
    launches = smoke.phase_reinforce(_s2s(), (decoding, mc, string), kernels, dev="cpu")
    assert launches == {"edit_distance": 1}
    line = rehearse.lines[-1]
    assert line["phase"] == "reinforce" and line["checks"]["edit_distance_equals_plain"]
    assert line["checks"]["grad_vs_cpu_max_rel_err"] == 0.0


def test_rebar_phase_rehearsal(smoke, rehearse):
    """The rebar phase on the CPU at a small shape; the estimate lies
    within its 4 standard errors."""
    from pydrobert_tpu_torch.ops import mc, straight_through

    logits = torch.randn(6, 20, 11, generator=torch.Generator().manual_seed(2)) * 3
    res = smoke.phase_rebar(straight_through, mc, logits, dev="cpu", rows=2)
    assert abs(res["z_score"]) <= 4
    assert res["value_vs_cpu"] == 0.0 and res["cv_grad_eta_vs_cpu"] == 0.0
    assert rehearse.lines[-1]["phase"] == "rebar"


# The recipe, moe and remat phases at a reduced size on the CPU: the same
# code paths as on the card, with SpecAugment and the edit distance counted
# by hand (their plain versions count no launch).
SMALL_MODEL = dict(vocab_size=16, num_filts=8, d_model=16, num_layers=2, num_heads=2,
                   subsample_channels=4, conv_kernel=5, dropout=0.1, dtype=torch.float32)
SMALL_SA = dict(max_time_warp=4.0, max_time_mask=5, max_freq_mask=2)
SMALL_RECIPE = dict(utts=8, t_min=40, t_max=80, u_min=2, u_max=6, batch=4, epochs=2,
                    score_batch=3, model=SMALL_MODEL, sa=SMALL_SA)
SMALL_MOE = dict(model=dict(SMALL_MODEL, num_experts=4, expert_top_k=2,
                            expert_capacity_factor=1.25, moe_aux_weight=0.01),
                 B=8, T=64, U=6, steps=2, sa=SMALL_SA)
SMALL_REMAT = dict(model=SMALL_MODEL, B=4, T=64, U=6, sa=SMALL_SA)


@pytest.fixture
def rehearse_train(smoke, rehearse, monkeypatch):
    """The rehearsal stubs, with ``trace`` stubbed and the SpecAugment and
    edit-distance wrappers counted."""
    from pydrobert_tpu_torch.ops import kernels

    monkeypatch.setattr(smoke, "trace", lambda fn, warmup=True: _stub_trace(fn))
    for name in ("spec_augment_apply", "edit_distance"):
        fn = getattr(kernels, name)

        def counted(*args, _fn=fn, _name=name):
            kernels.LAUNCHES[_name] += 1
            return _fn(*args)

        monkeypatch.setattr(kernels, name, counted)
    return rehearse


def _train_pkg():
    from pydrobert_tpu_torch.models import ConformerConfig, ConformerCTC, adamw, make_train_step
    from pydrobert_tpu_torch.ops import img

    return ConformerConfig, ConformerCTC, adamw, make_train_step, img


def _recipe_pkg():
    from pydrobert_tpu_torch import command_line, data, training
    from pydrobert_tpu_torch.ops.decoding import ctc_greedy_search
    from pydrobert_tpu_torch.utils import serial

    return _train_pkg() + (data, training, command_line, serial, ctc_greedy_search)


def test_recipe_phase_rehearsal(smoke, rehearse_train):
    launches = smoke.phase_recipe(_recipe_pkg(), rehearse_train, SMALL_RECIPE, dev="cpu")
    # 2 epochs and a traced third of 2 steps; 2 scored directories of 3
    # batches; the recipe script's 2 epochs and resumed third of 4 steps,
    # each call scored in one batch
    assert launches == {"spec_augment_apply": 6 + 12, "edit_distance": 6 + 2}
    line = rehearse_train.lines[-1]
    assert line["phase"] == "recipe" and line["resume_bit_equal"]
    script = line["script"]
    assert [c["hist_epochs"] for c in script["calls"]] == [[1, 2], [1, 2, 3]]
    assert script["launches"] == {"spec_augment_apply": 12, "edit_distance": 2}
    assert all(e["loader_reads"] == {"native": 2, "per_item": 0} for e in line["epochs"])
    assert line["epochs"][1]["mean_loss"] < line["epochs"][0]["mean_loss"]
    assert set(line["scores"]) == {"trained", "noisy"}
    assert all(s["equals_cpu"] for s in line["scores"].values())
    assert 0 < line["scores"]["noisy"]["error_rate"] < 1
    assert line["checkpoint_bytes"]["model"] > 0 and line["checkpoint_bytes"]["optimizer"] > 0


def test_recipe_phase_fails_a_wrong_resume(smoke, rehearse_train, monkeypatch):
    """A resume that restores the model but leaves the optimizer fresh
    fails the phase."""
    from pydrobert_tpu_torch import training

    def wrong(self, model, optimizer, epoch=None, strict=True):
        return self.load_model_for_epoch(model, self.get_last_epoch(), strict)

    monkeypatch.setattr(training.TrainingStateController,
                        "load_model_and_optimizer_for_epoch", wrong)
    with pytest.raises(AssertionError, match="resume"):
        smoke.phase_recipe(_recipe_pkg(), rehearse_train, SMALL_RECIPE, dev="cpu")


def test_recipe_phase_fails_a_script_that_does_not_resume(smoke, rehearse_train, monkeypatch,
                                                          tmp_path):
    """A recipe script whose controller forgets the history retrains from
    the first epoch on its second call, and the phase fails."""
    from pydrobert_tpu_torch import training

    monkeypatch.setattr(training.TrainingStateController, "get_last_epoch", lambda self: 0)
    with pytest.raises(AssertionError, match="did not train, resume and score"):
        smoke.recipe_script(rehearse_train, str(tmp_path), "cpu")


def test_moe_phase_rehearsal(smoke, rehearse_train):
    launches = smoke.phase_moe(_train_pkg(), rehearse_train, SMALL_MOE, dev="cpu")
    assert launches == {"spec_augment_apply": 2}
    line = rehearse_train.lines[-1]
    assert line["phase"] == "moe" and 0 <= line["dropped_share"] < 1
    for res in line["card_vs_cpu_routing"].values():
        assert res["top1_equal"] and res["dropped_equal"]
    assert not any(r["failed"] for r in line["card_vs_cpu_step"].values())


def test_remat_phase_rehearsal(smoke, rehearse_train):
    from pydrobert_tpu_torch.models import conformer

    launches = smoke.phase_remat(_train_pkg(), rehearse_train, conformer, SMALL_REMAT, dev="cpu")
    assert launches == {"spec_augment_apply": 4}
    line = rehearse_train.lines[-1]
    assert line["vs_plain"]["ok"] and line["vs_plain"]["plain_steps_bit_equal"]
    assert line["vs_plain"]["grad_max_rel_err"] == 0.0
    assert not line["planted_fault"]["ok"]
    assert conformer._remat_block.__name__ == "_remat_block"


def test_remat_phase_fails_a_generator_fault(smoke, rehearse_train, monkeypatch):
    """A remat that never sets the generator back fails the phase."""
    from pydrobert_tpu_torch.models import conformer

    def never_restores(block, *args):
        return torch.utils.checkpoint.checkpoint(block, *args, use_reentrant=False)

    monkeypatch.setattr(conformer, "_remat_block", never_restores)
    with pytest.raises(AssertionError, match="remat step differs"):
        smoke.phase_remat(_train_pkg(), rehearse_train, conformer, SMALL_REMAT, dev="cpu")


def test_replayed_routing_replays_the_first_forward(smoke):
    """Inside ReplayedRouting a layer routes as the first call did,
    whatever its own router says (gates from its own probabilities), and
    the flipped choices are counted; outside, its own routing returns."""
    from pydrobert_tpu_torch.models import ConformerConfig, ConformerCTC

    cfg = ConformerConfig(**SMALL_MOE["model"])
    a, b = (ConformerCTC(cfg, device="cpu", generator=torch.Generator().manual_seed(s)).block_0.moe
            for s in (0, 1))
    y = torch.randn(2, 20, cfg.d_model, generator=torch.Generator().manual_seed(2))
    mask = torch.ones(2, 20, dtype=torch.bool)
    own_a, own_b = a.route(y, mask), b.route(y, mask)
    assert not torch.equal(own_a["experts"], own_b["experts"])
    with smoke.ReplayedRouting(type(a), 1) as replay:
        a.route(y, mask)
        got = b.route(y, mask)
    assert torch.equal(got["experts"], own_a["experts"])
    assert torch.equal(got["gates"], own_b["probs"].gather(1, own_a["experts"]) / own_b["probs"].gather(1, own_a["experts"]).sum(-1, keepdim=True))
    assert replay.flips == [int((own_a["experts"] != own_b["experts"]).sum())]
    assert torch.equal(b.route(y, mask)["experts"], own_b["experts"])


SMALL_ARPA = """\
\\data\\
ngram 1=5
ngram 2=3

\\1-grams:
-0.8 <s> -0.3
-0.9 </s>
-0.5 a -0.2
-0.6 b -0.25
-1.1 c

\\2-grams:
-0.4 <s> a
-0.3 a b
-0.7 b </s>

\\end\\
"""


def _corpus_pkg():
    from pydrobert_tpu_torch import command_line, data, native
    from pydrobert_tpu_torch.utils import serial

    return _train_pkg() + (data, command_line, serial, native)


@pytest.fixture
def small_corpus(smoke, tmp_path):
    arpa = tmp_path / "small.arpa"
    arpa.write_text(SMALL_ARPA)
    return dict(SMALL_RECIPE, run_max=30, shift_ms=10.0, shard=2, train_steps=2, subset=4,
                fixed_lobe=5, ali_lobe=1, share_rounds=1, head_scale=32.0, arpa=str(arpa))


def test_corpus_phase_rehearsal(smoke, rehearse_train, small_corpus):
    """The corpus phase with a 2-layer model and 8 utterances on the CPU:
    every check passes; 2 tar steps and 3 epochs of 2 steps launch
    SpecAugment 8 times, and the scoring 3 edit-distance batches."""
    launches = smoke.phase_corpus(_corpus_pkg(), rehearse_train, small_corpus, dev="cpu")
    assert launches == {"spec_augment_apply": 8, "edit_distance": 3}
    line = rehearse_train.lines[-1]
    assert line["phase"] == "corpus" and all(line["checks"].values())
    assert line["shards"] == 4 and line["tar_batches"] == 2 and line["error_rate"] == 0.0
    assert set(line["loader_host_share"]) == {"dir_per_item", "dir_native", "tar_native"}
    assert line["arpa_info"]["max_ngram"] == "2"
    assert {"mvn_card", "chunk_ali_card_w2", "align_card", "arpa_card"} <= set(line["command_s"])


def test_corpus_phase_fails_a_per_item_fallback(smoke, rehearse_train, small_corpus,
                                                monkeypatch):
    """A tar dataset whose native fetch falls back to item-by-item reads
    gives the same batches, and the phase fails on them."""
    from pydrobert_tpu_torch import data

    monkeypatch.setattr(data.SpectTarDataSet, "native_batch_fetch", lambda self, idxs: None)
    with pytest.raises(AssertionError, match="tar_read_natively"):
        smoke.phase_corpus(_corpus_pkg(), rehearse_train, small_corpus, dev="cpu")


def test_corpus_phase_fails_without_the_native_reader(smoke, rehearse_train, small_corpus,
                                                      monkeypatch):
    from pydrobert_tpu_torch import native

    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(AssertionError, match="native reader did not build"):
        smoke.phase_corpus(_corpus_pkg(), rehearse_train, small_corpus, dev="cpu")


def test_format_round_trip_rules(smoke):
    """ctm and TextGrid seconds move a start frame only where its seconds
    value lands below the frame: 201 frames at 10 ms is 2.01 s, and
    1000 * 2.01 // 10 is 200."""
    mod = smoke
    assert mod.ctm_frames(3, 10, 10.0) == (3, 10)
    assert mod.tg_frames(3, 10, 10.0) == (3, 10)
    assert mod.ctm_frames(201, 205, 10.0) == (200, 205)
    assert mod.tg_frames(201, 205, 10.0) == (200, 205)


# the artifact, parallel and profiling phases at a CPU size
_TINY = dict(vocab_size=16, num_filts=8, d_model=16, num_layers=2, num_heads=2,
             subsample_channels=4, conv_kernel=5)


def _rnnt_pkg():
    from pydrobert_tpu_torch.models import ConformerConfig
    from pydrobert_tpu_torch.models.transducer import (
        ConformerTransducer, TransducerConfig, lookup_lm_fusion, make_transducer_train_step,
    )
    from pydrobert_tpu_torch.ops.transducer import (
        transducer_beam_search, transducer_greedy_search,
    )

    return (ConformerConfig, TransducerConfig, ConformerTransducer, make_transducer_train_step,
            transducer_greedy_search, transducer_beam_search, lookup_lm_fusion)


def _small_artifact(smoke, heads):
    from pydrobert_tpu_torch.models import ConformerConfig
    from pydrobert_tpu_torch.models.transducer import TransducerConfig

    rnnt = TransducerConfig(
        encoder=ConformerConfig(**dict(_TINY, num_layers=1), dropout=0.0),
        pred_dim=12, joint_dim=12,
    )
    return dict(smoke.ARTIFACT, model=_TINY, spec=(4, 64), width=4, requests=2,
                pad_call=(3, 48), rnnt=rnnt, rnnt_spec=(4, 32), rnnt_requests=2, reps=1,
                heads=heads)


def _artifact_pkg():
    from pydrobert_tpu_torch import config, export
    from pydrobert_tpu_torch.models import ConformerConfig, ConformerCTC
    from pydrobert_tpu_torch.utils.hlostats import count_body_kernels

    return config, export, ConformerConfig, ConformerCTC, _rnnt_pkg(), count_body_kernels


def test_artifact_phase_rehearsal(smoke, rehearse):
    """Exported heads served from a fresh process without model code, bit
    for bit equal to the live heads, the padded call too; the width-4
    programs record the kernels' operators, which run their plain versions
    on the CPU (so nothing launches)."""
    cfg = _small_artifact(smoke, ("ctc_greedy", "ctc_w16_scan", "ctc_w16_beam", "ctc_w16_raw",
                                  "rnnt_greedy", "rnnt_beam"))
    launches = smoke.phase_artifact(_artifact_pkg(), rehearse, cfg, dev="cpu")
    assert launches == {"decode_prologue": 0, "top_m": 0, "ctc_beam_search": 0,
                        "ctc_beam_search_renorm": 0, "depthwise_conv1d": 0}
    (line,) = [ln for ln in rehearse.lines if ln.get("phase") == "artifact"]
    assert set(line["heads"]) == set(cfg["heads"])
    for head in line["heads"].values():
        assert head["bit_equal_calls"] == 3 and head["bytes"] > 0
    convs = {"depthwise_conv1d": _TINY["num_layers"]}
    assert line["heads"]["ctc_greedy"]["kernel_ops"] == convs
    assert line["heads"]["rnnt_greedy"]["kernel_ops"] == {"depthwise_conv1d": 1}
    assert line["heads"]["ctc_w16_scan"]["loop_body_nodes"]
    assert line["heads"]["ctc_w16_scan"]["kernel_ops"] == {"decode_prologue": 1, **convs}
    assert line["heads"]["ctc_w16_beam"]["kernel_ops"] == {
        "decode_prologue": 1, "ctc_beam_search_renorm": 1, **convs}
    assert line["heads"]["ctc_w16_raw"]["kernel_ops"] == {
        "top_m": 1, "ctc_beam_search": 1, **convs}
    assert line["server"]["artifacts"] == 6


def test_artifact_phase_fails_an_artifact_with_other_weights(smoke, rehearse, monkeypatch):
    """An artifact whose saved weights differ from the live model's (its
    CTC head's bias for token 0 raised) fails the bit-for-bit comparison."""
    from pydrobert_tpu_torch import export

    real = export.export_ctc_recognizer

    def moved(path, model, params=None, **kw):
        params = dict(model.state_dict())
        params["ctc_head.bias"] = params["ctc_head.bias"].clone()
        params["ctc_head.bias"][0] += 1e4
        return real(path, model, params, **kw)

    monkeypatch.setattr(export, "export_ctc_recognizer", moved)
    with pytest.raises(AssertionError, match="differ from the live head"):
        smoke.phase_artifact(_artifact_pkg(), rehearse, _small_artifact(smoke, ("ctc_greedy",)),
                             dev="cpu")


def _parallel_pkg():
    from pydrobert_tpu_torch import export, parallel
    from pydrobert_tpu_torch.models import ConformerConfig, ConformerCTC, conformer, make_train_step

    return ConformerConfig, ConformerCTC, conformer, make_train_step, export, parallel


def _small_parallel(smoke):
    return dict(smoke.PARALLEL, model=_TINY, step_layers=2, step_batch=(4, 64, 5),
                export_spec=(4, 64))


def test_parallel_phase_rehearsal(smoke, rehearse):
    smoke.phase_parallel(_parallel_pkg(), _small_parallel(smoke), dev="cpu")
    (line,) = [ln for ln in rehearse.lines if ln.get("phase") == "parallel"]
    assert line["sharded_forward_bit_equal"] and line["sharded_export"]["bit_equal_to"]
    assert line["checkpoint"]["restore_bit_exact"] and line["mesh"] == [1, 1]
    assert not torch.distributed.is_initialized()


def test_parallel_phase_fails_stages_in_the_wrong_order(smoke, rehearse, monkeypatch):
    """Pipeline-form parameters with the layers reversed: the pipelined
    forward parts from the plain one."""
    from pydrobert_tpu_torch.models import conformer

    real = conformer.stack_block_params

    def reversed_layers(params, pp):
        out = real(params, pp)
        return {
            k: (v.detach().flip(1).requires_grad_(v.requires_grad) if k.startswith("blocks.")
                else v)
            for k, v in out.items()
        }

    monkeypatch.setattr(conformer, "stack_block_params", reversed_layers)
    with pytest.raises(AssertionError, match="pipelined forward"):
        smoke.phase_parallel(_parallel_pkg(), _small_parallel(smoke), dev="cpu")
    assert not torch.distributed.is_initialized()


def _profiling_pkg():
    from pydrobert_tpu_torch.export import ctc_recognizer
    from pydrobert_tpu_torch.models import ConformerConfig, ConformerCTC
    from pydrobert_tpu_torch.ops.decoding import CTCPrefixSearch
    from pydrobert_tpu_torch.utils import hlostats, profiling

    return (ConformerConfig, ConformerCTC, ctc_recognizer, CTCPrefixSearch, _rnnt_pkg(),
            profiling, hlostats)


def test_profiling_phase_rehearsal(smoke, rehearse, monkeypatch):
    """The marked trips of the scan decode launch what a frame adds between
    two short decodes (on the CPU: the operators a trip calls)."""
    monkeypatch.setattr(smoke, "trace", lambda fn, warmup=True: _stub_trace(fn))
    out = smoke.phase_profiling(_profiling_pkg(), rehearse, None, _small_artifact(smoke, ()),
                                dev="cpu")
    scan = out["ctc_scan_decode"]
    assert scan["loop_trip_count"] == scan["frames"] - 1
    assert scan["loop_kernels"] > 0
    assert abs(scan["loop_kernels"] - scan["decode_launches_per_frame"]) <= smoke.PROFILE_SLACK
    assert out["rnnt_greedy_decode"]["trips_per_frame"] >= 1


def test_profiling_phase_fails_unmarked_loops(smoke, rehearse, monkeypatch):
    """Decode loops whose trips are not marked for the profiler leave
    ``compiled_stats`` nothing to count: the phase fails."""
    import contextlib

    from pydrobert_tpu_torch.ops import _loops

    monkeypatch.setattr(smoke, "trace", lambda fn, warmup=True: _stub_trace(fn))
    monkeypatch.setattr(_loops, "loop_trip", lambda name: contextlib.nullcontext())
    with pytest.raises(AssertionError, match="marked trips"):
        smoke.phase_profiling(_profiling_pkg(), rehearse, None, _small_artifact(smoke, ()),
                              dev="cpu")


def test_profiling_phase_fails_a_mark_around_part_of_a_trip(smoke, rehearse, monkeypatch):
    """Each trip marked, but part of its work (four operators) runs after
    its mark closes: the launches a marked trip part from those a frame
    adds, and the phase fails."""
    import contextlib

    from pydrobert_tpu_torch.ops import _loops

    real = _loops.loop_trip

    @contextlib.contextmanager
    def short_mark(name):
        with real(name):
            yield
        torch.zeros(4).add_(1.0)
        torch.zeros(4).add_(1.0)

    monkeypatch.setattr(smoke, "trace", lambda fn, warmup=True: _stub_trace(fn))
    monkeypatch.setattr(_loops, "loop_trip", short_mark)
    with pytest.raises(AssertionError, match="a frame between two short decodes"):
        smoke.phase_profiling(_profiling_pkg(), rehearse, None, _small_artifact(smoke, ()),
                              dev="cpu")


@pytest.fixture
def lm_served(smoke, rehearse, monkeypatch):
    """The LM serve's compare pass at a small shape on the CPU: a 2-layer
    ConformerCTC over V=40, three requests of 4 utterances, a 3-gram fused
    at beta 0.5 through ``ctc_recognizer`` at width 4. Returns
    ``lm_gather``'s arguments after the config."""
    from _lm_dicts import random_prob_dicts
    from pydrobert_tpu_torch.export import ctc_recognizer
    from pydrobert_tpu_torch.lm import LookupLanguageModel
    from pydrobert_tpu_torch.models import ConformerConfig, ConformerCTC
    from pydrobert_tpu_torch.ops.decoding import CTCPrefixSearch

    monkeypatch.setattr(smoke, "trace", lambda fn, warmup=True: _stub_trace(fn))
    V = 40
    lm = LookupLanguageModel(V, sos=V, prob_dicts=random_prob_dicts(V, 3, 8, V), device="cpu")
    cfg = ConformerConfig(vocab_size=V, num_filts=8, d_model=16, num_layers=2, num_heads=2,
                          subsample_channels=4, conv_kernel=5, dtype=torch.float32)
    model = ConformerCTC(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.ctc_head.weight.mul_(8.0)
    g = torch.Generator().manual_seed(1)
    requests = [(torch.randn((4, 60, 8), generator=g), torch.randint(30, 61, (4,), generator=g))
                for _ in range(3)]
    search = CTCPrefixSearch(4, beta=0.5, lm=lm)
    assert search.lm_route() == "sparse"
    recognize = ctc_recognizer(model, 4, beta=0.5, lm=lm)
    captured = []
    hook = model.register_forward_hook(lambda mod, inp, out: captured.append(out))
    outputs = [recognize(f, n) for f, n in requests]
    hook.remove()
    cpu_search = CTCPrefixSearch(4, beta=0.5, lm=smoke.cpu_copy(LookupLanguageModel, lm))
    return (rehearse, model, recognize, search, cpu_search, requests,
            (outputs, captured, 1.0, 100.0))


def test_lm_gather_rehearsal(smoke, lm_served):
    """The gather pass: one prologue launch a request, every utterance
    equal to the compare pass up to ties, the first request equal to a
    CPU gather decode, the flag restored."""
    from pydrobert_tpu_torch import config

    out = smoke.lm_gather(config, *lm_served)
    assert not config.SPARSE_MEMBERSHIP_GATHER
    assert out["launches"]["decode_prologue"] == 3
    assert all(c["ok"] for c in out["vs_compare_route"])
    assert out["vs_cpu_gather_decode"]["ok"]
    assert out["table_bytes"] == 41 * 40 * 4 and out["table_rows"] == 41


def test_lm_gather_fails_a_wrong_table(smoke, lm_served, monkeypatch):
    """A bigram table whose values are off by 0.5 moves the gather
    route's probabilities away from the compare route's, and the pass
    fails."""
    from pydrobert_tpu_torch import config

    lm = lm_served[3].lm
    table = lm._order2_table() + 0.5
    monkeypatch.setattr(lm, "_order2_table", lambda: table)
    with pytest.raises(AssertionError, match="vs the compare route"):
        smoke.lm_gather(config, *lm_served)
    assert not config.SPARSE_MEMBERSHIP_GATHER
