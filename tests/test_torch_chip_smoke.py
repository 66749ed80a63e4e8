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
