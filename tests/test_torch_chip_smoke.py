"""chip_smoke.py's training-step gradient criterion, on the
CPU: the card's float32 gradient may lie no farther from a float64 witness
than ``GRAD_K`` (2.5) times the CPU's float32 gradient does, or
``GRAD_FLOOR`` (1e-3) if that is more, each distance over the tensor's
largest witness entry. It must pass the readings it was set from (the
sets that failed the fixed 1e-3 bound without a fault, and the ends of
the card/CPU ratios recorded before it, in PERF.md) and fail on a
planted fault: one tensor's card gradient scaled by 1.01."""

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
# fault: the three sets that failed the old fixed 1e-3 bound, at
# subsample.conv1/conv2.weight, and the ends of the earlier card/CPU
# ratios
RECORDED = [
    (1.18e-3, 9.35e-4),
    (2.13e-3, 2.13e-3),
    (1.169e-3, 1.157e-3),
    (5.1e-4, 5.1e-4 / 1.77),
    (1.0e-4, 1.0e-4 / 0.76),
]


@pytest.mark.parametrize("card,cpu", RECORDED)
def test_grad_criterion_passes_recorded_readings(smoke, card, cpu):
    ok, res = smoke.grad_criterion({"w": card}, {"w": cpu})
    assert ok and res["grad_vs_f64_failed"] == []
    assert res["grad_vs_f64_ratio"] == pytest.approx(card / cpu)
    assert res["grad_vs_f64_limit_use"] <= 1.0


def test_grad_criterion_reports_the_worst_tensor(smoke):
    card = {f"t{i}": c for i, (c, _) in enumerate(RECORDED)}
    cpu = {f"t{i}": c for i, (_, c) in enumerate(RECORDED)}
    ok, res = smoke.grad_criterion(card, cpu)
    assert ok
    assert res["grad_vs_f64_ratio_at"] == "t3"  # 1.77
    assert res["grad_vs_f64_limit_use_at"] == "t3"  # 5.1e-4 of the 1e-3 floor
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
    (2.13e-3), both devices off the witness by as much pass; a card
    gradient scaled by 1.01 (about a 1e-2 relative distance) fails, at
    its tensor."""
    witness = _witness()
    cpu, card = _noisy(witness, 1, rel_noise), _noisy(witness, 2, rel_noise)
    d_cpu = smoke.grad_distances(cpu, witness)
    ok, _ = smoke.grad_criterion(smoke.grad_distances(card, witness), d_cpu)
    assert ok
    planted = dict(card, **{"ln.bias": card["ln.bias"] * 1.01})
    d_card = smoke.grad_distances(planted, witness)
    assert d_card["ln.bias"] >= 7e-3
    ok, res = smoke.grad_criterion(d_card, d_cpu)
    assert not ok and res["grad_vs_f64_failed"] == ["ln.bias"]
