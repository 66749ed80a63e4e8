"""The comparison that decides ``correct``, on the CPU at a size it holds:
a sound run of each cell is correct, and the run comes out not correct
with the control (the reference in a lower precision in the program's
place) and with each fault a cell can have planted under its timed path:
a token altered where it is produced, and half of the batch decoded with
the rest answered by copies.
The harness's look for a card is skipped (``device="cpu"``); everything
else of a run is driven."""

import pytest
import torch

from portbench.tests import tiny

CELLS = ["ctc_l.prefix16", "rnnt_m.stream", "rnnt_m.greedy"]


def correct(root, cell, **kw):
    result, checks = tiny.run(root, cell, **kw)
    return result["correct"], checks


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tree, cell):
    ok, checks = correct(tree, cell)
    assert ok, checks


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tree, cell):
    ok, checks = correct(tree, cell, control=True)
    assert not ok, checks


def alter_token(out):
    """Each utterance's first token changed where it is produced (the judge
    reads a sample of the rows)."""
    hyps = out[0].clone()
    flat = hyps.reshape(hyps.shape[0], -1)
    flat[:, 0] = (flat[:, 0] + 1) % 40
    return (hyps,) + tuple(out[1:])


def half_batch(fn, feats, lens):
    """The first half of the batch decoded, the second half answered with
    copies of the first's results."""
    h = feats.shape[0] // 2
    out = fn(feats[:h], lens[:h])
    return tuple(torch.cat([o, o])[: feats.shape[0]] for o in out)


def plant_ctc(kind):
    def hook(entry):
        setup = entry.setup

        def broken_setup():
            setup()
            recognize = entry.recognize
            if kind == "token":
                entry.recognize = lambda f, l: alter_token(recognize(f, l))
            else:
                entry.recognize = lambda f, l: half_batch(recognize, f, l)
        entry.setup = broken_setup
    return hook


def plant_greedy(kind):
    def hook(entry):
        setup = entry.setup

        def broken_setup():
            setup()
            greedy = entry.model.greedy
            if kind == "token":
                entry.model.greedy = lambda f, l, e: alter_token(greedy(f, l, e))
            else:
                entry.model.greedy = lambda f, l, e: half_batch(
                    lambda a, b: greedy(a, b, e), f, l)
        entry.setup = broken_setup
    return hook


def plant_stream(entry):
    call = entry._call

    def broken(sess, feats, lens, p):
        out = call(sess, feats, lens, p)
        return alter_token(out) if p is None else out
    entry._call = broken


FAULTS = [
    ("ctc_l.prefix16", "token", plant_ctc("token")),
    ("ctc_l.prefix16", "half_batch", plant_ctc("half")),
    ("rnnt_m.greedy", "token", plant_greedy("token")),
    ("rnnt_m.greedy", "half_batch", plant_greedy("half")),
    ("rnnt_m.stream", "token", plant_stream),
]


@pytest.mark.parametrize("cell,fault,hook", FAULTS, ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_fault_is_not_correct(tree, cell, fault, hook):
    ok, checks = correct(tree, cell, hook=hook)
    assert not ok, (fault, checks)
