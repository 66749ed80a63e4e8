"""The decode prologue kernel's share of its roofline: the frozen bound
(:mod:`portbench.counts.decode_prologue`) for the frames the requests'
true lengths need, over the kernel's device time in those requests, in
percent of the published peaks (the card's power limit is the run's
``device.power_limit_w``)."""

from portbench import readers
from portbench.counts import flops
from portbench.counts.decode_prologue import bound_ms_true_lengths


def read(run):
    bound = dev = 0.0
    V1 = run.config["vocab_size"] + 1
    m = min(V1 - 1, 2 * int(run.spec["width"]))
    for span, u in readers.units(run):
        ks = run.records.kernels_of(span[0], span[1], "prologue_kernel")
        if not ks:
            continue
        dev += sum(e - s for s, e, _, _ in ks) / 1e6
        frames = sum(flops.out_length(L) for L in u["lens"])
        bound += bound_ms_true_lengths(frames, V1, m, 4)
    return 100.0 * bound / dev if dev else None
