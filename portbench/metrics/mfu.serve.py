"""The whole request's share of the card's bf16 peak (989 TFLOP/s, at the
power limit in ``device.power_limit_w``): the model FLOPs of the
requests' true lengths (:mod:`portbench.counts.flops`) over the wall
time of every request of the untraced window, in percent."""

from portbench import readers


def read(run):
    return readers.mfu(run)
