"""Kernel launches the host issues in one trip of the transducer greedy
loop, over the traced requests."""

from portbench import readers


def read(run):
    return readers.launches_per_trip(run, "transducer_greedy")
