"""Kernel launches the host issues in one trip of the CTC prefix search's
frame loop, over the traced requests."""

from portbench import readers


def read(run):
    return readers.launches_per_trip(run, "ctc_prefix_search")
