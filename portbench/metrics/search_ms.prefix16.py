"""Milliseconds of a request after the model's forward has finished on the
device: the CTC prefix search (its frame loop and the hand-off of the
beams), on the device's timeline (CUDA events, which stall nothing), the
mean over the untraced window's requests."""

from portbench import readers


def read(run):
    return readers.part_ms(run, "loop_ms")
