"""Milliseconds of a request after the encoder has finished on the device:
the transducer greedy loop (its trips, the host reads between them and the
hand-off of the transcripts), on the device's timeline (CUDA events, which
stall nothing), the mean over the untraced window's requests."""

from portbench import readers


def read(run):
    return readers.part_ms(run, "loop_ms")
