"""Milliseconds of a request until the acoustic model's forward has
finished on the device (the features made, the encoder, and for the CTC
model its head), on the device's timeline (CUDA events, which stall
nothing), the mean over the untraced window's requests."""

from portbench import readers


def read(run):
    return readers.part_ms(run, "enc_ms")
