"""Milliseconds of a request from the projector's start to the logits
after the prompts (the decoder's prefill over the padded prompts, its
routed experts over the true positions), on the device's timeline (CUDA
events, which stall nothing), the mean over the untraced window's
requests."""

from portbench import readers


def read(run):
    return readers.part_ms(run, "prefill_ms")
