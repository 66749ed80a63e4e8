"""Milliseconds of a streaming call (``pydt.stream/push``, from the new
frames' concatenation to the partial result's return, or
``pydt.stream/finish``) in which no kernel ran on the card, the mean over
the traced calls. The profiler's host costs lengthen the gaps of
launch-bound work, so this reads high there, as ``idle_share.*`` does."""

from portbench import spans


def read(run):
    return spans.per_call(run, lambda c: spans.idle_ns(run, *c) / 1e6)
