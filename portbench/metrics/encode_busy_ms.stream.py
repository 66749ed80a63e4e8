"""Device time of the kernels launched inside the window encodes
(``pydt.stream/encode``: the window's slice, pad, lengths and the causal
encoder; a finish's tail encode too) of one streaming call (a push or a
finish), in ms, the mean over the traced calls. Kernel times barely move
under the profiler, so this compares with the untraced window's push
times."""

from portbench import spans


def read(run):
    return spans.per_call(
        run, lambda c: spans.kernel_ns(run, spans.inside(run, "pydt.stream/encode", c)) / 1e6
    )
