"""Device time of the kernels launched inside the greedy advances
(``pydt.search/transducer_greedy``: the loop's trips and checks) of one
streaming call (a push or a finish), in ms, the mean over the traced
calls."""

from portbench import spans


def read(run):
    return spans.per_call(
        run,
        lambda c: spans.kernel_ns(run, spans.inside(run, "pydt.search/transducer_greedy", c))
        / 1e6,
    )
