"""The share of the transducer greedy loops
(``pydt.search/transducer_greedy``) in which no kernel ran on the card, in
percent: over each traced loop, from the start of the first kernel it
launched to the end of its last (its first check waits for the encoder).
The profiler's host costs lengthen the gaps of this launch-bound loop, so
the share reads high, as ``idle_share.*`` does."""

from portbench import spans


def read(run):
    return spans.idle_share(run, "pydt.search/transducer_greedy")
