"""The share of the CTC prefix searches (``pydt.search/ctc_prefix``) in
which no kernel ran on the card, in percent: over each traced search, from
the start of the first kernel it launched to the end of its last (the
host runs ahead of the card by the encoder's queue when the search
begins). The profiler's host costs lengthen the gaps of this launch-bound
loop, so the share reads high, as ``idle_share.*`` does."""

from portbench import spans


def read(run):
    return spans.idle_share(run, "pydt.search/ctc_prefix")
