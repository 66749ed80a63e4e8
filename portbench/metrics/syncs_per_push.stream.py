"""Points where the host waits on the card (``pydt.sync/`` spans: a read
of a device value, or a copy of host lengths to the card) inside one
streaming call (``pydt.stream/push`` or ``pydt.stream/finish``), the mean
over the traced calls."""

from portbench import spans


def read(run):
    return spans.per_call(run, lambda c: len(spans.inside(run, spans.SYNC, c)))
