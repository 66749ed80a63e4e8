"""Points where the host waits on the card (``pydt.sync/`` spans) inside
the traced requests' searches (``pydt.search/*``), over the frame-loop
trips (``pydt.loop/*``) inside them. A loop that a CUDA graph could
capture reads 0."""

from portbench import spans


def read(run):
    syncs = trips = 0
    for search in spans.inside(run, "pydt.search/"):
        syncs += len(spans.inside(run, spans.SYNC, search))
        trips += len(spans.inside(run, spans.LOOP, search))
    return syncs / trips if trips else None
