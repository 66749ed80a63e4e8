"""Kernel launches the host issues in one streaming push (finish calls
left out), the mean over the traced pushes."""

from portbench import readers


def read(run):
    spans = [s for s, u in readers.units(run) if u.get("kind") == "push"]
    if not spans:
        return None
    return sum(run.records.launches_in(a, b) for a, b in spans) / len(spans)
