"""The port's own spans in a traced run: the ``pydt.<layer>/<name>`` ranges
that ``pydrobert_tpu_torch.utils.profiling.span`` opens while a profiler
runs (a streaming push or finish, a window encode, a search, and
``pydt.sync/<site>`` around each point where the host waits on the card).
:class:`portbench.records.Records` keeps them among its host events, on
the clock of the kernels' records, in ns. The ``pydt.loop/`` trips are
its ranges.

A program without these spans gives none, and each reader of them then
returns None."""

from .records import union_ns

LOOP = "pydt.loop/"
SYNC = "pydt.sync/"
CALLS = ("pydt.stream/push", "pydt.stream/finish")
"""The streaming recognizer's calls: together the calls that
``push_p95_ms`` takes its tail over."""


def _named(name):
    """A test of a host event's name: ``name`` itself, or any name under it
    when it ends with ``/``."""
    if name.endswith("/"):
        return lambda n: n.startswith(name)
    return lambda n: n == name


def inside(run, name, outer=None):
    """``(start, end)`` of every span ``name`` (or under it, for a name that
    ends with ``/``) that lies inside ``outer``, or inside a traced unit."""
    r = run.records
    if r is None:
        return []
    test = _named(name)
    seq = r.ranges if name.startswith(LOOP) else r.host
    holders = [outer] if outer is not None else list(r.units)
    return [(s, e) for s, e, n in seq if test(n)
            and any(a <= s and e <= b for a, b in holders)]


def kernel_ns(run, spans):
    """Device time of the kernels launched inside ``spans`` (the union of
    their intervals)."""
    ks = []
    for a, b in spans:
        ks.extend((k[0], k[1]) for k in run.records.kernels_of(a, b))
    return union_ns(ks)


def idle_ns(run, lo, hi):
    """Time in ``[lo, hi]`` in which no kernel ran on the card."""
    busy = union_ns([(k[0], k[1]) for k in run.records.kernels if k[0] < hi and k[1] > lo],
                    lo, hi)
    return (hi - lo) - busy


def device_interval(run, span):
    """From the start of the first kernel launched inside ``span`` to the
    end of the last; None when it launched none. The host can run ahead of
    the card, so a span's host interval may hold earlier work's kernels."""
    ks = run.records.kernels_of(*span)
    if not ks:
        return None
    return min(k[0] for k in ks), max(k[1] for k in ks)


def idle_share(run, name):
    """Percent of the device intervals of the traced spans ``name`` in
    which no kernel ran; None without such spans."""
    idle = total = 0
    for span in inside(run, name):
        iv = device_interval(run, span)
        if iv is None:
            continue
        idle += idle_ns(run, *iv)
        total += iv[1] - iv[0]
    return 100.0 * idle / total if total else None


def per_call(run, value):
    """The mean over the traced streaming calls (:data:`CALLS`, pushes and
    finishes) of ``value(call_span)``; None without such calls."""
    calls = sorted(c for name in CALLS for c in inside(run, name))
    if not calls:
        return None
    return sum(value(c) for c in calls) / len(calls)
