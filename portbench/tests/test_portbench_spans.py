"""The readers of the port's spans (``portbench/spans.py`` and the seven
metrics on it) on synthetic profiler records: each reads an exact value
from a trace that holds its spans, and None from one that holds none, as
a program older than the spans gives."""

import types

import pytest

from portbench import harness
from portbench.records import Records


class _Event:
    def __init__(self, name, start, end, cuda=False, corr=0):
        self._name, self._start, self._dur = name, start, end - start
        self._cuda, self._corr = cuda, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._cuda else DeviceType.CPU

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self._corr


def _records(host, kernels, unit):
    """``host``: ``(name, start, end)``; ``kernels``: ``(launched at, start,
    end)``, each launched by a ``cudaLaunchKernel`` of 1 ns."""
    events = [_Event(n, s, e) for n, s, e in host]
    for i, (at, s, e) in enumerate(kernels, 1):
        events.append(_Event("cudaLaunchKernel", at, at + 1, corr=i))
        events.append(_Event(f"kernel{i}", s, e, cuda=True, corr=i))
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    return Records(prof, unit)


def _push_events(spans=True):
    """One call [0, 1000] holding one push, in ns: the push [100, 900]
    encodes a window [110, 400] (kernels 100 and 80 ns long), copies
    lengths (a 10 ns kernel outside both spans) and advances [430, 880]
    (two trips, one 40 ns kernel); two syncs inside the push, one outside
    it, and kernels before and after the push inside the call."""
    host = [("portbench.call", 0, 1000), ("pydt.sync/before", 20, 30),
            ("aten::cat", 105, 108)]
    if spans:
        host += [
            ("pydt.stream/push", 100, 900),
            ("pydt.stream/encode", 110, 400),
            ("pydt.sync/stream_window", 120, 130),
            ("pydt.search/transducer_greedy", 430, 880),
            ("pydt.sync/transducer_greedy", 440, 450),
            ("pydt.loop/transducer_greedy", 460, 500),
            ("pydt.loop/transducer_greedy", 500, 540),
        ]
    kernels = [(50, 60, 90), (150, 200, 300), (160, 300, 380), (412, 415, 425),
               (470, 480, 520), (905, 905, 990)]
    return host, kernels


def _finish_events(spans=True):
    """One call [1000, 2000] holding a finish [1100, 1900]: a last window
    encode [1110, 1300] (a 60 ns kernel), the tail encode [1400, 1500] (20
    ns), the tail pick's copy (a 10 ns kernel outside both) and an advance
    [1600, 1800] (50 ns); four syncs, among them ``stream_tail``."""
    host = [("portbench.call", 1000, 2000)]
    if spans:
        host += [
            ("pydt.stream/finish", 1100, 1900),
            ("pydt.stream/encode", 1110, 1300),
            ("pydt.sync/stream_window", 1120, 1130),
            ("pydt.stream/encode", 1400, 1500),
            ("pydt.sync/stream_window", 1410, 1420),
            ("pydt.sync/stream_tail", 1510, 1520),
            ("pydt.search/transducer_greedy", 1600, 1800),
            ("pydt.sync/transducer_greedy", 1610, 1620),
        ]
    kernels = [(1150, 1200, 1260), (1450, 1460, 1480), (1525, 1530, 1540),
               (1650, 1700, 1750)]
    return host, kernels


def _push_run(spans=True):
    """A traced window of one push (:func:`_push_events`)."""
    host, kernels = _push_events(spans)
    return types.SimpleNamespace(records=_records(host, kernels, "portbench.call"))


def _stream_run(spans=True):
    """A traced window of a push and then the session's finish."""
    (h1, k1), (h2, k2) = _push_events(spans), _finish_events(spans)
    return types.SimpleNamespace(records=_records(h1 + h2, k1 + k2, "portbench.call"))


def _search_run(name, syncs, spans=True):
    """One traced request: the encoder's kernel [20, 600] launched at 10;
    the search [100, 1000] launches at 210 and 310 (its trips) kernels that
    run [600, 650] and [700, 720], after the encoder's; ``syncs`` syncs in
    the search, one after it."""
    loop = "pydt.loop/" + ("ctc_prefix_search" if "ctc" in name else "transducer_greedy")
    host = [("portbench.request", 0, 2000), (loop, 200, 300), (loop, 300, 400),
            ("pydt.sync/after", 1100, 1110)]
    if spans:
        host += [(name, 100, 1000)]
        host += [("pydt.sync/" + name.split("/")[-1], 410 + 10 * i, 415 + 10 * i)
                 for i in range(syncs)]
    kernels = [(10, 20, 600), (210, 600, 650), (310, 700, 720)]
    return types.SimpleNamespace(records=_records(host, kernels, "portbench.request"))


CASES = [
    ("encode_busy_ms.stream", _push_run, 180e-6),
    ("advance_busy_ms.stream", _push_run, 40e-6),
    # 800 ns of push, busy 100 + 80 + 10 + 40
    ("push_idle_ms.stream", _push_run, 570e-6),
    ("syncs_per_push.stream", _push_run, 2.0),
    # the device interval [600, 720]: 70 of its 120 ns busy
    ("search_idle_share.prefix16",
     lambda spans=True: _search_run("pydt.search/ctc_prefix", 0, spans), 100.0 * 50 / 120),
    ("greedy_idle_share.greedy",
     lambda spans=True: _search_run("pydt.search/transducer_greedy", 3, spans),
     100.0 * 50 / 120),
    ("syncs_per_trip.serve",
     lambda spans=True: _search_run("pydt.search/transducer_greedy", 3, spans), 1.5),
    ("syncs_per_trip.serve",
     lambda spans=True: _search_run("pydt.search/ctc_prefix", 0, spans), 0.0),
    # the mean of the push and the finish: encodes 180 and 60 + 20 ns,
    # advances 40 and 50, idle 570 and 800 - 140, syncs 2 and 4
    ("encode_busy_ms.stream", _stream_run, 130e-6),
    ("advance_busy_ms.stream", _stream_run, 45e-6),
    ("push_idle_ms.stream", _stream_run, 615e-6),
    ("syncs_per_push.stream", _stream_run, 3.0),
]


@pytest.mark.parametrize("metric, make, want", CASES)
def test_span_reader_reads_exact_values(metric, make, want):
    got = harness.load_module("metrics", metric).read(make())
    assert got == pytest.approx(want, rel=1e-12, abs=0)


@pytest.mark.parametrize("metric, make", sorted({(m, f) for m, f, _ in CASES},
                                                key=lambda c: c[0]))
def test_span_reader_gives_none_without_spans(metric, make):
    assert harness.load_module("metrics", metric).read(make(spans=False)) is None


def test_spans_lie_inside_their_holders():
    run = _push_run()
    from portbench import spans

    (push,) = spans.inside(run, "pydt.stream/push")
    assert push == (100, 900)
    assert spans.inside(run, spans.SYNC) == [(20, 30), (120, 130), (440, 450)]
    assert spans.inside(run, spans.SYNC, push) == [(120, 130), (440, 450)]
    assert spans.inside(run, spans.LOOP, (430, 880)) == [(460, 500), (500, 540)]
    assert spans.device_interval(run, (430, 880)) == (480, 520)
    assert spans.device_interval(run, (600, 700)) is None
    assert spans.per_call(_stream_run(), lambda c: c[1] - c[0]) == 800  # a push, a finish
