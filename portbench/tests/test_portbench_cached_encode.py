"""``cached_encode_share.stream`` on synthetic profiler records: the share
of the traced ``pydt.stream/encode`` spans that hold a
``pydt.stream/encode_cached`` span, 0 where no encode is cached (a program
without the state-cached route) and None from a trace without encode
spans."""

import types

import pytest

from portbench import harness
from portbench.tests.test_portbench_spans import (
    _finish_events,
    _push_events,
    _push_run,
    _records,
)


def _cached_push_run(spans=True):
    """:func:`_push_run` whose encode [110, 400] holds the state-cached
    chunk encode, as ``serving.py``'s cached route opens it."""
    host, kernels = _push_events(spans)
    if spans:
        host.append(("pydt.stream/encode_cached", 112, 398))
    return types.SimpleNamespace(records=_records(host, kernels, "portbench.call"))


def _cached_push_then_window_finish(spans=True):
    """A cached push, then a finish whose two encodes re-encode windows."""
    (h1, k1), (h2, k2) = _push_events(spans), _finish_events(spans)
    if spans:
        h1.append(("pydt.stream/encode_cached", 112, 398))
    return types.SimpleNamespace(records=_records(h1 + h2, k1 + k2, "portbench.call"))


@pytest.mark.parametrize("make, want", [
    (_push_run, 0.0),
    (_cached_push_run, 100.0),
    (_cached_push_then_window_finish, 100.0 / 3),
])
def test_cached_encode_share_reads_the_share_of_encodes(make, want):
    got = harness.load_module("metrics", "cached_encode_share.stream").read(make())
    assert got == pytest.approx(want, rel=1e-12, abs=0)


@pytest.mark.parametrize("make", [_push_run, _cached_push_run])
def test_cached_encode_share_gives_none_without_encode_spans(make):
    read = harness.load_module("metrics", "cached_encode_share.stream").read
    assert read(make(spans=False)) is None
