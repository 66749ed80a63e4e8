"""``beam_route_share.prefix16`` on synthetic profiler records: the share
of the traced searches that launched the renormalizing whole-loop beam
kernel (the raw-mass one does not count), and None from a trace without
the search spans."""

import types

import pytest

from portbench import harness
from portbench.records import Records
from portbench.tests.test_portbench_spans import _Event

BEAM = "void pydt_beam::ctc_beam_kernel<16, true, __nv_bfloat16>(float const*, int const*)"
RAW = "void pydt_beam::ctc_beam_kernel<16, false, float>(float const*, int const*)"


def _run(kernel_names, spans=True):
    """One traced request [0, 10000] holding a search [1000i, 1000i + 900]
    for each kernel name, which that search launches at 1000i + 100 (a
    prologue kernel first in each)."""
    events = [_Event("portbench.request", 0, 10000)]
    corr = 0
    for i, name in enumerate(kernel_names):
        s = 1000 * i
        if spans:
            events.append(_Event("pydt.search/ctc_prefix", s, s + 900))
        for at, kname in ((s + 50, "void pydt::prologue_kernel<float, true>"), (s + 100, name)):
            corr += 1
            events.append(_Event("cudaLaunchKernel", at, at + 1, corr=corr))
            events.append(_Event(kname, at + 5, at + 40, cuda=True, corr=corr))
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    return types.SimpleNamespace(records=Records(prof, "portbench.request"))


@pytest.mark.parametrize("names, want", [
    ([BEAM, BEAM], 100.0),
    ([BEAM, "void at::native::elementwise_kernel<128, 4>"], 50.0),
    (["void at::native::elementwise_kernel<128, 4>"] * 3, 0.0),
    ([BEAM, RAW, RAW, RAW], 25.0),
])
def test_beam_route_share_reads_the_share_of_searches(names, want):
    got = harness.load_module("metrics", "beam_route_share.prefix16").read(_run(names))
    assert got == pytest.approx(want, rel=1e-12, abs=0)


def test_beam_route_share_gives_none_without_spans():
    read = harness.load_module("metrics", "beam_route_share.prefix16").read
    assert read(_run([BEAM], spans=False)) is None
    assert read(types.SimpleNamespace(records=None)) is None
