"""``dwconv_kernel_share.serve`` and ``dwconv_kernel_share.stream`` on
synthetic profiler records: the share of the traced depthwise convs that
launched the depthwise conv kernel (the tap loop's elementwise kernels do
not count, nor a kernel launched outside the span), and None from a trace
without the spans, as a program older than them gives."""

import types

import pytest

from portbench import harness
from portbench.records import Records
from portbench.tests.test_portbench_spans import _Event

DW = ("void pydt_dw::dw_kernel<unsigned int, 4>(unsigned int const*, float const*, "
      "float const*, int, int, int, int, unsigned int*)")
TAP = "void at::native::elementwise_kernel<128, 4>"
METRICS = ("dwconv_kernel_share.serve", "dwconv_kernel_share.stream")


def _run(kernel_names, spans=True, unit="portbench.request"):
    """One traced unit [0, 10000] holding a conv span [1000i, 1000i + 900]
    for each entry of ``kernel_names``, whose kernels that conv launches at
    1000i + 100 on; a depthwise kernel launched between two spans too."""
    events = [_Event(unit, 0, 10000)]
    corr = 0
    for i, names in enumerate(kernel_names):
        s = 1000 * i
        if spans:
            events.append(_Event("pydt.conv/depthwise", s, s + 900))
        for j, kname in enumerate(names):
            corr += 1
            at = s + 100 + 10 * j
            events.append(_Event("cudaLaunchKernel", at, at + 1, corr=corr))
            events.append(_Event(kname, at + 5, at + 8, cuda=True, corr=corr))
        corr += 1
        events.append(_Event("cudaLaunchKernel", s + 950, s + 951, corr=corr))
        events.append(_Event(DW, s + 955, s + 958, cuda=True, corr=corr))
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    return types.SimpleNamespace(records=Records(prof, unit))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("names, want", [
    ([[DW]] * 4, 100.0),
    ([[DW], [TAP] * 64, [DW], [TAP] * 64], 50.0),
    ([[TAP] * 64] * 3, 0.0),
    ([[TAP, DW], [], [], []], 25.0),
])
def test_dwconv_kernel_share_reads_the_share_of_convs(metric, names, want):
    got = harness.load_module("metrics", metric).read(_run(names))
    assert got == pytest.approx(want, rel=1e-12, abs=0)


@pytest.mark.parametrize("metric", METRICS)
def test_dwconv_kernel_share_gives_none_without_spans(metric):
    read = harness.load_module("metrics", metric).read
    assert read(_run([[DW]], spans=False)) is None
    assert read(types.SimpleNamespace(records=None)) is None
