"""The share of the traced CTC prefix searches (``pydt.search/ctc_prefix``)
that launched the renormalizing whole-loop beam kernel (``csrc/ctc_beam.cu``,
found by its name, as ``decode_prologue_roofline`` finds
``prologue_kernel``), in percent: 100 when every search ran its frame loop
as one launch of it, 0 when every one took the per-frame scan or the
raw-mass kernel. The two instantiations share the name
``ctc_beam_kernel`` and differ in their ``RENORM`` template argument,
``ctc_beam_kernel<16, true, __nv_bfloat16>`` against
``ctc_beam_kernel<16, false, float>``, so only the first counts. None
without such spans."""

import re

from portbench import spans

KERNEL = re.compile(r"ctc_beam_kernel<\d+, true,")


def read(run):
    searches = spans.inside(run, "pydt.search/ctc_prefix")
    if not searches:
        return None
    hit = sum(
        1 for s, e in searches
        if any(KERNEL.search(k[2]) for k in run.records.kernels_of(s, e, "ctc_beam_kernel"))
    )
    return 100.0 * hit / len(searches)
