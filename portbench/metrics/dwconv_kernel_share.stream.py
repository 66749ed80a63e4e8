"""The share of the traced depthwise convs of the streaming pushes' cached
encodes (``pydt.conv/depthwise``, one a Conformer block a cached step)
inside which the host launched the depthwise conv kernel
(``csrc/depthwise_conv.cu``, found by its name), in percent. None without
such spans."""

from portbench import spans

KERNEL = "pydt_dw::dw_kernel"


def read(run):
    convs = spans.inside(run, "pydt.conv/depthwise")
    if not convs:
        return None
    hit = sum(bool(run.records.kernels_of(s, e, KERNEL)) for s, e in convs)
    return 100.0 * hit / len(convs)
