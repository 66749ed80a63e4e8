"""The share of the traced depthwise convs of the offline cells' encoders
(``pydt.conv/depthwise``, one a Conformer block a forward) inside which the
host launched the depthwise conv kernel (``csrc/depthwise_conv.cu``, found
by its name, as ``beam_route_share.prefix16`` finds its kernel), in
percent: 100 when every block's conv was one launch of it, 0 when every
one ran the 64-launch tap loop. None without such spans."""

from portbench import spans

KERNEL = "pydt_dw::dw_kernel"


def read(run):
    convs = spans.inside(run, "pydt.conv/depthwise")
    if not convs:
        return None
    hit = sum(bool(run.records.kernels_of(s, e, KERNEL)) for s, e in convs)
    return 100.0 * hit / len(convs)
