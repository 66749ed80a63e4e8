"""The whole request's share of the card's bf16 peak (989 TFLOP/s, at the
power limit in ``device.power_limit_w``): the model FLOPs of the
requests at true lengths (:func:`portbench.counts.speech_llm.request_flops`:
the encoder, the projector, the prefill, and every decode step of every
beam at its cache's length) over the wall time of every request of the
untraced window, in percent."""

from portbench.counts import speech_llm
from portbench.counts.peaks import BF16_FLOPS_PER_S


def read(run):
    done = secs = 0.0
    width = int(run.spec["width"])
    for u in run.plain_units:
        if "steps" not in u:
            continue
        done += speech_llm.request_flops(run.config, u["lens"], width, u["steps"])
        secs += u["ms"] / 1e3
    return 100.0 * done / secs / BF16_FLOPS_PER_S if secs else None
