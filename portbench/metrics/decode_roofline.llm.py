"""A decode step's share of its roofline: the least bytes of a step
(:func:`portbench.counts.speech_llm.step_bytes`: every non-embedding
weight, the prompts' latent caches once per utterance at true lengths and
each beam's decoded latents) over the published bandwidth, divided by the
trip's time (``step_ms``), summed over every trip of the untraced
window's requests, in percent."""

from portbench.counts import speech_llm
from portbench.counts.peaks import HBM_BYTES_PER_S


def read(run):
    bound = took = 0.0
    width = int(run.spec["width"])
    for u in run.plain_units:
        for t, ms in enumerate(u.get("step_ms", ()), 1):
            bound += speech_llm.step_bytes(run.config, u["lens"], width, t) / HBM_BYTES_PER_S
            took += ms / 1e3
    return 100.0 * bound / took if took else None
