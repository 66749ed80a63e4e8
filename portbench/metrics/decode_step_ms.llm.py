"""Milliseconds of one trip of the beam search over the LLM decoder: from
one step's logits to the next's on the device's timeline (CUDA events at
the decoder's ``lm_head``), so the search's own work (the top-k over
``width x vocab_size`` candidates per utterance, the reorder, the host's
read of whether the batch is done) is inside it; the mean over every trip
of the untraced window's requests."""


def read(run):
    times = [ms for u in run.plain_units for ms in u.get("step_ms", ())]
    return sum(times) / len(times) if times else None
