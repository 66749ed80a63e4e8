"""Megabytes a decode step's beam reorder and the search's freezing of
finished utterances move in the LM's state (counted by the program: the
leaves that the reorder gathers and the freeze selects, read and
written), the mean over the untraced window's steps. The latent caches are
not among them: the prompt's is held once per utterance and the suffix's
written in place."""


def read(run):
    moved = sum(u["reorder_bytes"] for u in run.plain_units if "reorder_bytes" in u)
    steps = sum(u["steps"] for u in run.plain_units if "reorder_bytes" in u)
    return moved / steps / 1e6 if steps else None
