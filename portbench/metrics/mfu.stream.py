"""The whole push's share of the card's bf16 peak: the FLOPs of encoding
only the frames the push determines (each with its own left context, not
the re-encoded margin), their decisions and emissions, over the wall time
of every push of the untraced window, in percent."""

from portbench import readers


def read(run):
    return readers.mfu(run, kinds=("push",))
