"""The share of the traced window in which no kernel ran on the card, in
percent (``device.busy_s`` over ``device.window_s``), for the LLM-decoder
recognizer's requests."""

from portbench import readers


def read(run):
    return readers.idle_share(run)
