"""Seconds of audio decoded (true lengths at the mix's hop) over the
window's seconds: all the requests of the window over all its time."""


def read(run):
    if run.records is not None:
        return None
    return sum(u["audio_s"] for u in run.units) / run.window_s
