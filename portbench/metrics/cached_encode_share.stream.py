"""The share of the traced encodes of a streaming call
(``pydt.stream/encode``) that hold the state-cached chunk encode
(``pydt.stream/encode_cached``, ``serving.py``'s cached route), in
percent: 100 when every chunk was encoded once from the per-layer state
cache, 0 when every one re-encoded its window. None without encode spans."""

from portbench import spans


def read(run):
    encodes = spans.inside(run, "pydt.stream/encode")
    if not encodes:
        return None
    hit = sum(1 for e in encodes if spans.inside(run, "pydt.stream/encode_cached", e))
    return 100.0 * hit / len(encodes)
