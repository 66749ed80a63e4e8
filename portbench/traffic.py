"""The one generator of every traffic mix: a mix is a data file of
parameters (``portbench/traffic/<name>.json``), and each batch is made on
the device from the run's seed and the batch's index, so the same seed
gives the same inputs.

Keys of a mix:

- ``source``: the published corpus figures its lengths follow;
- ``batch``: utterances (or streams) in a batch;
- ``lengths_s``: each utterance's length in seconds, drawn independently
  from a log-normal of mean ``mean`` and log-standard-deviation ``log_sd``
  truncated to ``[min, max]`` (drawn by the inverse of its distribution
  function over the kept range, so no length is clipped onto a bound);
- ``pad_to``: the padded length of every batch in raw frames (at least
  ``max / hop_s``), so the program sees one shape;
- ``hop_s``: seconds of audio a raw frame stands for;
- ``push_raw_frames`` (streaming mixes): raw frames a stream sends in one
  push.

Features are standard normals.
"""

import math
from statistics import NormalDist

import numpy as np
import torch

_NORMAL = NormalDist()


def lengths(traffic, rng: np.random.Generator) -> np.ndarray:
    """A batch's lengths in raw frames, ``(batch,)`` int64."""
    dist = traffic["lengths_s"]
    sd = float(dist["log_sd"])
    mu = math.log(float(dist["mean"])) - sd * sd / 2
    lo, hi = (_NORMAL.cdf((math.log(float(dist[k])) - mu) / sd) for k in ("min", "max"))
    u = lo + (hi - lo) * rng.random(int(traffic["batch"]))
    secs = np.exp(mu + sd * np.array([_NORMAL.inv_cdf(float(p)) for p in u]))
    hop = float(traffic["hop_s"])
    raw = np.rint(secs / hop).astype(np.int64)
    return np.clip(raw, 1, int(math.floor(float(dist["max"]) / hop + 1e-9)))


def make_batch(ctx, index, num_filts: int):
    """Batch ``index`` of the run: ``dict(feats (B, pad_to, num_filts)
    float32 on the device, lens (B,) int64 numpy)``."""
    tr = ctx.traffic
    lens = lengths(tr, ctx.rng("batch", index))
    T = int(tr["pad_to"])
    if T < lens.max():
        raise ValueError("pad_to is shorter than the longest utterance")
    g = ctx.generator("feats", index)
    return {
        "feats": torch.randn((len(lens), T, num_filts), generator=g, device=ctx.device),
        "lens": lens,
    }


def audio_seconds(traffic, lens) -> float:
    return float(np.sum(lens)) * float(traffic["hop_s"])
