"""Package constants (counterpart of :mod:`pydrobert_tpu.config`).

The values and semantics match the JAX package so data, defaults and
numerics line up. Environment variables take the prefix
``PYDROBERT_TPU_TORCH_``.
"""

import math
import os

__all__ = [
    "DECODE_RENORM",
    "EPS_0",
    "EPS_INF",
    "EPS_NINF",
    "INDEX_PAD_VALUE",
    "TINY",
]

INDEX_PAD_VALUE = -100
"""The value to pad index-based tensors with (the ``ignore_index``
convention)."""

TINY = 1.1754943508222875e-38
"""Smallest normal single-precision floating-point value."""

DECODE_RENORM = os.environ.get("PYDROBERT_TPU_TORCH_DECODE_RENORM", "1") != "0"
"""Per-frame power-of-two renormalization of the CTC beam masses.

Beam masses are linear f32 products of per-frame probabilities; with
diffuse acoustics they fall below the f32 normal range within tens of
frames. With this flag each decode step rescales every beam's masses by
``2**-e``, ``e`` the exponent of the batch row's best total mass, carries
``e`` in an int32 accumulator, and applies it once at the end. Scaling by a
power of two is exact, so every comparison matches the unrenormalized
trajectory wherever that stays in normal range. Final probabilities below
the normal f32 floor flush to zero."""

EPS_NINF = math.log(1.1754943508222875e-38) / 2
"""A small enough log-space value that exponentiating it is very close to 0."""

EPS_0 = math.log1p(-2 * 1.1920928955078125e-07)
"""A large enough log-space value that exponentiating it is very close to 1."""

EPS_INF = math.log(3.4028234663852886e38) / 2
"""A large enough log-space value that exponentiating it is near infinity."""
