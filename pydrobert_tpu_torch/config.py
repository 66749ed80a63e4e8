"""Package constants (counterpart of :mod:`pydrobert_tpu.config`).

The values and semantics match the JAX package so data, defaults and
numerics line up. Environment variables take the prefix
``PYDROBERT_TPU_TORCH_``.
"""

import math
import os

__all__ = [
    "DECODE_RENORM",
    "DEFT_ALI_SUBDIR",
    "DEFT_CHUNK_SIZE",
    "DEFT_CTM_CHANNEL",
    "DEFT_DEL_COST",
    "DEFT_DTYPE",
    "DEFT_FEAT_SUBDIR",
    "DEFT_FILE_PREFIX",
    "DEFT_FILE_SUFFIX",
    "DEFT_FLOAT_PRINT_PRECISION",
    "DEFT_FRAME_SHIFT_MS",
    "DEFT_HYP_SUBDIR",
    "DEFT_INS_COST",
    "DEFT_NUM_WORKERS",
    "DEFT_PAD_VALUE",
    "DEFT_PDFS_SUBDIR",
    "DEFT_REF_SUBDIR",
    "DEFT_SUB_COST",
    "DEFT_TEXTGRID_SUFFIX",
    "DEFT_TEXTGRID_TIER_ID",
    "DEFT_TEXTGRID_TIER_NAME",
    "EPS_0",
    "EPS_INF",
    "EPS_NINF",
    "INDEX_PAD_VALUE",
    "SPARSE_FUSION_MAX_CORRECTIONS",
    "SPARSE_MEMBERSHIP_GATHER",
    "TINY",
    "USE_BEAM_KERNEL",
]

INDEX_PAD_VALUE = -100
"""The value to pad index-based tensors with (the ``ignore_index``
convention)."""

DEFT_PAD_VALUE = 0.0
"""Default value to pad floating-point arrays with."""

DEFT_INS_COST = 1.0
"""Default insertion cost in error rate/distance computations."""

DEFT_DEL_COST = 1.0
"""Default deletion cost in error rate/distance computations."""

DEFT_SUB_COST = 1.0
"""Default substitution cost in error rate/distance computations."""

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

USE_BEAM_KERNEL = os.environ.get("PYDROBERT_TPU_TORCH_BEAM_KERNEL", "auto")
"""An on/off switch: ``"0"`` keeps
:class:`pydrobert_tpu_torch.ops.decoding.CTCPrefixSearch` (no LM) on the
per-frame scan, and any other value (the default is ``"auto"``) routes it
through a whole-loop kernel wherever the shape fits.

The kernel follows :data:`DECODE_RENORM`: on (the default),
:func:`pydrobert_tpu_torch.ops.kernels.ctc_beam_search_renorm`, the
denormal-proof scan's own loop with its rescales, bit for bit; off,
:func:`pydrobert_tpu_torch.ops.kernels.ctc_beam_search`, which carries
raw linear masses, the reference's semantics. Either way the search
needs ``T >= 2``, ``1 < width <= min(32, V)`` and a shape whose state
fits one block's shared memory
(:func:`pydrobert_tpu_torch.ops.kernels.ctc_beam_search_fits`). The JAX
package's counterpart, ``USE_PALLAS_BEAM``, times both routes on the
device to choose under ``"auto"`` and never takes its kernel with
``DECODE_RENORM`` on unless forced; nothing is timed here, so the value
has no third meaning."""

SPARSE_FUSION_MAX_CORRECTIONS = int(
    os.environ.get("PYDROBERT_TPU_TORCH_SPARSE_FUSION_MAX_C", "128")
)
"""Largest per-context correction count for the sparse-slot fused decode.

:class:`pydrobert_tpu_torch.ops.decoding.CTCPrefixSearch` with a
:class:`pydrobert_tpu_torch.lm.LookupLanguageModel` of order 2 or more
scores only candidate slots (the shared top-M plus each beam's stored
n-gram corrections) instead of all ``V`` extensions per beam, provided the
LM's ``max_corrections`` (the summed per-order maximum children count)
does not exceed this bound; larger LMs take the dense advance. Read at
call time."""

SPARSE_MEMBERSHIP_GATHER = (
    os.environ.get("PYDROBERT_TPU_TORCH_SPARSE_MEMBERSHIP_GATHER", "0") == "1"
)
"""Answer the sparse decode's "is token v a stored n-gram under this
context" through the direct-indexed bigram table
(:meth:`pydrobert_tpu_torch.lm.LookupLanguageModel.order2_values`) instead
of comparing its order-2 slots against the correction lists; the
order >= 3 slots are still compared. Off by default, as in the JAX package.
Only :class:`pydrobert_tpu_torch.ops.decoding.CTCPrefixSearch` reads it
(at call time); an LM whose table is None (no bigrams, or more than
``LookupLanguageModel._DENSE_NGRAM_MAX`` entries) takes the compare path.
:class:`~pydrobert_tpu_torch.ops.decoding.BeamSearch` ignores it, as the
JAX package's does."""

EPS_NINF = math.log(1.1754943508222875e-38) / 2
"""A small enough log-space value that exponentiating it is very close to 0."""

EPS_0 = math.log1p(-2 * 1.1920928955078125e-07)
"""A large enough log-space value that exponentiating it is very close to 1."""

EPS_INF = math.log(3.4028234663852886e38) / 2
"""A large enough log-space value that exponentiating it is near infinity."""

DEFT_FRAME_SHIFT_MS = 10.0
"""The default frame shift in milliseconds for commands."""

DEFT_TEXTGRID_SUFFIX = ".TextGrid"
"""The default suffix indicating TextGrid files for commands."""

DEFT_CHUNK_SIZE = 1000
"""Default number of units to process at once when multiprocessing."""


def _cpu_count() -> int:
    if hasattr(os, "sched_getaffinity"):
        return len(os.sched_getaffinity(0))
    cpu_count = os.cpu_count()
    return 0 if cpu_count is None else cpu_count


DEFT_NUM_WORKERS = _cpu_count()
"""Default number of workers when multiprocessing."""

DEFT_FILE_PREFIX = ""
"""Default prefix of a data file in a data directory."""

DEFT_FILE_SUFFIX = ".pt"
"""Default suffix of a data file in a data directory (``torch.save``
files, interchangeable with the JAX package's; see
:mod:`pydrobert_tpu_torch.utils.serial`)."""

DEFT_FLOAT_PRINT_PRECISION = 3
"""Default precision to write floating point values to file with."""

DEFT_CTM_CHANNEL = "A"
"""Default channel to write to CTM files."""

DEFT_TEXTGRID_TIER_ID = 0
"""Default TextGrid tier to read transcripts from."""

DEFT_TEXTGRID_TIER_NAME = "transcript"
"""Default TextGrid tier to write transcripts to."""

DEFT_FEAT_SUBDIR = "feat"
"""Default subdirectory of a data directory containing features."""

DEFT_ALI_SUBDIR = "ali"
"""Default subdirectory of a data directory containing alignments."""

DEFT_REF_SUBDIR = "ref"
"""Default subdirectory of a data directory containing reference tokens."""

DEFT_PDFS_SUBDIR = "pdfs"
"""Default subdirectory of a data directory to write pdfs to."""

DEFT_HYP_SUBDIR = "hyp"
"""Default subdirectory of a data directory to write hypothesis tokens to."""

DEFT_DTYPE = "float32"
"""Default floating-point dtype name for feature computation."""
