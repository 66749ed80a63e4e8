"""Deprecated alias of :mod:`pydrobert_tpu_torch.functional`, as
:mod:`pydrobert_tpu.util`: it warns and forwards."""

import warnings

warnings.warn(
    "pydrobert_tpu_torch.util is deprecated. Use pydrobert_tpu_torch.functional",
    DeprecationWarning,
    stacklevel=2,
)

from .functional import *  # noqa: F401,F403,E402
