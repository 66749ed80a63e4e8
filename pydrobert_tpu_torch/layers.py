"""Deprecated alias of :mod:`pydrobert_tpu_torch.modules` (and some
functionals), as :mod:`pydrobert_tpu.layers`: it warns and forwards."""

import warnings

warnings.warn(
    "pydrobert_tpu_torch.layers is deprecated. Use pydrobert_tpu_torch.functional "
    "for functions and pydrobert_tpu_torch.modules for modules",
    DeprecationWarning,
    stacklevel=2,
)

from .functional import (  # noqa: F401,E402
    hard_optimal_completion_distillation_loss,
    minimum_error_rate_loss,
    random_shift,
    spec_augment,
    spec_augment_apply_parameters,
    spec_augment_draw_parameters,
)
from .modules import *  # noqa: F401,F403,E402
