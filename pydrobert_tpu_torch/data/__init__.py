"""Host data parsing (counterpart of :mod:`pydrobert_tpu.data`; only
:func:`~pydrobert_tpu_torch.data.parsing.parse_arpa_lm` so far)."""

from .parsing import parse_arpa_lm

__all__ = ["parse_arpa_lm"]
