"""Acoustic models (counterpart of :mod:`pydrobert_tpu.models`)."""

from .conformer import ConformerConfig, ConformerCTC, state_dict_from_jax

__all__ = ["ConformerConfig", "ConformerCTC", "state_dict_from_jax"]
