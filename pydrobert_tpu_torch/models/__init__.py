"""Acoustic models (counterpart of :mod:`pydrobert_tpu.models`)."""

from .conformer import (
    ConformerConfig,
    ConformerCTC,
    adamw,
    ctc_loss,
    make_train_step,
    state_dict_from_jax,
    streaming_logits,
)

__all__ = [
    "ConformerConfig",
    "ConformerCTC",
    "adamw",
    "ctc_loss",
    "make_train_step",
    "state_dict_from_jax",
    "streaming_logits",
]
