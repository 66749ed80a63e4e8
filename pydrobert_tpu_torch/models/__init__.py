"""Model families (counterpart of :mod:`pydrobert_tpu.models`)."""

from .conformer import (
    ConformerConfig,
    ConformerCTC,
    adamw,
    ctc_loss,
    make_train_step,
    state_dict_from_jax,
    streaming_logits,
)
from .seq2seq import (
    AttentionSeq2Seq,
    Seq2SeqConfig,
    Seq2SeqDecoderLM,
    adam,
    make_mer_train_step,
)

__all__ = [
    "AttentionSeq2Seq",
    "ConformerConfig",
    "ConformerCTC",
    "Seq2SeqConfig",
    "Seq2SeqDecoderLM",
    "adam",
    "adamw",
    "ctc_loss",
    "make_mer_train_step",
    "make_train_step",
    "state_dict_from_jax",
    "streaming_logits",
]
