"""Model families (counterpart of :mod:`pydrobert_tpu.models`)."""

from .conformer import (
    ConformerConfig,
    ConformerCTC,
    adamw,
    ctc_loss,
    make_train_step,
    moe_aux_loss,
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
from .transducer import (
    ConformerTransducer,
    TransducerConfig,
    lookup_lm_fusion,
    make_transducer_train_step,
    streaming_transducer_beam,
    streaming_transducer_greedy,
)

__all__ = [
    "AttentionSeq2Seq",
    "ConformerConfig",
    "ConformerCTC",
    "ConformerTransducer",
    "Seq2SeqConfig",
    "Seq2SeqDecoderLM",
    "TransducerConfig",
    "adam",
    "adamw",
    "ctc_loss",
    "lookup_lm_fusion",
    "make_mer_train_step",
    "make_train_step",
    "make_transducer_train_step",
    "moe_aux_loss",
    "state_dict_from_jax",
    "streaming_logits",
    "streaming_transducer_beam",
    "streaming_transducer_greedy",
]
