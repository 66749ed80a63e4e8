"""Host data path (counterpart of :mod:`pydrobert_tpu.data`): the on-disk
SpectDataSet convention, epoch-deterministic (and process-sharded)
samplers, bucket batching, padded-batch collation, loaders that hand
batches to the card, ARPA parsing and the transcript/token conversions.
The tar-backed dataset and the trn, ctm and TextGrid parsers are not
ported yet."""

from .dataloaders import (
    AbstractEpochSampler,
    BucketBatchSampler,
    ContextWindowDataLoader,
    ContextWindowDataLoaderParams,
    DataLoaderParams,
    DynamicLengthDataLoaderParams,
    EpochRandomSampler,
    EpochSequentialSampler,
    LangDataLoader,
    LangDataLoaderParams,
    SpectDataLoader,
    SpectDataLoaderParams,
    context_window_seq_to_batch,
    lang_seq_to_batch,
    spect_seq_to_batch,
)
from .datasets import (
    ContextWindowDataSet,
    LangDataSet,
    SpectDataSet,
    extract_window,
    validate_spect_data_set,
)
from .params import (
    ContextWindowDataParams,
    LangDataParams,
    SpectDataParams,
    params_from_dict,
    params_to_dict,
)
from .parsing import parse_arpa_lm, token_to_transcript, transcript_to_token

__all__ = [
    "AbstractEpochSampler",
    "BucketBatchSampler",
    "ContextWindowDataLoader",
    "ContextWindowDataLoaderParams",
    "ContextWindowDataParams",
    "ContextWindowDataSet",
    "DataLoaderParams",
    "DynamicLengthDataLoaderParams",
    "EpochRandomSampler",
    "EpochSequentialSampler",
    "LangDataLoader",
    "LangDataLoaderParams",
    "LangDataParams",
    "LangDataSet",
    "SpectDataLoader",
    "SpectDataLoaderParams",
    "SpectDataParams",
    "SpectDataSet",
    "context_window_seq_to_batch",
    "extract_window",
    "lang_seq_to_batch",
    "params_from_dict",
    "params_to_dict",
    "parse_arpa_lm",
    "spect_seq_to_batch",
    "token_to_transcript",
    "transcript_to_token",
    "validate_spect_data_set",
]


# Deprecated v0.3-era names: warn-and-forward aliases, as in the JAX package.


def _deprecated_alias(old_name, cls, **fixed_kwargs):
    import functools
    import warnings as _warnings

    @functools.wraps(cls, assigned=("__doc__",), updated=())
    def make(*args, **kwargs):
        _warnings.warn(
            f"The name '{old_name}' is deprecated. Please switch to "
            f"'{cls.__name__}'",
            DeprecationWarning,
            stacklevel=2,
        )
        kwargs = {**fixed_kwargs, **kwargs}
        return cls(*args, **kwargs)

    make.__name__ = old_name
    return make


DataSetParams = _deprecated_alias("DataSetParams", DataLoaderParams)
SpectDataSetParams = _deprecated_alias("SpectDataSetParams", SpectDataLoaderParams)
ContextWindowDataSetParams = _deprecated_alias(
    "ContextWindowDataSetParams", ContextWindowDataLoaderParams
)
SpectTrainingDataLoader = _deprecated_alias(
    "SpectTrainingDataLoader", SpectDataLoader, shuffle=True
)
SpectEvaluationDataLoader = _deprecated_alias(
    "SpectEvaluationDataLoader", SpectDataLoader, shuffle=False,
    suppress_uttids=False,
)
ContextWindowTrainingDataLoader = _deprecated_alias(
    "ContextWindowTrainingDataLoader", ContextWindowDataLoader, shuffle=True
)
ContextWindowEvaluationDataLoader = _deprecated_alias(
    "ContextWindowEvaluationDataLoader", ContextWindowDataLoader,
    shuffle=False, suppress_uttids=False,
)
