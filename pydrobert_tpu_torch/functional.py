"""Public functional interface (counterpart of
:mod:`pydrobert_tpu.functional`): the same functions, re-exported from the
port's ops. The randomized ones take a :class:`torch.Generator` (or their
draws) where the JAX package takes a key.
"""

from .ops.combinatorics import (  # noqa: F401
    binomial_coefficient,
    enumerate_binary_sequences,
    enumerate_binary_sequences_with_cardinality,
    enumerate_vocab_sequences,
    simple_random_sampling_without_replacement,
)
from .ops.decoding import (  # noqa: F401
    beam_search_advance,
    compress_blank_frames,
    ctc_forced_align,
    ctc_greedy_search,
    ctc_prefix_search_advance,
    random_walk_advance,
    sequence_log_probs,
)
from .ops.feats import (  # noqa: F401
    chunk_token_sequences_by_slices,
    feat_delta_filters,
    feat_deltas,
    mean_var_norm,
    slice_spect_data,
)
from .ops.img import (  # noqa: F401
    dense_image_warp,
    grid_sample,
    polyharmonic_spline,
    random_shift,
    sparse_image_warp,
    spec_augment,
    spec_augment_apply_parameters,
    spec_augment_draw_parameters,
    warp_1d_grid,
)
from .ops.pad import (  # noqa: F401
    chunk_by_slices,
    pad_masked_sequence,
    pad_variable,
)
from .ops.rl import time_distributed_return  # noqa: F401
from .ops.string import (  # noqa: F401
    edit_distance,
    error_rate,
    fill_after_eos,
    hard_optimal_completion_distillation_loss,
    minimum_error_rate_loss,
    optimal_completion,
    prefix_edit_distances,
    prefix_error_rates,
)

__all__ = [
    "beam_search_advance",
    "binomial_coefficient",
    "chunk_by_slices",
    "chunk_token_sequences_by_slices",
    "compress_blank_frames",
    "ctc_forced_align",
    "ctc_greedy_search",
    "ctc_prefix_search_advance",
    "dense_image_warp",
    "edit_distance",
    "enumerate_binary_sequences",
    "enumerate_binary_sequences_with_cardinality",
    "enumerate_vocab_sequences",
    "error_rate",
    "feat_delta_filters",
    "feat_deltas",
    "fill_after_eos",
    "grid_sample",
    "hard_optimal_completion_distillation_loss",
    "mean_var_norm",
    "minimum_error_rate_loss",
    "optimal_completion",
    "pad_masked_sequence",
    "pad_variable",
    "polyharmonic_spline",
    "prefix_edit_distances",
    "prefix_error_rates",
    "random_shift",
    "random_walk_advance",
    "sequence_log_probs",
    "simple_random_sampling_without_replacement",
    "slice_spect_data",
    "sparse_image_warp",
    "spec_augment",
    "spec_augment_apply_parameters",
    "spec_augment_draw_parameters",
    "time_distributed_return",
    "warp_1d_grid",
]
