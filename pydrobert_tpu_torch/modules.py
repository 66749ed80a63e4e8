"""Public module interface (counterpart of :mod:`pydrobert_tpu.modules`):
configured callables around the functionals, with the same names and
config keys. A parameter-free module holds its hyperparameters at
construction and takes tensors when called; the modules with parameters
(attention, the REBAR control variates) and the searches are the port's
:class:`torch.nn.Module`\\ s and classes, re-exported. The randomized
modules take a :class:`torch.Generator` where the JAX package takes a key.
"""


import numpy as np
import torch

from . import functional as F
from .lm import (  # noqa: F401
    ExtractableSequentialLanguageModel,
    ExtractableShallowFusionLanguageModel,
    LookupLanguageModel,
    MixableSequentialLanguageModel,
    MixableShallowFusionLanguageModel,
    SequentialLanguageModel,
    ShallowFusionLanguageModel,
)
from .ops.attn import (  # noqa: F401
    ConcatSoftAttention,
    DotProductSoftAttention,
    GeneralizedDotProductSoftAttention,
    GlobalSoftAttention,
    MultiHeadedAttention,
)
from .ops.decoding import (  # noqa: F401
    BeamSearch,
    CTCForcedAligner,
    CTCGreedySearch,
    CTCPrefixSearch,
    RandomWalk,
    SequenceLogProbabilities,
)
from .ops.mc import (  # noqa: F401
    GumbelOneHotCategoricalRebarControlVariate,
    LogisticBernoulliRebarControlVariate,
)

__all__ = [
    "BeamSearch",
    "ChunkBySlices",
    "ChunkTokenSequencesBySlices",
    "ConcatSoftAttention",
    "CTCForcedAligner",
    "CTCGreedySearch",
    "CTCPrefixSearch",
    "DenseImageWarp",
    "DotProductSoftAttention",
    "EditDistance",
    "ErrorRate",
    "ExtractableSequentialLanguageModel",
    "ExtractableShallowFusionLanguageModel",
    "FeatureDeltas",
    "FillAfterEndOfSequence",
    "GeneralizedDotProductSoftAttention",
    "GlobalSoftAttention",
    "GumbelOneHotCategoricalRebarControlVariate",
    "HardOptimalCompletionDistillationLoss",
    "LogisticBernoulliRebarControlVariate",
    "LookupLanguageModel",
    "MeanVarianceNormalization",
    "MinimumErrorRateLoss",
    "MixableSequentialLanguageModel",
    "MixableShallowFusionLanguageModel",
    "MultiHeadedAttention",
    "OptimalCompletion",
    "PadMaskedSequence",
    "PadVariable",
    "PolyharmonicSpline",
    "PrefixEditDistances",
    "PrefixErrorRates",
    "RandomShift",
    "RandomWalk",
    "SequenceLogProbabilities",
    "SequentialLanguageModel",
    "ShallowFusionLanguageModel",
    "SliceSpectData",
    "SparseImageWarp",
    "SpecAugment",
    "TimeDistributedReturn",
    "Warp1DGrid",
]


class _ConfiguredCallable:
    """Stores functional keyword config at init; applies at call.

    Call-time positional arguments bind to the functional's NON-config
    parameters in signature order (the functionals interleave config
    parameters between data arguments, so forwarding ``*args`` verbatim
    would mis-bind e.g. ``lengths`` onto ``max_time_warp``)."""

    _fn = None
    _config_keys = ()

    @classmethod
    def _call_param_names(cls):
        names = cls.__dict__.get("_call_params")
        if names is None:
            import inspect

            sig = inspect.signature(cls._fn)
            names = tuple(
                p.name
                for p in sig.parameters.values()
                if p.kind
                in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                and p.name not in cls._config_keys
            )
            cls._call_params = names
        return names

    def __init__(self, *args, **kwargs):
        keys = self._config_keys
        if len(args) > len(keys):
            raise TypeError(
                f"{type(self).__name__} takes at most {len(keys)} "
                f"positional arguments ({len(args)} given)"
            )
        for k, v in zip(keys, args):
            if k in kwargs:
                raise TypeError(
                    f"{type(self).__name__} got multiple values for "
                    f"argument '{k}'"
                )
            kwargs[k] = v
        bad = set(kwargs) - set(keys)
        if bad:
            raise TypeError(
                f"{type(self).__name__} got unexpected arguments {sorted(bad)}"
            )
        self._kwargs = kwargs

    def __getattr__(self, name):
        # expose config values as attributes, like the reference modules;
        # unset hyperparameters fall back to the functional's default
        d = self.__dict__.get("_kwargs", {})
        if name in d:
            return d[name]
        if name in type(self)._config_keys:
            import inspect

            p = inspect.signature(type(self)._fn).parameters.get(name)
            if p is not None and p.default is not inspect.Parameter.empty:
                return p.default
        raise AttributeError(name)

    def __call__(self, *args, **overrides):
        kwargs = dict(self._kwargs)
        kwargs.update(overrides)
        call_names = self._call_param_names()
        if len(args) > len(call_names):
            raise TypeError(
                f"{type(self).__name__}() takes at most {len(call_names)} "
                f"positional arguments ({len(args)} given)"
            )
        for nm, v in zip(call_names, args):
            if nm in kwargs:
                raise TypeError(
                    f"{type(self).__name__}() got multiple values for "
                    f"argument '{nm}'"
                )
            kwargs[nm] = v
        return type(self)._fn(**kwargs)

    def __repr__(self):
        cfg = ", ".join(f"{k}={v!r}" for k, v in self._kwargs.items())
        return f"{type(self).__name__}({cfg})"


def _wrap(name, fn, config_keys, doc):
    return type(
        name,
        (_ConfiguredCallable,),
        {"_fn": staticmethod(fn), "_config_keys": tuple(config_keys), "__doc__": doc},
    )


_STRING_KEYS = (
    "eos", "include_eos", "norm", "batch_first", "ins_cost", "del_cost",
    "sub_cost", "warn",
)
EditDistance = _wrap(
    "EditDistance", F.edit_distance, _STRING_KEYS,
    "Batched edit distance; call with ``(ref, hyp)``. Parity: reference "
    "``EditDistance`` (``_string.py:722-812``).",
)
ErrorRate = _wrap(
    "ErrorRate", F.error_rate, _STRING_KEYS,
    "Batched error rate; call with ``(ref, hyp)``. Parity: reference "
    "``ErrorRate`` (``_string.py:815-911``).",
)
_PREFIX_KEYS = (
    "eos", "include_eos", "norm", "batch_first", "ins_cost", "del_cost",
    "sub_cost", "padding", "exclude_last", "warn",
)
PrefixErrorRates = _wrap(
    "PrefixErrorRates", F.prefix_error_rates, _PREFIX_KEYS,
    "Error rates of all hyp prefixes; call with ``(ref, hyp)``.",
)
PrefixEditDistances = _wrap(
    "PrefixEditDistances", F.prefix_edit_distances, _PREFIX_KEYS,
    "Edit distances of all hyp prefixes; call with ``(ref, hyp)``.",
)
OptimalCompletion = _wrap(
    "OptimalCompletion", F.optimal_completion,
    (
        "eos", "include_eos", "batch_first", "ins_cost", "del_cost",
        "sub_cost", "padding", "exclude_last", "warn",
    ),
    "Optimal next tokens per hyp prefix; call with ``(ref, hyp)``.",
)
HardOptimalCompletionDistillationLoss = _wrap(
    "HardOptimalCompletionDistillationLoss",
    F.hard_optimal_completion_distillation_loss,
    (
        "eos", "include_eos", "batch_first", "ins_cost", "del_cost",
        "sub_cost", "weight", "reduction", "ignore_index", "warn",
    ),
    "OCD loss; call with ``(logits, ref, hyp)``. Parity: reference "
    "``HardOptimalCompletionDistillationLoss`` (``_string.py:1254-1373``).",
)
MinimumErrorRateLoss = _wrap(
    "MinimumErrorRateLoss", F.minimum_error_rate_loss,
    (
        "eos", "include_eos", "sub_avg", "batch_first", "norm", "ins_cost",
        "del_cost", "sub_cost", "reduction", "warn",
    ),
    "Minimum error rate loss over N-best samples; call with "
    "``(log_probs, ref, hyp)``.",
)
FillAfterEndOfSequence = _wrap(
    "FillAfterEndOfSequence", F.fill_after_eos, ("eos", "axis", "fill"),
    "Fill everything after the first eos; call with ``(tokens[, value])``. "
    "Parity: reference ``FillAfterEndOfSequence`` (``_string.py:45-134``).",
)
PadVariable = _wrap(
    "PadVariable", F.pad_variable, ("mode", "value"),
    "Per-sequence variable padding; call with ``(x, lens, pad)``.",
)
PadMaskedSequence = _wrap(
    "PadMaskedSequence", F.pad_masked_sequence, ("batch_first", "padding_value"),
    "Shift masked-out elements to the sequence end; call with ``(x, mask)``. "
    "Parity: reference ``PadMaskedSequence`` (``_pad.py:282-380``).",
)
ChunkBySlices = _wrap(
    "ChunkBySlices", F.chunk_by_slices, ("mode", "value"),
    "Slice and pad out-of-bounds; call with ``(x, slices[, lens])``. "
    "Parity: reference ``ChunkBySlices`` (``_pad.py:466-548``).",
)
ChunkTokenSequencesBySlices = _wrap(
    "ChunkTokenSequencesBySlices", F.chunk_token_sequences_by_slices,
    ("partial", "retain"),
    "Keep tokens overlapping slices; call with ``(refs, slices[, ref_lens])``. "
    "Parity: reference ``ChunkTokenSequencesBySlices`` "
    "(``_feats.py:840-930``).",
)
FeatureDeltas = _wrap(
    "FeatureDeltas", F.feat_deltas,
    ("dim", "time_dim", "concatenate", "order", "width", "pad_mode", "value"),
    "Concatenated feature deltas; call with ``(x,)``. Parity: reference "
    "``FeatureDeltas`` (``_feats.py:300-427``).",
)
SliceSpectData = _wrap(
    "SliceSpectData", F.slice_spect_data,
    ("policy", "window_type", "valid_only", "lobe_size"),
    "Compute chunk slices under fixed/ali/ref policies; call with "
    "``(input[, in_lens[, other_lens]])``. Parity: reference "
    "``SliceSpectData`` (``_feats.py:591-787``).",
)
PolyharmonicSpline = _wrap(
    "PolyharmonicSpline", F.polyharmonic_spline,
    ("order", "regularization_weight", "full_matrix"),
    "Polyharmonic spline interpolation; call with ``(train_points, "
    "train_values, query_points)``.",
)
Warp1DGrid = _wrap(
    "Warp1DGrid", F.warp_1d_grid, ("max_length", "interpolation_order"),
    "1-D warp grid for grid_sample; call with ``(src, flow, lengths)``. "
    "Parity: reference ``Warp1DGrid`` (``_img.py:306-390``).",
)
DenseImageWarp = _wrap(
    "DenseImageWarp", F.dense_image_warp, ("indexing", "mode", "padding_mode"),
    "Warp an image with a dense flow field; call with ``(image, flow)``. "
    "Parity: reference ``DenseImageWarp`` (``_img.py:442-517``).",
)
SparseImageWarp = _wrap(
    "SparseImageWarp", F.sparse_image_warp,
    (
        "indexing", "field_interpolation_order", "field_regularization_weight",
        "field_full_matrix", "pinned_boundary_points",
        "dense_interpolation_mode", "dense_padding_mode", "include_flow",
    ),
    "Warp an image via sparse control points; call with ``(image, "
    "source_points, dest_points)``.",
)
RandomShift = _wrap(
    "RandomShift", F.random_shift, ("prop", "mode", "value"),
    "Randomly pad sequences left and right; call with ``(input, in_lens[, "
    "training[, out_len]], generator=...)``.",
)
SpecAugment = _wrap(
    "SpecAugment", F.spec_augment,
    (
        "max_time_warp", "max_freq_warp", "max_time_mask", "max_freq_mask",
        "max_time_mask_proportion", "num_time_mask",
        "num_time_mask_proportion", "num_freq_mask", "interpolation_order",
    ),
    "SpecAugment; call with ``(generator, feats[, lengths][, training])``.",
)
TimeDistributedReturn = _wrap(
    "TimeDistributedReturn", F.time_distributed_return,
    ("gamma", "batch_first"),
    "Discounted per-step return; call with ``(r,)``. Parity: reference "
    "``TimeDistributedReturn`` (``_rl.py:44-96``).",
)


class MeanVarianceNormalization:
    """Normalize features, optionally with streaming statistics.

    Without stored statistics, normalizes per-utterance over all axes but
    `dim`. :func:`accumulate`/:func:`store` gather sufficient statistics
    across utterances into fixed `mean`/`std` buffers, as in the reference
    (``_feats.py:74-229``).
    """

    def __init__(self, dim: int = -1, mean=None, std=None, eps=None):
        from . import config as _config

        self.dim = dim
        self.mean = None if mean is None else np.asarray(mean)
        self.std = None if std is None else np.asarray(std)
        self.eps = _config.TINY if eps is None else eps
        self.count = self.sum = self.sumsq = None

    def __call__(self, x):
        return F.mean_var_norm(
            x, dim=self.dim, mean=self.mean, std=self.std, eps=self.eps
        )

    def accumulate(self, x) -> None:
        """Accumulate sufficient statistics from a (batch of) feature(s).

        The sums are float64. A tensor on a device is summed there, and
        the sums stay on that device until :func:`store`; anything else is
        summed in numpy on the host. One normalizer takes its inputs from
        one device."""
        on_device = isinstance(x, torch.Tensor) and x.device.type != "cpu"
        if on_device:
            x = x.detach()
        else:
            x = x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        dim = self.dim + x.ndim if self.dim < 0 else self.dim
        axes = tuple(i for i in range(x.ndim) if i != dim)
        count = int(np.prod([x.shape[i] for i in axes])) if axes else 1
        if on_device:
            s = x.sum(axes, dtype=torch.float64) if axes else x.double()
            ss = (x.double() ** 2).sum(axes) if axes else x.double() ** 2
        else:
            s = x.sum(axes, dtype=np.float64)
            ss = (x.astype(np.float64) ** 2).sum(axes)
        if self.count is None:
            self.count, self.sum, self.sumsq = 0, 0, 0
        self.count += count
        self.sum = self.sum + s
        self.sumsq = self.sumsq + ss

    def store(self, delete_stats: bool = True) -> None:
        """Convert accumulated statistics into `mean` and `std` buffers."""
        if not self.count:
            raise RuntimeError("no statistics accumulated")
        if isinstance(self.sum, torch.Tensor):
            self.sum, self.sumsq = self.sum.cpu().numpy(), self.sumsq.cpu().numpy()
        mean = self.sum / self.count
        var = self.sumsq / self.count - mean**2
        self.mean = mean.astype(np.float32)
        self.std = np.sqrt(np.maximum(var, 0)).astype(np.float32)
        if delete_stats:
            self.count = self.sum = self.sumsq = None


# ---- transducer family (beyond reference; see ops/transducer.py) ----

from .ops import transducer as _T  # noqa: E402

TransducerLoss = _wrap(
    "TransducerLoss", _T.transducer_loss, ("reduction",),
    "Negative RNN-T log-likelihood from node log-probabilities; call with "
    "``(blank_lp, emit_lp, logit_lens, ref_lens)``. See "
    ":func:`pydrobert_tpu_torch.ops.transducer.transducer_loss`.",
)
TransducerGreedySearch = _wrap(
    "TransducerGreedySearch", _T.transducer_greedy_search,
    ("pred_step", "joint_fn", "blank_idx", "max_symbols_per_frame"),
    "Batched greedy RNN-T decoding; call with ``(enc, enc_lens, "
    "init_state)``. See "
    ":func:`pydrobert_tpu_torch.ops.transducer.transducer_greedy_search`.",
)
TransducerBeamSearch = _wrap(
    "TransducerBeamSearch", _T.transducer_beam_search,
    (
        "pred_step", "joint_fn", "blank_idx", "width",
        "max_symbols_per_frame", "lm", "lm_weight",
    ),
    "Batched time-synchronous fixed-expansion RNN-T beam search; call with "
    "``(enc, enc_lens, init_state)``. See "
    ":func:`pydrobert_tpu_torch.ops.transducer.transducer_beam_search`.",
)

__all__ += [
    "TransducerBeamSearch",
    "TransducerGreedySearch",
    "TransducerLoss",
]
