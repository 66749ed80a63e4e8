"""On-disk SpectDataSet datasets (counterpart of
:mod:`pydrobert_tpu.data.datasets`, except ``SpectTarDataSet``).

The data-directory convention (``feat/``, ``ali/``, ``ref/`` of
per-utterance ``.pt`` tensors) is the JAX package's, and a directory
written by either package reads in the other. Datasets are plain sequence
objects: ``len()``, integer indexing, ``utt_ids``, ``write_pdf`` and
``write_hyp``, validation with optional fixing. Items are CPU tensors;
the loaders move batches to the device. Mean-variance normalization and
deltas go through :mod:`pydrobert_tpu_torch.ops.feats`.
"""

import os
import warnings
from typing import Optional, Set, Tuple, Union

import numpy as np
import torch

from .. import config
from ..ops.feats import feat_deltas, mean_var_norm
from ..utils.serial import load_tensor, save_tensor
from .params import ContextWindowDataParams, LangDataParams, SpectDataParams

__all__ = [
    "ContextWindowDataSet",
    "LangDataSet",
    "SpectDataSet",
    "extract_window",
    "validate_spect_data_set",
]


def _utts_in_dir(dir_: str, file_prefix: str, file_suffix: str) -> Set[str]:
    neg_fsl = -len(file_suffix) or None
    fpl = len(file_prefix)
    return set(
        x[fpl:neg_fsl]
        for x in os.listdir(dir_)
        if x.startswith(file_prefix) and x.endswith(file_suffix)
    )


def _load_ref(
    pth: str, tokens_only: bool, sos: Optional[int], eos: Optional[int]
) -> torch.Tensor:
    """Load a ref tensor, optionally dropping segments and adding sos/eos;
    2-D refs get the marker token with ``(-1, -1)`` segment bounds."""
    return _postprocess_ref(load_tensor(pth), tokens_only, sos, eos)


def _postprocess_ref(
    ref: torch.Tensor, tokens_only: bool, sos: Optional[int], eos: Optional[int]
) -> torch.Tensor:
    D = ref.dim()
    if tokens_only and D == 2:
        ref, D = ref[..., 0].contiguous(), 1
    for tok, first in ((sos, True), (eos, False)):
        if tok is None:
            continue
        sym = torch.full_like(ref[:1], -1 if D == 2 else tok)
        if D == 2:
            sym[0, 0] = tok
        ref = torch.cat([sym, ref] if first else [ref, sym], 0)
    return ref


def _write_hyp(hyp, pth: str, sos: Optional[int], eos: Optional[int]) -> None:
    """Strip sos/eos markers and save as int64."""
    hyp = torch.as_tensor(hyp).detach().cpu().long()
    lead = hyp if hyp.dim() == 1 else hyp[:, 0]
    if sos is not None:
        sos_idxs = torch.nonzero(lead == sos)[:, 0]
        if len(sos_idxs):
            hyp = hyp[int(sos_idxs[-1]) + 1 :]
            lead = hyp if hyp.dim() == 1 else hyp[:, 0]
    if eos is not None:
        eos_idxs = torch.nonzero(lead == eos)[:, 0]
        if len(eos_idxs):
            hyp = hyp[: int(eos_idxs[0])]
    save_tensor(hyp, pth)


class LangDataSet:
    """Token sequences stored one-per-file in a directory.

    Suitable for LM training; `data_dir` points directly at the ref dir.
    Yields CPU tensors.
    """

    def __init__(
        self,
        data_dir: str,
        params: Optional[LangDataParams] = None,
        file_prefix: str = config.DEFT_FILE_PREFIX,
        file_suffix: str = config.DEFT_FILE_SUFFIX,
        suppress_uttids: bool = True,
        tokens_only: bool = True,
    ):
        from .. import argcheck

        self.data_dir = argcheck.is_dir(data_dir, "data_dir")
        self.params = LangDataParams() if params is None else params
        self.file_prefix = argcheck.is_str(file_prefix, "file_prefix")
        self.file_suffix = argcheck.is_str(file_suffix, "file_suffix")
        self.suppress_uttids = suppress_uttids
        self.tokens_only = tokens_only
        self.utt_ids = tuple(
            sorted(self.find_utt_ids(set(self.params.subset_ids)))
        )

    def __len__(self) -> int:
        return len(self.utt_ids)

    def __getitem__(self, idx: int):
        return self.get_utterance_tuple(idx)

    def get_utterance_tuple(self, idx: int):
        utt_id = self.utt_ids[idx]
        ref = _load_ref(
            os.path.join(
                self.data_dir, self.file_prefix + utt_id + self.file_suffix
            ),
            self.tokens_only,
            self.params.sos,
            self.params.eos,
        )
        return ref if self.suppress_uttids else (ref, utt_id)

    def find_utt_ids(self, subset_ids: Set[str] = frozenset()) -> Set[str]:
        """All utterance ids in the data dir (optionally intersected)."""
        utt_ids = _utts_in_dir(self.data_dir, self.file_prefix, self.file_suffix)
        if subset_ids:
            utt_ids &= set(subset_ids)
        return utt_ids

    def write_hyp(self, utt: Union[str, int], hyp, hyp_dir: str) -> None:
        """Write a hypothesis token sequence, stripping sos/eos markers."""
        if isinstance(utt, int):
            utt = self.utt_ids[utt]
        os.makedirs(hyp_dir, exist_ok=True)
        pth = os.path.join(hyp_dir, self.file_prefix + utt + self.file_suffix)
        _write_hyp(hyp, pth, self.params.sos, self.params.eos)



class _FeatTransformMixin:
    """Shared MVN/delta construction + application for feat-yielding
    datasets (a single definition so the two dataset types cannot drift)."""

    def _init_transforms(self, feat_mean, feat_std) -> None:
        self._mvn = bool(self.params.do_mvn)
        self._deltas = bool(self.params.delta_order)
        self._mean = None if feat_mean is None else torch.as_tensor(np.asarray(feat_mean))
        self._std = None if feat_std is None else torch.as_tensor(np.asarray(feat_std))

    def _transform(self, feat: torch.Tensor) -> torch.Tensor:
        if self._mvn:
            feat = mean_var_norm(feat, mean=self._mean, std=self._std)
        if self._deltas:
            feat = feat_deltas(feat, order=self.params.delta_order)
        return feat


class SpectDataSet(_FeatTransformMixin):
    """Spectrographic data directory: ``feat/`` (+ ``ali/``, ``ref/``).

    Per-utterance tensors load as CPU tensors; MVN (with ``feat_mean``
    and ``feat_std`` when given, else each utterance's own statistics) and
    deltas are applied on read when ``params`` asks for them. As in the JAX
    package, ``suppress_alis`` and ``tokens_only`` default to True.
    """

    def __init__(
        self,
        data_dir: str,
        file_prefix: str = config.DEFT_FILE_PREFIX,
        file_suffix: str = config.DEFT_FILE_SUFFIX,
        warn_on_missing: bool = True,
        subset_ids: Optional[Set[str]] = None,
        feat_subdir: str = config.DEFT_FEAT_SUBDIR,
        ali_subdir: Optional[str] = config.DEFT_ALI_SUBDIR,
        ref_subdir: Optional[str] = config.DEFT_REF_SUBDIR,
        params: Optional[SpectDataParams] = None,
        feat_mean=None,
        feat_std=None,
        suppress_alis: bool = True,
        suppress_uttids: bool = True,
        tokens_only: bool = True,
    ):
        from .. import argcheck

        self.data_dir = argcheck.is_dir(data_dir, "data_dir")
        self.file_prefix = file_prefix
        self.file_suffix = file_suffix
        self.feat_subdir, self.ali_subdir = feat_subdir, ali_subdir
        self.ref_subdir = ref_subdir
        self.params = SpectDataParams() if params is None else params
        self.suppress_alis = suppress_alis
        self.suppress_uttids = suppress_uttids
        self.tokens_only = tokens_only
        self.sos, self.eos = self.params.sos, self.params.eos
        # suppressed alis must not drive the utterance intersection nor be
        # loaded-and-discarded per item (reference _datasets.py:469-471)
        if ali_subdir and not suppress_alis:
            self.has_ali = os.path.isdir(os.path.join(data_dir, ali_subdir))
        else:
            self.has_ali = False
        if ref_subdir:
            self.has_ref = os.path.isdir(os.path.join(data_dir, ref_subdir))
        else:
            self.has_ref = False
        if self.has_ali:
            self.has_ali = any(
                x.startswith(file_prefix) and x.endswith(file_suffix)
                for x in os.listdir(os.path.join(data_dir, ali_subdir))
            )
        if self.has_ref:
            self.has_ref = any(
                x.startswith(file_prefix) and x.endswith(file_suffix)
                for x in os.listdir(os.path.join(data_dir, ref_subdir))
            )
        if subset_ids is None:
            subset_ids = set(self.params.subset_ids)
        self.utt_ids = tuple(
            sorted(self.find_utt_ids(warn_on_missing, subset_ids=subset_ids))
        )
        self._init_transforms(feat_mean, feat_std)

    def __len__(self) -> int:
        return len(self.utt_ids)

    def __getitem__(self, idx: int):
        return self.get_utterance_tuple(idx)

    def find_utt_ids(
        self, warn_on_missing: bool, subset_ids: Set[str] = frozenset()
    ) -> Set[str]:
        """Utterance ids present in feat/ (∩ ali/ ∩ ref/ when present)."""
        utt_ids = _utts_in_dir(
            os.path.join(self.data_dir, self.feat_subdir),
            self.file_prefix,
            self.file_suffix,
        )
        if subset_ids:
            utt_ids &= set(subset_ids)
        for has, subdir, name in (
            (self.has_ali, self.ali_subdir, "ali"),
            (self.has_ref, self.ref_subdir, "ref"),
        ):
            if not has:
                continue
            other = _utts_in_dir(
                os.path.join(self.data_dir, subdir),
                self.file_prefix,
                self.file_suffix,
            )
            if subset_ids:
                other &= set(subset_ids)
            if warn_on_missing:
                for utt_id in sorted(utt_ids - other):
                    warnings.warn(f"Missing {name} for uttid: '{utt_id}'")
                for utt_id in sorted(other - utt_ids):
                    warnings.warn(f"Missing feat for uttid: '{utt_id}'")
            utt_ids &= other
        return utt_ids

    def get_utterance_tuple(self, idx: int) -> Tuple:
        utt_id = self.utt_ids[idx]
        feat = load_tensor(
            os.path.join(
                self.data_dir,
                self.feat_subdir,
                self.file_prefix + utt_id + self.file_suffix,
            )
        )
        feat = self._transform(feat)
        ali = None
        if self.has_ali:
            ali = load_tensor(
                os.path.join(
                    self.data_dir,
                    self.ali_subdir,
                    self.file_prefix + utt_id + self.file_suffix,
                )
            )
        ref = None
        if self.has_ref:
            ref = _load_ref(
                os.path.join(
                    self.data_dir,
                    self.ref_subdir,
                    self.file_prefix + utt_id + self.file_suffix,
                ),
                self.tokens_only,
                self.sos,
                self.eos,
            )
        if self.suppress_alis:
            out = (feat, ref)
        else:
            out = (feat, ali, ref)
        return out if self.suppress_uttids else out + (utt_id,)

    def write_pdf(
        self, utt: Union[str, int], pdf, pdfs_dir: Optional[str] = None
    ) -> None:
        """Write a float pdf matrix under ``pdfs/`` (or `pdfs_dir`)."""
        if isinstance(utt, int):
            utt = self.utt_ids[utt]
        if pdfs_dir is None:
            pdfs_dir = os.path.join(self.data_dir, config.DEFT_PDFS_SUBDIR)
        os.makedirs(pdfs_dir, exist_ok=True)
        save_tensor(
            torch.as_tensor(pdf).detach().cpu().float(),
            os.path.join(pdfs_dir, self.file_prefix + utt + self.file_suffix),
        )

    def write_hyp(
        self, utt: Union[str, int], hyp, hyp_dir: Optional[str] = None
    ) -> None:
        """Write hypothesis tokens under ``hyp/`` (or `hyp_dir`), stripping
        sos/eos markers."""
        if isinstance(utt, int):
            utt = self.utt_ids[utt]
        if hyp_dir is None:
            hyp_dir = os.path.join(self.data_dir, config.DEFT_HYP_SUBDIR)
        os.makedirs(hyp_dir, exist_ok=True)
        _write_hyp(
            hyp,
            os.path.join(hyp_dir, self.file_prefix + utt + self.file_suffix),
            self.sos,
            self.eos,
        )


def _load_np(path: str) -> np.ndarray:
    return load_tensor(path).numpy()


def _info_and_validate(
    data_set: SpectDataSet, info: bool, validate: bool, fix: Optional[int]
) -> dict:
    """Walk the dir checking dtypes, dimensions and bounds, optionally
    fixing small faults in place and gathering the statistics of
    ``get-torch-spect-data-dir-info``. The checks run on numpy views of the
    loaded CPU tensors."""

    feat_dtype = None
    ref_ndim = None
    num_filts = -1
    total_frames = 0
    total_tokens = 0 if data_set.has_ref else -1
    counts, segs = {}, {}
    rcounts, rsegs = {}, {}
    max_ali_class = max_ref_class = -1
    fp, fs = data_set.file_prefix, data_set.file_suffix
    for idx in range(len(data_set.utt_ids)):
        utt_id = data_set.utt_ids[idx]
        fn = fp + utt_id + fs
        feat_dir = os.path.join(data_set.data_dir, data_set.feat_subdir)
        feat = _load_np(os.path.join(feat_dir, fn))
        prefix_ = f"'{fn}' (index {idx}) in '{feat_dir}'"
        if validate:
            if not np.issubdtype(feat.dtype, np.floating) or (
                feat_dtype is not None and feat.dtype != feat_dtype
            ):
                raise ValueError(
                    f"{prefix_} is not a float array or not the same float "
                    "type as previous"
                )
            feat_dtype = feat.dtype
            if feat.ndim != 2:
                raise ValueError(f"{prefix_} does not have two dimensions")
            if num_filts >= 0 and feat.shape[1] != num_filts:
                raise ValueError(
                    f"{prefix_} has second dimension of size {feat.shape[1]},"
                    f" which does not match prior utterance size ({num_filts})"
                )
        T, num_filts = feat.shape[0], feat.shape[1]
        total_frames += T
        if data_set.has_ali:
            ali_dir = os.path.join(data_set.data_dir, data_set.ali_subdir)
            ali = _load_np(os.path.join(ali_dir, fn))
            prefix_ = f"'{fn}' (index {idx}) in '{ali_dir}'"
            if validate:
                if ali.dtype != np.int64:
                    msg = f"{prefix_} is not a long array"
                    if fix is not None and np.issubdtype(
                        ali.dtype, np.integer
                    ):
                        warnings.warn(msg + ". Converting")
                        ali = ali.astype(np.int64)
                        save_tensor(ali, os.path.join(ali_dir, fn))
                    else:
                        raise ValueError(msg)
                if ali.ndim != 1:
                    raise ValueError(f"{prefix_} does not have one dimension")
                if ali.shape[0] != T:
                    msg = (
                        f"{prefix_} does not have the same first dimension of"
                        f" size ({ali.shape[0]}) as its companion in '"
                        f"{os.path.join(data_set.data_dir, data_set.feat_subdir)}' ({T})"
                    )
                    if fix is not None and T + fix >= ali.shape[0] > T:
                        warnings.warn(msg + ". Cropping")
                        ali = ali[:T]
                        save_tensor(ali, os.path.join(ali_dir, fn))
                    else:
                        raise ValueError(msg)
            if info and len(ali):
                if ali.min() < 0:
                    raise ValueError("Got a negative ali class idx")
                change = np.nonzero(np.diff(ali))[0]
                starts = np.concatenate([[0], change + 1])
                ends = np.concatenate([change + 1, [len(ali)]])
                for s, e in zip(starts, ends):
                    c = int(ali[s])
                    counts[c] = counts.get(c, 0) + int(e - s)
                    segs[c] = segs.get(c, 0) + 1
                max_ali_class = max(max_ali_class, int(ali.max()))
        if data_set.has_ref:
            ref_dir = os.path.join(data_set.data_dir, data_set.ref_subdir)
            ref = _load_np(os.path.join(ref_dir, fn))
            prefix_ = f"'{fn}' (index {idx}) in '{ref_dir}'"
            if validate:
                if ref.dtype != np.int64:
                    msg = f"{prefix_} is not a long array"
                    if fix is not None and np.issubdtype(
                        ref.dtype, np.integer
                    ):
                        warnings.warn(msg + ". Converting")
                        ref = ref.astype(np.int64)
                        save_tensor(ref, os.path.join(ref_dir, fn))
                    else:
                        raise ValueError(msg)
                if ref_ndim is None:
                    ref_ndim = ref.ndim
                elif ref.ndim != ref_ndim:
                    raise ValueError(
                        f"{prefix_} is {ref.ndim}D. Previous transcriptions "
                        f"were {ref_ndim}D"
                    )
            if ref.ndim == 2:
                if validate and ref.shape[1] != 3:
                    raise ValueError(f"{prefix_} does not have shape (R, 3)")
                fixed = False
                for idx2 in range(ref.shape[0]):
                    tok, start, end = (int(x) for x in ref[idx2])
                    if validate and (start < 0) != (end < 0):
                        msg = (
                            f"{prefix_} has a reference token (index {idx2}) "
                            "with only one of start/end bounds set"
                        )
                        if fix is not None:
                            warnings.warn(msg + ". Removing unpaired boundary")
                            ref[idx2, 1:] = -1
                            fixed = True
                        else:
                            raise ValueError(msg)
                    elif start >= 0:
                        if validate and end > T:
                            msg = (
                                f"{prefix_} has a reference token (index "
                                f"{idx2}) with end bound {end} exceeding "
                                f"number of frames {T}"
                            )
                            if (
                                fix is not None
                                and end - fix <= T
                                and start <= T
                            ):
                                warnings.warn(msg + ". Cropping")
                                ref[idx2, 2] = end = T
                                fixed = True
                            else:
                                raise ValueError(msg)
                        if validate and start > end:
                            raise ValueError(
                                f"{prefix_} has a reference token (index "
                                f"{idx2}) with start bound {start} exceeding "
                                f"end bound {end}"
                            )
                    if tok < 0:
                        raise ValueError(
                            f"Got a negative reference token index '{tok}'"
                        )
                    if info:
                        c = tok
                        max_ref_class = max(max_ref_class, c)
                        rsegs[c] = rsegs.get(c, 0) + 1
                        # zero-length or unset segments poison the count to
                        # -1 ("unknown"), as the reference's end > start >= 0
                        # rule (_datasets.py:881-884)
                        if rcounts.get(c, 0) >= 0 and end > start >= 0:
                            rcounts[c] = rcounts.get(c, 0) + (end - start)
                        else:
                            rcounts[c] = -1
                if fixed:
                    save_tensor(ref, os.path.join(ref_dir, fn))
                total_tokens += ref.shape[0]
            else:
                if validate and ref.ndim != 1:
                    raise ValueError(f"{prefix_} has an invalid shape")
                for tok in ref.reshape(-1):
                    c = int(tok)
                    if c < 0:
                        raise ValueError(
                            f"Got a negative reference token index '{c}'"
                        )
                    max_ref_class = max(max_ref_class, c)
                    rsegs[c] = rsegs.get(c, 0) + 1
                    rcounts[c] = -1
                total_tokens += ref.shape[0]
    out = {
        "num_utterances": len(data_set.utt_ids),
        "num_filts": num_filts if num_filts >= 0 else 0,
        "total_frames": total_frames,
        "total_tokens": total_tokens,
        "max_ali_class": max_ali_class,
        "max_ref_class": max_ref_class,
    }
    if max_ali_class >= 0:
        width = len(str(max_ali_class))
        for c in range(max_ali_class + 1):
            out[f"count_{c:0{width}d}"] = counts.get(c, 0)
            out[f"segs_{c:0{width}d}"] = segs.get(c, 0)
    if max_ref_class >= 0:
        width = len(str(max_ref_class))
        for c in range(max_ref_class + 1):
            out[f"rcount_{c:0{width}d}"] = rcounts.get(c, -1)
            out[f"rsegs_{c:0{width}d}"] = rsegs.get(c, 0)
    return out


def validate_spect_data_set(
    data_set: SpectDataSet, fix: Optional[int] = None
) -> None:
    """Validate a SpectDataSet data directory, optionally fixing small
    issues in place (reference ``_datasets.py:912-968``)."""
    if fix is True or fix is False:
        warnings.warn(
            "boolean fix value is deprecated. Please use an integer or None",
            DeprecationWarning,
        )
        fix = 1 if fix else None
    _info_and_validate(data_set, False, True, fix)


def extract_window(
    feat: torch.Tensor, frame_idx: int, left: int, right: int, reverse: bool = False
) -> torch.Tensor:
    """The edge-padded context window ``(1 + left + right, F)`` around
    frame ``frame_idx`` of ``feat (T, F)``."""
    feat = torch.as_tensor(feat)
    T = feat.shape[0]
    idxs = torch.arange(frame_idx - left, frame_idx + right + 1).clamp(0, T - 1)
    window = feat[idxs]
    if reverse:
        window = window.flip(0)
    return window


class ContextWindowDataSet(SpectDataSet):
    """Pairs of (context window, ali) per frame of a SpectDataSet.

    ``dataset[idx]`` yields ``(windows, ali)`` for utterance `idx`, where
    windows is ``(T, 1 + left + right, F)``.
    """

    def __init__(
        self,
        data_dir: str,
        left: Optional[int] = None,
        right: Optional[int] = None,
        file_prefix: str = config.DEFT_FILE_PREFIX,
        file_suffix: str = config.DEFT_FILE_SUFFIX,
        warn_on_missing: bool = True,
        subset_ids: Optional[Set[str]] = None,
        feat_subdir: str = config.DEFT_FEAT_SUBDIR,
        ali_subdir: Optional[str] = config.DEFT_ALI_SUBDIR,
        reverse: Optional[bool] = None,
        params: Optional[ContextWindowDataParams] = None,
        feat_mean=None,
        feat_std=None,
        suppress_uttids: bool = True,
    ):
        params = ContextWindowDataParams() if params is None else params
        super().__init__(
            data_dir,
            file_prefix=file_prefix,
            file_suffix=file_suffix,
            warn_on_missing=warn_on_missing,
            subset_ids=subset_ids,
            feat_subdir=feat_subdir,
            ali_subdir=ali_subdir,
            ref_subdir=None,
            params=params,
            feat_mean=feat_mean,
            feat_std=feat_std,
            suppress_alis=False,
            suppress_uttids=suppress_uttids,
        )
        self.left = params.context_left if left is None else left
        self.right = params.context_right if right is None else right
        self.reverse = params.reverse if reverse is None else reverse

    def _windowed(self, item: Tuple) -> Tuple:
        feat, ali = item[0], item[1]
        utt_id = item[-1] if not self.suppress_uttids else None
        T = feat.shape[0]
        # every frame's window at once: (T, 1 + left + right) indices
        offs = torch.arange(-self.left, self.right + 1)
        if self.reverse:
            offs = offs.flip(0)
        windows = feat[(torch.arange(T)[:, None] + offs).clamp(0, max(T - 1, 0))]
        if self.suppress_uttids:
            return windows, ali
        return windows, ali, utt_id

    def get_utterance_tuple(self, idx: int) -> Tuple:
        return self._windowed(super().get_utterance_tuple(idx))

