"""Epoch-deterministic samplers, bucket batching, collation, loaders
(counterpart of :mod:`pydrobert_tpu.data.dataloaders`).

Samplers regenerate the exact shuffle for any ``(base_seed, epoch)`` pair
with numpy's ``RandomState((base_seed, epoch))``, so epoch orders equal the
JAX package's, and under :mod:`torch.distributed` each process takes the
strided shard ``[rank::world_size]``. Collation pads CPU tensors. A loader
moves each batch to ``device`` (``cuda`` when None): on a card the batch is
collated into pinned host memory and copied with ``non_blocking=True`` on
the consumer's thread, so with ``prefetch > 0`` the host assembles the next
batches on a worker thread while the card computes. Datasets with a
``native_batch_fetch`` have each batch's files read in one threaded pass.
"""

import abc
import dataclasses
import queue
import threading
import warnings
from itertools import islice
from typing import Dict, Hashable, Iterable, Iterator, List, Optional, Sequence, Set, Union

import numpy as np
import torch

from .. import config, default_device
from .datasets import ContextWindowDataSet, LangDataSet, SpectDataSet
from .params import (
    ContextWindowDataParams,
    LangDataParams,
    Parameterized,
    SpectDataParams,
    _field,
)

__all__ = [
    "AbstractEpochSampler",
    "BucketBatchSampler",
    "ContextWindowDataLoader",
    "ContextWindowDataLoaderParams",
    "DataLoaderParams",
    "DynamicLengthDataLoaderParams",
    "EpochRandomSampler",
    "EpochSequentialSampler",
    "LangDataLoader",
    "LangDataLoaderParams",
    "SpectDataLoader",
    "SpectDataLoaderParams",
    "context_window_seq_to_batch",
    "lang_seq_to_batch",
    "spect_seq_to_batch",
]

_ON_UNEVEN = ("raise", "drop", "uneven", "ignore")


def _dist_info():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class AbstractEpochSampler(abc.ABC):
    """Deterministic per-epoch index streams, sharded across processes.

    Each process takes the strided slice ``[rank::world_size]`` of the
    common stream (rank and world size from an initialized
    :mod:`torch.distributed` group). `on_uneven_distributed` is one of
    ``raise``/``drop``/``uneven``/``ignore``.
    """

    def __init__(
        self,
        data_source,
        init_epoch: int = 0,
        on_uneven_distributed: str = "raise",
    ):
        from .. import argcheck

        self.effective_total = self.total = len(data_source)
        self.epoch = argcheck.is_int(init_epoch, "init_epoch")
        on_uneven_distributed = argcheck.is_in(
            on_uneven_distributed, _ON_UNEVEN, "on_uneven_distributed"
        )
        if on_uneven_distributed != "ignore":
            self._rank, self._world_size = _dist_info()
            if self.total % self._world_size:
                if on_uneven_distributed == "raise":
                    raise ValueError(
                        f"dataset length ({self.total}) must be divisible by "
                        f"the distributed world size ({self._world_size}). "
                        "Consult the documentation for on_uneven_distributed"
                    )
                elif on_uneven_distributed == "drop":
                    self.effective_total = self.total - (
                        self.total % self._world_size
                    )
        else:
            self._rank, self._world_size = 0, 1

    def __len__(self) -> int:
        return (
            self.effective_total - self._rank + self._world_size - 1
        ) // self._world_size

    @abc.abstractmethod
    def get_samples_for_epoch_ignoring_distributed(
        self, epoch: int
    ) -> Iterable[int]:
        """The common (all-replica) sample stream for an epoch."""
        ...

    def get_samples_for_epoch(self, epoch: int) -> Iterable[int]:
        """This process's shard of the epoch's sample stream."""
        ret = self.get_samples_for_epoch_ignoring_distributed(epoch)
        return islice(ret, self._rank, self.effective_total, self._world_size)

    def __iter__(self) -> Iterator[int]:
        ret = self.get_samples_for_epoch(self.epoch)
        self.epoch += 1
        return iter(ret)


def _broadcast_int(value: int) -> int:
    """Rank 0's ``value`` on every rank of the :mod:`torch.distributed`
    group (on the card under NCCL, on the CPU otherwise)."""
    dist = torch.distributed
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([value], dtype=torch.int64, device=dev)
    dist.broadcast(t, 0)
    return int(t.item())


class EpochRandomSampler(AbstractEpochSampler):
    """Random order, seeded with ``(base_seed, epoch)``.

    The permutation is ``RandomState((base_seed, epoch)).permutation``,
    the JAX package's. A ``base_seed`` of None draws one from numpy's
    global state; under :mod:`torch.distributed` rank 0's draw is
    broadcast, so every rank permutes alike.
    """

    def __init__(
        self,
        data_source,
        init_epoch: int = 0,
        base_seed: Optional[int] = None,
        on_uneven_distributed: str = "raise",
    ):
        super().__init__(data_source, init_epoch, on_uneven_distributed)
        max_ = np.iinfo(np.int32).max
        if base_seed is None:
            base_seed = int(np.random.randint(max_))
            if _dist_info()[1] > 1:
                # every rank must permute identically or the strided
                # [rank::world] shards overlap or miss samples
                base_seed = _broadcast_int(base_seed)
        elif base_seed > max_:
            raise ValueError(f"base_seed must be <= {max_}")
        self.base_seed = base_seed

    def get_samples_for_epoch_ignoring_distributed(self, epoch: int):
        rs = np.random.RandomState((self.base_seed, epoch))
        return iter(rs.permutation(self.total))


class EpochSequentialSampler(AbstractEpochSampler):
    """In-order samples."""

    def get_samples_for_epoch_ignoring_distributed(self, epoch: int):
        return iter(range(self.total))


class BucketBatchSampler:
    """Batch by bucket, yielding a batch as soon as its bucket fills.

    Incomplete batches come last, ordered by bucket id.
    """

    def __init__(
        self,
        sampler,
        idx2bucket: Dict[int, Hashable],
        bucket2size: Dict[Hashable, int],
        drop_incomplete: bool = False,
    ):
        from .. import argcheck

        self.sampler = sampler
        self.idx2bucket = idx2bucket
        self.bucket2size = bucket2size
        self.drop_incomplete = argcheck.is_bool(
            drop_incomplete, "drop_incomplete"
        )

    def __iter__(self) -> Iterator[List[int]]:
        batches: Dict[Hashable, List[int]] = dict()
        for idx in self.sampler:
            idx = int(idx)
            hash_ = self.idx2bucket[idx]
            batch_size = self.bucket2size[hash_]
            batch = batches.setdefault(hash_, [])
            batch.append(idx)
            if batch_size == len(batch):
                yield batch
                del batches[hash_]
            elif batch_size < len(batch):
                raise RuntimeError(
                    f"batch '{hash_}' has invalid size '{batch_size}'"
                )
        if not self.drop_incomplete:
            for _, batch in sorted(batches.items(), key=lambda x: x[0]):
                yield batch


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DataLoaderParams(Parameterized):
    """Batch size and drop-last."""

    batch_size: int = _field(10, bounds=(1, None), softbounds=(5, 10))
    drop_last: bool = _field(False)

    @classmethod
    def get_tunable(cls) -> Set[str]:
        return {"batch_size"}

    @classmethod
    def _suggest(cls, trial, params, only, prefix):
        if "batch_size" in only:
            params.batch_size = trial.suggest_int(prefix + "batch_size", 5, 10)


@dataclasses.dataclass
class DynamicLengthDataLoaderParams(DataLoaderParams):
    """Adds length bucketing."""

    num_length_buckets: int = _field(1, bounds=(1, None))
    size_batch_by_length: bool = _field(False)


@dataclasses.dataclass
class LangDataLoaderParams(LangDataParams, DynamicLengthDataLoaderParams):
    """Loader + data params for :class:`LangDataLoader`."""


@dataclasses.dataclass
class SpectDataLoaderParams(SpectDataParams, DynamicLengthDataLoaderParams):
    """Loader + data params for :class:`SpectDataLoader`."""

    @classmethod
    def get_tunable(cls) -> Set[str]:
        return SpectDataParams.get_tunable() | DataLoaderParams.get_tunable()

    @classmethod
    def _suggest(cls, trial, params, only, prefix):
        SpectDataParams._suggest(trial, params, only, prefix)
        DataLoaderParams._suggest(trial, params, only, prefix)


@dataclasses.dataclass
class ContextWindowDataLoaderParams(ContextWindowDataParams, DataLoaderParams):
    """Loader + data params for :class:`ContextWindowDataLoader`."""

    @classmethod
    def get_tunable(cls) -> Set[str]:
        return (
            ContextWindowDataParams.get_tunable() | DataLoaderParams.get_tunable()
        )

    @classmethod
    def _suggest(cls, trial, params, only, prefix):
        ContextWindowDataParams._suggest(trial, params, only, prefix)
        DataLoaderParams._suggest(trial, params, only, prefix)


# ---------------------------------------------------------------------------
# collation
# ---------------------------------------------------------------------------


def _pad_stack(
    arrs: Sequence[torch.Tensor],
    value,
    batch_first: bool,
    pad_to: Optional[int] = None,
    pad_to_multiple: int = 1,
    pin_memory: bool = False,
) -> torch.Tensor:
    arrs = [torch.as_tensor(a) for a in arrs]
    N = len(arrs)
    maxlen = max(a.shape[0] for a in arrs)
    if pad_to_multiple > 1:
        maxlen = -(-maxlen // pad_to_multiple) * pad_to_multiple
    if pad_to is not None:
        if maxlen > pad_to:
            raise ValueError(
                f"a sequence of length {max(a.shape[0] for a in arrs)} "
                f"exceeds the fixed padded length {pad_to}"
            )
        maxlen = pad_to
    rest = tuple(arrs[0].shape[1:])
    out = torch.full(
        (N, maxlen) + rest, value, dtype=arrs[0].dtype, pin_memory=pin_memory
    )
    for i, a in enumerate(arrs):
        out[i, : a.shape[0]] = a
    if not batch_first:
        out = out.transpose(0, 1)
    return out


def _sizes(arrs, pin_memory: bool) -> torch.Tensor:
    out = torch.tensor([x.shape[0] for x in arrs], dtype=torch.int64)
    return out.pin_memory() if pin_memory else out


def lang_seq_to_batch(
    seq,
    batch_first: bool = True,
    sort: bool = True,
    has_uttids: bool = False,
    ref_pad_to: Optional[int] = None,
    pad_to_multiple: int = 1,
    pin_memory: bool = False,
):
    """Collate LangDataSet elements: ``(refs, ref_sizes[, uttids])``, refs
    padded with :obj:`config.INDEX_PAD_VALUE`.

    ``pad_to_multiple`` rounds the padded length up to a multiple;
    ``ref_pad_to`` fixes it outright (raising if an element exceeds it).
    With ``pin_memory`` the tensors are allocated in pinned host memory."""
    seq = list(seq)
    if sort and has_uttids:
        seq = sorted(seq, key=lambda x: x[0].shape[0], reverse=True)
    elif sort:
        seq = sorted(seq, key=lambda x: x.shape[0], reverse=True)
    if has_uttids:
        refs, uttids = zip(*seq)
    else:
        refs = seq
    ref_sizes = _sizes(refs, pin_memory)
    refs = _pad_stack(
        refs, config.INDEX_PAD_VALUE, batch_first, ref_pad_to, pad_to_multiple,
        pin_memory,
    )
    if has_uttids:
        return refs, ref_sizes, tuple(uttids)
    return refs, ref_sizes


def spect_seq_to_batch(
    seq,
    batch_first: bool = True,
    sort: bool = True,
    has_alis: bool = True,
    has_uttids: bool = False,
    feat_pad_to: Optional[int] = None,
    ref_pad_to: Optional[int] = None,
    pad_to_multiple: int = 1,
    pin_memory: bool = False,
):
    """Collate SpectDataSet elements: feats zero-padded, alis and refs
    padded with :obj:`config.INDEX_PAD_VALUE`, plus sizes.

    ``pad_to_multiple`` rounds padded lengths (feats and alis, and refs)
    up to a multiple; ``feat_pad_to`` and ``ref_pad_to`` fix them outright
    (raising if an element exceeds them). With ``pin_memory`` the tensors
    are allocated in pinned host memory."""
    seq = list(seq)
    if sort:
        seq = sorted(seq, key=lambda x: x[0].shape[0], reverse=True)
    cols = list(zip(*seq))
    if has_alis:
        if has_uttids:
            feats, alis, refs, uttids = cols
        else:
            feats, alis, refs = cols
        ali_not_none = all(x is not None for x in alis)
    elif has_uttids:
        feats, refs, uttids = cols
        ali_not_none = False
    else:
        feats, refs = cols
        ali_not_none = False
    ref_not_none = all(x is not None for x in refs)
    feat_sizes = _sizes(feats, pin_memory)
    feats = _pad_stack(
        feats, 0, batch_first, feat_pad_to, pad_to_multiple, pin_memory
    )
    alis = (
        _pad_stack(
            alis, config.INDEX_PAD_VALUE, batch_first, feat_pad_to,
            pad_to_multiple, pin_memory,
        )
        if ali_not_none
        else None
    )
    if ref_not_none:
        ref_sizes = _sizes(refs, pin_memory)
        refs = _pad_stack(
            refs, config.INDEX_PAD_VALUE, batch_first, ref_pad_to,
            pad_to_multiple, pin_memory,
        )
    else:
        ref_sizes = refs = None
    if has_alis:
        if has_uttids:
            return feats, alis, refs, feat_sizes, ref_sizes, tuple(uttids)
        return feats, alis, refs, feat_sizes, ref_sizes
    if has_uttids:
        return feats, refs, feat_sizes, ref_sizes, tuple(uttids)
    return feats, refs, feat_sizes, ref_sizes


def context_window_seq_to_batch(
    seq, has_uttids: bool = False, pin_memory: bool = False
):
    """Collate ContextWindowDataSet elements by concatenating frames:
    ``(windows, alis[, window_sizes, uttids])``. With ``pin_memory`` the
    tensors are copied into pinned host memory."""
    seq = list(seq)
    if has_uttids:
        windows, alis, uttids = zip(*seq)
    else:
        windows, alis = zip(*seq)

    def cat(xs):
        out = torch.cat([torch.as_tensor(x) for x in xs], 0)
        return out.pin_memory() if pin_memory else out

    batch_windows = cat(windows)
    batch_alis = None if any(x is None for x in alis) else cat(alis)
    if has_uttids:
        return batch_windows, batch_alis, _sizes(windows, pin_memory), tuple(uttids)
    return batch_windows, batch_alis


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


def _get_bucket_batch_sampler_params(dataset, num_buckets, batch_size, dynamic):
    """Length-bucket boundaries and per-bucket batch sizes (the ``x * y <=
    Y * B`` rule when ``dynamic``)."""
    elem_per_bucket = len(dataset) // num_buckets
    if elem_per_bucket < batch_size:
        warnings.warn(
            f"The number of elements per bucket of the dataset "
            f"({elem_per_bucket}) is less than batch_size ({batch_size}). "
            "Consider decreasing num_length_buckets"
        )
    len_idx = sorted((_first_len(dataset[i]), i) for i in range(len(dataset)))
    len_bounds = [
        len_idx[(n + 1) * elem_per_bucket - 1][0] for n in range(num_buckets)
    ]
    len_bounds[-1] = len_idx[-1][0]
    len_bounds_ = sorted(set(len_bounds))
    if len_bounds_ != len_bounds:
        warnings.warn(
            f"Cannot evenly split dataset into {num_buckets} buckets. "
            f"Decreasing to {len(len_bounds_)}"
        )
        len_bounds = len_bounds_
    num_buckets = len(len_bounds)
    idx2bucket = dict(
        (i, sum(int(l > b) for b in len_bounds)) for (l, i) in len_idx
    )
    if dynamic:
        m = len_bounds[-1] * batch_size
        bucket2size = dict(
            (j, max(1, m // max(1, len_bounds[j]))) for j in range(num_buckets)
        )
    else:
        bucket2size = dict((j, batch_size) for j in range(num_buckets))
    return idx2bucket, bucket2size


def _first_len(elem) -> int:
    x = elem[0] if isinstance(elem, tuple) else elem
    return x.shape[0]


class _BaseDataLoader:
    """Iterates a batch sampler over a dataset, collating each batch and
    moving it to ``device``.

    Single-process loading. A dataset with ``native_batch_fetch`` has each
    batch's files read in one threaded pass of the native reader
    (:mod:`pydrobert_tpu_torch.native`), into fresh buffers a batch; without
    the reader, or for a subclass that overrides item access below the
    class that provides the fetch, items are read one by one. ``reads``
    counts the batches read each way. On a card (``device`` is ``cuda``, the
    default) the collate copies the items into a batch in pinned host memory
    and the consumer copies that with ``non_blocking=True`` on its current
    stream. PyTorch's caching host allocator records that copy on the
    pinned block, and does not hand the block out again until the copy has
    completed, so a batch may be dropped on the host as soon as it is
    copied. With ``prefetch > 0`` a worker thread reads and collates up to
    ``prefetch`` batches ahead; the copies stay on the consumer's thread and
    stream, in order.
    """

    def __init__(self, dataset, batch_sampler, collate_fn, device=None, prefetch=0):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn
        self.device = default_device(device)
        self.pin_memory = self.device.type == "cuda"
        self.prefetch = int(prefetch)
        self.reads = {"native": 0, "per_item": 0}

    @property
    def epoch(self) -> int:
        return self.batch_sampler.sampler.epoch

    @epoch.setter
    def epoch(self, val: int):
        self.batch_sampler.sampler.epoch = val

    def _place(self, batch):
        if self.device.type == "cpu":
            return batch
        return tuple(
            x.to(self.device, non_blocking=True) if isinstance(x, torch.Tensor) else x
            for x in batch
        )

    def _native_fetch(self):
        """The dataset's ``native_batch_fetch``, unless a subclass overrode
        item access below the class that provides the fetch (the fetch
        would bypass the override): then ``None``, and items are read one
        by one."""
        fetch = getattr(self.dataset, "native_batch_fetch", None)
        if fetch is None:
            return None
        cls = type(self.dataset)

        def owner(name):
            for c in cls.__mro__:
                if name in c.__dict__:
                    return c
            return None

        fetch_owner = owner("native_batch_fetch")
        for name in ("__getitem__", "get_utterance_tuple"):
            item_owner = owner(name)
            if (
                item_owner is not None
                and fetch_owner is not None
                and item_owner is not fetch_owner
                and issubclass(item_owner, fetch_owner)
            ):
                return None
        return fetch

    def _iter_host_batches(self):
        fetch = self._native_fetch()
        for batch_idxs in self.batch_sampler:
            items = fetch(batch_idxs) if fetch is not None else None
            if items is None:
                items = [self.dataset[i] for i in batch_idxs]
                self.reads["per_item"] += 1
            else:
                self.reads["native"] += 1
            yield self.collate_fn(items)

    def __iter__(self):
        if self.prefetch <= 0:
            for batch in self._iter_host_batches():
                yield self._place(batch)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        sentinel = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self._iter_host_batches():
                    if not put(batch):
                        return
                put(sentinel)
            except BaseException as e:  # raised again on the consumer's side
                put(e)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield self._place(item)
        finally:
            stop.set()
            thread.join(timeout=5)

    def __len__(self) -> int:
        if isinstance(self.batch_sampler, BucketBatchSampler):
            from collections import Counter

            sampler = self.batch_sampler.sampler
            # counting regenerates the epoch permutation: cache it per epoch
            cached = getattr(self, "_len_cache", None)
            if cached is not None and cached[0] == sampler.epoch:
                return cached[1]
            bucket2count = Counter(
                self.batch_sampler.idx2bucket[int(i)]
                for i in sampler.get_samples_for_epoch(sampler.epoch)
            )
            len_ = 0
            for bucket, count in bucket2count.items():
                size = self.batch_sampler.bucket2size[bucket]
                if self.batch_sampler.drop_incomplete:
                    len_ += count // size
                else:
                    len_ += (count + size - 1) // size
            self._len_cache = (sampler.epoch, len_)
            return len_
        return len(self.batch_sampler)


class _SimpleBatchSampler:
    def __init__(self, sampler, batch_size: int, drop_last: bool):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(int(idx))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _make_batch_sampler(
    dataset, params, shuffle, init_epoch, on_uneven_distributed, seed
):
    kw = {"init_epoch": init_epoch}
    kw["on_uneven_distributed"] = (
        "drop" if params.drop_last else on_uneven_distributed
    )
    if shuffle:
        utt_sampler = EpochRandomSampler(dataset, base_seed=seed, **kw)
    else:
        utt_sampler = EpochSequentialSampler(dataset, **kw)
    num_buckets = getattr(params, "num_length_buckets", 1)
    if num_buckets > 1:
        idx2bucket, bucket2size = _get_bucket_batch_sampler_params(
            dataset,
            num_buckets,
            params.batch_size,
            params.size_batch_by_length,
        )
        return BucketBatchSampler(
            utt_sampler, idx2bucket, bucket2size, params.drop_last
        )
    return _SimpleBatchSampler(utt_sampler, params.batch_size, params.drop_last)


class LangDataLoader(_BaseDataLoader):
    """Batches of padded refs and sizes from a LangDataSet (or a directory
    of one), on ``device`` (``cuda`` when None)."""

    def __init__(
        self,
        data: Union[str, LangDataSet],
        params: Optional[LangDataLoaderParams] = None,
        data_params: Optional[LangDataParams] = None,
        shuffle: bool = True,
        batch_first: bool = True,
        sort_batch: bool = False,
        init_epoch: int = 0,
        on_uneven_distributed: str = "raise",
        seed: Optional[int] = None,
        device=None,
        prefetch: int = 0,
        ref_pad_to: Optional[int] = None,
        pad_to_multiple: int = 1,
        **ds_kwargs,
    ):
        params = LangDataLoaderParams() if params is None else params
        if not isinstance(data, str):  # any dataset-protocol object
            dataset = data
        else:
            dataset = LangDataSet(data, params=data_params or params, **ds_kwargs)
        self.batch_first, self.sort_batch = batch_first, sort_batch

        def collate(seq):
            return lang_seq_to_batch(
                seq, batch_first, sort_batch,
                has_uttids=not dataset.suppress_uttids,
                ref_pad_to=ref_pad_to, pad_to_multiple=pad_to_multiple,
                pin_memory=self.pin_memory,
            )

        super().__init__(
            dataset,
            _make_batch_sampler(
                dataset, params, shuffle, init_epoch, on_uneven_distributed, seed
            ),
            collate,
            device,
            prefetch,
        )


class SpectDataLoader(_BaseDataLoader):
    """Batches of padded feats (and alis, refs) and sizes from a
    SpectDataSet (or a directory of one), on ``device`` (``cuda`` when
    None)."""

    def __init__(
        self,
        data: Union[str, SpectDataSet],
        params: Optional[SpectDataLoaderParams] = None,
        data_params: Optional[SpectDataParams] = None,
        shuffle: bool = True,
        batch_first: bool = True,
        sort_batch: bool = False,
        init_epoch: int = 0,
        on_uneven_distributed: str = "raise",
        seed: Optional[int] = None,
        device=None,
        prefetch: int = 0,
        feat_pad_to: Optional[int] = None,
        ref_pad_to: Optional[int] = None,
        pad_to_multiple: int = 1,
        **ds_kwargs,
    ):
        params = SpectDataLoaderParams() if params is None else params
        if not isinstance(data, str):  # any dataset-protocol object
            dataset = data
        else:
            dataset = SpectDataSet(data, params=data_params or params, **ds_kwargs)
        self.batch_first, self.sort_batch = batch_first, sort_batch

        def collate(seq):
            return spect_seq_to_batch(
                seq,
                batch_first,
                sort_batch,
                has_alis=not dataset.suppress_alis,
                has_uttids=not dataset.suppress_uttids,
                feat_pad_to=feat_pad_to,
                ref_pad_to=ref_pad_to,
                pad_to_multiple=pad_to_multiple,
                pin_memory=self.pin_memory,
            )

        super().__init__(
            dataset,
            _make_batch_sampler(
                dataset, params, shuffle, init_epoch, on_uneven_distributed, seed
            ),
            collate,
            device,
            prefetch,
        )


class ContextWindowDataLoader(_BaseDataLoader):
    """Batches of concatenated context windows and alis from a
    ContextWindowDataSet (or a directory of one), on ``device`` (``cuda``
    when None)."""

    def __init__(
        self,
        data: Union[str, ContextWindowDataSet],
        params: Optional[ContextWindowDataLoaderParams] = None,
        data_params: Optional[ContextWindowDataParams] = None,
        shuffle: bool = True,
        init_epoch: int = 0,
        on_uneven_distributed: str = "raise",
        seed: Optional[int] = None,
        device=None,
        prefetch: int = 0,
        **ds_kwargs,
    ):
        params = ContextWindowDataLoaderParams() if params is None else params
        if not isinstance(data, str):  # any dataset-protocol object
            dataset = data
        else:
            dataset = ContextWindowDataSet(
                data, params=data_params or params, **ds_kwargs
            )

        def collate(seq):
            return context_window_seq_to_batch(
                seq, has_uttids=not dataset.suppress_uttids,
                pin_memory=self.pin_memory,
            )

        super().__init__(
            dataset,
            _make_batch_sampler(
                dataset, params, shuffle, init_epoch, on_uneven_distributed, seed
            ),
            collate,
            device,
            prefetch,
        )
