"""Experiment-level data module bundling per-partition loaders
(counterpart of :mod:`pydrobert_tpu.datamodule`).

One object holds per-partition (train/val/test/predict) or common loader
parameters and data directories, builds datasets and loaders per stage,
and surfaces corpus facts (vocab size, feature size) read from the outputs
of ``get-torch-spect-data-dir-info`` and
``compute-mvn-stats-for-torch-feat-data-dir``. A training loop calls
:meth:`SpectDataModule.train_dataloader` each epoch with the epoch index,
so a resumed run regenerates the same epoch order. Loaders hand batches to
``device`` (``cuda`` when None).
"""

import dataclasses
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

from .data.dataloaders import SpectDataLoader, SpectDataLoaderParams
from .data.datasets import SpectDataSet
from .data.params import Parameterized, _field

__all__ = [
    "DataModuleParams",
    "SpectDataModule",
    "SpectDataModuleParams",
]

_PARTITIONS = ("train", "val", "test", "predict")


@dataclasses.dataclass
class DataModuleParams(Parameterized):
    """Per-partition or common loader params + data dirs.

    Either `common` is set (shared across partitions) or any of
    `train`/`val`/`test`/`predict` are (``prefer_split`` decides when
    neither is).
    """

    common: Optional[Any] = _field(None)
    train: Optional[Any] = _field(None)
    val: Optional[Any] = _field(None)
    test: Optional[Any] = _field(None)
    predict: Optional[Any] = _field(None)
    train_dir: Optional[str] = _field(None)
    val_dir: Optional[str] = _field(None)
    test_dir: Optional[str] = _field(None)
    predict_dir: Optional[str] = _field(None)
    prefer_split: bool = _field(True)

    pclass = Parameterized  # overridden by subclasses

    @property
    def loader_params_are_split(self) -> bool:
        return any(
            getattr(self, p) is not None for p in _PARTITIONS
        )

    @property
    def loader_params_are_merged(self) -> bool:
        return self.common is not None

    def _check_overlap(self):
        if self.loader_params_are_merged and self.loader_params_are_split:
            raise ValueError(
                "Cannot simultaneously initialize 'common' and any of "
                "'train', 'val', 'test', or 'predict'"
            )

    def _use_split(self) -> bool:
        self._check_overlap()
        if self.loader_params_are_split:
            return True
        if self.loader_params_are_merged:
            return False
        return self.prefer_split

    def params_for(self, partition: str) -> Optional[Any]:
        """The effective loader params for a partition."""
        if partition not in _PARTITIONS:
            raise ValueError(f"unknown partition '{partition}'")
        if self._use_split():
            params = getattr(self, partition)
            if params is None and partition == "predict":
                # like dir_for: predict reuses the test configuration
                params = self.test
            return params
        return self.common

    def dir_for(self, partition: str) -> Optional[str]:
        path = getattr(self, partition + "_dir")
        if path is None and partition == "predict":
            path = self.test_dir
        return path

    def initialize_missing(self, include_predict: bool = False) -> None:
        """Fill unset partition params with fresh `pclass` instances."""
        if self._use_split():
            for p in _PARTITIONS:
                if p == "predict" and not include_predict:
                    continue
                if getattr(self, p) is None:
                    setattr(self, p, self.pclass())
        elif self.common is None:
            self.common = self.pclass()

    @classmethod
    def _nested_class(cls, name: str):
        # partition/common fields hold loader-params objects: file
        # deserialization rebuilds them as cls.pclass instances
        if name in _PARTITIONS or name == "common":
            return cls.pclass
        return None


@dataclasses.dataclass
class SpectDataModuleParams(DataModuleParams):
    """DataModuleParams for SpectDataSets, plus corpus metadata paths."""

    info_path: Optional[str] = _field(None)
    mvn_path: Optional[str] = _field(None)

    pclass = SpectDataLoaderParams


class SpectDataModule:
    """Bundles SpectDataSets/loaders for an experiment's partitions.

    Call :func:`setup` once (reads the info/MVN files, builds datasets),
    then ``*_dataloader(epoch)`` per stage. Properties `vocab_size`,
    `feat_size`, `num_filts`, `max_ref_class`, `max_ali_class` surface the
    info-file facts.
    """

    def __init__(
        self,
        data_params: SpectDataModuleParams,
        batch_first: bool = False,
        sort_batch: bool = False,
        suppress_alis: bool = True,
        tokens_only: bool = True,
        suppress_uttids: Optional[bool] = None,
        shuffle: Optional[bool] = None,
        warn_on_missing: bool = True,
        on_uneven_distributed: str = "raise",
        seed: Optional[int] = None,
        device=None,
        prefetch: int = 0,
    ):
        self.params = data_params
        self.batch_first = batch_first
        self.sort_batch = sort_batch
        self.suppress_alis = suppress_alis
        self.tokens_only = tokens_only
        self.suppress_uttids = suppress_uttids
        self.shuffle = shuffle
        self.warn_on_missing = warn_on_missing
        self.on_uneven_distributed = on_uneven_distributed
        self.seed = seed
        self.device = device
        self.prefetch = prefetch
        self._info_dict: Optional[Dict[str, int]] = None
        self._mvn_mean = self._mvn_std = None
        self._datasets: Dict[str, SpectDataSet] = {}

    # -- info-file facts
    def get_info_dict_value(self, key, default=None):
        return None if self._info_dict is None else self._info_dict.get(
            key, default
        )

    @property
    def max_ref_class(self):
        return self.get_info_dict_value("max_ref_class")

    @property
    def max_ali_class(self):
        return self.get_info_dict_value("max_ali_class")

    @property
    def vocab_size(self):
        mrc = self.max_ref_class
        return None if mrc is None else mrc + 1

    @property
    def num_filts(self):
        return self.get_info_dict_value("num_filts")

    feat_size = num_filts

    @property
    def batch_size(self) -> int:
        return self.params.params_for("train").batch_size

    def construct_dataset(self, partition, path, params) -> SpectDataSet:
        suppress_uttids = self.suppress_uttids
        if suppress_uttids is None:
            suppress_uttids = partition != "predict"
        return SpectDataSet(
            path,
            warn_on_missing=self.warn_on_missing,
            params=params,
            feat_mean=self._mvn_mean,
            feat_std=self._mvn_std,
            suppress_alis=self.suppress_alis,
            tokens_only=self.tokens_only,
            suppress_uttids=suppress_uttids,
        )

    def setup(self, stage: Optional[str] = None) -> None:
        """Read info/MVN metadata and construct the stage's datasets.

        `stage` of ``"fit"`` builds train+val; ``"test"``/``"predict"``
        their own; :obj:`None` builds all with a configured dir.
        """
        if self.params.info_path is not None and self._info_dict is None:
            self._info_dict = {}
            with open(self.params.info_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    key, value = line.split()
                    # -1 marks "absent" (e.g. max_ref_class with no ref/);
                    # dropping it keeps vocab_size/feat_size None
                    if int(value) == -1:
                        continue
                    self._info_dict[key] = int(value)
        if self.params.mvn_path is not None and self._mvn_mean is None:
            with open(self.params.mvn_path, "rb") as f:
                stats = pickle.load(f)
            self._mvn_mean = torch.as_tensor(np.asarray(stats["mean"]))
            self._mvn_std = torch.as_tensor(np.asarray(stats["std"]))
        if stage == "fit":
            partitions = ("train", "val")
        elif stage in ("test", "predict"):
            partitions = (stage,)
        else:
            partitions = _PARTITIONS
        for p in partitions:
            path = self.params.dir_for(p)
            if path is None:
                continue
            params = self.params.params_for(p)
            if params is None:
                params = SpectDataLoaderParams()
            self._datasets[p] = self.construct_dataset(p, path, params)

    def dataset(self, partition: str) -> SpectDataSet:
        return self._datasets[partition]

    def _dataloader(self, partition: str, epoch: int) -> SpectDataLoader:
        params = self.params.params_for(partition)
        if params is None:
            params = SpectDataLoaderParams()
        shuffle = self.shuffle
        if shuffle is None:
            shuffle = partition == "train"
        return SpectDataLoader(
            self._datasets[partition],
            params,
            shuffle=shuffle,
            batch_first=self.batch_first,
            sort_batch=self.sort_batch,
            init_epoch=epoch,
            on_uneven_distributed=self.on_uneven_distributed,
            seed=self.seed,
            device=self.device,
            prefetch=self.prefetch,
        )

    def train_dataloader(self, epoch: int = 0) -> SpectDataLoader:
        """Training loader whose shuffle is deterministic in `epoch`."""
        return self._dataloader("train", epoch)

    def val_dataloader(self, epoch: int = 0) -> SpectDataLoader:
        return self._dataloader("val", epoch)

    def test_dataloader(self, epoch: int = 0) -> SpectDataLoader:
        return self._dataloader("test", epoch)

    def predict_dataloader(self, epoch: int = 0) -> SpectDataLoader:
        return self._dataloader("predict", epoch)

    @classmethod
    def add_argparse_args(cls, parser, include_overloads: bool = True):
        """Add ``--read-data-{ini,yaml,json}`` flags that populate a
        :class:`SpectDataModuleParams` from a config file, plus the usual
        data-dir overloads."""
        grp = parser.add_argument_group("data module")
        grp.add_argument(
            "--read-data-ini", metavar="PATH", default=None,
            help="Path to an ini file of data-module params",
        )
        grp.add_argument(
            "--read-data-yaml", metavar="PATH", default=None,
            help="Path to a yaml file of data-module params",
        )
        grp.add_argument(
            "--read-data-json", metavar="PATH", default=None,
            help="Path to a json file of data-module params",
        )
        if include_overloads:
            for p in _PARTITIONS:
                grp.add_argument(
                    f"--{p}-dir", default=None,
                    help=f"Overrides the params file's {p}_dir",
                )
        return parser

    @classmethod
    def from_argparse_args(cls, namespace, **kwargs) -> "SpectDataModule":
        """Construct the data module from parsed
        :meth:`add_argparse_args` flags (file params + dir overloads);
        extra `kwargs` forward to the constructor."""
        params = None
        for attr in ("read_data_ini", "read_data_yaml", "read_data_json"):
            path = getattr(namespace, attr, None)
            if path is not None:
                if params is not None:
                    raise ValueError(
                        "at most one --read-data-{ini,yaml,json} may be set"
                    )
                params = SpectDataModuleParams.from_file(path)
        if params is None:
            params = SpectDataModuleParams()
        for p in _PARTITIONS:
            override = getattr(namespace, f"{p}_dir", None)
            if override is not None:
                setattr(params, f"{p}_dir", override)
        return cls(params, **kwargs)
