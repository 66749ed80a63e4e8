"""Epoch-level training state control: checkpointing, early stopping, LR
(counterpart of :mod:`pydrobert_tpu.training`).

The same CSV history as the JAX package's, column for column and
formatted alike (``epoch, es_resume_cd, es_patience_cd, rlr_resume_cd,
rlr_patience_cd, lr, train_met, val_met`` and user entries), the same
early-stopping and reduce-on-plateau countdowns, best and last epoch
queries, and keep-last-and-best checkpoint cleanup. In the PyTorch idiom:

- checkpoints are ``torch.save`` of the model's and optimizer's
  ``state_dict()``, written through a temporary file and ``os.replace``,
  on rank 0 only; loading fills a given model and optimizer in place, with
  ``map_location`` set to the model's device;
- a learning-rate reduction writes ``optimizer.param_groups[*]["lr"]`` in
  place, and the first epoch reads the rate from the optimizer;
- under :mod:`torch.distributed` the metrics are averaged across ranks
  (:func:`pydrobert_tpu_torch.parallel.all_reduce_metrics`).
"""

import dataclasses
import math
import os
import tempfile
import warnings
from collections import OrderedDict
from csv import DictReader, writer
from string import Formatter
from typing import Callable, Optional, Set

import torch

from .data.params import Parameterized, _field

__all__ = ["TrainingStateController", "TrainingStateParams"]


@dataclasses.dataclass
class TrainingStateParams(Parameterized):
    """Hyperparameters of the training state machine."""

    num_epochs: Optional[int] = _field(None, bounds=(1, None), softbounds=(10, 100))
    log10_learning_rate: Optional[float] = _field(None, softbounds=(-10, -2))
    early_stopping_threshold: float = _field(0.0, bounds=(0, None), softbounds=(0, 1.0))
    early_stopping_patience: int = _field(1, bounds=(1, None), softbounds=(1, 30))
    early_stopping_burnin: int = _field(0, bounds=(0, None), softbounds=(0, 10))
    reduce_lr_threshold: float = _field(0.0, bounds=(0, None), softbounds=(0, 1.0))
    reduce_lr_factor: float = _field(0.1, softbounds=(0.1, 0.5))
    reduce_lr_patience: int = _field(1, bounds=(1, None), softbounds=(1, 30))
    reduce_lr_cooldown: int = _field(0, bounds=(0, None), softbounds=(0, 10))
    reduce_lr_log10_epsilon: float = _field(-8, bounds=(None, 0))
    reduce_lr_burnin: int = _field(0, bounds=(0, None), softbounds=(0, 10))
    seed: Optional[int] = _field(None)
    keep_last_and_best_only: bool = _field(True)
    saved_model_fmt: str = _field("model_{epoch:03d}.pt")
    saved_optimizer_fmt: str = _field("optim_{epoch:03d}.pt")

    @classmethod
    def get_tunable(cls) -> Set[str]:
        return {
            "num_epochs",
            "log10_learning_rate",
            "early_stopping_threshold",
            "early_stopping_patience",
            "early_stopping_burnin",
            "reduce_lr_threshold",
            "reduce_lr_factor",
            "reduce_lr_patience",
            "reduce_lr_cooldown",
            "reduce_lr_burnin",
        }

    @classmethod
    def _suggest(cls, trial, params, only, prefix):
        # budget-aware sampling: patience and burnin are bounded by the
        # epoch budget remaining after one another
        if "num_epochs" in only:
            params.num_epochs = trial.suggest_int(prefix + "num_epochs", 10, 100)
        num_epochs = params.num_epochs if params.num_epochs else 100
        if "log10_learning_rate" in only:
            params.log10_learning_rate = trial.suggest_float(
                prefix + "log10_learning_rate", -10, -2
            )
        if "early_stopping_threshold" in only:
            params.early_stopping_threshold = trial.suggest_float(
                prefix + "early_stopping_threshold", 0.0, 1.0
            )
        if params.early_stopping_threshold:
            if "early_stopping_patience" in only:
                params.early_stopping_patience = trial.suggest_int(
                    prefix + "early_stopping_patience",
                    1,
                    max(1, min(30, num_epochs)),
                )
            if "early_stopping_burnin" in only:
                params.early_stopping_burnin = trial.suggest_int(
                    prefix + "early_stopping_burnin",
                    0,
                    max(0, min(10, num_epochs - params.early_stopping_patience)),
                )
        if "reduce_lr_threshold" in only:
            params.reduce_lr_threshold = trial.suggest_float(
                prefix + "reduce_lr_threshold", 0.0, 1.0
            )
        if params.reduce_lr_threshold:
            if "reduce_lr_factor" in only:
                params.reduce_lr_factor = trial.suggest_float(
                    prefix + "reduce_lr_factor", 0.1, 0.5
                )
            if "reduce_lr_patience" in only:
                params.reduce_lr_patience = trial.suggest_int(
                    prefix + "reduce_lr_patience", 1, max(1, min(30, num_epochs))
                )
            if "reduce_lr_cooldown" in only:
                params.reduce_lr_cooldown = trial.suggest_int(
                    prefix + "reduce_lr_cooldown", 0, 10
                )
            if "reduce_lr_burnin" in only:
                params.reduce_lr_burnin = trial.suggest_int(
                    prefix + "reduce_lr_burnin",
                    0,
                    max(0, min(10, num_epochs - params.reduce_lr_patience)),
                )


def _set_lr(optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def _model_device(model) -> torch.device:
    return next(model.parameters(), torch.empty(0)).device


class TrainingStateController:
    """Epoch-level experiment state machine.

    Typical usage::

        controller = TrainingStateController(params, "hist.csv", "states")
        controller.load_model_and_optimizer_for_epoch(model, optimizer)
        for epoch in range(controller.get_last_epoch() + 1, max_epochs + 1):
            ...  # train an epoch, compute train_met and val_met
            if not controller.update_for_epoch(
                model, optimizer, train_met, val_met
            ):
                break

    ``init_fn(model, optimizer, seed)``, when given, re-initializes both in
    place for epoch 0 (``optimizer`` is None when only the model loads);
    without it a model's ``reset_parameters()`` is called after seeding
    the default generators with ``params.seed``, and the optimizer's state
    is cleared.
    """

    SCIENTIFIC_PRECISION = 5

    def __init__(
        self,
        params: TrainingStateParams,
        state_csv_path: Optional[str] = None,
        state_dir: Optional[str] = None,
        warn: bool = True,
        reduce_op: Optional[str] = None,
        init_fn: Optional[Callable] = None,
    ):
        self.params = params
        if warn:
            for s in (params.saved_model_fmt, params.saved_optimizer_fmt):
                if not any(x[1] == "epoch" for x in Formatter().parse(s)):
                    warnings.warn(
                        f'State format string "{s}" does not contain "epoch" '
                        "field, so is possibly not unique. In this case, only "
                        "the state of the last epoch will persist. To "
                        "suppress this warning, set warn=False"
                    )
        self.state_csv_path = state_csv_path
        self.state_dir = state_dir
        self.cache_hist = dict()
        self.user_entry_types = OrderedDict()
        self.fmt_dict = dict()
        self.reduce_op = reduce_op
        self.init_fn = init_fn
        if params.num_epochs is None:
            self.fmt_dict["epoch"] = "{:010d}"
        else:
            self.fmt_dict["epoch"] = "{{:0{}d}}".format(
                int(math.log10(params.num_epochs)) + 1
            )
        self.fmt_dict["es_resume_cd"] = "{{:0{}d}}".format(
            int(math.log10(max(params.early_stopping_burnin, 1))) + 1
        )
        self.fmt_dict["es_patience_cd"] = "{{:0{}d}}".format(
            int(math.log10(max(params.early_stopping_patience, 1))) + 1
        )
        self.fmt_dict["rlr_resume_cd"] = "{{:0{}d}}".format(
            int(
                math.log10(
                    max(params.reduce_lr_cooldown, params.reduce_lr_burnin, 1)
                )
            )
            + 1
        )
        self.fmt_dict["rlr_patience_cd"] = "{{:0{}d}}".format(
            int(math.log10(max(params.reduce_lr_patience, 1))) + 1
        )
        self.fmt_dict["lr"] = "{{:.{}e}}".format(self.SCIENTIFIC_PRECISION - 1)
        self.fmt_dict["train_met"] = self.fmt_dict["lr"]
        self.fmt_dict["val_met"] = self.fmt_dict["lr"]
        dist = torch.distributed
        multi = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
        self._rank = dist.get_rank() if multi else -1
        self.reduced_entries = {"train_met", "val_met"}
        self.update_cache()

    def _barrier(self) -> None:
        if self._rank >= 0:
            torch.distributed.barrier()

    def update_cache(self) -> None:
        """(Re)read the history CSV into the in-memory cache."""
        self.cache_hist[0] = {
            "epoch": 0,
            "es_resume_cd": self.params.early_stopping_burnin,
            "es_patience_cd": self.params.early_stopping_patience,
            "rlr_resume_cd": self.params.reduce_lr_burnin,
            "rlr_patience_cd": self.params.reduce_lr_patience,
            "train_met": float("inf"),
            "val_met": float("inf"),
            "lr": None,
        }
        self.cache_hist[0].update(
            (key, None) for key in self.user_entry_types
        )
        if self.params.log10_learning_rate is not None:
            self.cache_hist[0]["lr"] = 10**self.params.log10_learning_rate
        if self.state_csv_path is None:
            return
        self._barrier()
        if not os.path.exists(self.state_csv_path):
            self._barrier()
            return
        with open(self.state_csv_path) as f:
            reader = DictReader(f)
            for row in reader:
                epoch = int(row["epoch"])
                self.cache_hist[epoch] = {
                    "epoch": epoch,
                    "es_resume_cd": int(row["es_resume_cd"]),
                    "es_patience_cd": int(row["es_patience_cd"]),
                    "rlr_resume_cd": int(row["rlr_resume_cd"]),
                    "rlr_patience_cd": int(row["rlr_patience_cd"]),
                    "lr": float(row["lr"]),
                    "train_met": float(row["train_met"]),
                    "val_met": float(row["val_met"]),
                }
                for name, type_ in self.user_entry_types.items():
                    self.cache_hist[epoch][name] = type_(row[name])
        self._barrier()

    def add_entry(
        self, name: str, typ: type = str, fmt: str = "{}", reduce: bool = False
    ) -> None:
        """Register a user-defined per-epoch history column. Must be
        called before the first :func:`update_for_epoch`."""
        if name in {
            "epoch",
            "es_resume_cd",
            "es_patience_cd",
            "rlr_resume_cd",
            "rlr_patience_cd",
            "lr",
            "train_met",
            "val_met",
        }:
            raise ValueError(f'"{name}" is a reserved entry name')
        if not isinstance(typ, type):
            raise ValueError(f"typ ({typ}) must be a type")
        self.user_entry_types[name] = typ
        self.fmt_dict[name] = fmt
        if reduce:
            self.reduced_entries.add(name)
        self.update_cache()

    def get_last_epoch(self) -> int:
        return max(self.cache_hist)

    def get_best_epoch(self, train_met: bool = False) -> int:
        """Epoch with the lowest recorded validation (or training) metric;
        ties go to the earlier epoch."""
        ent = "train_met" if train_met else "val_met"
        fmt = self.fmt_dict[ent]
        min_epoch = 0
        min_met = float(fmt.format(self.cache_hist[0][ent]))
        for info in self.cache_hist.values():
            cur = float(fmt.format(info[ent]))
            if cur < min_met:
                min_epoch = info["epoch"]
                min_met = cur
        return min_epoch

    def get_info(self, epoch: int, *default) -> dict:
        return self.cache_hist.get(epoch, *default)

    def __getitem__(self, epoch: int) -> dict:
        return self.get_info(epoch)

    def get_model_path_with_info(self, info: dict) -> str:
        return os.path.join(
            self.state_dir, self.params.saved_model_fmt.format(**info)
        )

    def get_optimizer_path_with_info(self, info: dict) -> str:
        return os.path.join(
            self.state_dir, self.params.saved_optimizer_fmt.format(**info)
        )

    def _reinit(self, model, optimizer) -> None:
        """Re-initialize for epoch 0: ``init_fn`` or the defaults."""
        if self.init_fn is not None:
            self.init_fn(model, optimizer, self.params.seed)
            return
        if self.params.seed is not None:
            torch.manual_seed(self.params.seed)
        if hasattr(model, "reset_parameters"):
            model.reset_parameters()
        else:
            warnings.warn(
                "model has no reset_parameters() and no init_fn was given, so "
                "cannot re-initialize its parameters for epoch 0"
            )
        if optimizer is not None:
            optimizer.state.clear()

    def load_model_for_epoch(
        self, model, epoch: Optional[int] = None, strict: bool = True
    ) -> None:
        """Load the model's ``state_dict`` for `epoch` in place (the best
        epoch when unset; re-initialized when 0), mapped to the model's
        device."""
        self._barrier()
        if epoch is None:
            epoch = self.get_best_epoch()
        if not epoch:
            self._reinit(model, None)
        elif self.state_dir is not None:
            pth = self.get_model_path_with_info(self.get_info(epoch))
            state = torch.load(pth, map_location=_model_device(model), weights_only=True)
            model.load_state_dict(state, strict=strict)
        else:
            warnings.warn(
                f"Unable to load model for epoch {epoch}. No state directory!"
            )
        self._barrier()

    def load_model_and_optimizer_for_epoch(
        self, model, optimizer, epoch: Optional[int] = None, strict: bool = True
    ) -> None:
        """Load the model's and optimizer's ``state_dict``s for `epoch` in
        place (the last epoch when unset; re-initialized when 0, with the
        learning rate set to ``10**log10_learning_rate`` when given)."""
        self._barrier()
        if epoch is None:
            epoch = self.get_last_epoch()
        if not epoch:
            self._reinit(model, optimizer)
            if self.params.log10_learning_rate is not None:
                _set_lr(optimizer, 10**self.params.log10_learning_rate)
        elif self.state_dir is not None:
            info = self.get_info(epoch)
            dev = _model_device(model)
            model.load_state_dict(
                torch.load(self.get_model_path_with_info(info), map_location=dev, weights_only=True),
                strict=strict,
            )
            optimizer.load_state_dict(
                torch.load(self.get_optimizer_path_with_info(info), map_location=dev, weights_only=True)
            )
        else:
            warnings.warn(
                f"Unable to load model and optimizer for epoch {epoch}. "
                "No state directory!"
            )
        self._barrier()

    def delete_model_and_optimizer_for_epoch(self, epoch: int) -> None:
        if self.state_dir is None:
            return
        info = self.get_info(epoch, None)
        if info is None:
            return
        self._clean_up_files(
            self.get_model_path_with_info(info),
            self.get_optimizer_path_with_info(info),
        )

    def _clean_up_files(self, *paths) -> None:
        if self._rank <= 0:
            for path in paths:
                try:
                    os.remove(path)
                except OSError:
                    pass

    def save_model_and_optimizer_with_info(
        self, model, optimizer, info: dict
    ) -> None:
        """Save both ``state_dict``s atomically (a temporary file, then
        ``os.replace``), on rank 0 only."""
        if self.state_dir is None:
            return
        if self._rank <= 0:
            write_pairs = (
                (model.state_dict(), self.get_model_path_with_info(info)),
                (optimizer.state_dict(), self.get_optimizer_path_with_info(info)),
            )
            replaces = []
            for obj, path in write_pairs:
                dir_ = os.path.dirname(path)
                os.makedirs(dir_, exist_ok=True)
                with tempfile.NamedTemporaryFile(
                    "wb", dir=dir_, delete=False
                ) as f:
                    torch.save(obj, f)
                    replaces.append((f.name, path))
            for src, dst in replaces:
                os.replace(src, dst)

    def save_info_to_hist(self, info: dict) -> None:
        """Append an epoch row to the CSV history (rank 0 only)."""
        self.cache_hist[info["epoch"]] = info
        if self.state_csv_path is None:
            return
        if self._rank <= 0:
            names = [
                "epoch",
                "es_resume_cd",
                "es_patience_cd",
                "rlr_resume_cd",
                "rlr_patience_cd",
                "lr",
                "train_met",
                "val_met",
            ]
            names += list(self.user_entry_types)
            write_header = not os.path.exists(self.state_csv_path)
            with open(self.state_csv_path, "a") as f:
                wr = writer(f)
                if write_header:
                    wr.writerow(names)
                wr.writerow([self.fmt_dict[k].format(info[k]) for k in names])

    def continue_training(self, epoch: Optional[int] = None) -> bool:
        """Whether training should continue after `epoch` (last if unset)."""
        if epoch is None:
            epoch = self.get_last_epoch()
        info = self.get_info(epoch)
        if not self.params.num_epochs:
            cont = True
        else:
            cont = epoch < self.params.num_epochs
        if self.params.early_stopping_threshold and not info["es_patience_cd"]:
            cont = False
        return cont

    def update_for_epoch(
        self,
        model,
        optimizer,
        train_met: float,
        val_met: float,
        epoch: Optional[int] = None,
        best_is_train: bool = False,
        **kwargs,
    ) -> bool:
        """Update the history and countdowns after an epoch, checkpoint,
        and return whether to continue. A reduction of the learning rate
        writes every ``optimizer.param_groups[*]["lr"]``."""
        if self._rank >= 0:
            from .parallel import all_reduce_metrics

            kwargs["train_met"] = float(train_met)
            kwargs["val_met"] = float(val_met)
            reduced = {
                k: float(kwargs[k]) for k in sorted(self.reduced_entries)
            }
            reduced = all_reduce_metrics(reduced, self.reduce_op or "mean")
            kwargs.update(reduced)
            train_met = kwargs.pop("train_met")
            val_met = kwargs.pop("val_met")
        train_met, val_met = float(train_met), float(val_met)
        if epoch is None:
            epoch = self.get_last_epoch() + 1
        last_best = self.get_best_epoch(best_is_train)
        if not self.params.num_epochs:
            cont = True
        else:
            cont = epoch < self.params.num_epochs
            if epoch > self.params.num_epochs:
                warnings.warn(
                    "Training is continuing, despite passing num_epochs"
                )
        info = self.get_info(epoch - 1, None)
        if info is None:
            raise ValueError(
                f"no entry for the previous epoch {epoch}, so unable to update"
            )
        info = dict(info)
        for key, value in kwargs.items():
            if key not in self.user_entry_types:
                raise TypeError(
                    "update_for_epoch() got an unexpected keyword argument "
                    f"'{key}' (did you forget to add_entry()?)"
                )
            elif not isinstance(value, self.user_entry_types[key]):
                raise ValueError(
                    f'keyword argument "{key}" value is not of type '
                    f"{self.user_entry_types[key]}"
                )
            info[key] = value
        remaining = set(self.user_entry_types) - set(kwargs)
        if remaining:
            raise TypeError(
                "The following keyword arguments were not provided as keyword"
                " arguments but were specified via add_entry(): "
                f"{sorted(remaining)}"
            )
        if info["lr"] is None:
            # only before the first epoch: the rate the optimizer starts at
            info["lr"] = float(optimizer.param_groups[0]["lr"])
        es_epoch = (
            epoch
            - self.params.early_stopping_patience
            + info["es_patience_cd"]
            - 1
        )
        es_info = self.get_info(es_epoch)
        if info["es_resume_cd"]:
            info["es_resume_cd"] -= 1
        elif (
            max(es_info["val_met"] - val_met, 0)
            < self.params.early_stopping_threshold
        ):
            info["es_patience_cd"] -= 1
            if info["es_patience_cd"] < 0:
                warnings.warn(
                    "Early stopping criterion was already met, but training "
                    "has continued"
                )
                info["es_patience_cd"] = 0
        else:
            info["es_patience_cd"] = self.params.early_stopping_patience
        if self.params.early_stopping_threshold and not info["es_patience_cd"]:
            cont = False
        rlr_epoch = (
            epoch - self.params.reduce_lr_patience + info["rlr_patience_cd"] - 1
        )
        rlr_info = self.get_info(rlr_epoch)
        if info["rlr_resume_cd"]:
            info["rlr_resume_cd"] -= 1
        elif (
            max(rlr_info["val_met"] - val_met, 0)
            < self.params.reduce_lr_threshold
        ):
            info["rlr_patience_cd"] -= 1
            if not info["rlr_patience_cd"]:
                old_lr = info["lr"]
                new_lr = old_lr * self.params.reduce_lr_factor
                rlr_epsilon = 10**self.params.reduce_lr_log10_epsilon
                if old_lr - new_lr > rlr_epsilon:
                    info["lr"] = new_lr
                    _set_lr(optimizer, new_lr)
                info["rlr_resume_cd"] = self.params.reduce_lr_cooldown
                info["rlr_patience_cd"] = self.params.reduce_lr_patience
        else:
            info["rlr_patience_cd"] = self.params.reduce_lr_patience
        info["epoch"] = epoch
        info["val_met"] = val_met
        info["train_met"] = train_met
        if self.state_dir is not None:
            model_pth = self.get_model_path_with_info(info)
            optim_pth = self.get_optimizer_path_with_info(info)
            wrote_info_warn = (
                f"Saving epoch {epoch} model and optimizer failed but write "
                f"to '{self.state_csv_path}' succeeded. You should delete "
                "that entry."
            )
            if self.params.keep_last_and_best_only:
                self.cache_hist[epoch] = info
                cur_best = self.get_best_epoch(best_is_train)
                if cur_best != epoch:
                    best_info = self.get_info(cur_best)
                    if model_pth == self.get_model_path_with_info(best_info):
                        raise ValueError(
                            f"New model checkpoint '{model_pth}' would "
                            "overwrite best model checkpoint, so we raised "
                            "instead. Either change the model format string "
                            "or set keep_last_and_best_only to False"
                        )
                    if optim_pth == self.get_optimizer_path_with_info(
                        best_info
                    ):
                        raise ValueError(
                            f"New optimizer checkpoint '{optim_pth}' would "
                            "overwrite best optimizer checkpoint, so we "
                            "raised instead. Either change the optimizer "
                            "format string or set keep_last_and_best_only to "
                            "False"
                        )
                if cur_best == epoch - 1:
                    self.save_model_and_optimizer_with_info(
                        model, optimizer, info
                    )
                    self.save_info_to_hist(info)
                else:
                    last_info = self.get_info(epoch - 1)
                    last_paths = {
                        self.get_model_path_with_info(last_info),
                        self.get_optimizer_path_with_info(last_info),
                    }
                    last_best_info = self.get_info(last_best)
                    last_best_paths = {
                        self.get_model_path_with_info(last_best_info),
                        self.get_optimizer_path_with_info(last_best_info),
                    }
                    save_info_first = {model_pth, optim_pth} & (
                        last_paths | last_best_paths
                    )
                    if save_info_first:
                        self.save_info_to_hist(info)
                    try:
                        self.save_model_and_optimizer_with_info(
                            model, optimizer, info
                        )
                    except Exception:
                        if (
                            self._rank <= 0
                            and save_info_first
                            and self.state_csv_path
                        ):
                            warnings.warn(wrote_info_warn)
                        raise
                    if not save_info_first:
                        self.save_info_to_hist(info)
                    clean_up = set(last_paths)
                    if last_best != cur_best:
                        clean_up |= last_best_paths
                    clean_up -= {model_pth, optim_pth}
                    self._clean_up_files(*clean_up)
            else:
                save_info_first = os.path.exists(model_pth) or os.path.exists(
                    optim_pth
                )
                if save_info_first:
                    self.save_info_to_hist(info)
                try:
                    self.save_model_and_optimizer_with_info(
                        model, optimizer, info
                    )
                except Exception:
                    if (
                        self._rank <= 0
                        and save_info_first
                        and self.state_csv_path
                    ):
                        warnings.warn(wrote_info_warn)
                    raise
                if not save_info_first:
                    self.save_info_to_hist(info)
        else:
            self.save_info_to_hist(info)
        return cont
