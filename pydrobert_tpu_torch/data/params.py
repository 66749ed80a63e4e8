"""Dataclass-based hyperparameter objects with optuna hooks (counterpart of
:mod:`pydrobert_tpu.data.params`).

Dataset, loader and training configuration as plain dataclasses, each
exposing ``get_tunable()`` and ``suggest_params(trial, base, only,
prefix)`` for optuna. Field bounds are checked on assignment; ini, yaml and
json files round-trip through :func:`params_to_dict` and
:func:`params_from_dict`, in the same layout as the JAX package's, so a
file written by either package reads in the other. ``yaml`` (and
``optuna``, through the trial) are imported only where they are used.
"""

import dataclasses
import json
import os
from typing import Any, Container, Dict, List, Optional, Set

__all__ = [
    "ContextWindowDataParams",
    "LangDataParams",
    "Parameterized",
    "SpectDataParams",
    "deserialize_params_from_file",
    "params_from_dict",
    "params_to_dict",
    "serialize_params_to_file",
]


@dataclasses.dataclass
class Parameterized:
    """Base for hyperparameter objects: bounds checks + optuna hooks."""

    # per-field metadata: {"bounds": (lo, hi), "softbounds": (lo, hi)}
    def __setattr__(self, name, value):
        fields = {f.name: f for f in dataclasses.fields(self)}
        f = fields.get(name)
        if f is not None and value is not None:
            bounds = f.metadata.get("bounds")
            if bounds is not None:
                lo, hi = bounds
                if lo is not None and value < lo:
                    raise ValueError(f"{name} must be >= {lo}, got {value}")
                if hi is not None and value > hi:
                    raise ValueError(f"{name} must be <= {hi}, got {value}")
        super().__setattr__(name, value)

    @classmethod
    def get_tunable(cls) -> Set[str]:
        """Names of hyperparameters the optuna hook can tune."""
        return set()

    @classmethod
    def suggest_params(cls, trial, base=None, only=None, prefix: str = ""):
        """Populate an instance with values suggested by an optuna trial."""
        params = cls() if base is None else base
        if only is None:
            only = cls.get_tunable()
        cls._suggest(trial, params, only, prefix)
        return params

    @classmethod
    def _suggest(cls, trial, params, only: Container[str], prefix: str):
        pass

    @classmethod
    def _nested_class(cls, name: str):
        """The Parameterized subclass a field holds, or None for plain
        values. Subclasses with object-valued fields override this so file
        deserialization can rebuild the nested objects."""
        return None

    def to_file(self, path: str) -> None:
        """Write this params object to an ini/yaml/json file (by
        extension)."""
        serialize_params_to_file(path, self)

    @classmethod
    def from_file(cls, path: str) -> "Parameterized":
        """Read a params object back from :meth:`to_file` output."""
        return deserialize_params_from_file(path, cls)


def params_to_dict(params: Parameterized) -> Dict[str, Any]:
    """Serialize a params object to a plain dict (ini/yaml-friendly)."""
    return dataclasses.asdict(params)


def params_from_dict(cls, d: Dict[str, Any]) -> Parameterized:
    """Deserialize a params object, validating field names and rebuilding
    nested Parameterized fields (via ``cls._nested_class``)."""
    names = {f.name for f in dataclasses.fields(cls)}
    bad = set(d) - names
    if bad:
        raise ValueError(f"unknown parameters for {cls.__name__}: {sorted(bad)}")
    kwargs = {}
    for name, value in d.items():
        sub = cls._nested_class(name)
        if sub is not None and isinstance(value, dict):
            value = params_from_dict(sub, value)
        kwargs[name] = value
    return cls(**kwargs)


def serialize_params_to_file(path: str, params: Parameterized) -> None:
    """Write a params object to ``path`` as ini, yaml, or json (chosen by
    extension), mirroring the reference's pydrobert-param file glue
    (``_pl_data.py:459-516``). Nested Parameterized fields become nested
    mappings (dotted sections in ini)."""
    d = params_to_dict(params)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".json":
        with open(path, "w") as f:
            json.dump(d, f, indent=1)
    elif ext in (".yaml", ".yml"):
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(d, f, sort_keys=False)
    elif ext == ".ini":
        import configparser

        # interpolation=None: values are json-encoded and may contain '%'
        cp = configparser.ConfigParser(interpolation=None)

        def add(section: str, sub: Dict[str, Any]):
            flat = {}
            for k, v in sub.items():
                if isinstance(v, dict):
                    add(f"{section}.{k}", v)
                else:
                    # JSON-encoded values: lists/None/bools round-trip
                    flat[k] = json.dumps(v)
            cp[section] = flat

        add("params", d)
        with open(path, "w") as f:
            cp.write(f)
    else:
        raise ValueError(f"unknown params file extension: {path!r}")


def deserialize_params_from_file(path: str, cls) -> Parameterized:
    """Read a params object of type `cls` from ini/yaml/json ``path``."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".json":
        with open(path) as f:
            d = json.load(f)
    elif ext in (".yaml", ".yml"):
        import yaml

        with open(path) as f:
            d = yaml.safe_load(f)
    elif ext == ".ini":
        import configparser

        # interpolation=None: values are json-encoded and may contain '%'
        cp = configparser.ConfigParser(interpolation=None)
        if not cp.read(path):
            raise IOError(f"could not read params file {path!r}")
        d: Dict[str, Any] = {}
        for section in cp.sections():
            parts = section.split(".")
            if parts[0] != "params":
                raise ValueError(f"unknown ini section {section!r}")
            node = d
            for p in parts[1:]:
                node = node.setdefault(p, {})
            for k, v in cp[section].items():
                node[k] = json.loads(v)
    else:
        raise ValueError(f"unknown params file extension: {path!r}")
    # None-valued nested sections serialize as None; drop them so defaults
    # apply cleanly, keeping explicit None for plain fields
    return params_from_dict(cls, d)


def _field(default, **metadata):
    if isinstance(default, (list, dict, set)):
        return dataclasses.field(
            default_factory=lambda: type(default)(default), metadata=metadata
        )
    return dataclasses.field(default=default, metadata=metadata)


@dataclasses.dataclass
class LangDataParams(Parameterized):
    """Parameters for :class:`LangDataSet` (reference ``_datasets.py:28-49``)."""

    subset_ids: List[str] = _field([])
    sos: Optional[int] = _field(None)
    eos: Optional[int] = _field(None)


@dataclasses.dataclass
class SpectDataParams(LangDataParams):
    """Parameters for :class:`SpectDataSet` (reference ``_datasets.py:230-265``)."""

    delta_order: int = _field(0, bounds=(0, None), softbounds=(0, 2))
    do_mvn: bool = _field(False)

    @classmethod
    def get_tunable(cls) -> Set[str]:
        return {"delta_order", "do_mvn"}

    @classmethod
    def _suggest(cls, trial, params, only, prefix):
        if "delta_order" in only:
            lo, hi = dataclasses.fields(cls)[-2].metadata["softbounds"]
            params.delta_order = trial.suggest_int(prefix + "delta_order", lo, hi)
        if "do_mvn" in only:
            params.do_mvn = trial.suggest_categorical(
                prefix + "do_mvn", [True, False]
            )


@dataclasses.dataclass
class ContextWindowDataParams(SpectDataParams):
    """Parameters for :class:`ContextWindowDataSet`
    (reference ``_datasets.py:1017-1067``)."""

    context_left: int = _field(4, bounds=(0, None), softbounds=(3, 8))
    context_right: int = _field(4, bounds=(0, None), softbounds=(3, 8))
    reverse: bool = _field(False)

    @classmethod
    def get_tunable(cls) -> Set[str]:
        return super().get_tunable() | {"context_left", "context_right", "reverse"}

    @classmethod
    def _suggest(cls, trial, params, only, prefix):
        SpectDataParams._suggest(trial, params, only, prefix)
        if "context_left" in only:
            params.context_left = trial.suggest_int(prefix + "context_left", 3, 8)
        if "context_right" in only:
            params.context_right = trial.suggest_int(
                prefix + "context_right", 3, 8
            )
        if "reverse" in only:
            params.reverse = trial.suggest_categorical(
                prefix + "reverse", [True, False]
            )
