"""Argument checks (the subset of :mod:`pydrobert_tpu.argcheck` the port
uses), with the same messages."""

from typing import Any, Optional

import numpy as np

__all__ = ["is_bool", "is_float", "is_int", "is_posi", "is_str"]


def _nv(name: Optional[str], val: Any) -> str:
    return repr(val) if name is None else f"{name} ({val!r})"


def is_int(val, name=None):
    """Check that `val` is an integer (Python or numpy, not bool)."""
    if isinstance(val, (bool, np.bool_)) or not isinstance(
        val, (int, np.integer)
    ):
        raise ValueError(f"{_nv(name, val)} is not an int")
    return int(val)


def is_float(val, name=None):
    """Check that `val` is a float or int (coerced to float)."""
    if isinstance(val, (bool, np.bool_)) or not isinstance(
        val, (int, float, np.integer, np.floating)
    ):
        raise ValueError(f"{_nv(name, val)} is not a float")
    return float(val)


def is_bool(val, name=None):
    if not isinstance(val, (bool, np.bool_)):
        raise ValueError(f"{_nv(name, val)} is not a bool")
    return bool(val)


def is_str(val, name=None):
    if not isinstance(val, str):
        raise ValueError(f"{_nv(name, val)} is not a str")
    return val


def is_posi(val, name=None):
    """Check that `val` is a positive integer."""
    v = is_int(val, name)
    if not v > 0:
        raise ValueError(f"{_nv(name, val)} is not > 0")
    return v
