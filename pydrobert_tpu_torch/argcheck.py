"""Argument checks (counterpart of :mod:`pydrobert_tpu.argcheck`, with the
same names, signatures and messages).

Validators return the value on success so they can be used inline::

    width = argcheck.is_posi(width, "width")

``is_tensor``/``as_tensor`` accept anything with a ``shape`` and a
``dtype`` (a :class:`torch.Tensor`, a :class:`numpy.ndarray`); comparisons
against arrays are taken on the host.
"""

import operator as _op
import os
from typing import Any, Optional, Type, TypeVar

import numpy as np

V = TypeVar("V")

__all__ = [
    "as_array", "as_bool", "as_closed01", "as_dir", "as_file", "as_float",
    "as_int", "as_nat", "as_negf", "as_negi", "as_nonnegf", "as_nonnegi",
    "as_nonposf", "as_nonposi", "as_open01", "as_path", "as_path_dir",
    "as_path_file", "as_posf", "as_posi", "as_str", "as_tensor", "has_ndim",
    "is_a", "is_array", "is_bool", "is_btw", "is_btw_closed", "is_btw_closedf",
    "is_btw_closedi", "is_btw_closedt", "is_btw_open", "is_btw_openf",
    "is_btw_openi", "is_btw_opent", "is_btwf", "is_btwi", "is_btwt",
    "is_closed01", "is_closed01f", "is_closed01i", "is_closed01t", "is_dir",
    "is_equal", "is_equalf", "is_equali", "is_equalt", "is_exactly", "is_file",
    "is_float", "is_gt", "is_gte", "is_gtef", "is_gtei", "is_gtet", "is_gtf",
    "is_gti", "is_gtt", "is_in", "is_int", "is_lt", "is_lte", "is_ltef",
    "is_ltei", "is_ltet", "is_ltf", "is_lti", "is_ltt", "is_nat", "is_neg",
    "is_negf", "is_negi", "is_negt", "is_nonempty", "is_nonneg", "is_nonnegf",
    "is_nonnegi", "is_nonnegt", "is_nonpos", "is_nonposf", "is_nonposi",
    "is_nonpost", "is_numlike", "is_open01", "is_open01f", "is_open01i",
    "is_open01t", "is_path", "is_pos", "is_posf", "is_posi", "is_post",
    "is_str", "is_tensor", "is_token",
]


def _nv(name: Optional[str], val: Any) -> str:
    return repr(val) if name is None else f"{name} ({val!r})"


def _is_array(val: Any) -> bool:
    return hasattr(val, "shape") and hasattr(val, "dtype")


def _host(val: Any) -> np.ndarray:
    if hasattr(val, "detach"):  # a torch.Tensor, maybe on the card
        val = val.detach().cpu()
    return np.asarray(val)


def _allow_none(fn):
    def wrapper(val, name=None, allow_none=False, **kwargs):
        if allow_none and val is None:
            return None
        return fn(val, name, **kwargs)

    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


@_allow_none
def is_a(val: V, name: Optional[str] = None, *, cls: Type = object) -> V:
    if not isinstance(val, cls):
        raise ValueError(f"{_nv(name, val)} is not a {cls.__name__}")
    return val


@_allow_none
def is_int(val, name=None):
    """Check that `val` is an integer (Python or numpy, not bool)."""
    if isinstance(val, (bool, np.bool_)) or not isinstance(val, (int, np.integer)):
        raise ValueError(f"{_nv(name, val)} is not an int")
    return int(val)


@_allow_none
def is_float(val, name=None):
    """Check that `val` is a float or int (coerced to float)."""
    if isinstance(val, (bool, np.bool_)) or not isinstance(
        val, (int, float, np.integer, np.floating)
    ):
        raise ValueError(f"{_nv(name, val)} is not a float")
    return float(val)


@_allow_none
def is_bool(val, name=None):
    if not isinstance(val, (bool, np.bool_)):
        raise ValueError(f"{_nv(name, val)} is not a bool")
    return bool(val)


@_allow_none
def is_str(val, name=None):
    if not isinstance(val, str):
        raise ValueError(f"{_nv(name, val)} is not a str")
    return val


@_allow_none
def is_numlike(val, name=None):
    if not (
        isinstance(val, (int, float, np.integer, np.floating)) or _is_array(val)
    ) or isinstance(val, (bool, np.bool_)):
        raise ValueError(f"{_nv(name, val)} is not numeric")
    return val


@_allow_none
def is_array(val, name=None):
    if not _is_array(val):
        raise ValueError(f"{_nv(name, val)} is not an array")
    return val


is_tensor = is_array


@_allow_none
def is_token(val, name=None, empty_okay: bool = False):
    """Check `val` is a string with no whitespace (optionally nonempty)."""
    if not isinstance(val, str) or (not empty_okay and not len(val)):
        raise ValueError(f"{_nv(name, val)} is not a (nonempty) token")
    if any(c.isspace() for c in val):
        raise ValueError(f"{_nv(name, val)} contains whitespace")
    return val


@_allow_none
def is_path(val, name=None):
    if not isinstance(val, (str, os.PathLike)):
        raise ValueError(f"{_nv(name, val)} is not path-like")
    return val


@_allow_none
def is_dir(val, name=None):
    is_path(val, name)
    if not os.path.isdir(val):
        raise ValueError(f"{_nv(name, val)} is not a directory")
    return val


@_allow_none
def is_file(val, name=None):
    is_path(val, name)
    if not os.path.isfile(val):
        raise ValueError(f"{_nv(name, val)} is not a file")
    return val


@_allow_none
def is_exactly(val, other: Any = None, name=None, other_name=None):
    """Check ``val is other`` (reference signature: val, other, name)."""
    if val is not other:
        raise ValueError(f"{_nv(name, val)} is not {_nv(other_name, other)}")
    return val


# reference signature: is_in(val, collection, name)
def _is_in(val, collection=(), name=None, allow_none=False):
    if allow_none and val is None:
        return None
    if val not in collection:
        raise ValueError(f"{_nv(name, val)} is not one of {list(collection)!r}")
    return val


is_in = _is_in


@_allow_none
def is_nonempty(val, name=None):
    if _is_array(val):
        if not int(np.prod(tuple(val.shape))):
            raise ValueError(f"{_nv(name, val)} is empty")
    elif not len(val):
        raise ValueError(f"{_nv(name, val)} is empty")
    return val


def has_ndim(val, ndim: int, name: Optional[str] = None, allow_none: bool = False):
    if allow_none and val is None:
        return None
    is_array(val, name)
    if val.ndim != ndim:
        raise ValueError(f"{_nv(name, val)} does not have {ndim} dimensions")
    return val


def _cmp_all(val, other, op) -> bool:
    if _is_array(val):
        arr = _host(val)
        return bool(np.all(op(arr, other)))
    return bool(op(val, other))



def _mk_cmp(opname, op, caster=None):
    def check(val, other, name=None, allow_none=False):
        if allow_none and val is None:
            return None
        if caster is not None:
            val = caster(val, name)
        if not _cmp_all(val, other, op):
            raise ValueError(f"{_nv(name, val)} is not {opname} {other!r}")
        return val

    return check


is_lt = _mk_cmp("<", _op.lt)
is_lte = _mk_cmp("<=", _op.le)
is_gt = _mk_cmp(">", _op.gt)
is_gte = _mk_cmp(">=", _op.ge)
is_equal = _mk_cmp("==", _op.eq)
is_ltf = _mk_cmp("<", _op.lt, is_float)
is_ltef = _mk_cmp("<=", _op.le, is_float)
is_gtf = _mk_cmp(">", _op.gt, is_float)
is_gtef = _mk_cmp(">=", _op.ge, is_float)
is_equalf = _mk_cmp("==", _op.eq, is_float)
is_lti = _mk_cmp("<", _op.lt, is_int)
is_ltei = _mk_cmp("<=", _op.le, is_int)
is_gti = _mk_cmp(">", _op.gt, is_int)
is_gtei = _mk_cmp(">=", _op.ge, is_int)
is_equali = _mk_cmp("==", _op.eq, is_int)
is_ltt = _mk_cmp("<", _op.lt, is_array)
is_ltet = _mk_cmp("<=", _op.le, is_array)
is_gtt = _mk_cmp(">", _op.gt, is_array)
is_gtet = _mk_cmp(">=", _op.ge, is_array)
is_equalt = _mk_cmp("==", _op.eq, is_array)


def _mk_sign(opname, op, caster=None, bound=0):
    def check(val, name=None, allow_none=False):
        if allow_none and val is None:
            return None
        v = val if caster is None else caster(val, name)
        if not _cmp_all(v, bound, op):
            raise ValueError(f"{_nv(name, val)} is not {opname} {bound}")
        return v

    return check


is_pos = _mk_sign(">", _op.gt)
is_neg = _mk_sign("<", _op.lt)
is_nonneg = _mk_sign(">=", _op.ge)
is_nonpos = _mk_sign("<=", _op.le)
is_posf = _mk_sign(">", _op.gt, is_float)
is_negf = _mk_sign("<", _op.lt, is_float)
is_nonnegf = _mk_sign(">=", _op.ge, is_float)
is_nonposf = _mk_sign("<=", _op.le, is_float)
is_posi = _mk_sign(">", _op.gt, is_int)
is_negi = _mk_sign("<", _op.lt, is_int)
is_nonnegi = _mk_sign(">=", _op.ge, is_int)
is_nonposi = _mk_sign("<=", _op.le, is_int)
is_post = _mk_sign(">", _op.gt, is_array)
is_negt = _mk_sign("<", _op.lt, is_array)
is_nonnegt = _mk_sign(">=", _op.ge, is_array)
is_nonpost = _mk_sign("<=", _op.le, is_array)
is_nat = is_posi


def _mk_btw(left_op, right_op, caster=None, deft_left=None, deft_right=None):
    def check(
        val,
        left=deft_left,
        right=deft_right,
        name=None,
        allow_none=False,
        left_inclusive=None,
        right_inclusive=None,
    ):
        if allow_none and val is None:
            return None
        v = val if caster is None else caster(val, name)
        lop = left_op if left_inclusive is None else (_op.ge if left_inclusive else _op.gt)
        rop = right_op if right_inclusive is None else (_op.le if right_inclusive else _op.lt)
        if not (_cmp_all(v, left, lop) and _cmp_all(v, right, rop)):
            raise ValueError(f"{_nv(name, val)} is not between {left!r} and {right!r}")
        return v

    return check


is_btw = _mk_btw(_op.gt, _op.lt)
is_btw_open = _mk_btw(_op.gt, _op.lt)
is_btw_closed = _mk_btw(_op.ge, _op.le)
is_btwf = _mk_btw(_op.gt, _op.lt, is_float)
is_btwi = _mk_btw(_op.gt, _op.lt, is_int)
is_btwt = _mk_btw(_op.gt, _op.lt, is_array)
is_btw_openf = _mk_btw(_op.gt, _op.lt, is_float)
is_btw_openi = _mk_btw(_op.gt, _op.lt, is_int)
is_btw_opent = _mk_btw(_op.gt, _op.lt, is_array)
is_btw_closedf = _mk_btw(_op.ge, _op.le, is_float)
is_btw_closedi = _mk_btw(_op.ge, _op.le, is_int)
is_btw_closedt = _mk_btw(_op.ge, _op.le, is_array)
def _mk_01(btw):
    # reference signature: (val, name=None, allow_none=False) — name comes
    # SECOND (the btw helpers put bounds first, which mis-bound positional
    # names onto the left bound)
    def check(val, name=None, allow_none=False):
        return btw(val, 0, 1, name=name, allow_none=allow_none)

    return check


is_open01 = _mk_01(_mk_btw(_op.gt, _op.lt))
is_closed01 = _mk_01(_mk_btw(_op.ge, _op.le))
is_open01f = _mk_01(_mk_btw(_op.gt, _op.lt, is_float))
is_closed01f = _mk_01(_mk_btw(_op.ge, _op.le, is_float))
is_open01i = _mk_01(_mk_btw(_op.gt, _op.lt, is_int))
is_closed01i = _mk_01(_mk_btw(_op.ge, _op.le, is_int))
is_open01t = _mk_01(_mk_btw(_op.gt, _op.lt, is_array))
is_closed01t = _mk_01(_mk_btw(_op.ge, _op.le, is_array))


def _mk_as(caster, post=None):
    def coerce(val, name=None, allow_none=False):
        if allow_none and val is None:
            return None
        try:
            v = caster(val)
        except (TypeError, ValueError) as e:
            raise ValueError(f"could not cast {_nv(name, val)}: {e}")
        if post is not None:
            post(v, name)
        return v

    return coerce


as_int = _mk_as(int)
as_float = _mk_as(float)
as_bool = _mk_as(bool)
as_str = _mk_as(str)
as_nat = _mk_as(int, is_pos)
as_posi = _mk_as(int, is_pos)
as_negi = _mk_as(int, is_neg)
as_nonnegi = _mk_as(int, is_nonneg)
as_nonposi = _mk_as(int, is_nonpos)
as_posf = _mk_as(float, is_pos)
as_negf = _mk_as(float, is_neg)
as_nonnegf = _mk_as(float, is_nonneg)
as_nonposf = _mk_as(float, is_nonpos)
as_open01 = _mk_as(float, lambda v, n: is_open01(v, name=n))
as_closed01 = _mk_as(float, lambda v, n: is_closed01(v, name=n))
as_path = _mk_as(str)
as_dir = _mk_as(str, is_dir)
as_file = _mk_as(str, is_file)


def as_path_dir(val, name=None, allow_none=False):
    if allow_none and val is None:
        return None
    import pathlib

    p = pathlib.Path(val)
    is_dir(p, name)
    return p


def as_path_file(val, name=None, allow_none=False):
    if allow_none and val is None:
        return None
    import pathlib

    p = pathlib.Path(val)
    is_file(p, name)
    return p


def as_array(val, name=None, allow_none=False, dtype=None):
    if allow_none and val is None:
        return None
    try:
        return np.asarray(_host(val), dtype=dtype)
    except (TypeError, ValueError) as e:
        raise ValueError(f"could not cast {_nv(name, val)} to array: {e}")


as_tensor = as_array
