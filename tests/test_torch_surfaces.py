"""The port's public surfaces against the JAX package's: functional,
modules, the deprecated layers/util shims, argcheck and
utils.pytree.broadcast_shapes. Re-exports are the port's own ops; every
argcheck validator accepts and rejects what the JAX package's does and
returns the same value; configured modules equal their functionals."""

import importlib
import sys

import numpy as np
import pytest
import torch

from pydrobert_tpu import argcheck as jarg
from pydrobert_tpu.utils import pytree as jtree
from pydrobert_tpu_torch import argcheck as parg
from pydrobert_tpu_torch import functional as F
from pydrobert_tpu_torch import modules as M
from pydrobert_tpu_torch.utils import pytree as ptree


@pytest.mark.parametrize("name", F.__all__)
def test_functional_reexports_the_ports_ops(name):
    fn = getattr(F, name)
    assert fn.__module__.startswith("pydrobert_tpu_torch.ops."), fn.__module__


def test_configured_modules_equal_their_functionals():
    rng = np.random.RandomState(0)
    ref = torch.from_numpy(rng.randint(0, 5, (6, 3)))
    hyp = torch.from_numpy(rng.randint(0, 5, (7, 3)))
    mod = M.ErrorRate(eos=4, norm=False, warn=False)
    assert mod.eos == 4 and mod.include_eos is False  # set, and the functional's default
    assert torch.equal(mod(ref, hyp), F.error_rate(ref, hyp, eos=4, norm=False, warn=False))
    assert torch.equal(M.EditDistance(warn=False)(ref, hyp), F.edit_distance(ref, hyp, warn=False))
    r = torch.from_numpy(rng.randn(9, 2).astype(np.float32))
    assert torch.equal(M.TimeDistributedReturn(0.9)(r), F.time_distributed_return(r, 0.9))
    x = torch.from_numpy(rng.randn(2, 10, 4).astype(np.float32))
    assert torch.equal(M.FeatureDeltas(order=1)(x), F.feat_deltas(x, order=1))
    with pytest.raises(TypeError):
        M.TimeDistributedReturn(0.9, False, 3)
    with pytest.raises(TypeError):
        M.ErrorRate(bogus=1)
    assert "eos=4" in repr(mod)
    mvn = M.MeanVarianceNormalization()
    mvn.accumulate(x)
    mvn.store()
    torch.testing.assert_close(mvn(x).mean((0, 1)), torch.zeros(4), atol=1e-6, rtol=0)


def test_modules_reexport_the_ports_classes():
    from pydrobert_tpu_torch.ops import decoding, mc

    assert M.CTCForcedAligner is decoding.CTCForcedAligner
    assert M.GumbelOneHotCategoricalRebarControlVariate is mc.GumbelOneHotCategoricalRebarControlVariate
    assert issubclass(M.CTCForcedAligner, torch.nn.Module)


@pytest.mark.parametrize("shim", ["layers", "util"])
def test_deprecated_shims_warn_and_forward(shim):
    sys.modules.pop(f"pydrobert_tpu_torch.{shim}", None)
    with pytest.warns(DeprecationWarning):
        mod = importlib.import_module(f"pydrobert_tpu_torch.{shim}")
    assert mod.minimum_error_rate_loss is F.minimum_error_rate_loss


_VALUES = [0, 3, -2, 0.5, 1.0, -1.5, True, "a", "a b", "", np.int64(4), np.float32(0.25),
           None, np.array([0.2, 0.7]), np.array([-1.0, 2.0])]


@pytest.mark.parametrize("name", [n for n in jarg.__all__ if n.startswith(("is_", "as_"))
                                  and n not in ("is_a", "is_exactly", "is_in", "has_ndim")
                                  and not n.startswith(("is_lt", "is_gt", "is_equal", "is_btw"))
                                  and n not in ("is_dir", "is_file", "as_dir", "as_file",
                                                "as_path_dir", "as_path_file")])
def test_argcheck_single_argument_validators_match_jax(name):
    for val in _VALUES:
        outs = []
        for mod in (jarg, parg):
            try:
                outs.append(("ok", getattr(mod, name)(val, "v")))
            except (TypeError, ValueError) as e:  # both raise the same
                outs.append((type(e).__name__, str(e)))
        (ja, jv), (pa, pv) = outs
        assert ja == pa, (name, val)
        if ja == "ok":
            np.testing.assert_array_equal(np.asarray(pv, dtype=object), np.asarray(jv, dtype=object))
        elif ja == "ValueError":
            assert pv == jv


@pytest.mark.parametrize("name", [n for n in jarg.__all__
                                  if n.startswith(("is_lt", "is_gt", "is_equal"))])
def test_argcheck_comparisons_match_jax(name):
    for val, other in ((1, 1), (2, 1), (0.5, 1), (np.array([1, 2]), 1), (True, 0)):
        res = []
        for mod in (jarg, parg):
            try:
                getattr(mod, name)(val, other, "v")
                res.append(True)
            except ValueError:
                res.append(False)
        assert res[0] == res[1], (name, val, other)
    # a tensor on the port's side compares on the host
    t = torch.tensor([1.0, 2.0])
    assert (parg.is_gtt(t, 0, "t") is t) == True  # noqa: E712


@pytest.mark.parametrize("name", [n for n in jarg.__all__ if n.startswith("is_btw")])
def test_argcheck_between_matches_jax(name):
    for val in (0, 1, 2, 0.5, np.array([0.5, 1.0])):
        res = []
        for mod in (jarg, parg):
            try:
                getattr(mod, name)(val, 0, 1, "v")
                res.append(True)
            except ValueError:
                res.append(False)
        assert res[0] == res[1], (name, val)


def test_argcheck_remaining_checks(tmp_path):
    assert parg.is_a(3, "x", cls=int) == 3
    assert parg.is_in("a", ["a", "b"]) == "a"
    assert parg.is_exactly(None, None) is None
    assert parg.has_ndim(torch.zeros(2, 3), 2).shape == (2, 3)
    assert parg.is_dir(str(tmp_path)) == str(tmp_path)
    assert parg.as_path_dir(tmp_path) == tmp_path
    assert parg.is_int(None, "x", allow_none=True) is None
    for fn, args in ((parg.is_a, (3, "x")), (parg.is_in, ("c", ["a"])), (parg.has_ndim, (torch.zeros(2), 2)),
                     (parg.is_file, (str(tmp_path),)), (parg.is_nonempty, (torch.zeros(0),))):
        kwargs = {"cls": str} if fn is parg.is_a else {}
        with pytest.raises(ValueError):
            fn(*args, **kwargs)


@pytest.mark.parametrize("a,b", [((3, 1), (4,)), ((), (2, 2)), ((1, 5), (7, 1, 1))])
def test_broadcast_shapes_matches_jax(a, b):
    assert ptree.broadcast_shapes(a, b) == tuple(jtree.broadcast_shapes(a, b))
