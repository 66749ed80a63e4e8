"""The port's edit distances and error rates (pydrobert_tpu_torch.ops.string)
against the JAX package's, and the plain version of the edit-distance
kernel against the Pallas kernel in interpret mode. Distances are small
integers or sums of the costs, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydrobert_tpu.ops import string as jstr
from pydrobert_tpu.ops.pallas import edit_distance_kernel
from pydrobert_tpu_torch.ops import kernels
from pydrobert_tpu_torch.ops import string as pstr

SHAPES = [(11, 13, 50), (40, 3, 200), (1, 1, 1)]  # (R, H, N), as test_pallas.py
COSTS = [(1.0, 1.0, 1.0), (3.0, 3.0, 4.0)]


def _tokens(seed, R, H, N, V=5):
    rng = np.random.RandomState(seed)
    return rng.randint(0, V, (R, N)).astype(np.int32), rng.randint(
        0, V, (H, N)
    ).astype(np.int32)


def _same(got, exp):
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


@pytest.mark.parametrize("costs", COSTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_edit_distance_matches_jax(costs, shape):
    ref, hyp = _tokens(sum(shape), *shape)
    ins, dl, sub = costs
    kw = dict(ins_cost=ins, del_cost=dl, sub_cost=sub)
    for norm in (False, True):
        exp = jstr.edit_distance(ref, hyp, norm=norm, **kw)
        got = pstr.edit_distance(torch.from_numpy(ref), torch.from_numpy(hyp), norm=norm, **kw)
        assert got.dtype == torch.float32
        _same(got, exp)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_error_rate_matches_jax(shape, scale):
    """Uniform costs, any scale: the mistake count, normalized or not."""
    ref, hyp = _tokens(sum(shape) + 1, *shape)
    kw = dict(ins_cost=scale, del_cost=scale, sub_cost=scale)
    for norm in (False, True):
        exp = jstr.error_rate(ref, hyp, norm=norm, **kw)
        got = pstr.error_rate(torch.from_numpy(ref), torch.from_numpy(hyp), norm=norm, **kw)
        _same(got, exp)


@pytest.mark.parametrize("include_eos", [False, True])
@pytest.mark.parametrize("batch_first", [False, True])
@pytest.mark.parametrize("norm", [False, True])
def test_eos_and_layout_match_jax(include_eos, batch_first, norm):
    """eos cuts each sequence (some have none, some start with it),
    include_eos counts it, batch_first transposes."""
    R, H, N, eos = 12, 15, 30, 4
    ref, hyp = _tokens(7, R, H, N)
    ref[0, 0] = hyp[0, 1] = eos  # empty reference and hypothesis
    ref[:, 2] = np.where(ref[:, 2] == eos, 0, ref[:, 2])  # no eos at all
    if batch_first:
        ref, hyp = ref.T.copy(), hyp.T.copy()
    kw = dict(
        eos=eos, include_eos=include_eos, batch_first=batch_first, norm=norm,
        warn=False,
    )
    for fn in ("edit_distance", "error_rate"):
        exp = getattr(jstr, fn)(ref, hyp, **kw)
        got = getattr(pstr, fn)(torch.from_numpy(ref), torch.from_numpy(hyp), **kw)
        _same(got, exp)


@pytest.mark.parametrize("R,H", [(6, 0), (0, 6), (0, 0)])
def test_empty_axes_match_jax(R, H):
    """No hypothesis steps or an empty reference: the JAX package's XLA DP
    route, not the kernel's."""
    ref, hyp = _tokens(R * 7 + H, R, H, 5)
    for norm in (False, True):
        for costs in COSTS:
            kw = dict(norm=norm, warn=False, ins_cost=costs[0], del_cost=costs[1],
                      sub_cost=costs[2])
            exp = jstr.edit_distance(ref, hyp, **kw)
            got = pstr.edit_distance(torch.from_numpy(ref), torch.from_numpy(hyp), **kw)
            _same(got, exp)
        exp = jstr.error_rate(ref, hyp, norm=norm, warn=False)
        got = pstr.error_rate(torch.from_numpy(ref), torch.from_numpy(hyp), norm=norm, warn=False)
        _same(got, exp)


@pytest.mark.parametrize("costs", COSTS + [(0.5, 1.25, 2.0), (0.3, 0.7, 0.1)])
@pytest.mark.parametrize("shape", SHAPES + [(100, 250, 9)])
@pytest.mark.parametrize("exclude_last", [False, True])
def test_reference_matches_pallas_interpret(costs, shape, exclude_last):
    """The kernel's plain version against the Pallas kernel in interpret
    mode on ragged lengths (0 included), bit for bit: both relax the
    deletions as cummin(row - i*del) + i*del."""
    R, H, N = shape
    ref, hyp = _tokens(R + 3 * H + N, R, H, N)
    rng = np.random.RandomState(N)
    ref_lens = rng.randint(0, R + 1, (N,)).astype(np.int32)
    hyp_lens = rng.randint(0, H + 1, (N,)).astype(np.int32)
    exp = edit_distance_kernel(
        jnp.asarray(ref), jnp.asarray(hyp), jnp.asarray(ref_lens),
        jnp.asarray(hyp_lens), *costs, exclude_last=exclude_last, interpret=True,
    )
    got = kernels.edit_distance_reference(
        *(torch.from_numpy(a) for a in (ref, hyp, ref_lens, hyp_lens)),
        *costs, exclude_last=exclude_last,
    )
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32), np.asarray(exp).view(np.uint32)
    )


def test_nonuniform_error_rate_raises():
    ref, hyp = _tokens(0, 4, 5, 3)
    with pytest.raises(NotImplementedError):
        pstr.error_rate(torch.from_numpy(ref), torch.from_numpy(hyp), sub_cost=2.0)
    # a distance with the same costs is ported
    pstr.edit_distance(torch.from_numpy(ref), torch.from_numpy(hyp), sub_cost=2.0)


def test_warnings_and_errors_match_jax():
    ref, hyp = _tokens(1, 4, 5, 3)
    ref[0] = 4
    with pytest.warns(UserWarning, match="empty transcripts"):
        pstr.error_rate(torch.from_numpy(ref), torch.from_numpy(hyp), eos=4)
    with pytest.warns(UserWarning, match="did not contain"):
        pstr.error_rate(torch.from_numpy(ref), torch.from_numpy(hyp), eos=9, include_eos=True)
    with pytest.raises(RuntimeError, match="batch size"):
        pstr.edit_distance(torch.from_numpy(ref), torch.from_numpy(hyp[:, :2]))
    with pytest.raises(RuntimeError, match="2 dimensional"):
        pstr.edit_distance(torch.from_numpy(ref[0]), torch.from_numpy(hyp))


def test_wrapper_takes_the_plain_version_on_cpu():
    ref, hyp = (torch.from_numpy(a) for a in _tokens(2, 9, 7, 6))
    lens = torch.full((6,), 7, dtype=torch.int32)
    kernels.reset_launches()
    got = kernels.edit_distance(ref, hyp, lens + 2, lens, 1.0, 1.0, 1.0)
    exp = kernels.edit_distance_reference(ref, hyp, lens + 2, lens, 1.0, 1.0, 1.0)
    assert torch.equal(got, exp)
    assert kernels.LAUNCHES["edit_distance"] == 0
    with pytest.raises(TypeError):
        kernels.edit_distance(ref.float(), hyp, lens, lens, 1.0, 1.0, 1.0)
    with pytest.raises(ValueError):
        kernels.edit_distance(ref, hyp[:, :3], lens, lens, 1.0, 1.0, 1.0)


def test_arrays_go_to_the_card(monkeypatch):
    """A reference that is not a tensor goes to cuda (raising without a
    card); a hypothesis follows the reference's device."""
    ref, hyp = _tokens(3, 4, 5, 3)
    got = pstr.edit_distance(torch.from_numpy(ref), hyp)
    _same(got, jstr.edit_distance(ref, hyp))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pstr.edit_distance(ref, hyp)
