"""The port's feature transforms (pydrobert_tpu_torch.ops.feats) against the
JAX package's on the same numpy inputs. ``mean_var_norm`` and
``feat_deltas`` sum in another order than XLA and agree within rtol 1e-6
and atol 1e-6; the delta filters are the same numpy code and equal bit for
bit; ``slice_spect_data`` (a host op) and
``chunk_token_sequences_by_slices`` are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydrobert_tpu.ops import feats as jfeats
from pydrobert_tpu_torch.ops import feats as pfeats


def _x(seed, shape=(4, 30, 5)):
    return (np.random.RandomState(seed).randn(*shape) * 3 + 1).astype(np.float32)


def _close(got, exp):
    exp = np.asarray(exp)
    assert tuple(got.shape) == exp.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dim", [-1, 0, 1])
@pytest.mark.parametrize("given", [False, True])
def test_mean_var_norm_matches_jax(dim, given):
    x = _x(dim + 5)
    kw = {}
    if given:
        size = x.shape[dim]
        rng = np.random.RandomState(2)
        kw = dict(mean=rng.randn(size).astype(np.float32),
                  std=(rng.rand(size) + 0.5).astype(np.float32))
    exp = jfeats.mean_var_norm(x, dim, **kw)
    got = pfeats.mean_var_norm(torch.from_numpy(x), dim,
                               **{k: torch.from_numpy(v) for k, v in kw.items()})
    _close(got, exp)


def test_mean_var_norm_errors_and_eps_match_jax():
    x = np.zeros((3, 4), np.float32)  # zero deviation: the eps floor
    _close(pfeats.mean_var_norm(torch.from_numpy(x)), jfeats.mean_var_norm(x))
    for dim in (2, -3):
        with pytest.raises(IndexError):
            jfeats.mean_var_norm(x, dim)
        with pytest.raises(IndexError):
            pfeats.mean_var_norm(torch.from_numpy(x), dim)


@pytest.mark.parametrize("order,width", [(0, 1), (1, 1), (2, 2), (3, 2), (2, 4)])
def test_feat_delta_filters_match_jax(order, width):
    np.testing.assert_array_equal(pfeats.feat_delta_filters(order, width),
                                  jfeats.feat_delta_filters(order, width))


@pytest.mark.parametrize("pad_mode", ["replicate", "constant", "reflect", "circular"])
@pytest.mark.parametrize(
    "kw",
    [dict(), dict(concatenate=False), dict(order=1, width=3), dict(order=0),
     dict(dim=0, time_dim=1, concatenate=False), dict(dim=1, time_dim=0),
     dict(dim=-1, time_dim=-1, concatenate=False, order=3, width=1)],
)
def test_feat_deltas_match_jax(pad_mode, kw):
    x = _x(len(kw) + len(pad_mode))
    kw = dict(kw, pad_mode=pad_mode, value=0.5)
    _close(pfeats.feat_deltas(torch.from_numpy(x), **kw), jfeats.feat_deltas(x, **kw))


@pytest.mark.parametrize("pad_mode", ["replicate", "constant", "reflect", "circular"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_feat_deltas_half_precision_match_jax(pad_mode, dtype):
    """The JAX package rounds each filter tap to the input's dtype before
    it convolves (ROADMAP C6); the port rounds them too and keeps its
    float32 sums: bit-exact."""
    x = np.random.RandomState(0).randn(4, 50, 13).astype(np.float32)
    exp = jfeats.feat_deltas(jnp.asarray(x).astype(getattr(jnp, dtype)), pad_mode=pad_mode)
    got = pfeats.feat_deltas(torch.from_numpy(x).to(getattr(torch, dtype)), pad_mode=pad_mode)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(exp.astype(jnp.float32)))


def test_feat_deltas_errors_match_jax():
    x = _x(0)
    for err, kw in ((RuntimeError, dict(time_dim=3)), (RuntimeError, dict(dim=3)),
                    (RuntimeError, dict(order=-1)), (RuntimeError, dict(width=0)),
                    (ValueError, dict(pad_mode="wrap"))):
        with pytest.raises(err):
            jfeats.feat_deltas(x, **kw)
        with pytest.raises(err):
            pfeats.feat_deltas(torch.from_numpy(x), **kw)


def _slices_equal(got, exp):
    for g, e in zip(got, exp):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


@pytest.mark.parametrize("window_type", ["symmetric", "causal", "future"])
@pytest.mark.parametrize("valid_only", [False, True])
@pytest.mark.parametrize("lobe_size", [0, 1, 3])
@pytest.mark.parametrize("with_lens", [False, True])
def test_slice_spect_data_fixed_matches_jax(window_type, valid_only, lobe_size, with_lens):
    x = _x(1, (3, 17, 2))
    lens = np.array([17, 9, 0]) if with_lens else None
    kw = dict(policy="fixed", window_type=window_type, valid_only=valid_only,
              lobe_size=lobe_size)
    exp = jfeats.slice_spect_data(x, lens, **kw)
    got = pfeats.slice_spect_data(torch.from_numpy(x),
                                  None if lens is None else torch.from_numpy(lens), **kw)
    _slices_equal(got, exp)


@pytest.mark.parametrize("window_type", ["symmetric", "causal", "future"])
@pytest.mark.parametrize("valid_only", [False, True])
@pytest.mark.parametrize("lobe_size", [0, 1, 2])
def test_slice_spect_data_ali_and_ref_match_jax(window_type, valid_only, lobe_size):
    rng = np.random.RandomState(lobe_size)
    ali = np.sort(rng.randint(0, 4, (3, 15)), 1)
    ali[1] = rng.randint(0, 3, 15)
    lens = np.array([15, 11, 6])
    ref = np.zeros((3, 6, 3), np.int64)
    starts = np.sort(rng.randint(0, 20, (3, 6)), 1)
    ref[..., 0] = rng.randint(0, 9, (3, 6))
    ref[..., 1] = starts
    ref[..., 2] = starts + rng.randint(0, 5, (3, 6))
    ref[2, 4:] = -1
    kw = dict(window_type=window_type, valid_only=valid_only, lobe_size=lobe_size)
    for policy, inp, in_lens, other in (
        ("ali", ali, None, None), ("ali", ali, lens, None),
        ("ref", ref, None, None), ("ref", ref, np.array([6, 6, 4]), np.array([30, 25, 12])),
    ):
        exp = jfeats.slice_spect_data(inp, in_lens, other, policy, **kw)
        got = pfeats.slice_spect_data(
            torch.from_numpy(inp), *(None if a is None else torch.from_numpy(a)
                                     for a in (in_lens, other)), policy, **kw)
        _slices_equal(got, exp)


def test_slice_spect_data_errors_match_jax():
    x = _x(0, (2, 5, 3))
    for args, kw in (((x[0, 0],), {}), ((x,), dict(policy="nope")),
                     ((x,), dict(window_type="nope")), ((x,), dict(lobe_size=-1)),
                     ((x,), dict(policy="ali")), ((x[..., :2],), dict(policy="ref"))):
        with pytest.raises(RuntimeError):
            jfeats.slice_spect_data(*args, **kw)
        with pytest.raises(RuntimeError):
            pfeats.slice_spect_data(*(torch.from_numpy(a) for a in args), **kw)


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("retain", [False, True])
@pytest.mark.parametrize("with_lens", [False, True])
def test_chunk_token_sequences_by_slices_matches_jax(partial, retain, with_lens):
    rng = np.random.RandomState(int(partial) + 2 * int(retain))
    N, R = 5, 8
    refs = np.zeros((N, R, 3), np.int32)
    starts = np.sort(rng.randint(0, 40, (N, R)), 1)
    refs[..., 0] = rng.randint(0, 9, (N, R))
    refs[..., 1] = starts
    refs[..., 2] = starts + rng.randint(-1, 6, (N, R))
    refs[1, 5:] = -1
    slices = np.stack([rng.randint(0, 20, N), rng.randint(20, 45, N)], 1).astype(np.int32)
    lens = rng.randint(0, R + 1, N).astype(np.int32) if with_lens else None
    exp, exp_lens = jfeats.chunk_token_sequences_by_slices(refs, slices, lens, partial, retain)
    got, got_lens = pfeats.chunk_token_sequences_by_slices(
        torch.from_numpy(refs), torch.from_numpy(slices),
        None if lens is None else torch.from_numpy(lens), partial, retain)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(exp_lens))
    assert got_lens.dtype == torch.int32


def test_chunk_token_sequences_errors_and_empty_match_jax():
    refs = np.zeros((3, 4, 3), np.int32)
    e, el = jfeats.chunk_token_sequences_by_slices(refs[..., 0], np.zeros((3, 2), np.int32))
    g, gl = pfeats.chunk_token_sequences_by_slices(torch.from_numpy(refs[..., 0]),
                                                   torch.zeros((3, 2), dtype=torch.int32))
    assert tuple(g.shape) == e.shape and tuple(gl.shape) == el.shape
    for args in ((refs[..., :2], np.zeros((3, 2), np.int32)), (refs, np.zeros((2, 2), np.int32)),
                 (refs, np.zeros((3, 2), np.int32), np.zeros(2, np.int32))):
        with pytest.raises(RuntimeError):
            jfeats.chunk_token_sequences_by_slices(*args)
        with pytest.raises(RuntimeError):
            pfeats.chunk_token_sequences_by_slices(*(torch.from_numpy(a) for a in args))
