"""The port's padding and chunking (pydrobert_tpu_torch.ops.pad) against the
JAX package's on the same numpy inputs. Every output is a gather of the
inputs or the padding value, so every comparison is exact; the errors the
JAX package raises are raised too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydrobert_tpu.ops import pad as jpad
from pydrobert_tpu_torch.ops import pad as ppad

N, T = 6, 13
LENS = np.array([13, 9, 4, 1, 7, 11], np.int32)


def _x(seed, rest=(3,), dtype=np.float32):
    x = np.random.RandomState(seed).randn(N, T, *rest)
    return (x * 10).astype(dtype)


def _equal(got, exp):
    exp = np.asarray(exp)
    assert tuple(got.shape) == exp.shape
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate"])
@pytest.mark.parametrize("rest,dtype", [((3,), np.float32), ((), np.float32), ((2, 2), np.int32)])
@pytest.mark.parametrize("out_len", [None, 30])
def test_pad_variable_matches_jax(mode, rest, dtype, out_len):
    rng = np.random.RandomState(len(mode) + len(rest))
    x = _x(3, rest, dtype)
    pad = rng.randint(0, 5, (2, N)).astype(np.int32)
    if mode == "reflect":
        pad = np.minimum(pad, LENS[None] - 1)
    exp = jpad.pad_variable(x, LENS, pad, mode, 2.0, out_len)
    got = ppad.pad_variable(torch.from_numpy(x), torch.from_numpy(LENS),
                            torch.from_numpy(pad), mode, 2.0, out_len)
    _equal(got, exp)


def test_pad_variable_errors_match_jax():
    x = _x(1)
    pad = np.ones((2, N), np.int32)
    cases = [
        (ValueError, (x[0], LENS, pad), {}),
        (ValueError, (x, LENS[:-1], pad), {}),
        (ValueError, (x, LENS, pad[:1]), {}),
        (ValueError, (x, LENS, pad), dict(mode="wrap")),
        (NotImplementedError, (x, LENS, pad * 4), dict(mode="reflect")),
        (RuntimeError, (x, LENS * 0, pad), dict(mode="replicate")),
    ]
    for err, args, kw in cases:
        with pytest.raises(err):
            jpad.pad_variable(*args, **kw)
        with pytest.raises(err):
            ppad.pad_variable(*(torch.from_numpy(a) for a in args), **kw)


@pytest.mark.parametrize("batch_first", [False, True])
@pytest.mark.parametrize("rest", [(3,), ()])
def test_pad_masked_sequence_matches_jax(batch_first, rest):
    x = _x(4, rest)
    mask = np.random.RandomState(5).rand(N, T) > 0.45
    mask[2] = False  # nothing selected
    mask[3] = True  # everything selected
    if not batch_first:
        x, mask = np.swapaxes(x, 0, 1).copy(), mask.T.copy()
    exp, exp_lens = jpad.pad_masked_sequence(x, mask, batch_first, -3.0)
    got, got_lens = ppad.pad_masked_sequence(torch.from_numpy(x), torch.from_numpy(mask),
                                             batch_first, -3.0)
    _equal(got, exp)
    _equal(got_lens, exp_lens)
    assert got_lens.dtype == torch.int32


def test_pad_masked_sequence_errors_match_jax():
    x, mask = _x(0), np.ones((N, T), bool)
    for args in ((x[0, 0], mask), (x, mask[0])):
        with pytest.raises(RuntimeError):
            jpad.pad_masked_sequence(*args)
        with pytest.raises(RuntimeError):
            ppad.pad_masked_sequence(*(torch.from_numpy(np.asarray(a)) for a in args))


def _slices(seed, lens, mode):
    """Slices that start left of, inside and right of each sequence, and
    empty ones."""
    rng = np.random.RandomState(seed)
    start = rng.randint(-4, T + 2, N)
    end = start + rng.randint(-2, 9, N)
    if mode == "reflect":
        # single-fold reflection: overhangs shorter than the sequence
        start = np.maximum(start, -(lens - 1))
        end = np.minimum(end, 2 * lens - 1)
    return np.stack([start, end], 1).astype(np.int32)


@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate"])
@pytest.mark.parametrize("with_lens", [False, True])
@pytest.mark.parametrize("out_len", [None, 12])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunk_by_slices_matches_jax(mode, with_lens, out_len, seed):
    x = _x(seed + 7)
    lens = LENS if with_lens else np.full((N,), T, np.int32)
    slices = _slices(seed, lens, mode)
    exp, exp_lens = jpad.chunk_by_slices(x, slices, LENS if with_lens else None, mode, 1.5,
                                         out_len)
    got, got_lens = ppad.chunk_by_slices(
        torch.from_numpy(x), torch.from_numpy(slices),
        torch.from_numpy(LENS) if with_lens else None, mode, 1.5, out_len,
    )
    _equal(got, exp)
    _equal(got_lens, exp_lens)


def test_chunk_by_slices_errors_match_jax():
    x = _x(2)
    cases = [
        (RuntimeError, (x[0, 0], np.zeros((N, 2), np.int32)), {}),
        (RuntimeError, (x, np.zeros((N, 2), np.int32), LENS[:2]), {}),
        (ValueError, (x, np.zeros((N, 2), np.int32)), dict(mode="wrap")),
        (NotImplementedError, (x, np.tile([[-T, 2]], (N, 1)).astype(np.int32)),
         dict(mode="reflect")),
    ]
    for err, args, kw in cases:
        with pytest.raises(err):
            jpad.chunk_by_slices(*args, **kw)
        with pytest.raises(err):
            ppad.chunk_by_slices(*(torch.from_numpy(np.asarray(a)) for a in args), **kw)
    # an empty batch or time axis gives an empty result in both
    e, el = jpad.chunk_by_slices(x[:, :0], np.zeros((N, 2), np.int32))
    g, gl = ppad.chunk_by_slices(torch.from_numpy(x[:, :0]), torch.zeros((N, 2), dtype=torch.int32))
    assert tuple(g.shape) == e.shape and gl.tolist() == np.asarray(el).tolist()
