"""The port's combinatorics (pydrobert_tpu_torch.ops.combinatorics) and RL
returns (pydrobert_tpu_torch.ops.rl) against the JAX package's. Counts,
enumerations and samples are exact (the sampler is given the uniforms the
JAX package draws from its split keys); log-partitions, means and returns
within rtol 1e-6 and atol 1e-6 (float32 sums and powers taken in another
order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydrobert_tpu.ops import combinatorics as jc
from pydrobert_tpu.ops import rl as jrl
from pydrobert_tpu_torch.ops import combinatorics as pc
from pydrobert_tpu_torch.ops import rl as prl


def _close(got, exp):
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "length,count",
    [(np.arange(12), 3), (np.arange(30), 7), (np.array([5, 4, 3]), np.array([[0], [2], [6]])),
     (66, 33), (62, np.arange(63))],
)
def test_binomial_coefficient_is_exact(length, count):
    got = pc.binomial_coefficient(length, count, device="cpu")
    exp = np.asarray(jc.binomial_coefficient(length, count))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), exp)
    with pytest.raises(RuntimeError):
        pc.binomial_coefficient(-1, 0, device="cpu")


@pytest.mark.parametrize("length,vocab", [(0, 3), (1, 4), (3, 3), (4, 2)])
def test_enumerations_match_jax(length, vocab):
    np.testing.assert_array_equal(
        pc.enumerate_vocab_sequences(length, vocab, device="cpu").numpy(),
        np.asarray(jc.enumerate_vocab_sequences(length, vocab)))
    np.testing.assert_array_equal(
        pc.enumerate_binary_sequences(length, device="cpu").numpy(),
        np.asarray(jc.enumerate_binary_sequences(length)))
    for count in range(length + 1):
        np.testing.assert_array_equal(
            pc.enumerate_binary_sequences_with_cardinality(length, count, device="cpu").numpy(),
            np.asarray(jc.enumerate_binary_sequences_with_cardinality(length, count)))


@pytest.mark.parametrize(
    "fn,args",
    [("binomial_coefficient", (5, 2)), ("enumerate_vocab_sequences", (2, 3)),
     ("enumerate_binary_sequences", (3,)),
     ("enumerate_binary_sequences_with_cardinality", (4, 2))],
)
def test_enumerations_default_to_cuda_and_raise_without_one(monkeypatch, fn, args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(pc, fn)(*args)


def test_batched_cardinality_enumeration_matches_jax():
    length, count = np.array([[3, 5], [4, 2]]), np.array([[1, 2], [4, 0]])
    s, b = pc.enumerate_binary_sequences_with_cardinality(
        torch.tensor(length), torch.tensor(count), device="cpu")
    es, eb = jc.enumerate_binary_sequences_with_cardinality(length, count)
    np.testing.assert_array_equal(s.numpy(), np.asarray(es))
    np.testing.assert_array_equal(b.numpy(), np.asarray(eb))


def _jax_uniforms(key, shape, out_size):
    """The uniforms of the JAX sampler: step t draws from the t-th of
    ``out_size`` split keys; returned in the port's layout (shape +
    (out_size,))."""
    keys = jax.random.split(key, out_size)
    return np.stack([np.asarray(jax.random.uniform(k, shape)) for k in keys], -1)


@pytest.mark.parametrize("seed", range(3))
def test_srswor_matches_jax_on_its_draws(seed):
    rng = np.random.RandomState(seed)
    total = rng.randint(1, 9, (4, 3))
    given = np.minimum(rng.randint(0, 9, (4, 3)), total)
    key = jax.random.PRNGKey(seed)
    exp = np.asarray(jc.simple_random_sampling_without_replacement(key, total, given, 10))
    u = _jax_uniforms(key, (4, 3), 10)
    got = pc.simple_random_sampling_without_replacement(
        None, torch.tensor(total), torch.tensor(given), 10, u=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), exp)
    np.testing.assert_array_equal(got.sum(-1).numpy(), given)
    with pytest.raises(RuntimeError):
        pc.simple_random_sampling_without_replacement(None, torch.tensor(total), torch.tensor(given), 3)
    drawn = pc.simple_random_sampling_without_replacement(
        torch.Generator().manual_seed(seed), torch.tensor(total), torch.tensor(given))
    np.testing.assert_array_equal(drawn.sum(-1).numpy(), given)
    assert not drawn.numpy()[np.arange(drawn.shape[-1]) >= total[..., None]].any()


def test_srswor_distribution_matches_jax():
    given, total = np.array([2, 3, 1]), np.array([5, 6, 4])
    jd = jc.SimpleRandomSamplingWithoutReplacement(given, total, 7)
    pd = pc.SimpleRandomSamplingWithoutReplacement(torch.tensor(given), torch.tensor(total), 7)
    assert tuple(pd.batch_shape) == jd.batch_shape and tuple(pd.event_shape) == jd.event_shape
    for name in ("log_partition", "mean", "variance"):
        _close(getattr(pd, name), getattr(jd, name))
    assert not pd.has_enumerate_support and not jd.has_enumerate_support
    key = jax.random.PRNGKey(5)
    exp = jd.sample(key, (2,))
    got = pd.sample((2,), u=torch.from_numpy(_jax_uniforms(key, (2, 3), 7)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    _close(pd.log_prob(got), jd.log_prob(exp))
    with pytest.raises(NotImplementedError):
        pd.enumerate_support()


@pytest.mark.parametrize("expand", [True, False])
def test_srswor_enumerate_support_matches_jax(expand):
    jd = jc.SimpleRandomSamplingWithoutReplacement(np.full((2,), 2), np.full((2,), 4), 6)
    pd = pc.SimpleRandomSamplingWithoutReplacement(torch.full((2,), 2), torch.full((2,), 4), 6)
    got, exp = pd.enumerate_support(expand), jd.enumerate_support(expand)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    if expand:
        _close(pd.log_prob(got), jd.log_prob(exp))
    else:  # an unexpanded support does not broadcast against the batch
        with pytest.raises(ValueError):
            jd.log_prob(exp)
        with pytest.raises(RuntimeError):
            pd.log_prob(got)


@pytest.mark.parametrize("gamma", [0.0, 0.5, 0.99])
@pytest.mark.parametrize("batch_first", [False, True])
def test_time_distributed_return_matches_jax(gamma, batch_first):
    r = np.random.RandomState(2).randn(17, 4).astype(np.float32)
    if batch_first:
        r = np.ascontiguousarray(r.T)
    got = prl.time_distributed_return(torch.from_numpy(r), gamma, batch_first)
    exp = jrl.time_distributed_return(jnp.asarray(r), gamma, batch_first)
    _close(got, exp)
    with pytest.raises(RuntimeError):
        prl.time_distributed_return(torch.zeros(3), gamma)


def test_time_distributed_return_stays_finite_on_long_sequences():
    """gamma ** 2000 underflows in float32; the powers of the index
    difference keep the kept triangle finite, as in the JAX package."""
    r = np.random.RandomState(0).rand(2000, 2).astype(np.float32)
    got = prl.time_distributed_return(torch.from_numpy(r), 0.95)
    exp = np.asarray(jrl.time_distributed_return(jnp.asarray(r), 0.95))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-5)
