"""Parity of pydrobert_tpu_torch.ops.topk with jax.lax.top_k and the JAX
package's exact_top_k: values, indices and tie order bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydrobert_tpu.ops import topk as jtopk
from pydrobert_tpu_torch.ops import topk as ptopk


def _inputs(kind, shape, rng):
    x = rng.randn(*shape).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 4) / 4  # multiples of 0.25: many equal values
    elif kind == "signed_zeros":
        x = np.where(rng.rand(*shape) < 0.5, np.float32(0.0), x)
        x = np.where(rng.rand(*shape) < 0.5, -x, x)  # half the zeros -> -0.0
    elif kind == "inf":
        u = rng.rand(*shape)
        x = np.where(u < 0.1, np.float32(np.inf), x)
        x = np.where(u > 0.9, np.float32(-np.inf), x)
    return x


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("kind", ["normal", "ties", "signed_zeros", "inf"])
@pytest.mark.parametrize("shape,k", [((7, 50), 10), ((3, 4, 257), 32), ((5, 9), 9)])
def test_exact_top_k_matches_lax_top_k(kind, shape, k):
    rng = np.random.RandomState(sum(shape) + k)
    x = _inputs(kind, shape, rng)
    ev, ei = jax.lax.top_k(jnp.asarray(x), k)
    jv, ji = jtopk.exact_top_k(jnp.asarray(x), k)
    pv, pi = ptopk.exact_top_k(torch.from_numpy(x), k)
    assert pv.dtype == torch.float32
    np.testing.assert_array_equal(_bits(pv.numpy()), _bits(ev))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ei))
    np.testing.assert_array_equal(_bits(pv.numpy()), _bits(jv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


def test_exact_top_k_signed_zero_order():
    x = np.array([[-0.0, 0.0, -0.0, 0.0, -1.0]], np.float32)
    pv, pi = ptopk.exact_top_k(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(pi.numpy(), [[1, 3, 0, 2, 4]])
    assert not np.signbit(pv.numpy()[0, 0]) and np.signbit(pv.numpy()[0, 2])


@pytest.mark.parametrize("kind", ["ties", "inf"])
def test_exact_top_k_bfloat16(kind):
    rng = np.random.RandomState(5)
    x = _inputs(kind, (6, 40), rng)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    ev, ei = jax.lax.top_k(jx, 12)
    pv, pi = ptopk.exact_top_k(torch.from_numpy(x).bfloat16(), 12)
    assert pv.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        pv.float().numpy(), np.asarray(ev.astype(jnp.float32))
    )
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ei))


def test_hoisted_top_k_on_cpu_is_exact_top_k():
    rng = np.random.RandomState(9)
    x = torch.from_numpy(_inputs("ties", (4, 3, 300), rng))
    hv, hi = ptopk.hoisted_top_k(x, 20)
    ev, ei = ptopk.exact_top_k(x, 20)
    assert hi.dtype == torch.int32
    assert torch.equal(hv, ev) and torch.equal(hi.long(), ei)


def test_hoisted_top_k_on_cpu_takes_what_the_kernel_takes():
    rng = np.random.RandomState(10)
    x = _inputs("inf", (5, 64), rng)
    ev, ei = jax.lax.top_k(jnp.asarray(x).astype(jnp.bfloat16), 7)
    hv, hi = ptopk.hoisted_top_k(torch.from_numpy(x).bfloat16(), 7)
    assert hv.dtype == torch.float32 and hi.dtype == torch.int32
    np.testing.assert_array_equal(hv.numpy(), np.asarray(ev.astype(jnp.float32)))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(ei))
    with pytest.raises(TypeError):  # no float16 kernel, on the CPU as on the card
        ptopk.hoisted_top_k(torch.from_numpy(x).half(), 7)
    with pytest.raises(ValueError):
        ptopk.hoisted_top_k(torch.from_numpy(x), 0)


def test_exact_top_k_rejects_bad_k():
    with pytest.raises(ValueError):
        ptopk.exact_top_k(torch.zeros(3, 4), 5)
    with pytest.raises(TypeError):
        ptopk.exact_top_k(torch.zeros(3, 4, dtype=torch.int32), 2)
