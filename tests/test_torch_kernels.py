"""The port's kernel module: the plain versions of the decode-prologue and
top-M kernels against the JAX package's Pallas kernels in interpret mode
and against its XLA prologue, and the CPU dispatch of the wrappers. The
kernels themselves are held against these plain versions on a card by
``tests/test_torch_cuda.py``."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydrobert_tpu.ops import decoding as jdec
from pydrobert_tpu.ops.pallas import decode_prologue_pallas, top_m_pallas
from pydrobert_tpu_torch.ops import decoding as pdec
from pydrobert_tpu_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _logits(shape, seed, ties=False, signed_zeros=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32) * 3
    if ties:
        x = np.round(x * 4) / 4
        x[x == 0] = 0.0  # +0.0 only: the Pallas kernel's bias add drops -0.0
    if signed_zeros:
        z = rng.rand(*shape)
        x = np.where(z < 0.2, np.float32(-0.0), np.where(z < 0.4, 0.0, x))
    return x


def _check_prologue(got, exp):
    """top values/indices bit-exact, max and blank exact, den rtol 2e-6."""
    gv, gi, gmx, gden, gblank = (np.asarray(g) for g in got)
    ev, ei, emx, eden, eblank = (np.asarray(e) for e in exp)
    np.testing.assert_array_equal(gv.view(np.uint32), ev.view(np.uint32))
    np.testing.assert_array_equal(gi, ei)
    np.testing.assert_array_equal(gmx, emx)
    np.testing.assert_array_equal(gblank, eblank)
    np.testing.assert_allclose(gden, eden, rtol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_decode_prologue_reference_matches_pallas_interpret(dtype, bias, ties):
    shape, M = (6, 4, 301), 32
    x = _logits(shape, 301 + 2 * bias + ties, ties=ties)
    g = (
        np.random.RandomState(7).randn(shape[-1] - 1).astype(np.float32)
        if bias
        else None
    )
    jx = jnp.asarray(x).astype(dtype)
    exp = decode_prologue_pallas(
        jx, M, None if g is None else jnp.asarray(g), interpret=True
    )
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = kernels.decode_prologue_reference(
        tx, M, None if g is None else torch.from_numpy(g)
    )
    _check_prologue([t.numpy() for t in got], exp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,m", [((6, 4, 300), 32), ((5, 257), 1), ((3, 40), 40)])
def test_top_m_reference_matches_pallas_interpret(dtype, shape, m):
    x = _logits(shape, sum(shape) + m, ties=True)
    ev, ei = top_m_pallas(jnp.asarray(x).astype(dtype), m, interpret=True)
    gv, gi = kernels.top_m_reference(torch.from_numpy(x).to(getattr(torch, dtype)), m)
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32
    np.testing.assert_array_equal(
        gv.numpy().view(np.uint32), np.asarray(ev).view(np.uint32)
    )
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ei))


@pytest.mark.parametrize("bias", [False, True])
def test_decode_prologue_matches_xla_path_with_signed_zeros(bias):
    """With -0.0 in the logits the reference is the JAX XLA prologue (it
    ranks the logits as they are when no bias is given)."""
    shape, M = (5, 3, 65), 16
    x = _logits(shape, 65 + bias, signed_zeros=True)
    g = np.random.RandomState(3).randn(64).astype(np.float32) if bias else None
    exp = jdec._decode_prologue(
        jnp.asarray(x), M, None if g is None else jnp.asarray(g)
    )
    got = pdec._decode_prologue(
        torch.from_numpy(x), M, None if g is None else torch.from_numpy(g)
    )
    tv, ti, mx, den, blank_probs = (np.asarray(e) for e in exp)
    gv, gi, gmx, gden, gblank = (t.numpy() for t in got)
    np.testing.assert_array_equal(gv.view(np.uint32), tv.view(np.uint32))
    np.testing.assert_array_equal(gi, ti)
    np.testing.assert_array_equal(gmx, mx)
    np.testing.assert_allclose(gden, den, rtol=2e-6)
    np.testing.assert_allclose(gblank, blank_probs, rtol=4e-6)


def test_wrappers_use_plain_versions_on_cpu():
    x = torch.from_numpy(_logits((4, 2, 129), 11, ties=True))
    kernels.reset_launches()
    got = kernels.decode_prologue(x, 8)
    exp = kernels.decode_prologue_reference(x, 8)
    for a, b in zip(got, exp):
        assert torch.equal(a, b)
    gv, gi = kernels.top_m(x, 8)
    ev, ei = kernels.top_m_reference(x, 8)
    assert torch.equal(gv, ev) and torch.equal(gi, ei)
    assert kernels.LAUNCHES == {"decode_prologue": 0, "top_m": 0}


def test_wrappers_check_arguments():
    x = torch.zeros(2, 3, 9)
    with pytest.raises(TypeError):
        kernels.decode_prologue(x.double(), 4)
    with pytest.raises(ValueError):
        kernels.decode_prologue(x, 9)  # m > V = 8
    with pytest.raises(ValueError):
        kernels.decode_prologue(x, 0)
    with pytest.raises(ValueError):
        kernels.decode_prologue(x, 4, torch.zeros(9))
    with pytest.raises(TypeError):
        kernels.top_m(x.half(), 4)


def test_kernel_modules_import_without_nvcc(tmp_path):
    """kernels.py and _build.py import with no nvcc anywhere; asking for
    the library then raises instead of running anything else."""
    code = (
        "import pydrobert_tpu_torch.ops.kernels, pydrobert_tpu_torch.ops._build as b\n"
        "try:\n"
        "    b.load_library()\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('built without nvcc')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    env["PYTHONPATH"] = REPO
    subprocess.run([sys.executable, "-c", code], env=env, check=True, cwd=REPO)
