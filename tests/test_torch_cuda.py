"""The port's Hopper kernels on a card, against their plain versions.

Every test needs a CUDA device and skips without one (the kernels have no
CPU mode). This file imports nothing of JAX, so it also runs where only
PyTorch is installed; there, skip the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pydrobert_tpu_torch.ops import kernels
from pydrobert_tpu_torch.ops.decoding import CTCPrefixSearch
from pydrobert_tpu_torch.ops.topk import hoisted_top_k

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _logits(shape, seed, dev, dtype=torch.float32, ties=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 3
    if ties:
        x = np.round(x * 4) / 4
    return torch.from_numpy(x).to(dev, dtype)


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,m", [((50, 8, 1025), 32), ((20, 3, 1001), 1), ((4, 2, 65), 64)]
)
def test_kernels_match_plain_versions(dev, dtype, shape, m):
    """top values/indices bit-exact, max and blank exact, den rtol 2e-6."""
    x = _logits(shape, m, dev, dtype, ties=True)
    g = torch.randn(shape[-1] - 1, generator=torch.Generator().manual_seed(0)).to(dev)
    for bias in (None, g):
        tv, ti, mx, den, blank = kernels.decode_prologue(x, m, bias)
        ev, ei, emx, eden, eblank = kernels.decode_prologue_reference(x, m, bias)
        assert _bits_equal(tv, ev) and torch.equal(ti, ei)
        assert torch.equal(mx, emx) and torch.equal(blank, eblank)
        torch.testing.assert_close(den, eden, rtol=2e-6, atol=0)
    gv, gi = kernels.top_m(x, m)
    ev, ei = kernels.top_m_reference(x, m)
    assert _bits_equal(gv, ev) and torch.equal(gi, ei)


def test_wrappers_count_launches_and_check_inputs(dev):
    x = _logits((6, 4, 129), 1, dev)
    kernels.reset_launches()
    kernels.decode_prologue(x, 8)
    kernels.top_m(x, 8)
    assert kernels.LAUNCHES == {"decode_prologue": 1, "top_m": 1}
    with pytest.raises(ValueError):
        kernels.decode_prologue(x.transpose(0, 1), 8)  # not contiguous
    with pytest.raises(ValueError):
        kernels.decode_prologue(x, 8, torch.zeros(128))  # bias on the CPU
    assert kernels.LAUNCHES == {"decode_prologue": 1, "top_m": 1}


def test_hoisted_top_k_takes_the_kernel_or_raises(dev):
    x = _logits((6, 4, 129), 3, dev)
    kernels.reset_launches()
    hv, hi = hoisted_top_k(x, 8)
    assert kernels.LAUNCHES["top_m"] == 1
    ev, ei = kernels.top_m_reference(x, 8)
    assert _bits_equal(hv, ev) and torch.equal(hi, ei)
    with pytest.raises(TypeError):
        hoisted_top_k(x.half(), 8)  # no float16 kernel, and no plain route
    with pytest.raises(ValueError):
        hoisted_top_k(x, 0)
    assert kernels.LAUNCHES["top_m"] == 1


def test_search_on_card_matches_cpu(dev):
    x = _logits((40, 6, 65), 2, torch.device("cpu"))
    lens = torch.tensor([40, 33, 20, 7, 1, 0])
    cy, cl, cp = CTCPrefixSearch(8)(x, lens)
    kernels.reset_launches()
    gy, gl, gp = (t.cpu() for t in CTCPrefixSearch(8)(x.to(dev), lens.to(dev)))
    assert kernels.LAUNCHES["decode_prologue"] == 1
    assert torch.equal(cl, gl)
    for n in range(6):
        for w in range(8):
            L = int(cl[n, w])
            assert torch.equal(cy[:L, n, w], gy[:L, n, w])
    torch.testing.assert_close(gp, cp, rtol=1e-5, atol=0)
