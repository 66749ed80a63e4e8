"""The port's whole-loop CTC beam search on the CPU: the plain version of
the ``ctc_beam_search`` kernel against the JAX package's kernel simulator
(``ctc_beam_search_reference``; its Pallas kernel in interpret mode is a
slow test there), ``CTCPrefixSearch``'s raw route (``DECODE_RENORM`` off)
against the JAX package's raw-mass search, and the gate of both whole-loop
routes (the default one, ``ctc_beam_search_renorm``, has the scan itself
as its plain version: ``tests/test_torch_decoding.py``). The kernels are
held against the plain versions on a card by
``tests/test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydrobert_tpu import config as jconfig
from pydrobert_tpu.ops import decoding as jdec
from pydrobert_tpu.ops.pallas import ctc_beam_search_reference as jax_beam_reference
from pydrobert_tpu_torch import config as pconfig
from pydrobert_tpu_torch import lm as plm
from pydrobert_tpu_torch.ops import decoding as pdec
from pydrobert_tpu_torch.ops import kernels

from _lm_dicts import random_prob_dicts


def _probs(T, N, V, seed, scale, ties=False):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(T, N, V + 1) * scale).astype(np.float32)
    if ties:  # quarter steps: many probabilities, and so masses, tie
        logits = np.round(logits * 4) / 4
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), 2))
    lens = rng.randint(0, T + 1, (N,)).astype(np.int32)
    lens[0], lens[1] = T, 0
    if N > 2:
        lens[2] = 1
    nonext = np.ascontiguousarray(probs[..., :V])
    blank = np.ascontiguousarray(probs[..., V])
    return logits, nonext, blank, lens


def _beam_outputs_equal(a, b, rtol):
    """``_beam_outputs_equal``'s rule (tests/test_pallas.py) without its
    atol: lengths exact, the same beams finite, finite probabilities within
    ``rtol``, tokens exact up to each length."""
    y0, l0, p0 = (np.asarray(x) for x in a)
    y1, l1, p1 = (np.asarray(x) for x in b)
    np.testing.assert_array_equal(l0, l1)
    fin = np.isfinite(p0)
    np.testing.assert_array_equal(fin, np.isfinite(p1))
    np.testing.assert_allclose(
        np.where(fin, p0, 0), np.where(fin, p1, 0), rtol=rtol, atol=0
    )
    N, W = l0.shape
    for n in range(N):
        for w in range(W):
            L = l0[n, w]
            np.testing.assert_array_equal(y0[:L, n, w], y1[:L, n, w])


@pytest.mark.parametrize("shape", [(64, 8, 128, 8), (32, 4, 64, 4), (12, 3, 9, 4)])
def test_beam_reference_matches_jax_simulator(shape):
    """Ragged lengths with 0 and 1. Logits x3 keep every mass in the
    normal float32 range over 64 frames: XLA's CPU backend flushes
    subnormal results to zero and PyTorch does not, so the two part once
    masses go subnormal (x2 logits do by about frame 55). In the normal
    range both round every product and sum alike and the results are bit
    for bit equal; the check allows rtol 1e-6 should XLA fuse a product
    and a sum."""
    T, N, V, W = shape
    _, nonext, blank, lens = _probs(T, N, V, sum(shape), 3.0)
    exp = jax.jit(jax_beam_reference, static_argnums=3)(
        jnp.asarray(nonext), jnp.asarray(blank), jnp.asarray(lens), W
    )
    got = kernels.ctc_beam_search_reference(
        torch.from_numpy(nonext), torch.from_numpy(blank), torch.from_numpy(lens), W
    )
    assert got[0].dtype == torch.long and got[1].dtype == torch.long
    assert got[2].dtype == torch.float32 and tuple(got[0].shape) == (T, N, W)
    _beam_outputs_equal([t.numpy() for t in got], exp, rtol=1e-6)
    np.testing.assert_array_equal(got[1][1].numpy(), 0)  # lens == 0: empty
    assert got[2][1, 0] == 1.0 and bool(torch.isinf(got[2][1, 1:]).all())


@pytest.mark.parametrize("shape", [(64, 8, 128, 8), (32, 4, 64, 4)])
def test_beam_reference_matches_jax_simulator_on_ties(shape):
    """x3 logits on quarter steps (normal masses, as above): candidates tie
    within and across beams, and both rank them to the lowest flat index."""
    T, N, V, W = shape
    _, nonext, blank, lens = _probs(T, N, V, sum(shape) + 1, 3.0, ties=True)
    exp = jax.jit(jax_beam_reference, static_argnums=3)(
        jnp.asarray(nonext), jnp.asarray(blank), jnp.asarray(lens), W
    )
    got = kernels.ctc_beam_search_reference(
        torch.from_numpy(nonext), torch.from_numpy(blank), torch.from_numpy(lens), W
    )
    _beam_outputs_equal([t.numpy() for t in got], exp, rtol=1e-6)


def test_beam_wrapper_takes_plain_version_on_cpu():
    _, nonext, blank, lens = _probs(20, 5, 40, 1, 2.0)
    args = (torch.from_numpy(nonext), torch.from_numpy(blank), torch.from_numpy(lens))
    kernels.reset_launches()
    exp = kernels.ctc_beam_search_reference(*args, 8)
    top = kernels.top_m(args[0], 16)
    for got in (kernels.ctc_beam_search(*args, 8), kernels.ctc_beam_search(*args, 8, top)):
        for a, b in zip(got, exp):
            assert torch.equal(a, b)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


def test_beam_wrapper_checks_arguments():
    nonext, blank = torch.zeros(6, 2, 10), torch.zeros(6, 2)
    lens = torch.tensor([6, 3])
    for bad_width in (0, 11, 33):
        with pytest.raises(ValueError, match="width"):
            kernels.ctc_beam_search(nonext, blank, lens, bad_width)
    with pytest.raises(TypeError):
        kernels.ctc_beam_search(nonext.double(), blank, lens, 4)
    with pytest.raises(TypeError):
        kernels.ctc_beam_search(nonext, blank, lens.float(), 4)
    with pytest.raises(ValueError):
        kernels.ctc_beam_search(nonext, blank[:5], lens, 4)
    with pytest.raises(ValueError):
        kernels.ctc_beam_search(nonext, blank, lens, 4, kernels.top_m(nonext, 4))


def test_renorm_wrapper_checks_arguments():
    """The renormalizing kernel's wrapper refuses what its launch cannot
    take before any route is chosen: a width out of range, inputs of
    other dtypes or shapes, float lengths."""
    logits = torch.zeros(6, 2, 11)
    tl, ti, mx, den, bl = kernels.decode_prologue(logits, 8)
    args = [logits, torch.exp(tl - mx[..., None]) / den[..., None], ti, mx, den,
            torch.exp(bl - mx) / den, torch.tensor([6, 3]), 4]
    kernels.ctc_beam_search_renorm(*args)
    for i, bad, err in (
        (7, 0, ValueError), (7, 11, ValueError), (2, ti.long(), TypeError),
        (1, args[1][..., :4], ValueError), (3, mx[:5], ValueError),
        (6, torch.tensor([6.0, 3.0]), TypeError), (0, logits.double(), TypeError),
    ):
        with pytest.raises(err):
            kernels.ctc_beam_search_renorm(*args[:i], bad, *args[i + 1:])


def test_beam_fits_follows_shared_memory():
    """Two (W, T) int32 path buffers dominate: at W=16 up to 1,772 frames
    fit a block's 232,448 bytes, at W=32 up to 832."""
    for W, T_max in ((16, 1772), (32, 832)):
        assert kernels.ctc_beam_search_fits(T_max, 32, 1024, W)
        assert not kernels.ctc_beam_search_fits(T_max + 1, 32, 1024, W)
    assert kernels.ctc_beam_search_fits(500, 32, 1024, 16)


def _route_spy(monkeypatch):
    """The widths of the whole-loop searches the route takes, either
    kernel's wrapper."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[3])
        return kernels.ctc_beam_search(*args, **kwargs)

    def spy_renorm(*args, **kwargs):
        calls.append(args[7])
        return kernels.ctc_beam_search_renorm(*args, **kwargs)

    monkeypatch.setattr(pdec, "ctc_beam_search", spy)
    monkeypatch.setattr(pdec, "ctc_beam_search_renorm", spy_renorm)
    return calls


@pytest.mark.parametrize("shape", [(48, 4, 128, 8), (30, 5, 20, 16)])
def test_beam_route_matches_jax_search_without_renorm(shape, monkeypatch):
    """The forced route against the JAX package's search with
    ``DECODE_RENORM`` off (the raw masses the whole-loop kernel carries),
    by ``_beam_outputs_equal``'s rule: the softmax and the scan's gathers
    round differently in the last ulps, which compound over T frames."""
    T, N, V, W = shape
    logits, _, _, lens = _probs(T, N, V, 7 + T, 2.0)
    monkeypatch.setattr(jconfig, "DECODE_RENORM", False)
    exp = jax.jit(jdec.CTCPrefixSearch(W))(jnp.asarray(logits), jnp.asarray(lens))
    monkeypatch.setattr(pconfig, "DECODE_RENORM", False)
    calls = _route_spy(monkeypatch)
    got = pdec.CTCPrefixSearch(W)(torch.from_numpy(logits), torch.from_numpy(lens))
    assert calls == [W]
    assert got[1].dtype == torch.long
    _beam_outputs_equal([t.numpy() for t in got], exp, rtol=1e-4)


def test_beam_route_matches_port_scan(monkeypatch):
    """The route against the port's own per-frame scan with raw masses."""
    logits, _, _, lens = _probs(40, 6, 50, 11, 2.0)
    x, ln = torch.from_numpy(logits), torch.from_numpy(lens)
    monkeypatch.setattr(pconfig, "DECODE_RENORM", False)
    monkeypatch.setattr(pconfig, "USE_BEAM_KERNEL", "0")
    scan = pdec.CTCPrefixSearch(8)(x, ln)
    monkeypatch.setattr(pconfig, "USE_BEAM_KERNEL", "auto")
    calls = _route_spy(monkeypatch)
    beam = pdec.CTCPrefixSearch(8)(x, ln)
    assert calls == [8]
    _beam_outputs_equal([t.numpy() for t in beam], [t.numpy() for t in scan], rtol=1e-4)


@pytest.mark.parametrize(
    "mode,renorm,taken", [
        ("auto", True, True), ("auto", False, True), ("1", True, True),
        ("1", False, True), ("0", True, False), ("0", False, False),
    ],
)
def test_beam_route_gate_modes(mode, renorm, taken, monkeypatch):
    """The switch is "0" against any other value: the default ("auto")
    and another value ("1") take a whole-loop route, the renormalizing one
    with renorm on; "0" never does."""
    monkeypatch.setattr(pconfig, "USE_BEAM_KERNEL", mode)
    monkeypatch.setattr(pconfig, "DECODE_RENORM", renorm)
    calls = _route_spy(monkeypatch)
    logits, _, _, lens = _probs(9, 3, 12, 5, 1.0)
    pdec.CTCPrefixSearch(4)(torch.from_numpy(logits), torch.from_numpy(lens))
    assert calls == ([4] if taken else [])


@pytest.mark.parametrize(
    "T,V,W", [(9, 12, 1), (1, 12, 4), (0, 12, 4), (9, 3, 4), (9, 40, 33)]
)
def test_beam_route_gate_shapes(T, V, W, monkeypatch):
    """Under the defaults W = 1, T < 2 and W > min(32, V) take the scan."""
    calls = _route_spy(monkeypatch)
    logits = np.random.RandomState(T + V + W).randn(T, 2, V + 1).astype(np.float32)
    pdec.CTCPrefixSearch(W)(torch.from_numpy(logits))
    assert calls == []


def test_beam_route_gate_needs_shared_memory():
    """Under the defaults a T past the fit takes the scan."""
    search = pdec.CTCPrefixSearch(32)
    assert search._takes_beam_route(832, 4, 1024)
    assert not search._takes_beam_route(833, 4, 1024)
    assert pdec.CTCPrefixSearch(16)._takes_beam_route(1772, 256, 1024)
    assert not pdec.CTCPrefixSearch(16)._takes_beam_route(1773, 256, 1024)


@pytest.mark.parametrize("case", ["sparse", "uni", "dense", "mixture", "state", "beta0"])
def test_beam_route_gate_lm_and_state(case, monkeypatch):
    """Under the defaults every LM route and an ``initial_state`` take the
    scan; an LM at ``beta == 0`` fuses nothing and takes the whole-loop
    route."""
    V = 12
    order = 1 if case == "uni" else 2
    lm = plm.LookupLanguageModel(
        V, sos=V, prob_dicts=random_prob_dicts(V, order, 3, sos=V), device="cpu"
    )
    kw = {"lm": lm, "beta": 0.0 if case == "beta0" else 0.5}
    if case == "dense":
        monkeypatch.setattr(pconfig, "SPARSE_FUSION_MAX_CORRECTIONS", -1)
    if case == "mixture":
        kw["valid_mixture"] = True
    if case == "state":
        kw = {}
    search = pdec.CTCPrefixSearch(4, **kw)
    assert search.lm_route() == {"sparse": "sparse", "uni": "uni", "dense": "dense",
                                 "mixture": "dense"}.get(case)
    calls = _route_spy(monkeypatch)
    logits, _, _, lens = _probs(9, 3, V, 5, 1.0)
    state = {"hidden": torch.zeros(3)} if case == "state" else None
    search(torch.from_numpy(logits), torch.from_numpy(lens), state)
    assert calls == ([4] if case == "beta0" else [])
