"""The port's edit distances and error rates (pydrobert_tpu_torch.ops.string)
against the JAX package's, and the plain version of the edit-distance
kernel against the Pallas kernel in interpret mode. Distances are small
integers or sums of the costs, so every comparison is exact; so are the
mistake counts at non-uniform costs, the prefix error rates and edit
distances, the optimal completions and ``fill_after_eos``. The
minimum-error-rate loss, a softmax-weighted mean, agrees within rtol 1e-6,
and its gradient within 1e-6; the OCD loss and its gradient within rtol
1e-6 and atol 1e-6."""

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


@pytest.mark.parametrize(
    "costs,expect",
    [((1.0, 1.0, np.inf), "finite"), ((np.inf, 1.0, 1.0), "inf"), ((1.0, np.inf, 1.0), "nan")],
)
def test_edit_distance_infinite_cost_matches_jax(costs, expect):
    """An infinite cost, through the public path and the kernel's plain
    version: with sub=inf a match still adds 0 (XLA compiles the JAX
    package's sub_cost * neq as a select), so distances stay finite sums of
    insertions and deletions; ins=inf gives inf and del=inf NaN in both."""
    ref, hyp = _tokens(3, 12, 15, 16)
    kw = dict(ins_cost=costs[0], del_cost=costs[1], sub_cost=costs[2])
    exp = np.asarray(jstr.edit_distance(ref, hyp, **kw))
    got = pstr.edit_distance(torch.from_numpy(ref), torch.from_numpy(hyp), **kw).numpy()
    lens = (torch.full((16,), 12, dtype=torch.int32), torch.full((16,), 15, dtype=torch.int32))
    plain = kernels.edit_distance_reference(
        torch.from_numpy(ref), torch.from_numpy(hyp), *lens, *costs
    ).numpy()
    check = {"finite": np.isfinite, "inf": np.isposinf, "nan": np.isnan}[expect]
    assert check(exp).all()
    for a in (got, plain):
        assert check(a).all()
        _same_or_nan(a, exp)


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
    """An error rate at non-uniform costs raises the JAX package's warning
    (mistake counts differ from distances there) and equals its result; a
    distance at the same costs raises none."""
    ref, hyp = _tokens(0, 4, 5, 3)
    with pytest.warns(UserWarning, match="non-uniform"):
        got = pstr.error_rate(torch.from_numpy(ref), torch.from_numpy(hyp), sub_cost=2.0)
    with pytest.warns(UserWarning, match="non-uniform"):
        exp = jstr.error_rate(ref, hyp, sub_cost=2.0)
    _same(got, exp)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
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


# The edit-distance kernel's wavefront order (csrc/edit_distance.cu),
# evaluated here in numpy float32, one rounding per operation as the kernel
# does, so that its indexing is held before any card runs it.

_WARP = 32


def _strip_of(R):
    """Columns per lane: ceil((R + 1) / 32), rounded up to a power of two
    while at most 32 (registers), else as it is (shared memory)."""
    k = (R + _WARP) // _WARP
    return k if k > 32 else 1 << (k - 1).bit_length()


# (R, columns a lane): every strip bucket's edges; test_torch_cuda.py holds
# the kernel library's own strip width to the same table
STRIP_WIDTHS = [
    (0, 1), (31, 1), (32, 2), (63, 2), (64, 4), (127, 4), (128, 8), (255, 8),
    (256, 16), (511, 16), (512, 32), (1023, 32), (1024, 33), (2000, 63),
]


@pytest.mark.parametrize("R,K", STRIP_WIDTHS)
def test_strip_widths(R, K):
    assert _strip_of(R) == K


def _nan_min(a, b):
    """torch.minimum's choice: NaN wins, else the smaller, the first on
    ties."""
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b, np.where(b < a, b, a)))


def _wavefront_edit_distance(ref, hyp, ref_lens, hyp_lens, ins, dl, sub, exclude_last):
    """The DP as the kernel's warp runs it: lane l owns columns [l*K,
    l*K + K) and at step s makes row t = s - l of its strip, with token
    t - 1, from the left lane's running minimum of row t and last column of
    row t - 1, both handed over one step earlier. Register strips take
    their prefix minima, then one minimum from the left; shared memory
    strips fold the running minimum cell by cell."""
    f32 = np.float32
    ins, dl, sub = f32(ins), f32(dl), f32(sub)
    R, N = ref.shape
    H = hyp.shape[0]
    off = 0 if exclude_last else 1
    K = _strip_of(R)
    lanes = (R + K) // K
    hl = hyp_lens.astype(np.int64)
    steps = np.minimum(H + off - 1, hl + off - 1)
    col = np.clip(ref_lens, 0, R)
    lane = np.arange(_WARP)[:, None]  # (32, 1)
    i = lane * K + np.arange(K)[None, :]  # (32, K) column of each cell
    idel = i.astype(f32) * dl
    rtok = np.zeros((_WARP, K, N), np.int64)
    has = (i >= 1) & (i <= R)
    rtok[has] = ref[i[has] - 1]
    row = np.broadcast_to(idel[..., None], (_WARP, K, N)).astype(f32)
    run_out = np.full((_WARP, N), np.inf, f32)
    last_out = row[:, K - 1].copy()
    diag = np.zeros((_WARP, N), f32)

    def from_left(a):  # __shfl_up_sync(.., 1): lane 0 keeps its own
        return np.concatenate([a[:1], a[:-1]], 0)

    total = int(steps.max()) + lanes - 1 if N and steps.max() > 0 else 0
    for s in range(1, total + 1):
        run_in, last_in = from_left(run_out), from_left(last_out)
        run_in = np.where(lane == 0, f32(np.inf), run_in)
        t = s - lane  # (32, 1)
        tok = hyp[np.clip(t[:, 0] - 1, 0, max(H - 1, 0))] if H else np.zeros((_WARP, N), np.int64)
        active = (t >= 1) & (t <= steps[None]) & (lane < lanes)  # (32, N)
        ins_t = ins * (hl[None] >= t).astype(f32)  # (32, N)
        us = []
        for j in range(K):
            v = row[:, j] + ins_t
            left = diag if j == 0 else row[:, j - 1]
            s_ = left + np.where(rtok[:, j] != tok, sub, f32(0))
            v = np.where(i[:, j, None] > 0, _nan_min(v, s_), v)
            us.append(v - idel[:, j, None])
        new = np.empty_like(row)
        if K <= 32:
            pre = us[0]
            for j in range(K):
                pre = us[0] if j == 0 else _nan_min(pre, us[j])
                new[:, j] = _nan_min(run_in, pre) + idel[:, j, None]
            out_run = _nan_min(run_in, pre)
        else:
            run = run_in
            for j in range(K):
                run = _nan_min(run, us[j])
                new[:, j] = run + idel[:, j, None]
            out_run = run
        row = np.where(active[:, None], new, row)
        run_out = np.where(active, out_run, run_out)
        last_out = np.where(active, new[:, K - 1], last_out)
        diag = last_in
    n = np.arange(N)
    done = row[col // K, col % K, n]
    return np.where(steps > 0, done, col.astype(f32) * dl).astype(f32)


# sub=inf leaves a match costing 0 and a substitution inf; a NaN cost
# spreads everywhere
WAVE_COSTS = COSTS + [(0.5, 1.25, 2.0), (0.3, 0.7, 0.1), (1.0, 1.0, np.inf), (np.nan, 1.0, 1.0)]


def _same_or_nan(got, exp):
    """Equal bit patterns, or NaN in both."""
    same = (got.view(np.uint32) == exp.view(np.uint32)) | (np.isnan(got) & np.isnan(exp))
    assert same.all(), (got, exp)


def _wave_case(R, H, N=11):
    ref, hyp = _tokens(R * 5 + H + 1, R, H, N)
    rng = np.random.RandomState(R + H)
    ref_lens = rng.randint(0, R + 1, (N,)).astype(np.int32)
    hyp_lens = rng.randint(0, H + 1, (N,)).astype(np.int32)
    ref_lens[:3] = 0, R, R + 3  # empty, full, past the end
    hyp_lens[:3] = H, 0, H
    return ref, hyp, ref_lens, hyp_lens


@pytest.mark.parametrize("exclude_last", [False, True])
@pytest.mark.parametrize("costs", WAVE_COSTS)
@pytest.mark.parametrize("H", [0, 1, 250])
@pytest.mark.parametrize("R", [0, 1, 30, 31, 32, 63, 64, 100, 300, 1030])
def test_wavefront_order_matches_reference(R, H, costs, exclude_last):
    """The kernel's order, bit for bit (or NaN in both), against the plain
    version at strip widths 1, 2, 4, 16 and 33 (shared memory) and their
    edges, ragged lengths with 0 and a reference length past R, finite,
    infinite and NaN costs."""
    args = _wave_case(R, H)
    with np.errstate(invalid="ignore"):
        got = _wavefront_edit_distance(*args, *costs, exclude_last)
    exp = kernels.edit_distance_reference(
        *(torch.from_numpy(a) for a in args), *costs, exclude_last=exclude_last
    )
    _same_or_nan(got, exp.numpy())


@pytest.mark.parametrize("exclude_last", [False, True])
@pytest.mark.parametrize("R", [31, 64])
def test_wavefront_order_matches_pallas_interpret(R, exclude_last):
    """Against the Pallas kernel too, at two strip widths; it reads no row
    past R, so every reference length stays within it."""
    costs = (0.5, 1.25, 2.0)
    args = _wave_case(R, 250, N=9)
    args[2][2] = R
    got = _wavefront_edit_distance(*args, *costs, exclude_last)
    exp = edit_distance_kernel(
        *(jnp.asarray(a) for a in args), *costs, exclude_last=exclude_last,
        interpret=True,
    )
    np.testing.assert_array_equal(got.view(np.uint32), np.asarray(exp).view(np.uint32))


@pytest.mark.parametrize("axis,fill,with_value", [(0, None, False), (1, -1, False), (0, 2.5, True)])
def test_fill_after_eos_matches_jax(axis, fill, with_value):
    rng = np.random.RandomState(axis + 7)
    tokens = rng.randint(0, 4, (9, 6)).astype(np.int32)
    value = rng.randn(9, 6).astype(np.float32) if with_value else None
    exp = jstr.fill_after_eos(jnp.asarray(tokens), 1, axis, fill,
                              None if value is None else jnp.asarray(value))
    got = pstr.fill_after_eos(torch.from_numpy(tokens), 1, axis, fill,
                              None if value is None else torch.from_numpy(value))
    _same(got, exp)


def _mer_inputs(seed, batch_first):
    rng = np.random.RandomState(seed)
    N, M, R, H = 4, 3, 6, 8
    log_probs = rng.randn(N, M).astype(np.float32)
    ref = rng.randint(0, 5, (R, N)).astype(np.int32)
    hyp = rng.randint(0, 5, (H, N, M)).astype(np.int32)
    ref[rng.randint(1, R, N), np.arange(N)] = -1  # padding as eos
    hyp[rng.randint(0, H, (N, M)), np.arange(N)[:, None], np.arange(M)[None]] = -1
    if batch_first:
        ref, hyp = ref.T.copy(), np.transpose(hyp, (1, 2, 0)).copy()
    return log_probs, ref, hyp


@pytest.mark.parametrize(
    "batch_first,sub_avg,reduction,include_eos",
    [(False, True, "mean", False), (True, False, "sum", True), (False, True, "none", True)],
)
def test_minimum_error_rate_loss_matches_jax(batch_first, sub_avg, reduction, include_eos):
    """The loss and its gradient in the log probabilities; the error rates
    (eos -1, the padding) take the edit-distance kernel's plain version."""
    import jax

    log_probs, ref, hyp = _mer_inputs(int(batch_first) + 3, batch_first)
    kw = dict(eos=-1, include_eos=include_eos, sub_avg=sub_avg, batch_first=batch_first,
              reduction=reduction, warn=False)

    def jloss(lp):
        return jstr.minimum_error_rate_loss(lp, jnp.asarray(ref), jnp.asarray(hyp), **kw)

    exp = jloss(jnp.asarray(log_probs))
    lp = torch.from_numpy(log_probs).requires_grad_(True)
    got = pstr.minimum_error_rate_loss(lp, torch.from_numpy(ref), torch.from_numpy(hyp), **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), rtol=1e-6, atol=1e-7)
    got.sum().backward()
    exp_g = jax.grad(lambda a: jloss(a).sum())(jnp.asarray(log_probs))
    np.testing.assert_allclose(lp.grad.numpy(), np.asarray(exp_g), rtol=1e-6, atol=1e-6)


def test_minimum_error_rate_loss_errors_match_jax():
    log_probs, ref, hyp = _mer_inputs(5, False)
    for args in (
        (log_probs[0], ref, hyp),  # log_probs not 2-d
        (log_probs, ref, hyp[0]),  # hyp not 3-d
        (log_probs[:, :1], ref, hyp[..., :1]),  # one sample
        (log_probs[:3], ref, hyp),  # batch sizes differ
    ):
        with pytest.raises(RuntimeError):
            jstr.minimum_error_rate_loss(*(jnp.asarray(a) for a in args))
        with pytest.raises(RuntimeError):
            pstr.minimum_error_rate_loss(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))


# Mistake counts, prefixes and the optimal completion (the plain DP the
# JAX package runs for them; no kernel takes them).

NONUNIFORM = [(1.0, 1.0, 2.0), (0.5, 1.25, 2.0), (2.0, 1.0, 1.0), (1.0, 3.0, 1.0), (0.3, 0.7, 0.1)]


def _eos_tokens(seed, R, H, N, eos=3, V=5):
    """Tokens over ``V`` with an ``eos`` at a random place in most
    sequences (some at the start, some nowhere)."""
    ref, hyp = _tokens(seed, R, H, N, V)
    rng = np.random.RandomState(seed + 1)
    for a in (ref, hyp):
        a[a == eos] = 0
        cut = rng.randint(0, a.shape[0] + 2, N)
        for n, c in enumerate(cut):
            if c < a.shape[0]:
                a[c, n] = eos
    return ref, hyp


def _same_bits(got, exp):
    exp = np.asarray(exp)
    assert got.shape == exp.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), exp.view(np.uint32))


@pytest.mark.parametrize("costs", NONUNIFORM)
@pytest.mark.parametrize("shape", [(11, 13, 50), (1, 6, 4), (7, 1, 5), (30, 40, 6)])
@pytest.mark.parametrize("norm", [False, True])
def test_nonuniform_error_rate_matches_jax(costs, shape, norm):
    """Mistakes along the cheapest alignment, ties to substitution over
    insertion over deletion; bit for bit."""
    ref, hyp = _tokens(sum(shape) + 5, *shape, V=4)
    kw = dict(ins_cost=costs[0], del_cost=costs[1], sub_cost=costs[2], norm=norm, warn=False)
    _same_bits(pstr.error_rate(torch.from_numpy(ref), torch.from_numpy(hyp), **kw),
               jstr.error_rate(ref, hyp, **kw))


@pytest.mark.parametrize("fn", ["error_rate", "prefix_error_rates"])
@pytest.mark.parametrize(
    "costs", [(1.0, 1.0, np.inf), (np.inf, 1.0, 1.0), (1.0, np.inf, 1.0), (1.0, np.nan, 1.0)]
)
def test_mistake_dp_at_infinite_and_nan_costs_matches_jax(fn, costs):
    """The mistake-counting DP where the deletion relaxation meets NaN
    (at del=inf every ``row - del_shift`` is NaN, and the last-argmin scan
    must still give an index, 0 as in the JAX package's combine); the
    same values and NaNs as the JAX package."""
    ref, hyp = _tokens(17, 7, 9, 5, V=4)
    kw = dict(ins_cost=costs[0], del_cost=costs[1], sub_cost=costs[2], warn=False)
    got = getattr(pstr, fn)(torch.from_numpy(ref), torch.from_numpy(hyp), **kw)
    _same_or_nan(got.numpy(), np.asarray(getattr(jstr, fn)(ref, hyp, **kw)))


@pytest.mark.parametrize("include_eos", [False, True])
@pytest.mark.parametrize("batch_first", [False, True])
def test_nonuniform_error_rate_eos_and_layout_match_jax(include_eos, batch_first):
    ref, hyp = _eos_tokens(11, 9, 12, 20)
    if batch_first:
        ref, hyp = ref.T.copy(), hyp.T.copy()
    for costs in NONUNIFORM[:3]:
        kw = dict(eos=3, include_eos=include_eos, batch_first=batch_first, warn=False,
                  ins_cost=costs[0], del_cost=costs[1], sub_cost=costs[2])
        _same_bits(pstr.error_rate(torch.from_numpy(ref), torch.from_numpy(hyp), **kw),
                   jstr.error_rate(ref, hyp, **kw))


def test_cummin_last_argmin_matches_jax():
    """The running minimum and the index of its last occurrence (ties go
    to the later index) on rows built of ties, against the JAX package's
    associative scan, and on the example ``[3, 1, 1, 2, 1]``."""
    from pydrobert_tpu.ops.string import _cummin_last_argmin as jscan

    v, i = pstr._cummin_last_argmin(torch.tensor([[3.0], [1.0], [1.0], [2.0], [1.0]]))
    assert v[:, 0].tolist() == [3.0, 1.0, 1.0, 1.0, 1.0]
    assert i[:, 0].tolist() == [0, 1, 2, 2, 4]
    rng = np.random.RandomState(5)
    for rows in (1, 2, 3, 7, 8, 9, 33):
        u = rng.randint(0, 3, (rows, 6)).astype(np.float32)
        ev, ei = jscan(jnp.asarray(u))
        gv, gi = pstr._cummin_last_argmin(torch.from_numpy(u))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(ev))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ei))


@pytest.mark.parametrize("fn", ["prefix_error_rates", "prefix_edit_distances"])
@pytest.mark.parametrize("costs", [(1.0, 1.0, 1.0), (2.0, 2.0, 2.0), (1.0, 1.0, 2.0), (0.5, 1.25, 2.0)])
@pytest.mark.parametrize("exclude_last", [False, True])
@pytest.mark.parametrize("batch_first", [False, True])
def test_prefix_distances_match_jax(fn, costs, exclude_last, batch_first):
    """Every prefix of every hypothesis, normalized or not, with eos,
    padding past each length; bit for bit."""
    ref, hyp = _eos_tokens(len(fn) + int(exclude_last), 8, 10, 12)
    if batch_first:
        ref, hyp = ref.T.copy(), hyp.T.copy()
    for norm in (False, True):
        kw = dict(eos=3, batch_first=batch_first, exclude_last=exclude_last, norm=norm,
                  padding=-7, warn=False, ins_cost=costs[0], del_cost=costs[1],
                  sub_cost=costs[2])
        got = getattr(pstr, fn)(torch.from_numpy(ref), torch.from_numpy(hyp), **kw)
        _same_bits(got, getattr(jstr, fn)(ref, hyp, **kw))


@pytest.mark.parametrize("shape", [(6, 0, 3), (0, 5, 3), (1, 1, 2)])
def test_prefix_distances_on_short_axes_match_jax(shape):
    ref, hyp = _tokens(sum(shape), *shape)
    for fn in ("prefix_error_rates", "prefix_edit_distances"):
        for exclude_last in (False, True):
            kw = dict(exclude_last=exclude_last, warn=False, sub_cost=2.0)
            got = getattr(pstr, fn)(torch.from_numpy(ref), torch.from_numpy(hyp), **kw)
            _same_bits(got, getattr(jstr, fn)(ref, hyp, **kw))


@pytest.mark.parametrize("costs", [(1.0, 1.0, 1.0), (1.0, 1.0, 2.0), (2.0, 1.0, 1.0)])
@pytest.mark.parametrize("exclude_last", [False, True])
@pytest.mark.parametrize("batch_first", [False, True])
def test_optimal_completion_matches_jax(costs, exclude_last, batch_first):
    """The sorted, distinct optimal next tokens of every prefix, padded
    to the reference length; exact, also where a reference repeats a
    token (V=4 over 9 positions)."""
    ref, hyp = _eos_tokens(int(exclude_last) + 3 * int(batch_first), 9, 11, 14, V=4)
    if batch_first:
        ref, hyp = ref.T.copy(), hyp.T.copy()
    for eos, include_eos in ((3, True), (3, False), (None, True)):
        kw = dict(eos=eos, include_eos=include_eos, batch_first=batch_first,
                  exclude_last=exclude_last, padding=-1, warn=False,
                  ins_cost=costs[0], del_cost=costs[1], sub_cost=costs[2])
        got = pstr.optimal_completion(torch.from_numpy(ref), torch.from_numpy(hyp), **kw)
        exp = np.asarray(jstr.optimal_completion(ref, hyp, **kw))
        assert got.shape == exp.shape
        np.testing.assert_array_equal(got.numpy(), exp)


def test_mask_to_unique_targets_matches_jax():
    """The int-free mark of every copy of an optimal token against the JAX
    package's int32 einsum, on random masks over references full of
    repeats."""
    from pydrobert_tpu.ops.string import _mask_to_unique_targets as jtargets

    rng = np.random.RandomState(9)
    mask = rng.rand(5, 8, 6) > 0.7  # (H, R, N)
    ref = rng.randint(0, 3, (6, 8)).astype(np.int32)  # (N, R)
    exp = np.asarray(jtargets(jnp.asarray(mask), jnp.asarray(ref), -5))
    got = pstr._mask_to_unique_targets(torch.from_numpy(mask), torch.from_numpy(ref), -5)
    np.testing.assert_array_equal(got.numpy(), exp)


def _ocd_inputs(seed, batch_first, V=7, H=9, N=6, R=8, eos=6):
    rng = np.random.RandomState(seed)
    ref = rng.randint(0, V - 1, (R, N)).astype(np.int32)
    hyp = rng.randint(0, V - 1, (H, N)).astype(np.int32)
    ref[rng.randint(2, R, N), np.arange(N)] = eos
    hyp[rng.randint(1, H, N), np.arange(N)] = eos
    logits = rng.randn(H, N, V).astype(np.float32)
    if batch_first:
        ref, hyp, logits = ref.T.copy(), hyp.T.copy(), logits.transpose(1, 0, 2).copy()
    return logits, ref, hyp


@pytest.mark.parametrize(
    "batch_first,reduction,with_weight,include_eos",
    [(False, "mean", False, True), (True, "mean", True, True), (False, "sum", True, False),
     (True, "none", False, True)],
)
def test_ocd_loss_matches_jax(batch_first, reduction, with_weight, include_eos):
    """The loss and its gradient in the logits; rtol 1e-6, atol 1e-6."""
    import jax

    logits, ref, hyp = _ocd_inputs(int(batch_first) + 7, batch_first)
    weight = np.random.RandomState(1).rand(7).astype(np.float32) + 0.5 if with_weight else None
    kw = dict(eos=6, include_eos=include_eos, batch_first=batch_first, reduction=reduction,
              warn=False)

    def jloss(lg):
        return jstr.hard_optimal_completion_distillation_loss(
            lg, jnp.asarray(ref), jnp.asarray(hyp),
            weight=None if weight is None else jnp.asarray(weight), **kw)

    exp = jloss(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = pstr.hard_optimal_completion_distillation_loss(
        lg, torch.from_numpy(ref), torch.from_numpy(hyp),
        weight=None if weight is None else torch.from_numpy(weight), **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), rtol=1e-6, atol=1e-6)
    got.sum().backward()
    exp_g = jax.grad(lambda a: jloss(a).sum())(jnp.asarray(logits))
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(exp_g), rtol=1e-6, atol=1e-6)


def test_ocd_loss_errors_match_jax():
    logits, ref, hyp = _ocd_inputs(3, False)
    cases = [
        (dict(), (logits[0], ref, hyp)),  # logits not 3-d
        (dict(), (logits[:-1], ref, hyp)),  # logits and hyp differ
        (dict(eos=7), (logits, ref, hyp)),  # eos not a class
        (dict(eos=2, ignore_index=2), (logits, ref, hyp)),  # eos is ignored
        (dict(eos=6, reduction="max"), (logits, ref, hyp)),
    ]
    for kw, args in cases:
        with pytest.raises(RuntimeError):
            jstr.hard_optimal_completion_distillation_loss(*(jnp.asarray(a) for a in args), **kw)
        with pytest.raises(RuntimeError):
            pstr.hard_optimal_completion_distillation_loss(
                *(torch.from_numpy(np.ascontiguousarray(a)) for a in args), **kw)


# ---- half precision (ROADMAP C7): jax.nn's rounding steps ----


def _bf16_ulp(x):
    """One bfloat16 ulp at each of ``x``'s magnitudes."""
    return np.spacing(np.abs(np.asarray(x, np.float32))) * 2.0**16


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_ocd_loss_half_precision_matches_jax(dtype):
    """The log-softmax in the logits' dtype, each step rounded: float16
    bit-exact; bfloat16 within one bfloat16 ulp (its sums still round
    apart)."""
    rng = np.random.RandomState(11)
    H, N, V, R = 6, 4, 7, 5
    ref, hyp = rng.randint(0, 6, (R, N)), rng.randint(0, 6, (H, N))
    logits = (rng.randn(H, N, V) * 3).astype(np.float32)
    kw = dict(eos=6, reduction="none", warn=False)
    exp = np.asarray(jstr.hard_optimal_completion_distillation_loss(
        jnp.asarray(logits).astype(getattr(jnp, dtype)), jnp.asarray(ref), jnp.asarray(hyp),
        **kw).astype(jnp.float32))
    got = pstr.hard_optimal_completion_distillation_loss(
        torch.from_numpy(logits).to(getattr(torch, dtype)), torch.from_numpy(ref),
        torch.from_numpy(hyp), **kw).float().numpy()
    if dtype == "float16":
        np.testing.assert_array_equal(got, exp)
    else:
        assert (np.abs(got - exp) <= _bf16_ulp(exp)).all()


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_minimum_error_rate_loss_half_precision_matches_jax(dtype):
    """The softmax of half-precision path scores, each step rounded:
    bit-exact in both dtypes."""
    rng = np.random.RandomState(12)
    H, N, M, R = 6, 4, 4, 5
    ref, hyp = rng.randint(0, 6, (R, N)), rng.randint(0, 6, (H, N, M))
    lp = (rng.randn(N, M) * 3).astype(np.float32)
    kw = dict(reduction="none", warn=False)
    exp = np.asarray(jstr.minimum_error_rate_loss(
        jnp.asarray(lp).astype(getattr(jnp, dtype)), jnp.asarray(ref), jnp.asarray(hyp), **kw
    ).astype(jnp.float32))
    got = pstr.minimum_error_rate_loss(
        torch.from_numpy(lp).to(getattr(torch, dtype)), torch.from_numpy(ref),
        torch.from_numpy(hyp), **kw).float().numpy()
    np.testing.assert_array_equal(got, exp)
