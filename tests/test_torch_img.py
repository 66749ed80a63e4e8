"""The port's SpecAugment (pydrobert_tpu_torch.ops.img) against the JAX
package's: the warp grid, the apply on parameters drawn by JAX (through the
public path and through the Pallas kernel in interpret mode), the
frequency-warp route, the masks' +0.0, and the port's own draw by shape,
range and distribution. Each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydrobert_tpu.ops import img as jimg
from pydrobert_tpu.ops.pallas import spec_augment_apply_kernel
from pydrobert_tpu_torch.ops import img as pimg
from pydrobert_tpu_torch.ops import kernels

N, T, F = 4, 64, 24
LENS = np.array([64, 50, 41, 33], np.float32)


def _feats(seed, shape=(N, T, F)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_params(feats, lens, key=3, max_freq_warp=0.0):
    params = jimg.spec_augment_draw_parameters(
        jax.random.PRNGKey(key), jnp.asarray(feats), 10.0, max_freq_warp, 10, 6,
        0.5, 3, 0.2, 2, lengths=jnp.asarray(lens),
    )
    return [None if p is None else np.asarray(p) for p in params]


def _torch(params):
    return [None if p is None else torch.from_numpy(np.array(p)) for p in params]


def _grid_f64(src, flow, lens, size, order):
    """warp_1d_grid's spline solved in float64 with numpy, from the same
    float32 knots."""
    eps = float(np.finfo(np.float32).eps)
    L = lens.astype(np.float64)
    s = np.clip(np.minimum(src, L - 1), 0, None)
    d = np.clip(np.minimum(s + flow, L - 1), 0, None)
    s, d = (2 * s + 1) / size - 1, (2 * d + 1) / size - 1
    lo = np.full(L.shape, 1 / size - 1 - eps)
    up = (2 * L - 1) / size - 1 + eps
    d = np.clip(d, lo + 1e-3, np.maximum(up - 1e-3, lo + 1e-3))
    knots, values = np.stack([lo, d, up], 1), np.stack([lo, s, up], 1)

    def phi(r):
        return r**order if order % 2 else r**order * np.log(np.maximum(r, eps))

    t = (2 * np.arange(size) + 1) / size - 1
    out = []
    for c, f in zip(knots, values):
        B = np.stack([c, np.ones(3)], 1)
        lhs = np.block([[phi(np.abs(c[:, None] - c[None])), B], [B.T, np.zeros((2, 2))]])
        wv = np.linalg.solve(lhs, np.concatenate([f, [0, 0]]))
        out.append(phi(np.abs(t[:, None] - c[None])) @ wv[:3] + wv[3] * t + wv[4])
    return np.array(out)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("size", [16, 64, 1000])
def test_warp_1d_grid_matches_jax(order, size):
    """The float32 spline system is ill-conditioned where a knot clamps
    near a border, and the two frameworks' LAPACK solves and small products
    round differently, so neither grid is exact: both are held against a
    float64 solve of the same system, the port within 1.5x the JAX
    package's own distance from it plus 2e-6. At SpecAugment's order 1 and
    up to 64 frames the two also agree within atol 1e-5."""
    rng = np.random.RandomState(size + order)
    lens = rng.randint(size // 2, size + 1, (5,)).astype(np.float32)
    src = (rng.rand(5) * lens).astype(np.float32)
    flow = (rng.randn(5) * size / 10).astype(np.float32)
    exp = np.asarray(jimg.warp_1d_grid(src, flow, lens, size, order))
    got = pimg.warp_1d_grid(
        torch.from_numpy(src), torch.from_numpy(flow), torch.from_numpy(lens),
        size, order,
    )
    assert got.shape == (5, size) and got.dtype == torch.float32
    got = got.numpy()
    truth = _grid_f64(src, flow, lens, size, order)
    assert np.abs(got - truth).max() <= 1.5 * np.abs(exp - truth).max() + 2e-6
    if order == 1 and size <= 64:
        np.testing.assert_allclose(got, exp, atol=1e-5, rtol=0)


def _spline_f64(c, f, x, order, reg):
    """The polyharmonic spline solved in float64 with numpy."""
    eps = float(np.finfo(np.float32).eps)
    c, f, x = (a.astype(np.float64) for a in (c, f, x))

    def phi(r):
        return r**order if order % 2 else r**order * np.log(np.maximum(r, eps))

    out = []
    for cn, fn, xn in zip(c, f, x):
        A = phi(np.linalg.norm(cn[:, None] - cn[None], axis=-1)) + reg * np.eye(len(cn))
        B = np.concatenate([cn, np.ones((len(cn), 1))], 1)
        k = B.shape[1]
        lhs = np.block([[A, B], [B.T, np.zeros((k, k))]])
        wv = np.linalg.solve(lhs, np.concatenate([fn, np.zeros((k, fn.shape[1]))]))
        Phi = phi(np.linalg.norm(xn[:, None] - cn[None], axis=-1))
        out.append(Phi @ wv[: len(cn)] + np.concatenate([xn, np.ones((len(xn), 1))], 1) @ wv[len(cn):])
    return np.array(out)


@pytest.mark.parametrize("full_matrix", [True, False])
@pytest.mark.parametrize("order,reg", [(1, 0.0), (2, 0.0), (2, 0.1), (3, 0.01)])
def test_polyharmonic_spline_matches_jax(full_matrix, order, reg):
    """2-D knots, as the sparse image warp uses them, through both solvers.
    float32 solves of these systems lose digits in either framework, so
    both are held against a float64 solve: the port within 2x the JAX
    package's own distance from it plus 1e-6."""
    rng = np.random.RandomState(order + 10 * full_matrix)
    c = rng.rand(3, 7, 2).astype(np.float32) * 10
    f = rng.randn(3, 7, 2).astype(np.float32)
    x = rng.rand(3, 20, 2).astype(np.float32) * 10
    exp = np.asarray(jimg.polyharmonic_spline(c, f, x, order, reg, full_matrix))
    got = pimg.polyharmonic_spline(
        torch.from_numpy(c), torch.from_numpy(f), torch.from_numpy(x), order, reg,
        full_matrix,
    )
    assert got.shape == (3, 20, 2) and got.dtype == torch.float32
    truth = _spline_f64(c, f, x, order, reg)
    assert np.abs(got.numpy() - truth).max() <= 2 * np.abs(exp - truth).max() + 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_spec_augment_apply_parameters_matches_jax(dtype):
    """Same JAX-drawn parameters through the JAX public path (its XLA route
    on the CPU) and the port. float32 and float16 within atol 1e-4: the
    warp grid differs by an ulp or two (test above), which moves a lerp by
    at most that times T/2 frames times the step between neighbouring
    frames; bfloat16 within the JAX package's own 2e-2. A time warp of
    float16 feats returns float32, as JAX's XLA route does (only bfloat16
    is cast back); masks alone keep float16, bit-exact."""
    feats = _feats(0)
    params = _jax_params(feats, LENS)
    jf = jnp.asarray(feats).astype(dtype)
    exp = jimg.spec_augment_apply_parameters(jf, params, lengths=jnp.asarray(LENS))
    got = pimg.spec_augment_apply_parameters(
        torch.from_numpy(feats).to(getattr(torch, dtype)), _torch(params),
        lengths=torch.from_numpy(LENS),
    )
    out_dtype = "float32" if dtype == "float16" else dtype
    assert str(exp.dtype) == out_dtype
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (N, T, F)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(exp.astype(jnp.float32)), atol=tol, rtol=tol
    )
    params[0] = params[1] = None  # masks only
    exp = jimg.spec_augment_apply_parameters(jf, params, lengths=jnp.asarray(LENS))
    got = pimg.spec_augment_apply_parameters(
        torch.from_numpy(feats).to(getattr(torch, dtype)), _torch(params),
        lengths=torch.from_numpy(LENS),
    )
    assert str(exp.dtype) == dtype and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(exp.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("warp", [True, False])
def test_apply_reference_matches_pallas_interpret(dtype, warp):
    """The kernel's plain version on the JAX package's own lerp indices,
    weights and masks: bit-exact against the JAX XLA route, and within the
    JAX package's 1e-5 of its Pallas kernel in interpret mode (where
    t0 == t1 at a border, the kernel's one-hot product sums (w0 + w1) * x
    where the gather computes w0 * x + w1 * x). Finite inputs only: the
    Pallas kernel multiplies by keep, so a masked -x, inf or NaN would
    give -0.0 or NaN where the XLA route gives +0.0."""
    feats = _feats(1)
    params = _jax_params(feats, LENS, key=5)
    jf = jnp.asarray(feats).astype(dtype)
    tf = torch.from_numpy(feats).to(getattr(torch, dtype))
    if warp:
        grid = jimg.warp_1d_grid(params[0], params[1], LENS, T)
        jt0, jt1, jw0, jw1 = jimg._axis_lerp_weights(grid, T)
        warped = jimg._separable_warp(jf, grid, None)
    else:
        jt0 = jt1 = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (N, T))
        jw0, jw1 = jnp.ones((N, T)), jnp.zeros((N, T))
        warped = jf
    tmask = pimg._span_mask(*_torch(params[4:6]), T)
    fmask = pimg._span_mask(*_torch(params[6:8]), F)
    xla = jnp.where(
        jnp.asarray(tmask.numpy())[:, :, None] | jnp.asarray(fmask.numpy())[:, None],
        jnp.asarray(0.0, warped.dtype), warped,
    )
    interp = spec_augment_apply_kernel(
        jf, jt0, jt1, jw0, jw1, jnp.asarray(tmask.numpy(), jnp.float32),
        jnp.asarray(fmask.numpy(), jnp.float32), interpret=True,
    )
    args = [torch.from_numpy(np.asarray(a)) for a in (jt0, jt1, jw0, jw1)]
    got = kernels.spec_augment_apply_reference(
        tf, *(args if warp else [None] * 4), tmask, fmask
    )
    assert got.dtype == tf.dtype
    got = got.float().numpy()
    np.testing.assert_array_equal(
        got.view(np.uint32), np.asarray(xla.astype(jnp.float32)).view(np.uint32)
    )
    np.testing.assert_allclose(
        got, np.asarray(interp.astype(jnp.float32)), atol=1e-5, rtol=0
    )


def test_frequency_warp_route_matches_jax(monkeypatch):
    """With a frequency warp both packages take the separable warp, not the
    kernel (atol 1e-4, as the time-warp test above); the wrapper sees no
    call."""
    feats = _feats(2)
    params = _jax_params(feats, LENS, key=7, max_freq_warp=4.0)
    assert params[2] is not None
    exp = jimg.spec_augment_apply_parameters(
        jnp.asarray(feats), params, lengths=jnp.asarray(LENS)
    )
    calls = []
    monkeypatch.setattr(kernels, "spec_augment_apply", lambda *a: calls.append(a))
    got = pimg.spec_augment_apply_parameters(
        torch.from_numpy(feats), _torch(params), lengths=torch.from_numpy(LENS)
    )
    assert not calls
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-4, rtol=0)


@pytest.mark.parametrize("warp", [True, False])
def test_masked_outputs_are_positive_zero(warp):
    """A masked -x is +0.0 (the JAX XLA route), with or without a warp,
    and so is a masked inf or NaN once it lies in a masked column."""
    feats = -np.abs(_feats(3)) - 1.0
    feats[:, :, 5] = np.inf
    feats[:, :, 6] = np.nan
    feats[:, :, 7] = -np.inf
    params = _jax_params(feats, LENS)
    params[6] = np.full((N, 1), 4, np.int32)  # frequency mask over 4..8
    params[7] = np.full((N, 1), 5, np.int32)
    if not warp:
        params[0] = params[1] = None
    got = pimg.spec_augment_apply_parameters(
        torch.from_numpy(feats), _torch(params), lengths=torch.from_numpy(LENS)
    ).numpy()
    tmask = pimg._span_mask(*_torch(params[4:6]), T).numpy()
    masked = tmask[:, :, None] | (np.arange(F) >= 4)[None, None] & (
        np.arange(F) < 9
    )[None, None]
    assert masked.any() and (~masked).any()
    assert (got[masked] == 0).all() and not np.signbit(got[masked]).any()
    assert (got[~masked] < 0).all()
    exp = np.asarray(
        jimg.spec_augment_apply_parameters(
            jnp.asarray(feats), params, lengths=jnp.asarray(LENS)
        )
    )
    np.testing.assert_array_equal(np.signbit(got), np.signbit(exp))


def test_draw_shapes_ranges_and_distribution():
    """Shapes, dtypes and ranges of every parameter; means of the drawn
    mask widths and warp shifts within 5 standard errors of JAX's over
    the same lengths (different random streams, same distribution)."""
    M = 2000
    rng = np.random.RandomState(4)
    lens = rng.randint(200, 1001, (M,)).astype(np.float32)
    feats = torch.zeros((M, 1000, 80))
    args = (80.0, 0.0, 100, 27, 0.04, 20, 0.04, 2)
    gen = torch.Generator().manual_seed(0)
    w_0, w, v_0, v, t_0, t, f_0, f = pimg.spec_augment_draw_parameters(
        gen, feats, *args, lengths=torch.from_numpy(lens)
    )
    assert v_0 is None and v is None
    assert w_0.shape == w.shape == (M,) and w.dtype == torch.float32
    assert t_0.shape == t.shape == (M, 20) and t.dtype == torch.int32
    assert f_0.shape == f.shape == (M, 2) and f.dtype == torch.int32
    L = torch.from_numpy(lens)
    Wc = torch.clamp(L / 2, max=80.0)
    assert bool(((w_0 >= Wc - 1e-3) & (w_0 <= L - Wc + 1e-3)).all())
    assert bool((w.abs() <= Wc + 1e-3).all())
    max_t = torch.floor(torch.clamp(L * 0.04, max=100))[:, None]
    nums = torch.floor(torch.clamp(L * 0.04, max=20))[:, None]
    assert bool(((t >= 0) & (t <= max_t)).all())
    assert bool((t[torch.arange(20)[None] >= nums] == 0).all())
    assert bool(((t_0 >= 0) & (t_0 + t <= L[:, None])).all())
    assert bool(((f >= 0) & (f <= 27) & (f_0 >= 0) & (f_0 + f <= 80)).all())

    jp = jimg.spec_augment_draw_parameters(
        jax.random.PRNGKey(0), jnp.zeros((M, 1000, 80)), *args,
        lengths=jnp.asarray(lens),
    )
    for got, exp in ((w / Wc, np.asarray(jp[1]) / Wc.numpy()), (t, jp[5]), (f, jp[7])):
        got = got.double().numpy().ravel()
        exp = np.asarray(exp, np.float64).ravel()
        se = np.sqrt(got.var() / got.size + exp.var() / exp.size)
        assert abs(got.mean() - exp.mean()) < 5 * se + 1e-12


def test_spec_augment_follows_its_generator():
    feats = torch.from_numpy(_feats(6))
    lens = torch.from_numpy(LENS)
    a, b = (
        pimg.spec_augment(torch.Generator().manual_seed(9), feats, 10.0, lengths=lens)
        for _ in range(2)
    )
    assert torch.equal(a, b) and not torch.equal(a, feats)
    c = pimg.spec_augment(torch.Generator().manual_seed(10), feats, 10.0, lengths=lens)
    assert not torch.equal(a, c)
    assert pimg.spec_augment(None, feats, training=False) is feats


def test_spec_augment_puts_arrays_on_the_card(monkeypatch):
    """Features that are not a tensor go to cuda, which raises without a
    card instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pimg.spec_augment(None, _feats(6))


def test_apply_wrapper_checks_and_stays_on_cpu():
    feats = torch.from_numpy(_feats(8))
    kernels.reset_launches()
    t = torch.zeros((N, T), dtype=torch.int32)
    w = torch.ones((N, T))
    tm = torch.zeros((N, T), dtype=torch.bool)
    fm = torch.zeros((N, F), dtype=torch.bool)
    got = kernels.spec_augment_apply(feats, t, t, w, w * 0, tm, fm)
    assert torch.equal(got, feats[:, :1].expand(N, T, F))
    assert kernels.LAUNCHES["spec_augment_apply"] == 0
    with pytest.raises(ValueError):
        kernels.spec_augment_apply(feats, t, None, w, w, tm, fm)
    with pytest.raises(ValueError):
        kernels.spec_augment_apply(feats, t[:, :-1], t[:, :-1], w, w, tm, fm)
    with pytest.raises(TypeError):
        kernels.spec_augment_apply(feats, None, None, None, None, tm.float(), fm)
    with pytest.raises(ValueError):
        kernels.spec_augment_apply(feats[0], None, None, None, None, None, None)
