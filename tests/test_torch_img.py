"""The port's SpecAugment and image warps (pydrobert_tpu_torch.ops.img)
against the JAX package's: the warp grid, the apply on parameters drawn by
JAX (through the public path and through the Pallas kernel in interpret
mode), the frequency-warp route, the masks' +0.0, the port's own draw by
shape, range and distribution, ``grid_sample`` and ``dense_image_warp``
(atol 1e-5), ``sparse_image_warp`` (the spline limit) and
``random_shift`` from given pads (exact). Each test states its
tolerance."""

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


# grid_sample, the dense and sparse warps, random_shift


def _image(seed, shape=(3, 2, 9, 12)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
def test_grid_sample_matches_jax(mode, padding_mode):
    """Coordinates across and well past the image (reflection folds more
    than once); atol 1e-5."""
    img = _image(1)
    grid = np.random.RandomState(2).uniform(-2.5, 2.5, (3, 7, 5, 2)).astype(np.float32)
    exp = jimg.grid_sample(img, grid, mode, padding_mode)
    got = pimg.grid_sample(torch.from_numpy(img), torch.from_numpy(grid), mode, padding_mode)
    assert got.shape == exp.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=0, atol=1e-5)


@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
def test_grid_sample_nearest_at_half_pixels_matches_jax(padding_mode):
    """Every coordinate half-way between two pixels (and the edges' half
    pixels), where nearest rounds half to even: the same pixels, exactly."""
    img = _image(3, (2, 1, 8, 16))
    H, W = 8, 16
    ix = np.arange(-1, W + 1) + 0.5  # pixel coordinates on the half pixels
    iy = np.arange(-1, H + 1) + 0.5
    gx = (2 * ix + 1) / W - 1
    gy = (2 * iy + 1) / H - 1
    grid = np.stack(np.broadcast_arrays(gx[None], gy[:, None]), -1).astype(np.float32)
    grid = np.broadcast_to(grid[None], (2,) + grid.shape).copy()
    exp = np.asarray(jimg.grid_sample(img, grid, "nearest", padding_mode))
    got = pimg.grid_sample(torch.from_numpy(img), torch.from_numpy(grid), "nearest",
                           padding_mode).numpy()
    np.testing.assert_array_equal(got, exp)


def test_grid_sample_errors_match_jax():
    img, grid = _image(0), np.zeros((3, 2, 2, 2), np.float32)
    for kw in (dict(mode="bicubic"), dict(padding_mode="wrap")):
        with pytest.raises(ValueError):
            jimg.grid_sample(img, grid, **kw)
        with pytest.raises(ValueError):
            pimg.grid_sample(torch.from_numpy(img), torch.from_numpy(grid), **kw)


@pytest.mark.parametrize("indexing", ["hw", "wh"])
@pytest.mark.parametrize("mode,padding_mode", [("bilinear", "border"), ("nearest", "zeros"),
                                               ("bilinear", "reflection")])
def test_dense_image_warp_matches_jax(indexing, mode, padding_mode):
    img = _image(4)
    flow = (np.random.RandomState(5).randn(3, 9, 12, 2) * 3).astype(np.float32)
    exp = jimg.dense_image_warp(img, flow, indexing, mode, padding_mode)
    got = pimg.dense_image_warp(torch.from_numpy(img), torch.from_numpy(flow), indexing, mode,
                                padding_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        pimg.dense_image_warp(torch.from_numpy(img), torch.from_numpy(flow), "xy")


@pytest.mark.parametrize("k", [1, 2, 3])
def test_pinned_points_match_jax(k):
    WH = np.array([[12.0, 9.0], [80.0, 1000.0]], np.float32)
    exp = np.asarray(jimg._pinned_points(k, jnp.asarray(WH)))
    got = pimg._pinned_points(k, torch.from_numpy(WH)).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-7, atol=0)


def _sparse_case(seed, N=3, H=9, W=12, M=4):
    rng = np.random.RandomState(seed)
    img = _image(seed, (N, 2, H, W))
    src = np.stack([rng.uniform(1, H - 2, (N, M)), rng.uniform(1, W - 2, (N, M))], -1)
    dst = src + rng.randn(N, M, 2) * 1.5
    return img, src.astype(np.float32), dst.astype(np.float32)


def _sparse_truth(img, src, dst, order, pinned, indexing, include_flow):
    """The warp with its spline solved in float64 (numpy) and sampled in
    float64 by the port's own gather form."""
    if indexing == "hw":
        src, dst = src[..., ::-1], dst[..., ::-1]
    N, C, H, W = img.shape
    WH = np.broadcast_to(np.array([W, H], np.float64), (N, 2))
    src, dst = src.astype(np.float64), dst.astype(np.float64)
    if pinned:
        pins = pimg._pinned_points(pinned, torch.from_numpy(WH.copy())).numpy()
        src, dst = np.concatenate([src, pins], 1), np.concatenate([dst, pins], 1)
    hg, wg = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    query = np.broadcast_to(np.stack([wg.ravel(), hg.ravel()], 1)[None], (N, H * W, 2))
    img64 = torch.from_numpy(img.astype(np.float64))
    if include_flow:
        flow = _spline_f64(dst, dst - src, query, order, 0.0).reshape(N, H, W, 2)
        hw = np.stack([wg, hg], 2)[None]
        grid = (2 * hw - 2 * flow + 1.0) / np.array([W, H]) - 1.0
        warped = pimg.grid_sample(img64, torch.from_numpy(grid)).numpy()
        return warped, (flow[..., ::-1] if indexing == "hw" else flow)
    values = (2.0 * src + 1.0) / WH[:, None] - 1.0
    grid = _spline_f64(dst, values, query, order, 0.0).reshape(N, H, W, 2)
    return pimg.grid_sample(img64, torch.from_numpy(grid), padding_mode="border").numpy(), None


@pytest.mark.parametrize("include_flow", [True, False])
@pytest.mark.parametrize("indexing", ["hw", "wh"])
@pytest.mark.parametrize("order,pinned", [(2, 0), (2, 1), (1, 2), (3, 1)])
def test_sparse_image_warp_matches_jax(include_flow, indexing, order, pinned):
    """The spline solve is ill-conditioned in float32 in either framework,
    so both are held against a float64 solve, the port within 2x the JAX
    package's own distance from it plus 1e-6 for the flow and 1e-5 for the
    warped image; and the port's dense warp of the JAX flow equals the JAX
    warp within atol 1e-5."""
    img, src, dst = _sparse_case(order + 3 * pinned)
    kw = dict(indexing=indexing, field_interpolation_order=order,
              pinned_boundary_points=pinned, include_flow=include_flow)
    exp = jimg.sparse_image_warp(img, src, dst, **kw)
    got = pimg.sparse_image_warp(torch.from_numpy(img), torch.from_numpy(src),
                                 torch.from_numpy(dst), **kw)
    warped, flow = _sparse_truth(img, src, dst, order, pinned, indexing, include_flow)
    if include_flow:
        (exp, exp_flow), (got, got_flow) = exp, got
        assert got_flow.shape == exp_flow.shape
        dist = np.abs(np.asarray(exp_flow) - flow).max()
        assert np.abs(got_flow.numpy() - flow).max() <= 2 * dist + 1e-6
        again = pimg.dense_image_warp(torch.from_numpy(img),
                                      torch.from_numpy(np.asarray(exp_flow)), indexing)
        np.testing.assert_allclose(again.numpy(), np.asarray(exp), rtol=0, atol=1e-5)
    assert got.shape == exp.shape
    dist = np.abs(np.asarray(exp) - warped).max()
    assert np.abs(got.numpy() - warped).max() <= 2 * dist + 1e-5


def test_sparse_image_warp_without_points_matches_jax():
    img = _image(6)
    none = np.zeros((3, 0, 2), np.float32)
    exp_img, exp_flow = jimg.sparse_image_warp(img, none, none)
    got_img, got_flow = pimg.sparse_image_warp(torch.from_numpy(img), torch.from_numpy(none),
                                               torch.from_numpy(none))
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(exp_img))
    np.testing.assert_array_equal(got_flow.numpy(), np.asarray(exp_flow))


@pytest.mark.parametrize("mode", ["reflect", "constant", "replicate"])
@pytest.mark.parametrize("out_len", [None, 40])
def test_random_shift_from_given_pads_matches_jax(mode, out_len):
    """JAX's uniforms (drawn from its key as its random_shift draws them)
    turned into pads by the port and applied: the same output, exactly."""
    x = _feats(7, (4, 20, 3))
    lens = np.array([20, 14, 9, 5], np.int32)
    key = jax.random.PRNGKey(11)
    prop = (0.5, 0.3)
    exp, exp_lens = jimg.random_shift(key, x, lens, prop, mode, 1.5, out_len=out_len)
    u = np.asarray(jax.random.uniform(key, (2, 4)))
    pad = pimg.random_shift_pads(torch.from_numpy(lens), prop, torch.from_numpy(u))
    got, got_lens = pimg.random_shift_apply(torch.from_numpy(x), torch.from_numpy(lens), pad,
                                            mode, 1.5, out_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(exp_lens))


def test_random_shift_follows_its_generator():
    """The generator's draws: reproducible, within ``prop`` of each
    length, and the input as it is when not training; errors as JAX's."""
    x = torch.from_numpy(_feats(8, (4, 20, 3)))
    lens = torch.tensor([20, 14, 9, 5])
    outs = [pimg.random_shift(x, lens, (0.5, 0.3), generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    added = outs[0][1] - lens
    assert bool((added >= 0).all()) and bool((added <= (0.8 * lens).long()).all())
    same, same_lens = pimg.random_shift(x, lens, (0.5, 0.3), training=False)
    assert same is x and torch.equal(same_lens, lens)
    for args in ((x[0, 0], lens), (x, lens[:2])):
        with pytest.raises(RuntimeError):
            jimg.random_shift(jax.random.PRNGKey(0), *(np.asarray(a) for a in args), (0.1, 0.1))
        with pytest.raises(RuntimeError):
            pimg.random_shift(*args, (0.1, 0.1))
