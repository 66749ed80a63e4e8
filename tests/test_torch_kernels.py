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
    np.testing.assert_array_equal(gv.view(np.uint32), ev.view(np.uint32), err_msg="top values")
    np.testing.assert_array_equal(gi, ei, err_msg="top indices")
    np.testing.assert_array_equal(gmx, emx, err_msg="sm_max")
    np.testing.assert_array_equal(gblank, eblank, err_msg="blank logit")
    np.testing.assert_allclose(gden, eden, rtol=2e-6, err_msg="sm_den")


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


def _degenerate(shape, kind, seed):
    """Rows of mixed -0.0 and +0.0 with a few logits among them, or rows
    whose keys all tie (on every other frame at another value)."""
    if kind == "signed_zeros":
        return _logits(shape, seed, signed_zeros=True) * (
            np.random.RandomState(seed + 1).rand(*shape) < 0.1
        )
    x = np.full(shape, 0.75, np.float32)
    x[::2] = -1.5
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["signed_zeros", "all_tie"])
def test_top_m_reference_matches_pallas_interpret_on_degenerate_rows(dtype, kind):
    """+0.0 ranks above -0.0 and tied keys go lowest index first, as
    ``jax.lax.top_k`` orders them."""
    x = _degenerate((6, 4, 300), kind, 17)
    ev, ei = top_m_pallas(jnp.asarray(x).astype(dtype), 32, interpret=True)
    gv, gi = kernels.top_m_reference(torch.from_numpy(x).to(getattr(torch, dtype)), 32)
    np.testing.assert_array_equal(
        gv.numpy().view(np.uint32), np.asarray(ev).view(np.uint32)
    )
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ei))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["signed_zeros", "all_tie"])
def test_decode_prologue_reference_matches_pallas_interpret_on_degenerate_rows(
    dtype, kind
):
    """With a bias, as the Pallas kernel always adds one: signed zeros then
    rank by the bias alone, tied rows keep their ties."""
    shape, M = (6, 4, 301), 32
    x = _degenerate(shape, kind, 23)
    g = np.random.RandomState(9).randn(shape[-1] - 1).astype(np.float32)
    if kind == "all_tie":
        g = np.zeros_like(g)  # +0.0: every key of a row still ties
    exp = decode_prologue_pallas(
        jnp.asarray(x).astype(dtype), M, jnp.asarray(g), interpret=True
    )
    got = kernels.decode_prologue_reference(
        torch.from_numpy(x).to(getattr(torch, dtype)), M, torch.from_numpy(g)
    )
    _check_prologue([t.numpy() for t in got], exp)


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
    assert kernels.LAUNCHES == {
        "decode_prologue": 0, "top_m": 0, "spec_augment_apply": 0, "edit_distance": 0,
        "ctc_beam_search": 0, "ctc_beam_search_renorm": 0, "depthwise_conv1d": 0,
    }


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


def _op_cases():
    """CPU inputs of each registered operator: the arguments the wrappers
    pass it."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 3, 17, generator=g)
    f = torch.randn(2, 6, 5, generator=g)
    t0, t1 = torch.randint(0, 6, (2, 6), generator=g), torch.randint(0, 6, (2, 6), generator=g)
    w0 = torch.rand(2, 6, generator=g)
    tmask, fmask = torch.rand(2, 6, generator=g) > 0.5, torch.rand(2, 5, generator=g) > 0.5
    ref, hyp = torch.randint(0, 5, (7, 3), generator=g), torch.randint(0, 5, (6, 3), generator=g)
    p = torch.softmax(torch.randn(6, 2, 9, generator=g), -1)
    nonext, blank = p[..., :8].contiguous(), p[..., 8].contiguous()
    tv, ti = kernels.top_m_reference(nonext, 8)
    lg = torch.randn(6, 3, 11, generator=g).to(torch.bfloat16)
    tl, rti, mx, den, bl = kernels.decode_prologue_reference(lg, 8)
    renorm_in = (torch.exp(tl - mx[..., None]) / den[..., None], rti, mx, den,
                 torch.exp(bl - mx) / den, torch.tensor([6, 0, 3]))
    ops = torch.ops.pydrobert_tpu_torch
    y = torch.randn(2, 9, 6, generator=g)
    dw = torch.randn(5, 6, generator=g), torch.randn(6, generator=g)
    return {
        "depthwise_conv1d": (ops.depthwise_conv1d.default, (y.bfloat16(), *dw, 2)),
        "depthwise_conv1d_causal": (ops.depthwise_conv1d.default, (y, *dw, 4)),
        "decode_prologue": (ops.decode_prologue.default, (x, 4, None)),
        "decode_prologue_bias": (ops.decode_prologue.default, (x, 4, torch.randn(16, generator=g))),
        "top_m": (ops.top_m.default, (x, 4)),
        "spec_augment_apply": (ops.spec_augment_apply.default, (f, t0, t1, w0, 1 - w0, tmask, fmask)),
        "spec_augment_apply_identity": (
            ops.spec_augment_apply.default, (f, None, None, None, None, None, None)
        ),
        "edit_distance": (
            ops.edit_distance.default,
            (ref, hyp, torch.tensor([7, 3, 0]), torch.tensor([6, 2, 1]), 1.0, 1.0, 2.0, False),
        ),
        "ctc_beam_search": (
            ops.ctc_beam_search.default, (nonext, blank, torch.tensor([6, 3]), 4, tv, ti)
        ),
        "ctc_beam_search_renorm": (ops.ctc_beam_search_renorm.default, (lg, *renorm_in, 4)),
    }


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_registered_operator_passes_opcheck(case):
    """Each kernel as a ``torch.library`` operator: its schema, its CPU
    (plain) implementation, its fake implementation's shapes, dtypes and
    strides against the real outputs, and the AOT dispatch, by
    ``torch.library.opcheck``; its CPU outputs equal the plain version's."""
    op, args = _op_cases()[case]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
    got = op(*args)
    name = op._schema.name.split("::")[1]
    ref = getattr(kernels, f"{name}_reference")
    if name == "decode_prologue":
        exp = ref(*args)
        exp = exp[:2] + (torch.stack(exp[2:]),)
    elif name == "ctc_beam_search":
        exp = ref(*args[:4], (args[4], args[5]))
    else:
        exp = ref(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,), exp if isinstance(exp, tuple) else (exp,)):
        assert torch.equal(a, b)


def test_export_records_the_operators_on_cpu():
    """A wrapper traced by ``torch.export`` records its operator also on the
    CPU (so the program launches the kernel once it is moved to the card),
    and the program's CPU outputs equal the eager wrapper's, which takes the
    plain version without the operator."""
    x = torch.from_numpy(_logits((5, 3, 17), 2))

    class M(torch.nn.Module):
        def forward(self, x):
            vals, idx, *stats = kernels.decode_prologue(x, 4)
            return (vals, idx, *stats, *kernels.top_m(x, 3))

    eager = M()(x)
    ep = torch.export.export(M(), (x,), strict=False)
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert sum("pydrobert_tpu_torch.decode_prologue" in t for t in targets) == 1
    assert sum("pydrobert_tpu_torch.top_m" in t for t in targets) == 1
    got = ep.module()(x)
    assert len(got) == len(eager) == 7
    for a, b in zip(got, eager):
        assert torch.equal(a, b)


def _tap_loop(y, kernel, bias, dtype, causal):
    """The Conformer's depthwise conv as its module wrote it before the
    kernel: K shifted multiply-adds in ``dtype``."""
    K, T = kernel.shape[0], y.shape[1]
    w = kernel.to(dtype)
    left = K - 1 if causal else (K - 1) // 2
    yp = torch.nn.functional.pad(y, (0, 0, left, K - 1 - left))
    out = bias.to(dtype)
    for k in range(K):
        out = out + yp[:, k : k + T] * w[k]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("N, T, C, K", [(3, 20, 8, 7), (2, 3, 5, 8), (1, 1, 3, 1), (2, 40, 16, 32)])
def test_depthwise_conv1d_cpu_operator_equals_the_tap_loop(dtype, causal, N, T, C, K):
    """The operator's CPU registration, the wrapper and the module on the
    CPU give the old tap loop's bits, T < K and K = 1 included."""
    from pydrobert_tpu_torch.models import conformer as pconf

    g = torch.Generator().manual_seed(N * T + C * K)
    y = (torch.randn(N, T, C, generator=g) * 3).to(dtype)
    kernel, bias = torch.randn(K, C, generator=g), torch.randn(C, generator=g)
    exp = _tap_loop(y, kernel, bias, dtype, causal)
    left = K - 1 if causal else (K - 1) // 2
    assert torch.equal(torch.ops.pydrobert_tpu_torch.depthwise_conv1d(y, kernel, bias, left), exp)
    assert torch.equal(kernels.depthwise_conv1d(y, kernel, bias, left), exp)
    module = pconf._DepthwiseConv1D(K, C, causal)
    with torch.no_grad():
        module.kernel.copy_(kernel)
        module.bias.copy_(bias)
        assert torch.equal(module(y), exp)
    assert torch.equal(module(y), exp)


def test_depthwise_conv1d_checks_arguments():
    y, kernel, bias = torch.zeros(2, 5, 4), torch.zeros(3, 4), torch.zeros(4)
    with pytest.raises(ValueError):
        kernels.depthwise_conv1d(y[0], kernel, bias, 1)
    with pytest.raises(ValueError):
        kernels.depthwise_conv1d(y, kernel[:, :3], bias, 1)
    with pytest.raises(ValueError):
        kernels.depthwise_conv1d(y, kernel[:0], bias, 0)
    with pytest.raises(ValueError):
        kernels.depthwise_conv1d(y, kernel, bias[:3], 1)
    with pytest.raises(ValueError):
        kernels.depthwise_conv1d(y, kernel, bias, 3)


def test_depthwise_conv_records_a_gradient_through_the_tap_loop(monkeypatch):
    """A call that records gradients takes the tap loop under autograd (the
    wrapper is never called), with the old loop's gradients; one without
    takes the wrapper."""
    from pydrobert_tpu_torch.models import conformer as pconf

    calls = []
    wrapper = kernels.depthwise_conv1d
    monkeypatch.setattr(kernels, "depthwise_conv1d",
                        lambda *a: calls.append(1) or wrapper(*a))
    g = torch.Generator().manual_seed(5)
    module = pconf._DepthwiseConv1D(7, 6, False)
    with torch.no_grad():
        module.kernel.copy_(torch.randn(7, 6, generator=g))
        module.bias.copy_(torch.randn(6, generator=g))
    y = torch.randn(2, 11, 6, generator=g, requires_grad=True)
    up = torch.randn(2, 11, 6, generator=g)
    (module(y) * up).sum().backward()
    assert not calls
    grads = [t.grad.clone() for t in (y, module.kernel, module.bias)]
    y2 = y.detach().clone().requires_grad_()
    k2, b2 = (p.detach().clone().requires_grad_() for p in (module.kernel, module.bias))
    (_tap_loop(y2, k2, b2, torch.float32, False) * up).sum().backward()
    for a, b in zip(grads, (y2.grad, k2.grad, b2.grad)):
        assert torch.equal(a, b)
    with torch.no_grad():
        module(y)
    module.requires_grad_(False)
    module(y.detach())  # grad mode on, nothing requires it
    assert len(calls) == 2


@pytest.mark.parametrize("y_dtype, p_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float32), (torch.float64, torch.float64),
])
def test_depthwise_conv_without_gradient_takes_the_wrapper_at_any_dtype(
    monkeypatch, y_dtype, p_dtype
):
    """With no gradient recorded the module calls the wrapper whatever the
    dtypes (the wrapper, not the route, refuses what the card's kernel
    cannot take), and on the CPU gives the old loop's bits."""
    from pydrobert_tpu_torch.models import conformer as pconf

    calls = []
    wrapper = kernels.depthwise_conv1d
    monkeypatch.setattr(kernels, "depthwise_conv1d",
                        lambda *a: calls.append(1) or wrapper(*a))
    g = torch.Generator().manual_seed(9)
    module = pconf._DepthwiseConv1D(5, 6, True)
    with torch.no_grad():
        module.kernel.copy_(torch.randn(5, 6, generator=g))
        module.bias.copy_(torch.randn(6, generator=g))
    module.to(p_dtype)
    y = torch.randn(2, 9, 6, generator=g).to(y_dtype)
    with torch.no_grad():
        got = module(y)
    assert calls == [1]
    assert torch.equal(got, _tap_loop(y, module.kernel, module.bias, y_dtype, True))


def test_export_records_the_depthwise_conv_operator():
    """An exported Conformer records one ``depthwise_conv1d`` operator a
    block (so its artifact launches the kernel on the card), and its CPU
    outputs equal the eager model's."""
    from pydrobert_tpu_torch.models import conformer as pconf

    cfg = pconf.ConformerConfig(vocab_size=12, num_filts=8, d_model=16, num_layers=3, num_heads=2,
                                subsample_channels=4, conv_kernel=5, dtype=torch.bfloat16)
    model = pconf.ConformerCTC(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    feats = torch.randn(2, 30, 8, generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([30, 17])
    with torch.no_grad():
        eager = model(feats, lens)
        ep = torch.export.export(model, (feats, lens), strict=False)
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert sum("pydrobert_tpu_torch.depthwise_conv1d" in t for t in targets) == 3
    for a, b in zip(ep.module()(feats, lens), eager):
        assert torch.equal(a, b)


def test_wrappers_refuse_dtensors(tmp_path):
    """A kernel wrapper takes local tensors: a DTensor is refused before
    any route is taken (the kernels sit after the encoder's gathered
    output)."""
    import socket
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.device_mesh import init_device_mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        x = distribute_tensor(torch.from_numpy(_logits((5, 3, 17), 3)), mesh)
        with pytest.raises(TypeError, match="DTensor"):
            kernels.decode_prologue(x, 4)
        with pytest.raises(TypeError, match="DTensor"):
            kernels.top_m(x, 4)
        with pytest.raises(TypeError, match="DTensor"):
            kernels.depthwise_conv1d(x, torch.zeros(3, 17), torch.zeros(17), 1)
    finally:
        dist.destroy_process_group()
