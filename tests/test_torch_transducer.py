"""The port's RNN-T loss, searches, Conformer-Transducer and its training
step against the JAX package's, on the same numpy inputs and, for the
model, the same weights (carried by ``state_dict_from_jax``): the JAX
tests' sizes (``tests/test_transducer.py``: toy searchers at V=9, the
``_ENC`` encoder at V=16, d=16, 2 layers, float32, ``pred_dim =
joint_dim = 12``).

Tolerances: hypotheses and lengths bit-equal; the log-semiring scan and
losses within rtol 1e-6 (the scan also within atol 1e-6 near 0)
and node-level gradients within atol 1e-6 (the lattice scans sum in
other orders: the JAX package's associative scan, the port's doubling
scan); search scores within rtol 1e-6 (sums of tens of float32
log-probabilities, each rounded apart by the two frameworks' matrix
products); the model's loss within rtol
1e-5, every gradient within 1e-5 of its tensor's largest entry and the
parameters after one AdamW step within atol 1e-6. No two beams of these
searches tie mathematically: the only exact ties are the ``-1e30`` scores
of the first frame's unfilled beams, which both rank lowest index
first."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pydrobert_tpu.lm as jlm_mod
from pydrobert_tpu.models import transducer as jm
from pydrobert_tpu.models.conformer import ConformerConfig as JConfig
from pydrobert_tpu.ops import transducer as jt
from pydrobert_tpu_torch import lm as plm_mod
from pydrobert_tpu_torch.models import transducer as pm
from pydrobert_tpu_torch.models.conformer import ConformerConfig as PConfig
from pydrobert_tpu_torch.ops import transducer as pt

from _lm_dicts import random_prob_dicts

ENC = dict(
    vocab_size=16, num_filts=8, d_model=16, num_layers=2, num_heads=2,
    subsample_channels=4, conv_kernel=5, dropout=0.0,
)
CAUSAL = dict(attention_context=(4, 0), causal_conv=True)
LR = 1e-3


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ---------------------------------------------------------------- the loss


def _node_inputs(seed=0, N=5, T=7, U=4):
    rng = np.random.RandomState(seed)
    blank = np.log(rng.rand(N, T, U + 1)).astype(np.float32)
    emit = np.log(rng.rand(N, T, U)).astype(np.float32)
    Tl = rng.randint(2, T + 1, N).astype(np.int32)
    Ul = rng.randint(0, U + 1, N).astype(np.int32)
    Tl[0], Ul[0] = T, U  # one full row; the others ragged (U = 0 among them)
    return blank, emit, Tl, Ul


def test_log_affine_scan_matches_jax():
    rng = np.random.RandomState(3)
    c = np.log(rng.rand(4, 11)).astype(np.float32)
    x = np.log(rng.rand(4, 11)).astype(np.float32)
    x[:, 5] = -1e30
    c[1, 3] = -1e30
    exp = jax.jit(jt._log_affine_scan)(c, x)
    got = pt._log_affine_scan(*_t(c, x))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_transducer_loss_and_gradients_match_jax(reduction):
    blank, emit, Tl, Ul = _node_inputs()
    assert (Ul == 0).any() and (Tl < blank.shape[1]).any()

    def jloss(b, e):
        out = jt.transducer_loss(b, e, Tl, Ul, reduction=reduction)
        return out, out.sum()

    (exp, _), (gb, ge) = jax.jit(
        lambda b, e: (jloss(b, e), jax.grad(lambda b, e: jloss(b, e)[1], (0, 1))(b, e))
    )(blank, emit)
    b, e = (a.requires_grad_() for a in _t(blank, emit))
    got = pt.transducer_loss(b, e, *_t(Tl, Ul), reduction=reduction)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), rtol=1e-6)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(gb), rtol=0, atol=1e-6)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ge), rtol=0, atol=1e-6)


def test_transducer_loss_default_lengths_and_errors():
    blank, emit, _, _ = _node_inputs(1)
    exp = jt.transducer_loss(blank, emit, reduction="none")
    got = pt.transducer_loss(*_t(blank, emit), reduction="none")
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6)
    with pytest.raises(RuntimeError, match="emit_lp"):
        pt.transducer_loss(*_t(blank, emit[:, :, :-1]))
    with pytest.raises(RuntimeError, match="reduction"):
        pt.transducer_loss(*_t(blank, emit), reduction="max")


def test_transducer_loss_from_joint_matches_jax():
    rng = np.random.RandomState(1)
    N, T, U, V = 4, 6, 3, 11
    jl = rng.randn(N, T, U + 1, V).astype(np.float32)
    refs = rng.randint(0, V - 1, (N, U)).astype(np.int32)
    Tl = rng.randint(2, T + 1, N).astype(np.int32)
    Ul = rng.randint(1, U + 1, N).astype(np.int32)
    exp, eg = jax.jit(
        jax.value_and_grad(lambda j: jt.transducer_loss_from_joint(j, refs, Tl, Ul, blank_idx=-1))
    )(jl)
    j = torch.from_numpy(jl).requires_grad_()
    got = pt.transducer_loss_from_joint(j, *_t(refs, Tl, Ul), blank_idx=-1)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(exp), rtol=1e-6)
    np.testing.assert_allclose(j.grad.numpy(), np.asarray(eg), rtol=0, atol=1e-6)
    with pytest.raises(RuntimeError, match="refs"):
        pt.transducer_loss_from_joint(j, torch.zeros((N, U + 1), dtype=torch.long))


# ----------------------------------------------------- the toy searchers


def _toy(seed=1, N=4, T=6, D=8, V=9):
    """tests/test_transducer.py's ``_toy_searchers``, for both packages."""
    rng = np.random.RandomState(seed)
    enc = rng.randn(N, T, D).astype(np.float32)
    enc_lens = rng.randint(1, T + 1, N).astype(np.int32)
    W1, W2, Emb = ((rng.randn(*s) * 0.7).astype(np.float32) for s in ((D, V), (V, V), (V, V)))
    jW1, jW2, jEmb = map(jnp.asarray, (W1, W2, Emb))
    pW1, pW2, pEmb = _t(W1, W2, Emb)

    def jstep(tok, state):
        new = 0.5 * state + jEmb[tok]
        return new, new

    def jjoint(enc_t, pred_out):
        return jnp.tanh(enc_t @ jW1) + jnp.tanh(pred_out @ jW2)

    def pstep(tok, state):
        new = 0.5 * state + pEmb[tok]
        return new, new

    def pjoint(enc_t, pred_out):
        return torch.tanh(enc_t @ pW1) + torch.tanh(pred_out @ pW2)

    return enc, enc_lens, (jstep, jjoint), (pstep, pjoint), np.zeros((N, V), np.float32)


@pytest.mark.parametrize("E", [1, 2, 4])
def test_greedy_search_matches_jax(E):
    enc, lens, (js, jj), (ps, pj), s0 = _toy()
    eh, el = jax.jit(lambda e, l: jt.transducer_greedy_search(e, l, js, jj, s0, 8, E))(enc, lens)
    gh, gl = pt.transducer_greedy_search(*_t(enc, lens), ps, pj, torch.from_numpy(s0), 8, E)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(el))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(eh))
    assert (np.asarray(el) > 0).any()


def test_greedy_advance_over_chunks_equals_one_shot():
    """Chunks of one, two and three frames per row carry the search."""
    enc, lens, _, (ps, pj), s0 = _toy()
    exp_h, exp_l = pt.transducer_greedy_search(*_t(enc, lens), ps, pj, torch.from_numpy(s0), 8, 3)
    carry = pt.transducer_greedy_init(4, 18, ps, torch.from_numpy(s0), 8)
    o0 = 0
    for size in (1, 2, 3):
        chunk_lens = np.clip(lens - o0, 0, size)
        carry = pt.transducer_greedy_advance(
            torch.from_numpy(enc[:, o0 : o0 + size]), torch.from_numpy(chunk_lens), ps, pj, 8,
            carry, 3,
        )
        o0 += size
    assert torch.equal(carry[1], exp_l) and torch.equal(carry[2], exp_h)


@pytest.mark.parametrize("W,E", [(1, 4), (3, 2), (4, 4)])
def test_beam_search_matches_jax(W, E):
    enc, lens, (js, jj), (ps, pj), s0 = _toy()
    exp = jax.jit(lambda e, l: jt.transducer_beam_search(e, l, js, jj, s0, 8, W, E))(enc, lens)
    got = pt.transducer_beam_search(*_t(enc, lens), ps, pj, torch.from_numpy(s0), 8, W, E)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(exp[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(exp[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(exp[2]), rtol=1e-6, atol=1e-6)
    if W == 1:  # width 1 emits the greedy search's tokens
        gh, gl = pt.transducer_greedy_search(*_t(enc, lens), ps, pj, torch.from_numpy(s0), 8, E)
        for n in range(enc.shape[0]):
            assert gh[n, : gl[n]].tolist() == got[0][n, 0, : got[1][n, 0]].tolist()


def test_beam_search_lm_fusion_matches_jax():
    """The JAX test's last-token-table LM at weights 0 and 0.7: weight 0
    equals the unfused search, and the fused one equals JAX's."""
    enc, lens, (js, jj), (ps, pj), s0 = _toy()
    N, V, W, E = 4, 9, 2, 3
    tbl = np.random.RandomState(9).randn(V, V).astype(np.float32)
    jtbl, ptbl = jnp.asarray(tbl), torch.from_numpy(tbl)
    jlm = (lambda tok, last: (jtbl[tok], tok), jnp.broadcast_to(jtbl[7], (N, V)),
           jnp.zeros((N,), jnp.int32))
    plm = (lambda tok, last: (ptbl[tok], tok), ptbl[7].expand(N, V).clone(),
           torch.zeros((N,), dtype=torch.long))
    bare = pt.transducer_beam_search(*_t(enc, lens), ps, pj, torch.from_numpy(s0), 8, W, E)
    zero = pt.transducer_beam_search(
        *_t(enc, lens), ps, pj, torch.from_numpy(s0), 8, W, E, lm=plm, lm_weight=0.0
    )
    for a, b in zip(bare, zero):
        assert torch.equal(a, b)
    exp = jax.jit(
        lambda e, l: jt.transducer_beam_search(e, l, js, jj, s0, 8, W, E, lm=jlm, lm_weight=0.7)
    )(enc, lens)
    got = pt.transducer_beam_search(
        *_t(enc, lens), ps, pj, torch.from_numpy(s0), 8, W, E, lm=plm, lm_weight=0.7
    )
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(exp[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(exp[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(exp[2]), rtol=1e-6, atol=1e-6)
    assert not torch.equal(got[0], bare[0])


# ---------------------------------------------------------------- the model


def _models(enc_extra=None, seed=0, N=4, T=24, U=5, out_scale=1.0):
    """Both models with the JAX model's weights (``out_scale`` scales the
    joint's output layer), and numpy inputs."""
    enc_kw = dict(ENC, **(enc_extra or {}))
    jcfg = jm.TransducerConfig(encoder=JConfig(dtype=jnp.float32, **enc_kw), pred_dim=12,
                               joint_dim=12)
    pcfg = pm.TransducerConfig(encoder=PConfig(dtype=torch.float32, **enc_kw), pred_dim=12,
                               joint_dim=12)
    rng = np.random.RandomState(seed)
    feats = rng.randn(N, T, 8).astype(np.float32)
    lens = rng.randint(T // 2, T + 1, N).astype(np.int32)
    lens[0] = T
    refs = rng.randint(0, 16, (N, U)).astype(np.int32)
    ref_lens = rng.randint(1, U + 1, N).astype(np.int32)
    jmodel = jm.ConformerTransducer(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), feats, lens, refs, ref_lens)
    params = jax.tree.map(np.asarray, params["params"])
    params["joint"]["out"]["kernel"] = params["joint"]["out"]["kernel"] * out_scale
    pmodel = pm.ConformerTransducer(pcfg, device="cpu")
    pmodel.load_state_dict(pm.state_dict_from_jax(params), strict=True)
    return jmodel, params, pmodel, (feats, lens, refs, ref_lens)


@pytest.fixture(scope="module")
def models():
    return _models()


def test_state_dict_from_jax_covers_every_parameter(models):
    """No parameter exists that the JAX model lacks (PyTorch's LSTM would
    add an input bias), and each is carried across."""
    _, params, pmodel, _ = models
    assert sum(p.numel() for p in pmodel.parameters()) == sum(
        a.size for a in jax.tree.leaves(params)
    )
    names = set(pmodel.state_dict())
    assert "predictor.lstm.if.weight" in names and "predictor.lstm.if.bias" not in names
    assert "encoder.block_1.conv.dw.kernel" in names


def test_encoder_predictor_and_joint_match_jax(models):
    jmodel, params, pmodel, (feats, lens, refs, _) = models
    v = {"params": params}
    enc, enc_lens = jmodel.apply(v, feats, lens, method="encode")
    pred = jmodel.apply(v, jnp.asarray(refs), method=lambda m, r: m.predictor(r))
    joint = jmodel.apply(v, enc[:, :, None], pred[:, None], method=lambda m, e, p: m.joint(e, p))
    with torch.no_grad():
        penc, plens = pmodel.encode(*_t(feats, lens))
        ppred = pmodel.predictor(torch.from_numpy(refs))
        pjoint = pmodel.joint(penc[:, :, None], ppred[:, None])
    np.testing.assert_array_equal(plens.numpy(), np.asarray(enc_lens))
    np.testing.assert_allclose(penc.numpy(), np.asarray(enc), rtol=0, atol=2e-5)
    np.testing.assert_allclose(ppred.numpy(), np.asarray(pred), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pjoint.numpy(), np.asarray(joint), rtol=1e-6, atol=1e-6)


def test_predictor_step_equals_the_sequence(models):
    """The one-step predictor of decoding, iterated, computes the training
    pass's outputs, and equals flax's step."""
    jmodel, params, pmodel, (_, _, refs, _) = models
    N = refs.shape[0]
    toks = np.concatenate([np.full((N, 1), 16, np.int32), refs], 1)
    with torch.no_grad():
        seq = pmodel.predictor(torch.from_numpy(refs))
        carry = pmodel.predictor.init_carry(N)
        step = pmodel.predictor.stepper()
        steps = []
        for u in range(toks.shape[1]):
            out, carry = step(torch.from_numpy(toks[:, u]), carry)
            steps.append(out)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), seq.numpy(), rtol=0, atol=1e-6)
    v = {"params": params}
    jcarry = jmodel.apply(v, N, method=lambda m, n: m.predictor.init_carry(n))
    jout, jcarry = jmodel.apply(
        v, jnp.asarray(toks[:, 0]), jcarry, method=lambda m, t, c: m.predictor.step(t, c)
    )
    np.testing.assert_allclose(steps[0].numpy(), np.asarray(jout), rtol=0, atol=1e-6)


def test_model_loss_matches_jax_and_the_materialized_joint(models, monkeypatch):
    """The streamed joint, all frames in one slab and one frame a slab,
    equals JAX's streamed loss and ``transducer_loss_from_joint`` on the
    materialized joint."""
    jmodel, params, pmodel, (feats, lens, refs, ref_lens) = models
    exp = jmodel.apply({"params": params}, *map(jnp.asarray, (feats, lens, refs, ref_lens)))
    with torch.no_grad():
        got = pmodel(*_t(feats, lens, refs, ref_lens))
        enc, enc_lens = pmodel.encode(*_t(feats, lens))
        pred = pmodel.predictor(torch.from_numpy(refs))
        full = pmodel.joint(enc[:, :, None], pred[:, None])
        materialized = pt.transducer_loss_from_joint(
            full, torch.from_numpy(refs), enc_lens, torch.from_numpy(ref_lens), blank_idx=16
        )
        monkeypatch.setattr(pm, "SLAB_ELEMENTS", 1)
        per_frame = pmodel(*_t(feats, lens, refs, ref_lens))
    with torch.enable_grad():  # the slabs recomputed in the backward pass
        pmodel(*_t(feats, lens, refs, ref_lens)).backward()
    assert all(p.grad is not None for p in pmodel.joint.parameters())
    pmodel.zero_grad(set_to_none=True)
    np.testing.assert_allclose(float(got), float(exp), rtol=1e-5)
    np.testing.assert_allclose(float(materialized), float(got), rtol=1e-6)
    np.testing.assert_allclose(float(per_frame), float(got), rtol=1e-6)


@pytest.mark.parametrize("E", [1, 2, 4])
def test_model_greedy_matches_jax(models, E):
    jmodel, params, pmodel, (feats, lens, _, _) = models
    eh, el = jax.jit(lambda f, l: jmodel.apply({"params": params}, f, l, E, method="greedy"))(
        feats, lens
    )
    gh, gl = pmodel.greedy(*_t(feats, lens), E)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(el))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(eh))


@pytest.mark.parametrize("W,E", [(1, 4), (3, 2), (4, 4)])
def test_model_beam_matches_jax(models, W, E):
    jmodel, params, pmodel, (feats, lens, _, _) = models
    exp = jax.jit(lambda f, l: jmodel.apply({"params": params}, f, l, W, E, method="beam"))(
        feats, lens
    )
    got = pmodel.beam(*_t(feats, lens), W, E)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(exp[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(exp[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(exp[2]), rtol=1e-6, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _lms(V=16, seed=21):
    """A random 3-gram lookup LM in both packages (the port's carried by the
    JAX LM's state dict)."""
    jlm = jlm_mod.LookupLanguageModel(V, sos=V, prob_dicts=random_prob_dicts(V, 3, seed, V))
    plm = plm_mod.LookupLanguageModel(V, sos=V, device="cpu")
    plm.load_state_dict(jlm.state_dict())
    return jlm, plm


def test_lookup_lm_fusion_matches_jax():
    jlm, plm = _lms()
    jstep, jlp0, jctx0 = jm.lookup_lm_fusion(jlm, 3)
    pstep, plp0, pctx0 = pm.lookup_lm_fusion(plm, 3)
    np.testing.assert_array_equal(pctx0.numpy(), np.asarray(jctx0))
    np.testing.assert_allclose(plp0.numpy(), np.asarray(jlp0), rtol=0, atol=1e-6)
    assert plp0.shape == (3, 17)
    tok = np.array([4, 0, 15], np.int32)
    jlp, jctx = jstep(jnp.asarray(tok), jctx0)
    plp, pctx = pstep(torch.from_numpy(tok), pctx0)
    np.testing.assert_array_equal(pctx.numpy(), np.asarray(jctx))
    np.testing.assert_allclose(plp.numpy(), np.asarray(jlp), rtol=0, atol=1e-6)


@pytest.mark.parametrize("W,E", [(3, 2), (4, 4)])
def test_model_beam_with_lookup_lm_matches_jax(models, W, E):
    jmodel, params, pmodel, (feats, lens, _, _) = models
    jlm, plm = _lms()
    exp = jax.jit(
        lambda f, l: jmodel.apply({"params": params}, f, l, W, E, jlm, 0.4, method="beam")
    )(feats, lens)
    got = pmodel.beam(*_t(feats, lens), W, E, lm=plm, lm_weight=0.4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(exp[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(exp[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(exp[2]), rtol=1e-6, atol=1e-6)
    bare = pmodel.beam(*_t(feats, lens), W, E)
    assert not torch.equal(got[2], bare[2])
    with pytest.raises(RuntimeError, match="vocab"):
        pmodel.beam(*_t(feats, lens), W, E, lm=_lms(V=12)[1])


def _keep_grads():
    """An optax transformation that passes the gradients on and keeps them
    as its state, so the JAX step hands them back."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda g, state, params=None: (g, g),
    )


def test_train_step_matches_jax(models):
    """One ``make_transducer_train_step`` step with AdamW at dropout 0 (no
    augmentation): the loss, every gradient (within 1e-5 of its tensor's
    largest entry) and every parameter after the step (within atol 1e-6;
    the attention key biases, whose true gradient is 0, within one
    learning rate of where they were on both)."""
    jmodel, params, _, data = models
    opt = optax.chain(_keep_grads(), optax.adamw(LR))
    jstep = jax.jit(jm.make_transducer_train_step(jmodel, opt))
    new_params, (egrads, _), eloss = jstep(
        params, opt.init(params), jax.random.PRNGKey(1), *map(jnp.asarray, data)
    )
    egrads = pm.state_dict_from_jax(jax.tree.map(np.asarray, egrads))
    expect = pm.state_dict_from_jax(jax.tree.map(np.asarray, new_params))

    pmodel = pm.ConformerTransducer(models[2].cfg, device="cpu")  # a copy to step
    pmodel.load_state_dict(pm.state_dict_from_jax(params), strict=True)
    before = {k: v.detach().clone() for k, v in pmodel.named_parameters()}
    step = pm.make_transducer_train_step(pmodel, pm_adamw(pmodel))
    loss = step(torch.Generator().manual_seed(0), *_t(*data))
    np.testing.assert_allclose(float(loss), float(eloss), rtol=1e-5)
    for name, p in pmodel.named_parameters():
        g, eg = p.grad, egrads[name]
        scale = float(eg.abs().max())
        if name.endswith("attn.key.bias"):
            assert float(g.abs().max()) < 1e-6
            for q in (p.detach(), expect[name]):
                assert float((q - before[name]).abs().max()) <= LR * 1.01
            continue
        np.testing.assert_allclose(g.numpy(), eg.numpy(), rtol=0, atol=1e-5 * scale,
                                   err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), expect[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


def pm_adamw(model):
    from pydrobert_tpu_torch.models import adamw

    return adamw(model.parameters(), LR)


def test_training_on_cpu_lowers_the_loss():
    """Ten steps with dropout on: every loss finite, the last below the
    first."""
    cfg = pm.TransducerConfig(
        encoder=PConfig(dtype=torch.float32, **dict(ENC, dropout=0.1)), pred_dim=12, joint_dim=12
    )
    model = pm.ConformerTransducer(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    feats = torch.randn(4, 24, 8, generator=gen)
    lens = torch.tensor([24, 20, 16, 13])
    refs = torch.randint(0, 16, (4, 4), generator=gen)
    ref_lens = torch.tensor([4, 3, 2, 1])
    step = pm.make_transducer_train_step(model, pm_adamw(model))
    losses = [float(step(gen, feats, lens, refs, ref_lens)) for _ in range(10)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# ------------------------------------------------------------- streaming


@pytest.fixture(scope="module")
def causal():
    return _models(CAUSAL, seed=1, N=3, T=48)


@pytest.mark.parametrize("T,chunk", [(41, 3), (48, 6)])
def test_streaming_greedy_matches_one_shot_and_jax(causal, T, chunk):
    """Ragged streams, the shortest half the longest (the JAX test's
    cases): the streamed search equals the port's one-shot greedy, which
    equals the JAX model's."""
    jmodel, params, pmodel, (feats, _, _, _) = causal
    feats = feats[:, :T]
    lens = np.array([T, max(T - 9, 3), max(T // 2, 2)], np.int32)
    got = pm.streaming_transducer_greedy(pmodel, *_t(feats, lens), chunk, 3)
    one_shot = pmodel.greedy(*_t(feats, lens), 3)
    exp = jax.jit(lambda f, l: jmodel.apply({"params": params}, f, l, 3, method="greedy"))(
        feats, lens
    )
    for g, o, e in zip(got, one_shot, exp):
        assert torch.equal(g, o)
        np.testing.assert_array_equal(o.numpy(), np.asarray(e))


@pytest.mark.parametrize("fused", [False, True])
def test_streaming_beam_matches_one_shot_and_jax(causal, fused):
    """The JAX test's case (T=44, chunk 5, W=3, E=2), bare and fused with a
    3-gram lookup LM: the streamed search equals the port's one-shot beam
    search (scores within rtol 1e-6: the window encoder sums in another
    order), which equals the JAX model's."""
    jmodel, params, pmodel, (feats, _, _, _) = causal
    T = 44
    feats = feats[:, :T]
    lens = np.array([T, T - 9, T // 2], np.int32)
    jlm, plm = _lms(seed=5) if fused else (None, None)
    got = pm.streaming_transducer_beam(pmodel, *_t(feats, lens), 5, width=3,
                                       max_symbols_per_frame=2, lm=plm, lm_weight=0.4)
    one_shot = pmodel.beam(*_t(feats, lens), 3, 2, lm=plm, lm_weight=0.4)
    assert torch.equal(got[0], one_shot[0]) and torch.equal(got[1], one_shot[1])
    np.testing.assert_allclose(got[2].numpy(), one_shot[2].numpy(), rtol=1e-6, atol=1e-5)
    exp = jax.jit(
        lambda f, l: jmodel.apply({"params": params}, f, l, 3, 2, jlm, 0.4, method="beam")
    )(feats, lens)
    np.testing.assert_array_equal(one_shot[1].numpy(), np.asarray(exp[1]))
    np.testing.assert_array_equal(one_shot[0].numpy(), np.asarray(exp[0]))
    np.testing.assert_allclose(one_shot[2].numpy(), np.asarray(exp[2]), rtol=1e-6, atol=1e-6)


def test_streaming_rejects_noncausal_configs(models):
    _, _, pmodel, (feats, lens, _, _) = models
    for fn in (pm.streaming_transducer_greedy, pm.streaming_transducer_beam):
        with pytest.raises(ValueError, match="causal"):
            fn(pmodel, *_t(feats, lens), 4)
    cfg = dataclasses.replace(pmodel.cfg.encoder, **CAUSAL)
    model = pm.ConformerTransducer(pm.TransducerConfig(cfg, 12, 12), device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        pm.streaming_transducer_greedy(model, *_t(feats, lens), 0)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_transducer_loss_from_joint_half_precision_log_softmax(dtype, monkeypatch):
    """The joint's log-softmax in its dtype with jax.nn's rounding steps
    (ROADMAP C7). The JAX package's loss does not run on half-precision
    joints (its scan concatenates float32 and half arrays), so the node
    log-probabilities handed to the loss are held to ``jax.nn.log_softmax``
    of the same joint, as the JAX package computes them: float16 bit-exact,
    bfloat16 within one bfloat16 ulp."""
    rng = np.random.RandomState(4)
    N, T, U, V = 3, 5, 2, 13
    jl = (rng.randn(N, T, U + 1, V) * 3).astype(np.float32)
    refs = rng.randint(0, V - 1, (N, U))
    seen = {}
    monkeypatch.setattr(pt, "transducer_loss", lambda b, e, *a, **k: seen.update(b=b, e=e))
    pt.transducer_loss_from_joint(torch.from_numpy(jl).to(getattr(torch, dtype)),
                                  torch.from_numpy(refs))
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(jl).astype(getattr(jnp, dtype)), -1)
                    .astype(jnp.float32))
    emit = np.take_along_axis(lp[:, :, :U], refs[:, None, :, None], 3)[..., 0]
    for got, exp in ((seen["b"], lp[..., -1]), (seen["e"], emit)):
        got = got.float().numpy()
        if dtype == "float16":
            np.testing.assert_array_equal(got, exp)
        else:  # one bfloat16 ulp: float32's spacing times 2 ** 16
            assert (np.abs(got - exp) <= np.spacing(np.abs(exp)) * 2.0**16).all()
