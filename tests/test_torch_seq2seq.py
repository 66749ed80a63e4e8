"""The port's attention seq2seq model and its minimum-error-rate training
step against the JAX package's (``tests/test_models.py``'s sizes: vocab 8,
hidden 12, T = 11, ragged lengths [11, 8, 4]). The port's weights come
from the flax tree by ``state_dict_from_jax``; inputs from numpy seeds.

Tolerances: the encoder at every frame, padding included, and a decoder
step within atol 1e-6; log probabilities within 1e-5; the MER step's loss
within rtol 1e-5, every gradient within 1e-5 of its tensor's largest
entry, and the parameters after 3 Adam steps within atol 1e-5. Both steps
take the same hypotheses: each package's ``RandomWalk`` is replaced, for
the test, by one that returns a fixed sample."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pydrobert_tpu.ops.decoding as jdec
from pydrobert_tpu.models import seq2seq as js2s
from pydrobert_tpu_torch.models import seq2seq as ps2s
from pydrobert_tpu_torch.ops import decoding as pdec

CFG = dict(vocab_size=8, num_filts=5, enc_hidden=12, dec_hidden=12, embed_dim=6, attn_hidden=10)
LENS = np.array([11, 8, 4], np.int32)
EOS, M, S = 0, 3, 6


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    feats = rng.randn(3, 11, 5).astype(np.float32)
    jmodel = js2s.AttentionSeq2Seq(js2s.Seq2SeqConfig(**CFG))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(LENS))
    return jmodel, params, feats


def port_model(params):
    model = ps2s.AttentionSeq2Seq(ps2s.Seq2SeqConfig(**CFG), device="cpu")
    model.load_state_dict(ps2s.state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return model


def test_state_dict_from_jax_covers_every_parameter(setup):
    """No parameter exists that the JAX model lacks (PyTorch's GRU would
    add two recurrent biases), and every one is carried across."""
    jmodel, params, _ = setup
    model = port_model(params)
    n_jax = sum(np.asarray(a).size for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert not any(k.endswith(("hr.bias", "hz.bias")) for k in model.state_dict())


def test_encoder_matches_jax_at_every_frame(setup):
    """Padded frames included: flax runs the cell through the padding, and
    so does the port (nothing is packed)."""
    jmodel, params, feats = setup
    enc, mask = jmodel.apply(params, jnp.asarray(feats), jnp.asarray(LENS),
                             method=js2s.AttentionSeq2Seq.encode)
    with torch.no_grad():
        penc, pmask = port_model(params).encode(torch.from_numpy(feats), torch.from_numpy(LENS))
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(mask))
    assert not np.asarray(mask).all()
    np.testing.assert_allclose(penc.numpy(), np.asarray(enc), rtol=0, atol=1e-6)


def test_decoder_step_matches_jax(setup):
    jmodel, params, feats = setup
    rng = np.random.RandomState(1)
    enc = rng.randn(3, 11, 12).astype(np.float32)
    mask = np.arange(11)[None] < LENS[:, None]
    hidden = rng.randn(3, 12).astype(np.float32)
    tok = np.array([8, 3, 0], np.int32)  # the sos slot, then tokens
    logits, new_h = jmodel.apply(params, *(jnp.asarray(a) for a in (tok, hidden, enc, mask)),
                                 method=js2s.AttentionSeq2Seq.step)
    with torch.no_grad():
        pl, ph = port_model(params).step(*(torch.from_numpy(a) for a in (tok, hidden, enc, mask)))
    np.testing.assert_allclose(pl.numpy(), np.asarray(logits), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ph.numpy(), np.asarray(new_h), rtol=0, atol=1e-6)


def test_decoder_lm_matches_jax(setup):
    """The LM protocol: full log-probabilities over a history (the sos slot
    first), a step at per-row indices, and update_input's guard."""
    jmodel, params, feats = setup
    jlm = js2s.Seq2SeqDecoderLM(jmodel, params)
    plm = ps2s.Seq2SeqDecoderLM(port_model(params))
    hist = np.random.RandomState(2).randint(0, 8, (5, 3)).astype(np.int32)
    jstate = jlm.initial_state(jnp.asarray(feats), jnp.asarray(LENS))
    exp = np.asarray(jlm(jnp.asarray(hist), dict(jstate)))
    with torch.no_grad():
        pstate = plm.initial_state(torch.from_numpy(feats), torch.from_numpy(LENS))
        got = plm(torch.from_numpy(hist), dict(pstate)).numpy()
    assert got.shape == (6, 3, 8)
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-5)
    idx = np.array([0, 3, 5])
    exp_i, _ = jlm(jnp.asarray(hist), dict(jstate), idx=jnp.asarray(idx))
    with torch.no_grad():
        got_i, _ = plm(torch.from_numpy(hist), dict(pstate), idx=torch.from_numpy(idx))
    np.testing.assert_allclose(got_i.numpy(), np.asarray(exp_i), rtol=0, atol=1e-5)
    with pytest.raises(RuntimeError):
        plm(torch.from_numpy(hist), {}, idx=0)


class _FixedWalk:
    """A ``RandomWalk`` stand-in that returns one fixed sample, so that the
    two packages' steps score the same hypotheses."""

    sample = None  # (y (S, N * M), y_lens (N * M,)) as numpy

    def __init__(self, lm, eos=None):
        pass


class _JaxWalk(_FixedWalk):
    def __call__(self, key, state, batch_size, max_iters):
        y, y_lens = self.sample
        return jnp.asarray(y), jnp.asarray(y_lens), jnp.zeros((batch_size,))


class _PortWalk(_FixedWalk):
    def __call__(self, generator, state, batch_size, max_iters):
        y, y_lens = self.sample
        return torch.from_numpy(y).long(), torch.from_numpy(y_lens).long(), torch.zeros(batch_size)


def _record_grads():
    """An optax transformation that applies no update and keeps the
    gradients as its state, so the JAX step hands them back."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda g, state, params=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


@pytest.fixture()
def mer_setup(setup, monkeypatch):
    jmodel, params, feats = setup
    rng = np.random.RandomState(3)
    refs = rng.randint(1, 8, (3, 4)).astype(np.int32)
    ref_lens = np.array([4, 3, 2], np.int32)
    # a sample from the port's own walk: some paths end in eos, some not
    plm = ps2s.Seq2SeqDecoderLM(port_model(params))
    with torch.no_grad():
        st = plm.initial_state(torch.from_numpy(feats), torch.from_numpy(LENS))
        tiled = {k: v.repeat_interleave(M, 0) for k, v in st.items()}
        y, y_lens, _ = pdec.RandomWalk(plm, eos=EOS)(
            torch.Generator().manual_seed(5), tiled, 3 * M, S
        )
    y_lens_np = y_lens.numpy().astype(np.int32)
    assert 0 < (y_lens_np < S).sum() < 3 * M  # both kinds of path
    _FixedWalk.sample = (y.numpy().astype(np.int32), y_lens_np)
    monkeypatch.setattr(jdec, "RandomWalk", _JaxWalk)
    monkeypatch.setattr(pdec, "RandomWalk", _PortWalk)
    args = (feats, LENS, refs, ref_lens)
    return jmodel, params, args


def test_mer_step_loss_and_gradients_match_jax(mer_setup):
    jmodel, params, args = mer_setup
    opt = _record_grads()
    jstep = jax.jit(js2s.make_mer_train_step(jmodel, opt, num_samples=M, max_iters=S, eos=EOS))
    _, grads, jloss = jstep(params, opt.init(params), jax.random.PRNGKey(0),
                            *(jnp.asarray(a) for a in args))
    model = port_model(params)
    pstep = ps2s.make_mer_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                                     num_samples=M, max_iters=S, eos=EOS)
    ploss = pstep(None, *(torch.from_numpy(a) for a in args))
    assert np.isfinite(float(jloss)) and float(jloss) != 0.0
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    exp = ps2s.state_dict_from_jax(jax.tree.map(np.asarray, grads))
    for name, p in model.named_parameters():
        g, e = p.grad, exp[name]
        scale = float(e.abs().max())
        assert float((g - e).abs().max()) <= 1e-5 * max(scale, 1e-30), name


def test_mer_step_three_adam_steps_match_jax(mer_setup):
    jmodel, params, args = mer_setup
    opt = optax.adam(1e-3)
    jstep = jax.jit(js2s.make_mer_train_step(jmodel, opt, num_samples=M, max_iters=S, eos=EOS))
    model = port_model(params)
    pstep = ps2s.make_mer_train_step(model, ps2s.adam(model.parameters(), 1e-3),
                                     num_samples=M, max_iters=S, eos=EOS)
    jp, jst = params, opt.init(params)
    for i in range(3):
        jp, jst, jloss = jstep(jp, jst, jax.random.PRNGKey(i), *(jnp.asarray(a) for a in args))
        ploss = pstep(None, *(torch.from_numpy(a) for a in args))
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    exp = ps2s.state_dict_from_jax(jax.tree.map(np.asarray, jp))
    moved = 0.0
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), exp[name].numpy(), rtol=0, atol=1e-5, err_msg=name)
        moved = max(moved, float((exp[name] - ps2s.state_dict_from_jax(
            jax.tree.map(np.asarray, params))[name]).abs().max()))
    assert moved > 1e-3  # Adam moved the weights by about 3 lr


def test_mer_step_samples_from_the_walk(setup):
    """Without the stand-in the step draws its own hypotheses from the
    generator: finite losses, and the weights move."""
    jmodel, params, feats = setup
    model = port_model(params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = ps2s.make_mer_train_step(model, ps2s.adam(model.parameters(), 1e-2),
                                    num_samples=M, max_iters=S, eos=EOS)
    rng = np.random.RandomState(4)
    refs = torch.from_numpy(rng.randint(1, 8, (3, 4)))
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(gen, torch.from_numpy(feats), torch.from_numpy(LENS), refs,
                         torch.tensor([4, 3, 2]))) for _ in range(2)]
    assert all(np.isfinite(losses))
    assert max(float((model.state_dict()[k] - v).abs().max()) for k, v in before.items()) > 0
