"""The port's training step against the JAX package's: the CTC loss, every
gradient and the parameters after AdamW steps (d32/L2/H2/V11, float32,
dropout 0, the same SpecAugment parameters in both), then dropout's own
statistics, which cannot match JAX's bits. Each test states its
tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pydrobert_tpu.models import conformer as jconf
from pydrobert_tpu.ops import img as jimg
from pydrobert_tpu_torch.models import conformer as pconf
from pydrobert_tpu_torch.ops import img as pimg

TINY = dict(
    vocab_size=11, num_filts=10, d_model=32, num_layers=2, num_heads=2,
    subsample_channels=4, conv_kernel=7,
)
LR = 1e-3


@pytest.fixture(scope="module")
def setup():
    """Feasible lengths throughout: every reference fits its frames, where
    torch gives inf and optax a large finite loss."""
    rng = np.random.RandomState(0)
    N, T, U = 4, 60, 6
    feats = rng.randn(N, T, TINY["num_filts"]).astype(np.float32)
    lens = np.array([60, 52, 41, 30], np.int32)
    refs = rng.randint(0, TINY["vocab_size"], (N, U)).astype(np.int32)
    ref_lens = np.array([6, 5, 3, 2], np.int32)
    jcfg = jconf.ConformerConfig(dtype=jnp.float32, dropout=0.0, **TINY)
    jmodel = jconf.ConformerCTC(jcfg)
    params = jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(lens)
    )["params"]
    sa = jimg.spec_augment_draw_parameters(
        jax.random.PRNGKey(1), jnp.asarray(feats), 5.0, 0.0, 5, 3, 0.2, 2, 0.1, 1,
        lengths=jnp.asarray(lens, jnp.float32),
    )
    sa = [None if p is None else np.array(p) for p in sa]
    return jmodel, params, sa, (feats, lens, refs, ref_lens)


def _port(params, sa, dropout=0.0):
    cfg = pconf.ConformerConfig(dtype=torch.float32, dropout=dropout, **TINY)
    model = pconf.ConformerCTC(cfg, device="cpu")
    model.load_state_dict(
        pconf.state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True
    )

    def augment(generator, feats, lens):
        return pimg.spec_augment_apply_parameters(
            feats, [None if p is None else torch.from_numpy(p) for p in sa],
            lengths=lens.float(),
        )

    return model, augment


def test_ctc_loss_matches_optax(setup):
    """Mean per-utterance loss within rtol 1e-6 (about 2e-7 relative
    apart in float32 at losses near 100)."""
    rng = np.random.RandomState(1)
    N, T, V, U = 4, 60, 11, 20
    logits = (rng.randn(N, T, V) * 3).astype(np.float32)
    lens = np.array([60, 45, 33, 21], np.int32)
    refs = rng.randint(0, V - 1, (N, U)).astype(np.int32)
    ref_lens = np.array([20, 11, 7, 1], np.int32)
    exp = jconf.ctc_loss(*(jnp.asarray(a) for a in (logits, lens, refs, ref_lens)), V - 1)
    got = pconf.ctc_loss(
        *(torch.from_numpy(a) for a in (logits, lens, refs, ref_lens)), V - 1
    )
    np.testing.assert_allclose(float(got), float(exp), rtol=1e-6)


def test_loss_and_gradients_match_jax(setup):
    """Loss within rtol 1e-6, every gradient within atol 1e-5 (float32,
    sums in another order)."""
    jmodel, params, sa, (feats, lens, refs, ref_lens) = setup

    def jloss(p):
        f = jimg.spec_augment_apply_parameters(
            jnp.asarray(feats), sa, lengths=jnp.asarray(lens, jnp.float32)
        )
        logits, out_lens = jmodel.apply(
            {"params": p}, f, jnp.asarray(lens), deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(2)},
        )
        return jconf.ctc_loss(
            logits, out_lens, jnp.asarray(refs), jnp.asarray(ref_lens),
            TINY["vocab_size"],
        )

    eloss, egrads = jax.value_and_grad(jloss)(params)
    egrads = pconf.state_dict_from_jax(jax.tree.map(np.asarray, egrads))
    model, augment = _port(params, sa)
    f = augment(None, torch.from_numpy(feats), torch.from_numpy(lens))
    logits, out_lens = model(f, torch.from_numpy(lens), deterministic=False)
    loss = pconf.ctc_loss(
        logits, out_lens, torch.from_numpy(refs), torch.from_numpy(ref_lens),
        TINY["vocab_size"],
    )
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(eloss), rtol=1e-6)
    names = dict(model.named_parameters())
    assert set(names) == set(egrads)
    for name, p in names.items():
        np.testing.assert_allclose(
            p.grad.numpy(), egrads[name].numpy(), atol=1e-5, rtol=0, err_msg=name
        )


def test_adamw_steps_match_jax(setup):
    """Three steps of make_train_step with AdamW (optax's defaults): each
    loss within rtol 1e-5, every parameter within atol 1e-5 afterwards,
    except the attention key biases. Softmax is blind to a key bias, so
    its true gradient is 0 and both frameworks compute rounding noise
    (below 1e-6); Adam divides that noise by its own root mean square,
    so each framework moves those biases by up to the learning rate in a
    direction of its own. They are held to that: gradients below 1e-6,
    and no more than one learning rate of movement per step."""
    jmodel, params, sa, data = setup
    jstep = jax.jit(
        jconf.make_train_step(
            jmodel, optax.adamw(LR),
            lambda key, f, l: jimg.spec_augment_apply_parameters(
                f, sa, lengths=l.astype(jnp.float32)
            ),
        )
    )
    model, augment = _port(params, sa)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    step = pconf.make_train_step(model, pconf.adamw(model.parameters(), LR), augment)
    opt_state = optax.adamw(LR).init(params)
    steps = 3
    for i in range(steps):
        params, opt_state, eloss = jstep(
            params, opt_state, jax.random.PRNGKey(i), *(jnp.asarray(a) for a in data)
        )
        loss = step(torch.Generator().manual_seed(i), *(torch.from_numpy(a) for a in data))
        np.testing.assert_allclose(float(loss), float(eloss), rtol=1e-5)
    expect = pconf.state_dict_from_jax(jax.tree.map(np.asarray, params))
    for name, param in model.named_parameters():
        p = param.detach()
        if name.endswith("attn.key.bias"):
            assert float(param.grad.abs().max()) < 1e-6
            for q in (p, expect[name]):
                assert float((q - before[name]).abs().max()) <= steps * LR * 1.01
        else:
            np.testing.assert_allclose(
                p.numpy(), expect[name].numpy(), atol=1e-5, rtol=0, err_msg=name
            )


def test_fast_dropout_statistics():
    """Drop fraction within 4 standard deviations of cutoff/256, kept
    values scaled by exactly 256/(256 - cutoff) rounded to the dtype, the
    same mask from the same seed, and the edges of the rate."""
    x = torch.ones((512, 1024))
    for rate in (0.1, 0.3, 0.5):
        drop = pconf._FastDropout(rate)
        cutoff = min(round(rate * 256), 255)
        y = drop(x, deterministic=False, generator=torch.Generator().manual_seed(3))
        p = cutoff / 256
        frac = float((y == 0).float().mean())
        assert abs(frac - p) < 4 * np.sqrt(p * (1 - p) / x.numel())
        kept = y[y != 0]
        assert bool((kept == 256 / (256 - cutoff)).all())
        again = drop(x, deterministic=False, generator=torch.Generator().manual_seed(3))
        assert torch.equal(y, again)
    xb = x.to(torch.bfloat16)
    yb = pconf._FastDropout(0.1)(xb, False, torch.Generator().manual_seed(0))
    assert yb.dtype == torch.bfloat16
    scale = float(torch.tensor(256 / 230, dtype=torch.bfloat16))
    assert bool((yb[yb != 0].float() == scale).all())
    assert pconf._FastDropout(0.0)(x, False) is x
    assert pconf._FastDropout(0.001)(x, False) is x  # below 1/512: a no-op
    assert pconf._FastDropout(0.5)(x, True) is x  # deterministic
    assert not pconf._FastDropout(1.0)(x, False).any()


def test_attention_dropout_follows_flax(monkeypatch):
    """One keep mask of (T, T) shared by every utterance and head, kept
    weights divided by the keep probability."""
    cfg = pconf.ConformerConfig(dtype=torch.float32, attn_dropout=0.25, **TINY)
    attn = pconf._Attention(cfg)
    N, T, d = 3, 24, TINY["d_model"]
    H = TINY["num_heads"]
    y = torch.randn(N, T, d, generator=torch.Generator().manual_seed(0))
    mask = torch.ones((N, 1, 1, T), dtype=torch.bool)
    weights = []
    real = torch.matmul

    def spy(a, b):  # the (N, H, T, T) weights times the values
        if a.shape == (N, H, T, T):
            weights.append(a.detach().clone())
        return real(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    attn(y, mask, False, torch.Generator().manual_seed(1))
    attn(y, mask)
    monkeypatch.undo()
    dropped, plain = weights
    ratio = dropped / plain
    keep = ratio != 0
    assert bool((keep == keep[0, 0]).all())  # shared over batch and heads
    assert bool(torch.allclose(ratio[keep], torch.tensor(1 / 0.75)))
    frac = 1 - float(keep[0, 0].float().mean())
    assert abs(frac - 0.25) < 4 * np.sqrt(0.25 * 0.75 / T**2)


def test_training_on_cpu_lowers_the_loss():
    """20 steps with SpecAugment and dropout on: the last loss is below
    the first, every loss finite."""
    cfg = pconf.ConformerConfig(dtype=torch.float32, attn_dropout=0.1, **TINY)
    model = pconf.ConformerCTC(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    feats = torch.randn(4, 60, TINY["num_filts"], generator=gen)
    lens = torch.tensor([60, 50, 40, 33])
    refs = torch.randint(0, TINY["vocab_size"], (4, 6), generator=gen)
    ref_lens = torch.tensor([6, 5, 3, 2])

    def augment(g, f, l):
        return pimg.spec_augment(
            g, f, max_time_warp=5.0, max_time_mask=5, max_freq_mask=3, lengths=l.float()
        )

    step = pconf.make_train_step(model, pconf.adamw(model.parameters(), 3e-3), augment)
    losses = [float(step(gen, feats, lens, refs, ref_lens)) for _ in range(20)]
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.75 * losses[0]


def test_adamw_takes_optax_defaults():
    opt = pconf.adamw([torch.nn.Parameter(torch.zeros(2))], 1e-3)
    group = opt.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["weight_decay"] == 1e-4 and group["lr"] == 1e-3
