"""The port's mixture-of-experts blocks and remat against the JAX
package's: ``_MoEFeedForward`` and the whole MoE ``ConformerCTC`` with the
same parameters (carried by ``state_dict_from_jax``), ``moe_aux_loss``, the
float32 training steps of the CTC and transducer models, and remat's
gradients with dropout on. Each test states its tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pydrobert_tpu.models import conformer as jconf
from pydrobert_tpu.models import transducer as jtrans
from pydrobert_tpu_torch.models import conformer as pconf
from pydrobert_tpu_torch.models import transducer as ptrans

TINY = dict(
    vocab_size=11, num_filts=10, d_model=32, num_layers=2, num_heads=2,
    subsample_channels=4, conv_kernel=7,
)
MOE = dict(num_experts=4, expert_top_k=2, expert_capacity_factor=1.25)
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, N=4, T=40):
    rng = np.random.RandomState(seed)
    feats = rng.randn(N, T, TINY["num_filts"]).astype(np.float32)
    lens = np.array([T, 33, 21, 9][:N], np.int32)
    return feats, lens


def _pair(seed, dtype="float32", dropout=0.0, **extra):
    jdt, pdt = DT[dtype]
    kw = dict(TINY, **MOE)
    kw.update(extra)
    jcfg = jconf.ConformerConfig(dtype=jdt, dropout=dropout, **kw)
    pcfg = pconf.ConformerConfig(dtype=pdt, dropout=dropout, **kw)
    feats, lens = _inputs(seed)
    jmodel = jconf.ConformerCTC(jcfg)
    params = jmodel.init(
        jax.random.PRNGKey(seed), jnp.asarray(feats), jnp.asarray(lens)
    )["params"]
    params = jax.tree.map(np.asarray, params)
    pmodel = pconf.ConformerCTC(pcfg, device="cpu")
    pmodel.load_state_dict(pconf.state_dict_from_jax(params), strict=True)
    return jmodel, params, pmodel, feats, lens


def _moe_layer(seed, dtype, k, cf, tie=False):
    """One ``_MoEFeedForward`` in each package on the same (N, T, d) input
    and padding; ``tie`` zeroes the router so every expert ties."""
    jdt, pdt = DT[dtype]
    d = 16
    kw = dict(TINY, d_model=d, num_experts=4, expert_top_k=k, expert_capacity_factor=cf)
    jcfg = jconf.ConformerConfig(dtype=jdt, dropout=0.0, **kw)
    pcfg = pconf.ConformerConfig(dtype=pdt, dropout=0.0, **kw)
    rng = np.random.RandomState(seed)
    N, T = 3, 11
    x = rng.randn(N, T, d).astype(np.float32)
    mask = np.arange(T)[None] < np.array([11, 7, 3])[:, None]
    jlayer = jconf._MoEFeedForward(jcfg)
    variables = jlayer.init(
        jax.random.PRNGKey(seed), jnp.asarray(x, jdt), jnp.asarray(mask), True
    )
    params = jax.tree.map(np.asarray, variables["params"])
    if tie:
        params["gate"] = jax.tree.map(np.zeros_like, params["gate"])
    else:  # biased experts so a capacity of 0.5 drops tokens
        params["gate"]["bias"] = np.array([1.5, 0.5, 0.0, -1.0], np.float32)
    (jout, jmut) = jlayer.apply(
        {"params": params}, jnp.asarray(x, jdt), jnp.asarray(mask), True,
        mutable=["losses"],
    )
    player = pconf._MoEFeedForward(pcfg)
    sd = {"ln.weight": params["ln"]["scale"], "ln.bias": params["ln"]["bias"]}
    sd["gate.weight"] = params["gate"]["kernel"].T
    sd["gate.bias"] = params["gate"]["bias"]
    sd.update({w: params[w] for w in ("wi", "bi", "wo", "bo")})
    player.load_state_dict({k_: torch.tensor(np.asarray(v)) for k_, v in sd.items()})
    with torch.no_grad():
        pout, paux = player(
            torch.tensor(x).to(pdt), torch.from_numpy(mask), deterministic=True
        )
        route = player.route(player.ln(torch.tensor(x).to(pdt)), torch.from_numpy(mask))
    return (jout, jconf.moe_aux_loss(jmut)), (pout, paux), route, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,cf", [(1, 1.25), (2, 1.25), (2, 0.5)], ids=["k1", "k2", "k2_drop"])
def test_moe_layer_matches_flax(dtype, k, cf):
    """float32: within atol 1e-6 at outputs below 0.5 (measured: at most
    1.2e-7, 4 ulps, on about half the entries; the expert products are
    float32 matrix products in both, summed in other orders, while
    dispatch and combine add no rounding of their own). bfloat16: within
    one bfloat16 ulp of the output's scale (atol 2**-7 * max|out|;
    measured 2**-9). The aux loss within rtol 1e-6."""
    (jout, jaux), (pout, paux), route, mask = _moe_layer(5, dtype, k, cf)
    jout = np.asarray(jout.astype(jnp.float32))
    pout = pout.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(pout, jout, atol=1e-6, rtol=0)
    else:
        np.testing.assert_allclose(pout, jout, atol=2**-7 * np.abs(jout).max(), rtol=0)
    np.testing.assert_allclose(float(paux), float(jaux), rtol=1e-6)
    keep = route["keep"].numpy()
    if cf < 1:
        assert not keep[mask.reshape(-1)].all()  # the capacity drops tokens
    # padded frames never route: they get nothing but the expert biases' 0
    assert not keep[~mask.reshape(-1)].any()
    assert not pout.reshape(-1, pout.shape[-1])[~mask.reshape(-1)].any()


@pytest.mark.parametrize("k", [1, 2])
def test_moe_router_ties_take_lax_top_k_order(k):
    """A zero router ties every expert: lax.top_k takes the lowest indices
    first, and so does the port; outputs bit-exact in float32."""
    (jout, jaux), (pout, paux), route, mask = _moe_layer(6, "float32", k, 4.0, tie=True)
    valid = mask.reshape(-1)
    assert (route["experts"].numpy()[valid] == np.arange(k)).all()
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(paux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_conformer_forward_and_aux_match_flax(dtype):
    """The whole MoE ConformerCTC: float32 logits within atol 2e-4 (the
    dense model's bound), bfloat16 within 0.1 (bf16 layers compound), the
    per-block aux losses summed by moe_aux_loss within rtol 1e-5 in
    float32 and 1e-3 in bfloat16 (the routers read bf16 activations that
    the earlier layers rounded apart; the single layer holds 1e-6)."""
    jmodel, params, pmodel, feats, lens = _pair(3, dtype)
    (elogits, elens), muts = jmodel.apply(
        {"params": params}, jnp.asarray(feats), jnp.asarray(lens), mutable=["losses"]
    )
    with torch.no_grad():
        logits, out_lens, aux = pmodel(
            torch.from_numpy(feats), torch.from_numpy(lens), return_aux=True
        )
    assert len(aux) == TINY["num_layers"]
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(elens))
    atol = 2e-4 if dtype == "float32" else 0.1
    np.testing.assert_allclose(logits.numpy(), np.asarray(elogits), atol=atol, rtol=0)
    np.testing.assert_allclose(
        float(pconf.moe_aux_loss(aux)), float(jconf.moe_aux_loss(muts)),
        rtol=1e-5 if dtype == "float32" else 1e-3,
    )


def test_moe_state_dict_covers_every_parameter():
    _, params, pmodel, _, _ = _pair(4)
    sd = pconf.state_dict_from_jax(params)
    assert set(sd) == set(pmodel.state_dict())
    assert sd["block_0.moe.wi"].shape == (4, 32, 128)
    assert sd["block_0.moe.gate.weight"].shape == (4, 32)
    assert sum(np.asarray(v).size for v in jax.tree.leaves(params)) == sum(
        v.numel() for v in sd.values()
    )


def test_moe_aux_loss_of_no_blocks_is_zero():
    assert float(pconf.moe_aux_loss([])) == 0.0
    assert float(jconf.moe_aux_loss({})) == 0.0


def test_moe_train_step_matches_jax():
    """make_train_step on the MoE model: loss (CTC + 0.01 aux) within
    rtol 1e-6, every gradient within atol 1e-5 (the dense step's bounds),
    then three AdamW steps' losses within rtol 1e-5 (float32, dropout 0)."""
    jmodel, params, pmodel, feats, lens = _pair(7)
    rng = np.random.RandomState(8)
    refs = rng.randint(0, TINY["vocab_size"], (4, 4)).astype(np.int32)
    ref_lens = np.array([4, 3, 2, 1], np.int32)
    data = (feats, lens, refs, ref_lens)

    def jloss(p):
        (logits, out_lens), muts = jmodel.apply(
            {"params": p}, jnp.asarray(feats), jnp.asarray(lens),
            deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["losses"],
        )
        ctc = jconf.ctc_loss(
            logits, out_lens, jnp.asarray(refs), jnp.asarray(ref_lens), TINY["vocab_size"]
        )
        return ctc + 0.01 * jconf.moe_aux_loss(muts)

    eloss, egrads = jax.value_and_grad(jloss)(params)
    egrads = pconf.state_dict_from_jax(jax.tree.map(np.asarray, egrads))
    logits, out_lens, aux = pmodel(
        torch.from_numpy(feats), torch.from_numpy(lens), deterministic=False,
        return_aux=True,
    )
    loss = pconf.ctc_loss(
        logits, out_lens, torch.from_numpy(refs), torch.from_numpy(ref_lens),
        TINY["vocab_size"],
    ) + 0.01 * pconf.moe_aux_loss(aux)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(eloss), rtol=1e-6)
    for name, p in pmodel.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), egrads[name].numpy(), atol=1e-5, rtol=0, err_msg=name
        )
    jstep = jax.jit(jconf.make_train_step(jmodel, optax.adamw(1e-3)))
    step = pconf.make_train_step(pmodel, pconf.adamw(pmodel.parameters(), 1e-3))
    opt_state = optax.adamw(1e-3).init(params)
    for i in range(3):
        params, opt_state, el = jstep(
            params, opt_state, jax.random.PRNGKey(i), *(jnp.asarray(a) for a in data)
        )
        pl = step(torch.Generator().manual_seed(i), *(torch.from_numpy(a) for a in data))
        np.testing.assert_allclose(float(pl), float(el), rtol=1e-5)


def test_moe_transducer_train_step_matches_jax():
    """make_transducer_train_step with a MoE encoder: the loss with its
    aux term within rtol 1e-5 of JAX's over two Adam steps (float32,
    dropout 0)."""
    enc = dict(TINY, **MOE)
    jcfg = jtrans.TransducerConfig(
        encoder=jconf.ConformerConfig(dtype=jnp.float32, dropout=0.0, **enc),
        pred_dim=16, joint_dim=16,
    )
    pcfg = ptrans.TransducerConfig(
        encoder=pconf.ConformerConfig(dtype=torch.float32, dropout=0.0, **enc),
        pred_dim=16, joint_dim=16,
    )
    feats, lens = _inputs(9, N=2, T=24)
    refs = np.array([[1, 2, 3], [4, 5, 0]], np.int32)
    ref_lens = np.array([3, 2], np.int32)
    data = (feats, lens, refs, ref_lens)
    jmodel = jtrans.ConformerTransducer(jcfg)
    params = jmodel.init(
        jax.random.PRNGKey(0), *(jnp.asarray(a) for a in data)
    )["params"]
    pmodel = ptrans.ConformerTransducer(pcfg, device="cpu")
    pmodel.load_state_dict(
        ptrans.state_dict_from_jax(jax.tree.map(np.asarray, params)), strict=True
    )
    jstep = jax.jit(jtrans.make_transducer_train_step(jmodel, optax.adam(1e-3)))
    step = ptrans.make_transducer_train_step(
        pmodel, torch.optim.Adam(pmodel.parameters(), 1e-3, eps=1e-8)
    )
    opt_state = optax.adam(1e-3).init(params)
    for i in range(2):
        params, opt_state, el = jstep(
            params, opt_state, jax.random.PRNGKey(i), *(jnp.asarray(a) for a in data)
        )
        pl = step(torch.Generator().manual_seed(i), *(torch.from_numpy(a) for a in data))
        np.testing.assert_allclose(float(pl), float(el), rtol=1e-5)


def _plain_checkpoint(block, x, pad_mask, deterministic, generator):
    return torch.utils.checkpoint.checkpoint(
        block, x, pad_mask, deterministic, generator, use_reentrant=False
    )


def _remat_grads(remat, seed, restore=True, moe=False, monkeypatch=None):
    """Loss and gradients of one dropout-on forward/backward from one
    generator state, with or without remat."""
    kw = dict(TINY, **(MOE if moe else {}))
    cfg = pconf.ConformerConfig(dtype=torch.float32, dropout=0.1, remat=remat, **kw)
    model = pconf.ConformerCTC(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    feats, lens = _inputs(seed)
    if not restore:  # the planted fault: a checkpoint that does not replay it
        monkeypatch.setattr(pconf, "_remat_block", _plain_checkpoint)
    gen = torch.Generator().manual_seed(seed + 100)
    logits, out_lens, aux = model(
        torch.from_numpy(feats), torch.from_numpy(lens), deterministic=False,
        generator=gen, return_aux=True,
    )
    loss = logits.square().mean() + 0.01 * pconf.moe_aux_loss(aux)
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_remat_gradients_equal_plain_with_dropout(moe):
    """remat=True against remat=False from the same generator state, with
    dropout 0.1 at every site: the loss and every gradient bit-equal on
    the CPU (the recomputation replays the generator's bits). This is
    JAX's tests/test_models.py remat check plus the dropout case it lacks."""
    loss0, g0 = _remat_grads(False, 11, moe=moe)
    loss1, g1 = _remat_grads(True, 11, moe=moe)
    assert loss0 == loss1
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_remat_without_restoring_the_generator_fails(monkeypatch):
    """The planted fault: a checkpoint that does not set the generator
    back recomputes other dropout masks, so the gradients move (the loss,
    from the forward, does not)."""
    loss0, g0 = _remat_grads(False, 12)
    loss1, g1 = _remat_grads(True, 12, restore=False, monkeypatch=monkeypatch)
    assert loss0 == loss1
    assert any(not torch.equal(g0[k], g1[k]) for k in g0)


def test_remat_forward_matches_flax_remat():
    """The port's remat forward against JAX's nn.remat model: the same
    logits as without remat (atol 2e-4, the dense bound)."""
    kw = dict(TINY)
    jcfg = jconf.ConformerConfig(dtype=jnp.float32, remat=True, **kw)
    pcfg = pconf.ConformerConfig(dtype=torch.float32, remat=True, **kw)
    feats, lens = _inputs(13)
    jmodel = jconf.ConformerCTC(jcfg)
    params = jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(lens)
    )["params"]
    elogits, _ = jmodel.apply({"params": params}, jnp.asarray(feats), jnp.asarray(lens))
    pmodel = pconf.ConformerCTC(pcfg, device="cpu")
    pmodel.load_state_dict(pconf.state_dict_from_jax(jax.tree.map(np.asarray, params)))
    logits, _ = pmodel(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(elogits), atol=2e-4, rtol=0)
