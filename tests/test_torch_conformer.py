"""Parity of pydrobert_tpu_torch.models.ConformerCTC with the JAX package's
flax model: the same float32 parameters (carried by state_dict_from_jax)
and inputs give logits within atol 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydrobert_tpu.models import conformer as jconf
from pydrobert_tpu_torch.models import conformer as pconf

TINY = dict(
    vocab_size=16, num_filts=10, d_model=32, num_layers=2, num_heads=2,
    subsample_channels=4, conv_kernel=7,
)


def _pair(seed, **extra):
    jcfg = jconf.ConformerConfig(dtype=jnp.float32, **TINY, **extra)
    pcfg = pconf.ConformerConfig(dtype=torch.float32, **TINY, **extra)
    rng = np.random.RandomState(seed)
    N, T = 4, 27
    feats = rng.randn(N, T, TINY["num_filts"]).astype(np.float32)
    lens = np.array([T, 19, 8, 1], np.int32)
    jmodel = jconf.ConformerCTC(jcfg)
    params = jmodel.init(
        jax.random.PRNGKey(seed), jnp.asarray(feats), jnp.asarray(lens)
    )["params"]
    params = jax.tree.map(np.asarray, params)
    pmodel = pconf.ConformerCTC(pcfg, device="cpu")
    pmodel.load_state_dict(pconf.state_dict_from_jax(params), strict=True)
    return jmodel, params, pmodel, feats, lens


@pytest.mark.parametrize(
    "extra",
    [{}, {"attention_context": (4, 0), "causal_conv": True}],
    ids=["full_context", "streaming"],
)
def test_conformer_ctc_matches_flax(extra):
    jmodel, params, pmodel, feats, lens = _pair(3, **extra)
    elogits, elens = jmodel.apply(
        {"params": params}, jnp.asarray(feats), jnp.asarray(lens)
    )
    logits, out_lens = pmodel(torch.from_numpy(feats), torch.from_numpy(lens))
    assert logits.dtype == torch.float32
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(elens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(elogits), atol=2e-4, rtol=0)


def test_state_dict_covers_every_parameter():
    _, params, pmodel, _, _ = _pair(4)
    sd = pconf.state_dict_from_jax(params)
    assert set(sd) == set(pmodel.state_dict())
    n_jax = sum(np.asarray(v).size for v in jax.tree.leaves(params))
    assert n_jax == sum(v.numel() for v in sd.values())


def test_conformer_ctc_bfloat16_runs_finite():
    cfg = pconf.ConformerConfig(**TINY)
    model = pconf.ConformerCTC(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    feats = torch.randn(2, 16, TINY["num_filts"], generator=torch.Generator().manual_seed(1))
    logits, out_lens = model(feats, torch.tensor([16, 9]))
    assert logits.shape == (2, 4, 17) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    assert out_lens.tolist() == [4, 3]


def test_seeded_init_is_reproducible():
    cfg = pconf.ConformerConfig(**TINY)
    a, b = (
        pconf.ConformerCTC(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
        for _ in range(2)
    )
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k


def test_default_device_is_cuda_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pconf.ConformerCTC(pconf.ConformerConfig(**TINY))


@pytest.mark.parametrize("bad", [{"num_experts": 2}, {"remat": True}])
def test_unported_options_raise(bad):
    with pytest.raises(NotImplementedError):
        pconf.ConformerConfig(**TINY, **bad)
    with pytest.raises(TypeError):
        pconf.ConformerConfig(seq_sharding=object())
