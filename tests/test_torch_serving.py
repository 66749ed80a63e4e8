"""The port's streaming CTC serving on the CPU against the JAX package's:
``pos_offset``, ``streaming_logits`` and ``StreamingCTCRecognizer`` on the
same float32 weights (carried by ``state_dict_from_jax``) and inputs, on
both routes of the search. Lengths and tokens exact, probabilities within
atol 1e-5 and logits within atol 2e-4 (the forwards sum in other orders;
tests/test_serving.py's and tests/test_torch_conformer.py's tolerances)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydrobert_tpu.lm as jlm_mod
from pydrobert_tpu import config as jconfig
from pydrobert_tpu.models import conformer as jconf
from pydrobert_tpu.serving import StreamingCTCRecognizer as JaxRecognizer
from pydrobert_tpu_torch import config as pconfig
from pydrobert_tpu_torch import lm as plm_mod
from pydrobert_tpu_torch import serving as pserving
from pydrobert_tpu_torch.models import conformer as pconf
from pydrobert_tpu_torch.ops import decoding as pdec

from _lm_dicts import random_prob_dicts

# tests/test_serving.py's causal encoder, with its CTC vocabulary
CFG = dict(
    vocab_size=12, num_filts=8, d_model=16, num_layers=2, num_heads=2,
    subsample_channels=4, conv_kernel=5, dropout=0.0,
    attention_context=(4, 0), causal_conv=True,
)


def _setup(T=45, N=3, seed=5):
    jmodel = jconf.ConformerCTC(jconf.ConformerConfig(dtype=jnp.float32, **CFG))
    rng = np.random.RandomState(seed)
    feats = rng.randn(N, T, 8).astype(np.float32)
    lens = np.asarray([T, T - 10, (T // 2) + 1], np.int64)[:N]
    params = jmodel.init(
        jax.random.PRNGKey(seed), jnp.asarray(feats), jnp.asarray(lens, jnp.int32)
    )["params"]
    params = jax.tree.map(np.asarray, params)
    pmodel = pconf.ConformerCTC(
        pconf.ConformerConfig(dtype=torch.float32, **CFG), device="cpu"
    )
    pmodel.load_state_dict(pconf.state_dict_from_jax(params), strict=True)
    return jmodel, params, pmodel, feats, lens


def _compare(got, exp, atol=1e-5):
    y, y_lens, y_probs = (t.numpy() for t in got)
    ey, ey_lens, ey_probs = (np.asarray(e) for e in exp)
    assert y.shape == ey.shape
    np.testing.assert_array_equal(y_lens, ey_lens)
    np.testing.assert_allclose(y_probs, ey_probs, atol=atol, rtol=0)
    mask = np.arange(y.shape[0])[:, None, None] < ey_lens[None]
    np.testing.assert_array_equal(np.where(mask, y, -1), np.where(mask, ey, -1))


@pytest.fixture(scope="module")
def models():
    return _setup()


def test_pos_offset_matches_flax(models):
    jmodel, params, pmodel, feats, lens = models
    exp, _ = jmodel.apply(
        {"params": params}, jnp.asarray(feats), jnp.asarray(lens, jnp.int32), True, 7
    )
    with torch.no_grad():
        got, _ = pmodel(torch.from_numpy(feats), torch.from_numpy(lens), pos_offset=7)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=2e-4, rtol=0)
    with torch.no_grad():
        plain, _ = pmodel(torch.from_numpy(feats), torch.from_numpy(lens))
    assert not torch.allclose(plain, got)  # the offset moves the positions


@pytest.mark.parametrize("chunk", [1, 4])
def test_streaming_logits_match_flax_and_one_shot(models, chunk):
    """Within each utterance's out_lens (past them both are unspecified)."""
    jmodel, params, pmodel, feats, lens = models
    exp, exp_lens = jconf.streaming_logits(
        jmodel, params, jnp.asarray(feats), jnp.asarray(lens, jnp.int32), chunk
    )
    got, out_lens = pconf.streaming_logits(
        pmodel, torch.from_numpy(feats), torch.from_numpy(lens), chunk
    )
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(exp_lens))
    with torch.no_grad():
        full, _ = pmodel(torch.from_numpy(feats), torch.from_numpy(lens))
    valid = np.arange(got.shape[1])[None] < out_lens.numpy()[:, None]
    for ref in (np.asarray(exp), full.numpy()):
        np.testing.assert_allclose(got.numpy()[valid], ref[valid], atol=2e-4, rtol=0)


@pytest.mark.parametrize("route", ["scan", "beam"])
@pytest.mark.parametrize("pieces", [[45], [3, 30, 12], [44, 1]])
def test_streaming_recognizer_matches_jax(models, pieces, route, monkeypatch):
    """Every partial and the final result against the JAX package's
    session. The beam route is the whole-loop search on raw masses, held
    against the JAX session with DECODE_RENORM off; the scan route is the
    default renormalized search on both sides."""
    jmodel, params, pmodel, feats, lens = models
    if route == "beam":
        monkeypatch.setattr(pconfig, "USE_BEAM_KERNEL", "1")
        monkeypatch.setattr(jconfig, "DECODE_RENORM", False)
    calls = []
    beam = pdec.ctc_beam_search
    monkeypatch.setattr(
        pdec, "ctc_beam_search", lambda *a, **k: calls.append(1) or beam(*a, **k)
    )
    jrec = JaxRecognizer(jmodel, params, chunk=4, width=4, decode_pad_multiple=16)
    prec = pserving.StreamingCTCRecognizer(pmodel, chunk=4, width=4, decode_pad_multiple=16)
    jsess, psess = jrec.start(3), prec.start(3)
    t = 0
    for size in pieces:
        chunk = feats[:, t : t + size]
        new_lens = np.clip(lens - t, 0, size)
        exp = jrec.push(jsess, chunk, new_lens, partials=True)
        got = prec.push(psess, torch.from_numpy(chunk), new_lens, partials=True)
        assert tuple(got[1].shape) == (3, 4)
        _compare(got, exp)
        t += size
    _compare(prec.finish(psess), jrec.finish(jsess))
    # one search per partial and one at finish, on the route asked for
    assert len(calls) == (len(pieces) + 1 if route == "beam" else 0)


def test_streaming_finish_matches_port_one_shot(models, monkeypatch):
    monkeypatch.setattr(pconfig, "USE_BEAM_KERNEL", "1")
    _, _, pmodel, feats, lens = models
    with torch.no_grad():
        logits, out_lens = pmodel(torch.from_numpy(feats), torch.from_numpy(lens))
    exp = pdec.CTCPrefixSearch(4)(logits.transpose(0, 1).contiguous(), out_lens)
    rec = pserving.StreamingCTCRecognizer(pmodel, chunk=2, width=4, decode_pad_multiple=8)
    sess = rec.start(3)
    for t in range(0, 45, 8):
        assert rec.push(sess, feats[:, t : t + 8], np.clip(lens - t, 0, 8)) is None
    got = rec.finish(sess)
    assert got[0].shape[0] == 16  # 12 frames padded up to a multiple of 8
    _compare((got[0][:12],) + got[1:], exp)


def test_streaming_rejects_resume_noncausal_and_reuse(models):
    _, _, pmodel, feats, _ = models
    rec = pserving.StreamingCTCRecognizer(pmodel, chunk=4, width=4)
    sess = rec.start(3)
    rec.push(sess, feats[:, :8], np.asarray([8, 2, 8]))
    with pytest.raises(RuntimeError, match="resume"):
        rec.push(sess, feats[:, 8:16], np.asarray([8, 8, 8]))
    with pytest.raises(ValueError, match="new_lens"):
        rec.push(sess, feats[:, 8:16], np.asarray([9, 0, 8]))
    sess = rec.start(3)
    rec.finish(sess)
    with pytest.raises(RuntimeError, match="finished"):
        rec.finish(sess)
    with pytest.raises(RuntimeError, match="finished"):
        rec.push(sess, feats[:, :1])
    for bad in ({"attention_context": (None, None)}, {"causal_conv": False}):
        cfg = pconf.ConformerConfig(dtype=torch.float32, **dict(CFG, **bad))
        model = pconf.ConformerCTC(cfg, device="cpu")
        with pytest.raises(ValueError, match="causal"):
            pserving.StreamingCTCRecognizer(model)
        with pytest.raises(ValueError, match="causal"):
            pconf.streaming_logits(model, torch.from_numpy(feats), torch.tensor([45] * 3), 4)
    with pytest.raises(TypeError, match="MixableSequentialLanguageModel"):
        pserving.StreamingCTCRecognizer(pmodel, lm=object())


def test_streaming_recognizer_with_lm_matches_jax_and_one_shot(models):
    """A 3-gram lookup LM fused at beta 0.5 (the sparse route): every
    partial and the finish against the JAX session with the same LM
    (carried by its state dict), and the finish against the port's
    one-shot LM search of the full forward."""
    jmodel, params, pmodel, feats, lens = models
    V = CFG["vocab_size"]
    jlm = jlm_mod.LookupLanguageModel(V, sos=V, prob_dicts=random_prob_dicts(V, 3, 21, V))
    plm = plm_mod.LookupLanguageModel(V, sos=V, device="cpu")
    plm.load_state_dict(jlm.state_dict())
    kw = dict(chunk=4, width=4, beta=0.5, decode_pad_multiple=16)
    jrec = JaxRecognizer(jmodel, params, lm=jlm, **kw)
    prec = pserving.StreamingCTCRecognizer(pmodel, lm=plm, **kw)
    assert prec.search.lm_route() == "sparse"
    jsess, psess = jrec.start(3), prec.start(3)
    t = 0
    for size in (3, 30, 12):
        chunk = feats[:, t : t + size]
        new_lens = np.clip(lens - t, 0, size)
        exp = jrec.push(jsess, chunk, new_lens, partials=True)
        _compare(prec.push(psess, torch.from_numpy(chunk), new_lens, partials=True), exp)
        t += size
    got = prec.finish(psess)
    _compare(got, jrec.finish(jsess))
    with torch.no_grad():
        logits, out_lens = pmodel(torch.from_numpy(feats), torch.from_numpy(lens))
    one_shot = pdec.CTCPrefixSearch(4, 0.5, plm)(logits.transpose(0, 1).contiguous(), out_lens)
    _compare((got[0][: logits.shape[1]],) + got[1:], one_shot)
