"""The port's streaming serving on the CPU against the JAX package's:
``pos_offset``, ``streaming_logits`` and ``StreamingCTCRecognizer`` on the
same float32 weights (carried by ``state_dict_from_jax``) and inputs, on
both routes of the search. Lengths and tokens exact, probabilities within
atol 1e-5 and logits within atol 2e-4 (the forwards sum in other orders;
tests/test_serving.py's and tests/test_torch_conformer.py's tolerances).
Then ``StreamingTransducerRecognizer`` in greedy and beam mode, every
partial and the finish against the JAX package's session and the finish
against the port's one-shot decode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydrobert_tpu.lm as jlm_mod
from pydrobert_tpu import config as jconfig
from pydrobert_tpu.models import conformer as jconf
from pydrobert_tpu.models import transducer as jrnnt
from pydrobert_tpu.serving import StreamingCTCRecognizer as JaxRecognizer
from pydrobert_tpu.serving import StreamingTransducerRecognizer as JaxRnntRecognizer
from pydrobert_tpu_torch import config as pconfig
from pydrobert_tpu_torch import lm as plm_mod
from pydrobert_tpu_torch import serving as pserving
from pydrobert_tpu_torch.models import conformer as pconf
from pydrobert_tpu_torch.models import transducer as prnnt
from pydrobert_tpu_torch.ops import _ctc_scan as pscan
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
    default renormalized search on both sides (the port's renormalizing
    whole-loop route, whose plain version is the scan)."""
    jmodel, params, pmodel, feats, lens = models
    if route == "beam":
        monkeypatch.setattr(pconfig, "DECODE_RENORM", False)
        monkeypatch.setattr(jconfig, "DECODE_RENORM", False)
    calls = []
    for name in ("ctc_beam_search", "ctc_beam_search_renorm"):
        monkeypatch.setattr(
            pdec, name, lambda *a, _f=getattr(pdec, name), _n=name, **k:
            calls.append(_n) or _f(*a, **k)
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
    want = "ctc_beam_search" if route == "beam" else "ctc_beam_search_renorm"
    assert calls == [want] * (len(pieces) + 1)


def test_streaming_finish_matches_port_one_shot(models):
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


@pytest.mark.parametrize("gather", [False, True])
def test_streaming_recognizer_with_lm_matches_jax_and_one_shot(models, gather, monkeypatch):
    """A 3-gram lookup LM fused at beta 0.5 (the sparse route): every
    partial and the finish against the JAX session with the same LM
    (carried by its state dict), and the finish against the port's
    one-shot LM search of the full forward; on the compare route and on
    the gather route (``SPARSE_MEMBERSHIP_GATHER`` in both packages)."""
    monkeypatch.setattr(jconfig, "SPARSE_MEMBERSHIP_GATHER", gather)
    monkeypatch.setattr(pconfig, "SPARSE_MEMBERSHIP_GATHER", gather)
    tables = []
    advance = pscan._ctc_prefix_search_advance_sparse
    monkeypatch.setattr(
        pscan, "_ctc_prefix_search_advance_sparse",
        lambda *a: tables.append(a[14] is not None) or advance(*a),
    )
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
    assert tables and set(tables) == {gather}


# ------------------------------------------------- transducer sessions

RNNT_ENC = dict(CFG, vocab_size=16)


@pytest.fixture(scope="module")
def rnnt():
    """tests/test_serving.py's transducer set-up (T=45, lengths 45, 35 and
    23) in both packages, the port's weights carried from the flax tree."""
    kw = dict(pred_dim=12, joint_dim=12)
    jmodel = jrnnt.ConformerTransducer(
        jrnnt.TransducerConfig(encoder=jconf.ConformerConfig(dtype=jnp.float32, **RNNT_ENC), **kw)
    )
    rng = np.random.RandomState(0)
    T, N = 45, 3
    feats = rng.randn(N, T, 8).astype(np.float32)
    lens = np.asarray([T, T - 10, (T // 2) + 1], np.int64)
    refs = rng.randint(0, 16, (N, 4)).astype(np.int32)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), feats, lens.astype(np.int32), refs, np.full((N,), 4, np.int32)
    )["params"]
    params = jax.tree.map(np.asarray, params)
    pmodel = prnnt.ConformerTransducer(
        prnnt.TransducerConfig(encoder=pconf.ConformerConfig(dtype=torch.float32, **RNNT_ENC),
                               **kw),
        device="cpu",
    )
    pmodel.load_state_dict(prnnt.state_dict_from_jax(params), strict=True)
    return jmodel, params, pmodel, feats, lens


def _rnnt_compare(got, exp, score_tol=1e-6):
    """Tokens and lengths exact; beam scores within rtol 1e-6 (the two
    frameworks' joints round apart in the last ulp)."""
    for i, (g, e) in enumerate(zip(got, exp)):
        if g.is_floating_point():
            np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=score_tol, atol=score_tol)
        else:
            U = min(g.shape[-1], np.asarray(e).shape[-1]) if g.dim() > 1 else None
            g, e = g.numpy(), np.asarray(e)
            if U is not None:
                g, e = g[..., :U], e[..., :U]
            np.testing.assert_array_equal(g, e)


def _rnnt_sessions(jrec, prec, feats, lens, pieces):
    """Both sessions through the same pushes, every partial compared."""
    jsess, psess = jrec.start(feats.shape[0]), prec.start(feats.shape[0])
    t = 0
    for size in pieces:
        chunk = feats[:, t : t + size]
        new_lens = np.clip(lens - t, 0, chunk.shape[1])
        _rnnt_compare(prec.push(psess, torch.from_numpy(chunk), new_lens),
                      jrec.push(jsess, chunk, new_lens))
        t += chunk.shape[1]
    assert t == feats.shape[1]
    got = prec.finish(psess)
    _rnnt_compare(got, jrec.finish(jsess))
    return got


@pytest.mark.parametrize(
    "pieces", [[45], [7, 20, 18], [1] * 45, [44, 1], [3, 5, 4, 33], [4] * 11 + [1]]
)
def test_transducer_session_greedy_matches_jax_and_one_shot(rnnt, pieces):
    jmodel, params, pmodel, feats, lens = rnnt
    kw = dict(chunk=4, mode="greedy", max_symbols_per_frame=3, max_frames=32)
    got = _rnnt_sessions(JaxRnntRecognizer(jmodel, params, **kw),
                         pserving.StreamingTransducerRecognizer(pmodel, **kw),
                         feats, lens, pieces)
    hyps, hyp_lens = pmodel.greedy(*(torch.from_numpy(a) for a in (feats, lens)), 3)
    assert torch.equal(got[1], hyp_lens)
    assert torch.equal(got[0][:, : hyps.shape[1]], hyps)
    assert int(hyp_lens.min()) > 0


@pytest.mark.parametrize("fused", [False, True])
def test_transducer_session_beam_matches_jax_and_one_shot(rnnt, fused):
    """Width 3, two rounds a frame, pushes of 9, 1, 25 and 10 frames; bare
    and fused with a 3-gram lookup LM at weight 0.4. The finish equals the
    port's one-shot beam search (scores within rtol 1e-6: the window
    encoder sums in another order)."""
    jmodel, params, pmodel, feats, lens = rnnt
    jlm = plm = None
    if fused:
        jlm = jlm_mod.LookupLanguageModel(16, sos=16, prob_dicts=random_prob_dicts(16, 3, 7, 16))
        plm = plm_mod.LookupLanguageModel(16, sos=16, device="cpu")
        plm.load_state_dict(jlm.state_dict())
    kw = dict(chunk=5, mode="beam", width=3, max_symbols_per_frame=2, max_frames=32,
              lm_weight=0.4)
    got = _rnnt_sessions(JaxRnntRecognizer(jmodel, params, lm=jlm, **kw),
                         pserving.StreamingTransducerRecognizer(pmodel, lm=plm, **kw),
                         feats, lens, [9, 1, 25, 10])
    bh, bl, bs = pmodel.beam(*(torch.from_numpy(a) for a in (feats, lens)), 3, 2, lm=plm,
                             lm_weight=0.4)
    assert torch.equal(got[1], bl) and torch.equal(got[0][..., : bh.shape[2]], bh)
    np.testing.assert_allclose(got[2].numpy(), bs.numpy(), rtol=1e-6, atol=1e-5)


# (lengths, chunk, pushes): streams that end mid-chunk, one shorter than a
# subsampling block, all ending before finish, and chunks of 1 and past L
EDGE_SESSIONS = {
    "short_stream": ([45, 3, 23], 4, [9, 1, 25, 10]),
    "all_end_early": ([41, 30, 2], 4, [16, 16, 13]),
    "chunk_1": ([45, 35, 23], 1, [7, 20, 18]),
    "chunk_past_L": ([45, 35, 22], 6, [9, 1, 25, 10]),
}


@pytest.mark.parametrize("mode", ["greedy", "beam"])
@pytest.mark.parametrize("case", sorted(EDGE_SESSIONS))
def test_transducer_session_edge_streams_match_jax_and_one_shot(rnnt, case, mode):
    """The cached route through streams that end mid-chunk or inside the
    first subsampling block, sessions whose streams all end before
    ``finish`` (their last frames kept when their chunks were encoded),
    and chunks of one frame and of more than the attention's left
    context: every partial and the finish equal the JAX package's window
    session, the finish the port's one-shot decode."""
    jmodel, params, pmodel, feats, _ = rnnt
    lens, chunk, pieces = EDGE_SESSIONS[case]
    lens = np.asarray(lens, np.int64)
    kw = dict(chunk=chunk, mode=mode, width=3, max_symbols_per_frame=2, max_frames=32)
    prec = pserving.StreamingTransducerRecognizer(pmodel, **kw)
    assert prec.cached
    got = _rnnt_sessions(JaxRnntRecognizer(jmodel, params, **kw), prec, feats, lens, pieces)
    args = [torch.from_numpy(a) for a in (feats, lens)]
    if mode == "greedy":
        exp = pmodel.greedy(*args, 2)
    else:
        exp = pmodel.beam(*args, 3, 2)
        np.testing.assert_allclose(got[2].numpy(), exp[2].numpy(), rtol=1e-6, atol=1e-5)
    U = exp[0].shape[-1]
    assert torch.equal(got[1], exp[1]) and torch.equal(got[0][..., :U], exp[0])


@pytest.mark.parametrize("chunk", [1, 4, 6])
def test_encoder_stream_step_matches_one_shot(rnnt, chunk):
    """The encoder chunk by chunk from its state cache (chunks of one frame,
    four, and more than the left context of four) against the one-shot
    ``model.encode`` at every valid frame, within the window route's atol
    2e-4; lengths as the session sends them, raw frames past the pushes
    zero."""
    _, _, pmodel, feats, lens = rnnt
    cfg = pmodel.cfg.encoder
    with torch.no_grad():
        exp, out_lens = pmodel.encode(torch.from_numpy(feats), torch.from_numpy(lens))
    T4 = exp.shape[1]
    n = -(-T4 // chunk)
    f = torch.zeros((feats.shape[0], 4 * chunk * n, feats.shape[2]))
    f[:, : feats.shape[1]] = torch.from_numpy(feats)
    state = pconf.encoder_stream_state(pmodel.encoder, cfg, feats.shape[0])
    rows = []
    for o0 in range(0, n * chunk, chunk):
        x, state = pconf.encoder_stream_step(
            pmodel.encoder, cfg, state, f[:, 4 * o0 : 4 * (o0 + chunk)],
            torch.from_numpy(lens - 4 * o0), o0,
        )
        assert x.shape == (feats.shape[0], chunk, cfg.d_model) and x.dtype == cfg.dtype
        rows.append(x.float())
    got = torch.cat(rows, 1)[:, :T4]
    valid = torch.arange(T4)[None] < out_lens[:, None]
    assert int(valid.sum()) == int(out_lens.sum())
    np.testing.assert_allclose(got[valid].numpy(), exp[valid].numpy(), atol=2e-4, rtol=0)


def test_encoder_stream_step_runs_each_block_through_its_own_modules(rnnt):
    """A chunk of the stream step calls the forward of every block's
    attention, convolution module, both feed-forwards and output LayerNorm
    once each, the modules of the one-shot forward, so that a change to
    them reaches the stream."""
    _, _, pmodel, feats, lens = rnnt
    cfg = pmodel.cfg.encoder
    names = ("mhsa.attn", "conv", "ffn1", "ffn2", "ln_out")
    calls = {(i, n): 0 for i in range(cfg.num_layers) for n in names}

    def counter(key):
        def hook(module, args, out):
            calls[key] += 1

        return hook

    hooks = [
        getattr(pmodel.encoder, f"block_{i}").get_submodule(n).register_forward_hook(counter((i, n)))
        for i, n in calls
    ]
    try:
        state = pconf.encoder_stream_state(pmodel.encoder, cfg, feats.shape[0])
        pconf.encoder_stream_step(
            pmodel.encoder, cfg, state, torch.from_numpy(feats[:, :16]), torch.from_numpy(lens), 0
        )
    finally:
        for h in hooks:
            h.remove()
    assert calls == dict.fromkeys(calls, 1)


def test_transducer_session_moe_takes_the_window_route(rnnt):
    """A mixture-of-experts causal encoder routes by the tokens of its
    batch, so its session re-encodes windows (the step refuses it) and still
    equals the JAX package's window session, every partial and the
    finish."""
    _, _, _, feats, lens = rnnt
    enc = dict(RNNT_ENC, num_experts=4, expert_top_k=2)
    kw = dict(pred_dim=12, joint_dim=12)
    jmodel = jrnnt.ConformerTransducer(
        jrnnt.TransducerConfig(encoder=jconf.ConformerConfig(dtype=jnp.float32, **enc), **kw)
    )
    refs = np.zeros((feats.shape[0], 4), np.int32)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(1), feats, lens.astype(np.int32), refs,
        np.full((feats.shape[0],), 4, np.int32),
    )["params"]
    params = jax.tree.map(np.asarray, params)
    pmodel = prnnt.ConformerTransducer(
        prnnt.TransducerConfig(encoder=pconf.ConformerConfig(dtype=torch.float32, **enc), **kw),
        device="cpu",
    )
    pmodel.load_state_dict(prnnt.state_dict_from_jax(params), strict=True)
    kw = dict(chunk=4, mode="greedy", max_symbols_per_frame=3, max_frames=32)
    prec = pserving.StreamingTransducerRecognizer(pmodel, **kw)
    assert not prec.cached and prec.start(3).enc_state is None
    with pytest.raises(ValueError, match="dense"):
        pconf.encoder_stream_state(pmodel.encoder, pmodel.cfg.encoder, 3)
    got = _rnnt_sessions(JaxRnntRecognizer(jmodel, params, **kw), prec, feats, lens, [7, 20, 18])
    assert int(got[1].min()) > 0


def test_transducer_session_rejects_resume_noncausal_and_reuse(rnnt):
    _, _, pmodel, feats, _ = rnnt
    rec = pserving.StreamingTransducerRecognizer(pmodel, chunk=4, max_frames=32)
    sess = rec.start(3)
    rec.push(sess, feats[:, :8], np.asarray([8, 2, 8]))
    with pytest.raises(RuntimeError, match="resume"):
        rec.push(sess, feats[:, 8:16], np.asarray([8, 8, 8]))
    with pytest.raises(RuntimeError, match="max_frames"):
        rec.push(sess, np.zeros((3, 130, 8), np.float32), np.asarray([130, 0, 130]))
    sess = rec.start(3)
    rec.finish(sess)
    with pytest.raises(RuntimeError, match="finished"):
        rec.finish(sess)
    with pytest.raises(RuntimeError, match="finished"):
        rec.push(sess, feats[:, :1])
    with pytest.raises(ValueError, match="mode"):
        pserving.StreamingTransducerRecognizer(pmodel, mode="sample")
    enc = pconf.ConformerConfig(dtype=torch.float32, **dict(RNNT_ENC, causal_conv=False))
    model = prnnt.ConformerTransducer(prnnt.TransducerConfig(enc, 12, 12), device="cpu")
    with pytest.raises(ValueError, match="causal"):
        pserving.StreamingTransducerRecognizer(model)
