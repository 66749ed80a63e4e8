"""Serving artifacts of the port (``pydrobert_tpu_torch.export``) against the
JAX package's (``pydrobert_tpu.export``): the same weights (carried by
``state_dict_from_jax``), the same numpy inputs, each test named after the
JAX test in ``tests/test_export.py`` it mirrors. Hypotheses and lengths
must be equal; probabilities within rtol 1e-4 (the live-search tests'
tolerance) and transducer beam scores within rtol 1e-6. The sharded
artifact runs across gloo ranks in ``tests/test_torch_parallel.py``."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydrobert_tpu import export as jexport
from pydrobert_tpu.models import ConformerConfig as JConformerConfig
from pydrobert_tpu.models import ConformerCTC as JConformerCTC
from pydrobert_tpu.models.transducer import ConformerTransducer as JTransducer
from pydrobert_tpu.models.transducer import TransducerConfig as JTransducerConfig
from pydrobert_tpu_torch import export as pexport
from pydrobert_tpu_torch.models import conformer as pconf
from pydrobert_tpu_torch.models import transducer as ptrans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CTC = dict(
    vocab_size=16, num_filts=8, d_model=16, num_layers=2, num_heads=2,
    subsample_channels=4, conv_kernel=5, dropout=0.0,
)
RNNT_ENC = dict(CTC, num_layers=1, attention_context=(4, 0), causal_conv=True)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module")
def ctc():
    """The JAX test's ``_ctc_setup`` (N=3, T=33) with the head x8, so that
    no decision is a near-tie that float32 rounding could flip."""
    jmodel = JConformerCTC(JConformerConfig(dtype=jnp.float32, **CTC))
    rng = np.random.RandomState(7)
    N, T = 3, 33
    feats = rng.randn(N, T, 8).astype(np.float32)
    lens = np.array([T, T - 9, T // 2], np.int32)
    params = jax.tree.map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), feats, lens)["params"]
    )
    params["ctc_head"]["kernel"] = params["ctc_head"]["kernel"] * 8
    pmodel = pconf.ConformerCTC(pconf.ConformerConfig(dtype=torch.float32, **CTC), device="cpu")
    pmodel.load_state_dict(pconf.state_dict_from_jax(params), strict=True)
    return jmodel, params, pmodel, feats, lens


def _same_hyps(got, exp, rtol=1e-4):
    """Lengths equal, tokens equal within each length, probabilities or
    scores (a third output) within ``rtol``."""
    hyps, hlens = _np(got[0]), _np(got[1])
    ehyps, elens = _np(exp[0]), _np(exp[1])
    assert hyps.shape == ehyps.shape
    np.testing.assert_array_equal(hlens, elens)
    mask = np.arange(ehyps.shape[-1]) < elens[..., None]
    np.testing.assert_array_equal(np.where(mask, hyps, -1), np.where(mask, ehyps, -1))
    if len(exp) > 2:
        np.testing.assert_allclose(_np(got[2]), _np(exp[2]), rtol=rtol, atol=0)


def test_flatten_round_trip(ctc, tmp_path):
    tree = {"a": {"b": np.arange(3), "c": {"d": np.ones((2, 2))}}, "e": np.zeros(1)}
    flat = pexport.flatten_arrays(tree)
    assert flat.keys() == jexport.flatten_arrays(tree).keys() == {"a/b", "a/c/d", "e"}
    back = pexport.unflatten_arrays(flat)
    assert np.array_equal(back["a"]["c"]["d"], tree["a"]["c"]["d"])
    with pytest.raises(ValueError):
        pexport.flatten_arrays({"x/y": np.zeros(1)})
    # a JAX artifact's params.npz loads into the port through
    # state_dict_from_jax
    jmodel, params, pmodel, feats, lens = ctc
    np.savez(tmp_path / "params.npz", **jexport.flatten_arrays(params))
    with np.load(tmp_path / "params.npz") as z:
        flax = pexport.unflatten_arrays({k: z[k] for k in z.files})
    sd = pconf.state_dict_from_jax(flax)
    for k, v in pmodel.state_dict().items():
        assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("width", [None, 4], ids=["greedy", "beam"])
def test_ctc_greedy_artifact_round_trip(ctc, tmp_path, width):
    """Greedy (the JAX test) and the width-4 search (its
    ``test_ctc_beam_artifact_matches_live_search``): the port's artifact,
    reloaded, against the JAX package's reloaded artifact."""
    jmodel, params, pmodel, feats, lens = ctc
    N, T = feats.shape[:2]
    jexport.export_ctc_recognizer(
        str(tmp_path / "jax"), jmodel, params, specs=[(N, T)], width=width,
        platforms=("cpu",),
    )
    exp = jexport.ServingArtifact.load(str(tmp_path / "jax"))(feats, lens)
    pexport.export_ctc_recognizer(str(tmp_path / "art"), pmodel, specs=[(N, T)], width=width)
    art = pexport.ServingArtifact.load(str(tmp_path / "art"), device="cpu")
    assert not art._compiled
    got = art(feats, lens)
    assert 0 in art._compiled
    _same_hyps(got, exp)
    live = pexport.ctc_recognizer(pmodel, width)(torch.from_numpy(feats), torch.from_numpy(lens))
    for a, b in zip(got, live):
        assert torch.equal(a, b)
    meta = json.load(open(tmp_path / "art" / "meta.json"))
    assert meta["platforms"] == ["cpu", "cuda"]
    assert meta["extra"]["family"] == "ctc" and meta["extra"]["width"] == width
    assert meta["paddable"] == [[0, 1], [0]] and meta["output_batch_axis"] == 0
    assert set(meta) >= set(json.load(open(tmp_path / "jax" / "meta.json")))


def test_artifact_pads_batch_and_time_to_spec(ctc, tmp_path):
    jmodel, params, pmodel, feats, lens = ctc
    # exported at (4, 40): a (3, 33) call must zero-pad in, slice out
    jexport.export_ctc_recognizer(
        str(tmp_path / "jax"), jmodel, params, specs=[(4, 40)], platforms=("cpu",)
    )
    exp = jexport.ServingArtifact.load(str(tmp_path / "jax"))(feats, lens)
    pexport.export_ctc_recognizer(str(tmp_path / "art"), pmodel, specs=[(4, 40)])
    art = pexport.ServingArtifact.load(str(tmp_path / "art"), device="cpu")
    hyps, hyp_lens = art(feats, lens)
    assert hyps.shape[0] == 3 and hyp_lens.shape == (3,)
    _same_hyps((hyps, hyp_lens), exp)
    padded_feats = np.zeros((4, 40, 8), np.float32)
    padded_feats[:3, :33] = feats
    padded_lens = np.zeros((4,), np.int32)
    padded_lens[:3] = lens
    full_hyps, full_lens = art(padded_feats, padded_lens)
    assert torch.equal(hyps, full_hyps[:3]) and torch.equal(hyp_lens, full_lens[:3])


def test_artifact_picks_smallest_fitting_spec_and_rejects_misfits(ctc, tmp_path):
    jmodel, params, pmodel, feats, lens = ctc
    pexport.export_ctc_recognizer(str(tmp_path / "art"), pmodel, specs=[(8, 64), (3, 33)])
    art = pexport.ServingArtifact.load(str(tmp_path / "art"), device="cpu")
    # the exact (3, 33) fit must win over padding into (8, 64)
    assert art._fits(art.meta["specs"][1], [feats, lens])
    hyps, _ = art(feats, lens)
    assert hyps.shape[0] == 3 and list(art._compiled) == [1]
    with pytest.raises(ValueError, match="no exported specialization"):
        art(np.zeros((9, 64, 8), np.float32), np.zeros((9,), np.int32))
    with pytest.raises(ValueError, match="no exported specialization"):
        art(feats.astype(np.float64), lens)


_SERVE = """
import sys, torch
import pydrobert_tpu_torch.ops.kernels
from pydrobert_tpu_torch.export import ServingArtifact
art = ServingArtifact.load(sys.argv[1], device="cpu")
feats, lens = torch.load(sys.argv[2])
torch.save(tuple(art(feats, lens)), sys.argv[3])
model_code = [m for m in sys.modules if m.startswith("pydrobert_tpu_torch.") and (
    m.startswith(("pydrobert_tpu_torch.models", "pydrobert_tpu_torch.lm"))
    or m in ("pydrobert_tpu_torch.ops.decoding", "pydrobert_tpu_torch.ops.transducer"))]
assert not model_code, model_code
assert "jax" not in sys.modules
"""


def test_artifact_runs_without_model_code(ctc, tmp_path):
    """A fresh process that imports only torch, the kernels' module and
    the loader serves the artifact; no model, search or LM module is
    imported, and its hypotheses equal the JAX artifact's."""
    jmodel, params, pmodel, feats, lens = ctc
    N, T = feats.shape[:2]
    pexport.export_ctc_recognizer(str(tmp_path / "art"), pmodel, specs=[(N, T)], width=4)
    torch.save((torch.from_numpy(feats), torch.from_numpy(lens)), tmp_path / "in.pt")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run(
        [sys.executable, "-c", _SERVE, str(tmp_path / "art"), str(tmp_path / "in.pt"),
         str(tmp_path / "out.pt")],
        env=env, check=True, cwd=str(tmp_path), timeout=300,
    )
    got = torch.load(tmp_path / "out.pt")
    jexport.export_ctc_recognizer(
        str(tmp_path / "jax"), jmodel, params, specs=[(N, T)], width=4, platforms=("cpu",)
    )
    _same_hyps(got, jexport.ServingArtifact.load(str(tmp_path / "jax"))(feats, lens))


def _rnnt(seed, N, T, short):
    jmodel = JTransducer(
        JTransducerConfig(
            encoder=JConformerConfig(dtype=jnp.float32, **RNNT_ENC), pred_dim=12, joint_dim=12
        )
    )
    rng = np.random.RandomState(seed)
    feats = rng.randn(N, T, 8).astype(np.float32)
    lens = np.array([T, T - short], np.int32)
    refs = rng.randint(0, 16, (N, 4)).astype(np.int32)
    params = jax.tree.map(
        np.asarray,
        jmodel.init(jax.random.PRNGKey(seed), feats, lens, refs, np.full((N,), 4, np.int32))[
            "params"
        ],
    )
    pcfg = ptrans.TransducerConfig(
        encoder=pconf.ConformerConfig(dtype=torch.float32, **RNNT_ENC), pred_dim=12, joint_dim=12
    )
    pmodel = ptrans.ConformerTransducer(pcfg, device="cpu")
    pmodel.load_state_dict(ptrans.state_dict_from_jax(params), strict=True)
    return jmodel, params, pmodel, feats, lens


def test_transducer_greedy_artifact_matches_live(tmp_path):
    jmodel, params, pmodel, feats, lens = _rnnt(3, 2, 29, 8)
    pexport.export_transducer_recognizer(
        str(tmp_path / "art"), pmodel, specs=[(2, 29)], mode="greedy", max_symbols_per_frame=3
    )
    art = pexport.ServingArtifact.load(str(tmp_path / "art"), device="cpu")
    got = art(feats, lens)
    exp = jmodel.apply({"params": params}, feats, lens, 3, method="greedy")
    np.testing.assert_array_equal(_np(got[0]), _np(exp[0]))
    np.testing.assert_array_equal(_np(got[1]), _np(exp[1]))
    live = pmodel.greedy(torch.from_numpy(feats), torch.from_numpy(lens), 3)
    assert all(torch.equal(a, b) for a, b in zip(got, live))


def test_transducer_beam_artifact_matches_live(tmp_path):
    jmodel, params, pmodel, feats, lens = _rnnt(4, 2, 25, 5)
    pexport.export_transducer_recognizer(
        str(tmp_path / "art"), pmodel, specs=[(2, 25)], mode="beam", width=3,
        max_symbols_per_frame=2,
    )
    art = pexport.ServingArtifact.load(str(tmp_path / "art"), device="cpu")
    got = art(feats, lens)
    exp = jmodel.apply({"params": params}, feats, lens, 3, 2, None, 0.3, method="beam")
    np.testing.assert_array_equal(_np(got[0]), _np(exp[0]))
    np.testing.assert_array_equal(_np(got[1]), _np(exp[1]))
    np.testing.assert_allclose(_np(got[2]), _np(exp[2]), rtol=1e-6)
    live = pmodel.beam(torch.from_numpy(feats), torch.from_numpy(lens), 3, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, live))


@pytest.mark.parametrize("route", ["auto", "0", "raw"])
def test_export_records_kernel_operators_on_cpu_platforms(ctc, tmp_path, route, monkeypatch):
    """Where the JAX package refuses ``allow_pallas`` with ``"cpu"`` in
    ``platforms`` (``test_export_rejects_pallas_on_cpu_platforms``), every
    port artifact records the kernels' operators and runs on the CPU: a
    width-4 program traced on the CPU with the default arguments holds each
    encoder block's ``depthwise_conv1d`` operator, then the decode
    prologue's and ``ctc_beam_search_renorm``'s operators, on the
    scan route (``USE_BEAM_KERNEL="0"``) the prologue's, on the raw route
    (``DECODE_RENORM`` off) ``top_m``'s and ``ctc_beam_search``'s, and its
    outputs equal the JAX package's live search. ``platforms`` still
    decides where it loads."""
    from pydrobert_tpu_torch import config as pconfig

    jmodel, params, pmodel, feats, lens = ctc
    if route == "0":
        monkeypatch.setattr(pconfig, "USE_BEAM_KERNEL", "0")
    saved = pconfig.DECODE_RENORM
    pconfig.DECODE_RENORM = route != "raw"
    try:
        art = pexport.export_ctc_recognizer(
            str(tmp_path / "art"), pmodel, specs=[(3, 33)], width=4
        )
        pexport.export_ctc_recognizer(
            str(tmp_path / "card"), pmodel, specs=[(3, 33)], width=4, platforms=("cuda",)
        )
    finally:
        pconfig.DECODE_RENORM = saved
    targets = [
        str(n.target).split(".")[-2] for n in art._programs[0].graph.nodes
        if n.op == "call_function" and "pydrobert_tpu_torch" in str(n.target)
    ]
    # each encoder block's depthwise conv, then the search's kernels
    want = ["depthwise_conv1d"] * CTC["num_layers"] + {
        "auto": ["decode_prologue", "ctc_beam_search_renorm"], "0": ["decode_prologue"],
        "raw": ["top_m", "ctc_beam_search"]}[route]
    assert targets == want
    got = pexport.ServingArtifact.load(str(tmp_path / "art"), device="cpu")(feats, lens)
    from pydrobert_tpu.ops.decoding import CTCPrefixSearch as JSearch

    logits, out_lens = jmodel.apply({"params": params}, feats, lens)
    ey, el, ep = JSearch(4)(jnp.swapaxes(logits, 0, 1), out_lens)
    _same_hyps(got, (jnp.transpose(ey, (1, 2, 0)), el, ep))
    with pytest.raises(ValueError, match="exported for"):
        pexport.ServingArtifact.load(str(tmp_path / "card"), device="cpu")


def test_scan_route_exports_one_loop_body(ctc, tmp_path, monkeypatch):
    """On the scan route (``USE_BEAM_KERNEL="0"``) the search's frames are
    one scan in the program, not unrolled: ``count_body_kernels`` finds its
    body with one trip a frame after the first, and the body's operators
    equal those a profiled eager trip calls."""
    from pydrobert_tpu_torch import config as pconfig
    from pydrobert_tpu_torch.ops.decoding import CTCPrefixSearch
    from pydrobert_tpu_torch.utils.hlostats import compiled_stats, count_body_kernels

    monkeypatch.setattr(pconfig, "USE_BEAM_KERNEL", "0")
    jmodel, params, pmodel, feats, lens = ctc
    art = pexport.export_ctc_recognizer(str(tmp_path / "art"), pmodel, specs=[(3, 33)], width=4)
    bodies = count_body_kernels(art._programs[0])
    loops = {k: v for k, v in bodies.items() if k != "main"}
    assert len(loops) == 1
    (body,) = loops.values()
    with torch.no_grad():
        logits, out_lens = pmodel(torch.from_numpy(feats), torch.from_numpy(lens))
    x = logits.transpose(0, 1).contiguous()
    assert body["trip_count"] == x.shape[0] - 1
    stats = compiled_stats(CTCPrefixSearch(4), x, out_lens)
    assert stats["loop_trip_count"] == x.shape[0] - 1
    assert stats["loop_kernels"] == body["kernels"]


def test_mesh_artifact_needs_its_ranks(ctc, tmp_path):
    """A mesh artifact loaded where the group has fewer ranks than its mesh
    raises at its first call, as the JAX loader does with fewer devices
    (``pydrobert_tpu/export.py:319-335``)."""
    jmodel, params, pmodel, feats, lens = ctc
    pexport.export_ctc_recognizer(str(tmp_path / "art"), pmodel, specs=[(4, 40)])
    meta_path = tmp_path / "art" / "meta.json"
    meta = json.load(open(meta_path))
    meta["mesh"] = {"axis_names": ["data", "model"], "shape": [2, 2]}
    meta["param_specs"] = {k: [] for k in pmodel.state_dict()}
    meta["input_specs"] = [["data"], ["data"]]
    json.dump(meta, open(meta_path, "w"))
    art = pexport.ServingArtifact.load(str(tmp_path / "art"), device="cpu")
    with pytest.raises(RuntimeError, match=r"\(2, 2\) mesh \(4 ranks\); this group has 1"):
        art(feats, lens)
