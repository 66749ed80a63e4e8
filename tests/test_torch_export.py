"""The slice end to end (features in, hypotheses out) against the JAX
package's recognizer, and the port's import hygiene."""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydrobert_tpu.lm as jlm_mod
from pydrobert_tpu.models import conformer as jconf
from pydrobert_tpu.ops.decoding import CTCPrefixSearch, ctc_greedy_search
from pydrobert_tpu_torch import lm as plm_lm
from pydrobert_tpu_torch.export import ctc_recognizer
from pydrobert_tpu_torch.models import conformer as pconf

from _lm_dicts import random_prob_dicts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(
    vocab_size=16, num_filts=10, d_model=32, num_layers=2, num_heads=2,
    subsample_channels=4, conv_kernel=7,
)


@pytest.fixture(scope="module")
def models():
    jcfg = jconf.ConformerConfig(dtype=jnp.float32, **TINY)
    pcfg = pconf.ConformerConfig(dtype=torch.float32, **TINY)
    rng = np.random.RandomState(17)
    N, T = 5, 41
    feats = rng.randn(N, T, TINY["num_filts"]).astype(np.float32)
    lens = np.array([T, 33, 20, 4, 0], np.int32)
    jmodel = jconf.ConformerCTC(jcfg)
    params = jax.tree.map(
        np.asarray,
        jmodel.init(jax.random.PRNGKey(2), jnp.asarray(feats), jnp.asarray(lens))[
            "params"
        ],
    )
    # sharpen the head so the search's decisions are not near-ties
    params["ctc_head"]["kernel"] = params["ctc_head"]["kernel"] * 8
    pmodel = pconf.ConformerCTC(pcfg, device="cpu")
    pmodel.load_state_dict(pconf.state_dict_from_jax(params), strict=True)
    return jmodel, params, pmodel, feats, lens


def test_ctc_recognizer_beam_matches_jax(models):
    jmodel, params, pmodel, feats, lens = models
    search = CTCPrefixSearch(4)

    def fn(params, feats, lens):  # export_ctc_recognizer's beam body
        logits, out_lens = jmodel.apply({"params": params}, feats, lens)
        y, y_lens, y_probs = search(jnp.swapaxes(logits, 0, 1), out_lens)
        return jnp.transpose(y, (1, 2, 0)), y_lens, y_probs

    ehyps, elens, eprobs = (
        np.asarray(e) for e in jax.jit(fn)(params, jnp.asarray(feats), jnp.asarray(lens))
    )
    hyps, hlens, probs = ctc_recognizer(pmodel, width=4)(
        torch.from_numpy(feats), torch.from_numpy(lens)
    )
    assert hyps.shape == ehyps.shape
    np.testing.assert_array_equal(hlens.numpy(), elens)
    N, W, _ = ehyps.shape
    for n in range(N):
        for w in range(W):
            L = elens[n, w]
            np.testing.assert_array_equal(hyps.numpy()[n, w, :L], ehyps[n, w, :L])
    np.testing.assert_allclose(probs.numpy(), eprobs, rtol=1e-4, atol=0)


def test_ctc_recognizer_greedy_matches_jax(models):
    jmodel, params, pmodel, feats, lens = models
    logits, out_lens = jmodel.apply(
        {"params": params}, jnp.asarray(feats), jnp.asarray(lens)
    )
    _, ehyps, elens = ctc_greedy_search(logits, out_lens, batch_first=True)
    hyps, hlens = ctc_recognizer(pmodel)(
        torch.from_numpy(feats), torch.from_numpy(lens)
    )
    np.testing.assert_array_equal(hlens.numpy(), np.asarray(elens))
    np.testing.assert_array_equal(hyps.numpy(), np.asarray(ehyps))


def test_ctc_recognizer_lm_matches_jax(models):
    """The beam head shallow-fused with a 3-gram lookup LM (carried by its
    state dict) against export_ctc_recognizer's body with the JAX LM."""
    jmodel, params, pmodel, feats, lens = models
    V = TINY["vocab_size"]
    jlm = jlm_mod.LookupLanguageModel(V, sos=V, prob_dicts=random_prob_dicts(V, 3, 31, V))
    plm = plm_lm.LookupLanguageModel(V, sos=V, device="cpu")
    plm.load_state_dict(jlm.state_dict())
    search = CTCPrefixSearch(4, beta=0.5, lm=jlm)

    def fn(params, feats, lens):  # export_ctc_recognizer's beam body
        logits, out_lens = jmodel.apply({"params": params}, feats, lens)
        y, y_lens, y_probs = search(jnp.swapaxes(logits, 0, 1), out_lens)
        return jnp.transpose(y, (1, 2, 0)), y_lens, y_probs

    ehyps, elens, eprobs = (
        np.asarray(e) for e in jax.jit(fn)(params, jnp.asarray(feats), jnp.asarray(lens))
    )
    hyps, hlens, probs = ctc_recognizer(pmodel, width=4, beta=0.5, lm=plm)(
        torch.from_numpy(feats), torch.from_numpy(lens)
    )
    np.testing.assert_array_equal(hlens.numpy(), elens)
    mask = np.arange(ehyps.shape[2])[None, None] < elens[..., None]
    np.testing.assert_array_equal(np.where(mask, hyps.numpy(), -1), np.where(mask, ehyps, -1))
    np.testing.assert_allclose(probs.numpy(), eprobs, rtol=1e-4, atol=0)


def _port_sources():
    root = os.path.join(REPO, "pydrobert_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "examples", "train_ctc_asr_torch.py")


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pydrobert_tpu")


def test_port_imports_nothing_of_jax():
    """An AST scan of every module of the port, chip_smoke.py and the
    port's recipe script."""
    sources = list(_port_sources())
    assert len(sources) > 10
    for path in sources:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in FORBIDDEN, f"{path} imports {name}"


def test_port_import_leaves_jax_unloaded():
    code = (
        "import pydrobert_tpu_torch.export, pydrobert_tpu_torch.models, sys\n"
        "import pydrobert_tpu_torch.serving, pydrobert_tpu_torch.ops.transducer\n"
        "import pydrobert_tpu_torch.parallel, pydrobert_tpu_torch.utils.cache\n"
        "import pydrobert_tpu_torch.utils.hlostats, pydrobert_tpu_torch.utils.profiling\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert 'jax' not in sys.modules and 'pydrobert_tpu' not in sys.modules, bad\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], env=env, check=True, cwd=REPO)
