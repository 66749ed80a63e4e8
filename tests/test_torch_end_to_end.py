"""The training recipe end to end, in the port against the JAX package's
loop of ``test_minimum_end_to_end_slice``, on one data directory: loader
(MVN) -> CTC training with the state controller -> resume -> greedy
decode -> hyp writing -> the error-rate command.

Both sides start from the same weights (carried by
``state_dict_from_jax``), in float32 with dropout 0 and SpecAugment off,
under Adam at optax's defaults. The tolerances: batches bit-equal except
the MVN features (rtol and atol 1e-6, as ``ops.feats`` holds); losses
within rtol 1e-4 and parameters within atol 1e-4 after each epoch of 2
Adam steps (attention key biases apart: their true gradient is 0, see
tests/test_torch_train.py); the CSV's countdown and rate columns equal and
its metrics within rtol 1e-4; the resumed weights and optimizer state
bit-equal to the live ones; hypotheses and the error-rate file equal."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pydrobert_tpu import command_line as jcli
from pydrobert_tpu.data import SpectDataLoader as JLoader
from pydrobert_tpu.data import SpectDataLoaderParams as JLoaderParams
from pydrobert_tpu.data import SpectDataSet as JDataSet
from pydrobert_tpu.models import conformer as jconf
from pydrobert_tpu.ops.decoding import ctc_greedy_search as jgreedy
from pydrobert_tpu.training import TrainingStateController as JController
from pydrobert_tpu.training import TrainingStateParams as JParams
from pydrobert_tpu.utils.serial import save_tensor as jsave
from pydrobert_tpu_torch import command_line as pcli
from pydrobert_tpu_torch.data import SpectDataLoader, SpectDataLoaderParams, SpectDataSet
from pydrobert_tpu_torch.models import conformer as pconf
from pydrobert_tpu_torch.ops.decoding import ctc_greedy_search
from pydrobert_tpu_torch.training import TrainingStateController, TrainingStateParams

VOCAB = 13
TINY = dict(
    vocab_size=VOCAB, num_filts=8, d_model=16, num_layers=1, num_heads=2,
    subsample_channels=4, conv_kernel=5, dropout=0.0,
)
LR = 3e-3


def _data_dir(root):
    rng = np.random.RandomState(5)
    for n in range(8):
        T = int(rng.randint(20, 32))  # wide enough that CTC stays feasible
        jsave(rng.randn(T, 8).astype(np.float32), os.path.join(root, "feat", f"utt{n}.pt"))
        R = int(rng.randint(1, 4))
        jsave(rng.randint(0, VOCAB, (R,)).astype(np.int64), os.path.join(root, "ref", f"utt{n}.pt"))


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_recipe_matches_jax_end_to_end(tmp_path):
    root = str(tmp_path / "data")
    _data_dir(root)
    jmodel = jconf.ConformerCTC(jconf.ConformerConfig(dtype=jnp.float32, **TINY))
    params = jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 24, 8)), jnp.array([24])
    )["params"]
    joptim = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    opt_state = joptim.init(params)
    jstep = jax.jit(jconf.make_train_step(jmodel, joptim))
    model = pconf.ConformerCTC(pconf.ConformerConfig(dtype=torch.float32, **TINY), device="cpu")
    model.load_state_dict(pconf.state_dict_from_jax(jax.tree.map(np.asarray, params)))
    optim = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    step = pconf.make_train_step(model, optim)
    tp = dict(num_epochs=3, seed=1)
    jctl = JController(JParams(**tp), str(tmp_path / "jhist.csv"), str(tmp_path / "jstates"))
    ctl = TrainingStateController(
        TrainingStateParams(**tp), str(tmp_path / "hist.csv"), str(tmp_path / "states")
    )
    lp = dict(batch_size=4, do_mvn=True)
    losses = []
    for epoch in range(2):
        jl = JLoader(root, JLoaderParams(**lp), seed=7, init_epoch=epoch)
        pl = SpectDataLoader(
            root, SpectDataLoaderParams(**lp), seed=7, init_epoch=epoch, device="cpu"
        )
        jls, pls = [], []
        for jb, pb in zip(jl, pl, strict=True):
            np.testing.assert_allclose(pb[0].numpy(), jb[0], rtol=1e-6, atol=1e-6)
            for a, b in zip(pb[1:], jb[1:]):
                assert a.numpy().dtype == b.dtype
                np.testing.assert_array_equal(a.numpy(), b)
            feats, refs, feat_sizes, ref_sizes = jb
            params, opt_state, jloss = jstep(
                params, opt_state, jax.random.PRNGKey(epoch), jnp.asarray(feats),
                jnp.asarray(feat_sizes, jnp.int32),
                jnp.asarray(np.where(refs < 0, 0, refs), jnp.int32),
                jnp.asarray(ref_sizes, jnp.int32),
            )
            feats, refs, feat_sizes, ref_sizes = pb
            loss = step(None, feats, feat_sizes, refs.clamp(min=0), ref_sizes)
            np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
            jls.append(float(jloss))
            pls.append(float(loss))
        losses.append(np.mean(pls))
        jcont, opt_state = jctl.update_for_epoch(params, opt_state, np.mean(jls), np.mean(jls))
        assert ctl.update_for_epoch(model, optim, losses[-1], losses[-1]) == jcont
        expect = pconf.state_dict_from_jax(jax.tree.map(np.asarray, params))
        for name, p in model.named_parameters():
            if not name.endswith("attn.key.bias"):
                np.testing.assert_allclose(
                    p.detach().numpy(), expect[name].numpy(), atol=1e-4, rtol=0, err_msg=name
                )
    assert losses[1] < losses[0]
    jrows, rows = _rows(str(tmp_path / "jhist.csv")), _rows(str(tmp_path / "hist.csv"))
    assert [r.keys() for r in rows] == [r.keys() for r in jrows] and len(rows) == 2
    for r, jr in zip(rows, jrows):
        for k in r:
            if k.endswith("_met"):
                np.testing.assert_allclose(float(r[k]), float(jr[k]), rtol=1e-4)
            else:
                assert r[k] == jr[k], k

    # resume: a fresh controller loads epoch 2 into a fresh model and optimizer
    ctl2 = TrainingStateController(
        TrainingStateParams(**tp), str(tmp_path / "hist.csv"), str(tmp_path / "states")
    )
    assert ctl2.get_last_epoch() == 2
    model2 = pconf.ConformerCTC(pconf.ConformerConfig(dtype=torch.float32, **TINY), device="cpu")
    optim2 = torch.optim.Adam(model2.parameters(), lr=1.0)
    ctl2.load_model_and_optimizer_for_epoch(model2, optim2)
    for (k, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        assert torch.equal(a, b), k
    s, s2 = optim.state_dict(), optim2.state_dict()
    assert s["param_groups"] == s2["param_groups"]
    for i in s["state"]:
        for k in s["state"][i]:
            assert torch.equal(s["state"][i][k], s2["state"][i][k])

    # greedy decode, write hyps, score with each package's command
    jds = JDataSet(root, params=JLoaderParams(**lp))
    ds = SpectDataSet(root, params=SpectDataLoaderParams(**lp))
    for i, utt in enumerate(ds.utt_ids):
        jfeat = jnp.asarray(jds[i][0])[None]
        jlog, jlens = jmodel.apply({"params": params}, jfeat, jnp.asarray([jfeat.shape[1]]))
        _, jpaths, jout = jgreedy(jnp.swapaxes(jlog, 0, 1), jlens)
        jhyp = np.asarray(jpaths)[: int(jout[0]), 0].astype(np.int64)
        feat = ds[i][0][None]
        with torch.no_grad():
            logits, lens = model(feat, torch.tensor([feat.shape[1]]))
        _, paths, out = ctc_greedy_search(logits.transpose(0, 1), lens)
        hyp = paths[: int(out[0]), 0]
        np.testing.assert_array_equal(hyp.numpy(), jhyp)
        jds.write_hyp(utt, jhyp, os.path.join(root, "jhyp"))
        ds.write_hyp(utt, hyp)
    ref = os.path.join(root, "ref")
    for cli, hyp_dir, out, extra in (
        (jcli, "jhyp", "jwer.txt", []),
        (pcli, "hyp", "wer.txt", ["--device", "cpu"]),
    ):
        assert not cli.compute_torch_token_data_dir_error_rates(
            [ref, os.path.join(root, hyp_dir), str(tmp_path / out), "--quiet"] + extra
        )
    wer = open(tmp_path / "wer.txt").read()
    assert wer == open(tmp_path / "jwer.txt").read()
    assert np.isfinite(float(wer)) and float(wer) >= 0


@pytest.mark.parametrize("flags", [[], ["--per-utt"], ["--distances"], ["--nist-costs"], ["--batch-size", "2"]])
def test_error_rate_command_equals_jax(tmp_path, flags):
    """compute-torch-token-data-dir-error-rates on seeded references and
    hypotheses with substitutions, insertions and deletions: the same
    output as the JAX package's command for each flag set."""
    rng = np.random.RandomState(3)
    ref_dir, hyp_dir = str(tmp_path / "ref"), str(tmp_path / "hyp")
    for n in range(7):
        ref = rng.randint(0, 20, rng.randint(1, 12))
        hyp = [int(t) for t in ref if rng.rand() > 0.2]
        hyp = [t if rng.rand() > 0.2 else int(rng.randint(20)) for t in hyp]
        hyp.insert(int(rng.randint(len(hyp) + 1)), 21)
        jsave(ref.astype(np.int64), os.path.join(ref_dir, f"u{n}.pt"))
        jsave(np.asarray(hyp, np.int64), os.path.join(hyp_dir, f"u{n}.pt"))
    jout, pout = str(tmp_path / "j.txt"), str(tmp_path / "p.txt")
    assert jcli.compute_torch_token_data_dir_error_rates([ref_dir, hyp_dir, jout, "--quiet"] + flags) == 0
    assert pcli.compute_torch_token_data_dir_error_rates(
        [ref_dir, hyp_dir, pout, "--quiet", "--device", "cpu"] + flags
    ) == 0
    assert open(pout).read() == open(jout).read()


def test_spect_data_dir_info_command_equals_jax(populate_data_dir, tmp_path):
    root, *_ = populate_data_dir(num_utts=5)
    jout, pout = str(tmp_path / "j.txt"), str(tmp_path / "p.txt")
    assert jcli.get_torch_spect_data_dir_info([root, jout, "--strict"]) == 0
    assert pcli.get_torch_spect_data_dir_info([root, pout, "--strict"]) == 0
    assert open(pout).read() == open(jout).read()


def test_command_line_dispatches_by_name(populate_data_dir, tmp_path, capsys):
    import subprocess
    import sys

    root, *_ = populate_data_dir(num_utts=3)
    out = str(tmp_path / "info.txt")
    assert pcli.main(["get-torch-spect-data-dir-info", root, out]) == 0
    assert "num_utterances 3" in open(out).read()
    assert pcli.main(["no-such-command"]) == 2
    assert "compute-torch-token-data-dir-error-rates" in capsys.readouterr().err
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    proc = subprocess.run(
        [sys.executable, "-m", "pydrobert_tpu_torch.command_line",
         "get_torch_spect_data_dir_info", root],
        capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode == 0, proc.stderr
    assert "num_utterances 3" in proc.stdout
