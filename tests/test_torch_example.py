"""examples/train_ctc_asr_torch.py, the port's recipe script, on the CPU:
synthesize -> train under the state controller -> greedy decode -> score,
resumed by a second call bit for bit; and sharded over a two-rank gloo
group (``--model-parallelism 2``), as ``torchrun`` would start it."""

import importlib.util
import os
import socket
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "examples", "train_ctc_asr_torch.py")


@pytest.fixture(scope="module")
def recipe():
    spec = importlib.util.spec_from_file_location("train_ctc_asr_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(work, epochs, *extra):
    return ["--work-dir", str(work), "--device", "cpu", "--num-utts", "8",
            "--num-epochs", str(epochs), *extra]


def _hist_epochs(work):
    with open(os.path.join(work, "hist.csv")) as f:
        return [int(line.split(",")[0]) for line in f.read().splitlines()[1:]]


def _same_checkpoints(a, b):
    for name in ("model", "optim"):
        sa = torch.load(a / "states" / f"{name}_003.pt", weights_only=True)
        sb = torch.load(b / "states" / f"{name}_003.pt", weights_only=True)
        if name == "optim":
            sa, sb = sa["state"], sb["state"]
            sa = {k: v for p in sa for k, v in ((f"{p}.{n}", t) for n, t in sa[p].items())}
            sb = {k: v for p in sb for k, v in ((f"{p}.{n}", t) for n, t in sb[p].items())}
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (name, k)


def test_recipe_runs_and_resumes_on_the_cpu(recipe, tmp_path, capsys):
    """Two epochs, then a second call to three epochs that resumes from
    the second checkpoint: its third checkpoint (weights and AdamW state)
    is bit-equal to an uninterrupted three-epoch run's, and a third call
    past the last epoch trains nothing and scores again."""
    work, whole = tmp_path / "resumed", tmp_path / "whole"
    assert recipe.main(_args(work, 2)) == 0
    for out in ("hist.csv", "wer.txt", os.path.join("data", "hyp")):
        assert os.path.exists(work / out), out
    assert len(os.listdir(work / "data" / "hyp")) == 8
    assert _hist_epochs(work) == [1, 2]
    capsys.readouterr()
    assert recipe.main(_args(work, 3)) == 0
    printed = capsys.readouterr().out
    assert "epoch 3:" in printed and "epoch 1:" not in printed
    assert _hist_epochs(work) == [1, 2, 3]
    assert recipe.main(_args(whole, 3)) == 0
    _same_checkpoints(work, whole)
    capsys.readouterr()
    assert recipe.main(_args(work, 3)) == 0
    printed = capsys.readouterr().out.splitlines()
    assert not [line for line in printed if line.startswith("epoch")], printed
    assert printed[-1].startswith("error rate:")
    assert _hist_epochs(work) == [1, 2, 3]
    rate = float(open(work / "wer.txt").read())
    assert 0 <= rate


def test_recipe_refuses_to_run_unsharded(recipe, tmp_path):
    with pytest.raises(RuntimeError, match="--model-parallelism 2 needs a torch.distributed"):
        recipe.main(_args(tmp_path, 1, "--model-parallelism", "2"))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_recipe_sharded_over_two_ranks(tmp_path):
    """``--model-parallelism 2`` on two gloo ranks started with
    ``torchrun``'s environment: a (1, 2) mesh, both ranks return 0, the
    checkpoints hold full tensors that load into an unsharded model, and
    rank 0 writes the hypotheses and the score."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, SCRIPT, *_args(tmp_path, 2, "--model-parallelism", "2")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=180)[0])
        finally:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "mesh: {'data': 1, 'model': 2}" in outs[0]
    assert _hist_epochs(tmp_path) == [1, 2]
    assert len(os.listdir(tmp_path / "data" / "hyp")) == 8
    assert os.path.exists(tmp_path / "wer.txt")

    from pydrobert_tpu_torch.models import ConformerConfig, ConformerCTC

    sd = torch.load(tmp_path / "states" / "model_002.pt", weights_only=True)
    cfg = ConformerConfig(vocab_size=13, num_filts=8, d_model=16, num_layers=1, num_heads=2,
                          subsample_channels=4, conv_kernel=5, dtype=torch.float32)
    ConformerCTC(cfg, device="cpu").load_state_dict(sd, strict=True)
