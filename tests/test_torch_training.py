"""The port's TrainingStateController against the JAX package's: the
controller cases of tests/test_training.py with a torch model and
optimizer (stops, scheduling, the slippery slope, store and retrieve,
best, add_entry, keep-last-and-best, the optuna hooks), the history CSV
compared byte for byte with the JAX controller's, fed the same metrics,
and two processes under torch.distributed (samplers, metric reduction,
rank-0 writes)."""

import os
import warnings

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pydrobert_tpu import training as jtraining
from pydrobert_tpu_torch.training import TrainingStateController, TrainingStateParams


def _make(seed=0, lr=1e-3):
    gen = torch.Generator().manual_seed(seed)
    model = torch.nn.Linear(4, 4)
    with torch.no_grad():
        model.weight.copy_(torch.randn(4, 4, generator=gen))
        model.bias.zero_()
    return model, torch.optim.Adam(model.parameters(), lr=lr)


def _lr(optimizer):
    lrs = {g["lr"] for g in optimizer.param_groups}
    assert len(lrs) == 1
    return lrs.pop()


def _step(model, optimizer):
    """One optimizer step, so the optimizer has state to save."""
    optimizer.zero_grad()
    model(torch.ones(2, 4)).sum().backward()
    optimizer.step()


def _same(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_controller_stops_at_num_epochs():
    model, opt = _make()
    controller = TrainingStateController(TrainingStateParams(num_epochs=10))
    for _ in range(9):
        assert controller.update_for_epoch(model, opt, 0.1, 0.1)
        assert controller.continue_training()
    assert not controller.update_for_epoch(model, opt, 0.1, 0.1)
    assert not controller.continue_training()


def test_controller_scheduling():
    model, opt = _make(lr=1e-3)
    p = TrainingStateParams(
        early_stopping_threshold=0.1,
        early_stopping_patience=10,
        early_stopping_burnin=1,
        reduce_lr_threshold=0.2,
        reduce_lr_factor=0.5,
        reduce_lr_patience=5,
        reduce_lr_cooldown=2,
        reduce_lr_burnin=4,
    )
    controller = TrainingStateController(p)
    init_lr = _lr(opt)
    for _ in range(8):
        assert controller.update_for_epoch(model, opt, 1, 1)
        assert controller.continue_training()
    assert np.isclose(_lr(opt), init_lr)
    assert controller.update_for_epoch(model, opt, 1, 1)
    assert np.isclose(_lr(opt), init_lr / 2)
    for _ in range(6):
        assert controller.update_for_epoch(model, opt, 0.89, 0.89)
        assert controller.continue_training()
    assert np.isclose(_lr(opt), init_lr / 2)
    assert controller.update_for_epoch(model, opt, 0.68, 0.68)
    assert controller.continue_training()
    assert np.isclose(_lr(opt), init_lr / 2)
    for _ in range(9):
        assert controller.update_for_epoch(model, opt, 0.68, 0.68)
        assert controller.continue_training()
    assert not controller.update_for_epoch(model, opt, 0.68, 0.68)
    assert not controller.continue_training()
    p.early_stopping_threshold = 0.0
    p.reduce_lr_threshold = 0.0
    controller = TrainingStateController(p)
    model, opt = _make(lr=1e-3)
    for _ in range(20):
        assert controller.update_for_epoch(model, opt, 0, 0)
        assert controller.continue_training()
    assert np.isclose(_lr(opt), 1e-3)


def test_controller_slippery_slope():
    model, opt = _make()
    p = TrainingStateParams(
        early_stopping_threshold=1.0,
        early_stopping_patience=5,
        early_stopping_burnin=0,
        reduce_lr_threshold=1.0,
        reduce_lr_patience=2,
        reduce_lr_factor=0.5,
        reduce_lr_burnin=0,
        reduce_lr_cooldown=0,
    )
    controller = TrainingStateController(p)
    init_lr = _lr(opt)
    for step in range(6):
        controller.update_for_epoch(model, opt, 1.0, 3.5 - 0.75 * step)
        assert controller.continue_training(), step
        assert np.isclose(_lr(opt), init_lr), step


def test_controller_stores_and_retrieves(tmp_path):
    state_dir, csv = str(tmp_path / "states"), str(tmp_path / "hist.csv")
    model1, opt1 = _make(1, lr=1.0)
    model2, opt2 = _make(2, lr=2.0)
    _step(model1, opt1)
    _step(model2, opt2)
    params = TrainingStateParams(seed=7)
    controller = TrainingStateController(params, state_csv_path=csv, state_dir=state_dir)
    controller.update_for_epoch(model1, opt1, 0.3, 0.3)
    controller.update_for_epoch(model2, opt2, 0.5, 0.5)
    controller2 = TrainingStateController(params, state_csv_path=csv, state_dir=state_dir)
    assert controller2.get_last_epoch() == 2
    assert controller2.get_best_epoch() == 1
    model, opt = _make(9, lr=5.0)
    controller2.load_model_and_optimizer_for_epoch(model, opt)
    _same(model, model2)
    assert _lr(opt) == 2.0
    s, s2 = opt.state_dict()["state"], opt2.state_dict()["state"]
    for i in s2:
        for k in s2[i]:
            assert torch.equal(s[i][k], s2[i][k])
    controller2.load_model_for_epoch(model, 1)
    _same(model, model1)
    # epoch 0: the default re-initialization, seeded
    controller2.load_model_and_optimizer_for_epoch(model, opt, 0)
    assert not opt.state
    before = {k: v.clone() for k, v in model.state_dict().items()}
    controller2.load_model_for_epoch(model, 0)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])  # seed 7 both times


def test_controller_best(tmp_path):
    state_dir = str(tmp_path)
    model1, opt1 = _make(1, lr=1.0)
    model2, opt2 = _make(2, lr=2.0)
    model3, opt3 = _make(3, lr=3.0)
    controller = TrainingStateController(TrainingStateParams(), state_dir=state_dir)
    assert controller.get_best_epoch() == 0
    controller.update_for_epoch(model1, opt1, 0.5, 0.5)
    assert controller.get_best_epoch() == 1
    controller.update_for_epoch(model2, opt2, 1, 1)
    assert controller.get_best_epoch() == 1
    controller.update_for_epoch(model2, opt2, 1, 1)
    with pytest.raises(IOError):
        controller.load_model_and_optimizer_for_epoch(model3, opt3, 2)
    controller.load_model_and_optimizer_for_epoch(model3, opt3, 1)
    _same(model3, model1)
    assert _lr(opt3) == 1.0
    controller.load_model_and_optimizer_for_epoch(model3, opt3, 3)
    _same(model3, model2)
    assert _lr(opt3) == 2.0
    controller.update_for_epoch(model1, opt1, 0.6, 0.6)
    assert controller.get_best_epoch() == 1
    # round-to-even at SCIENTIFIC_PRECISION: .400005 rounds to .40000
    controller.update_for_epoch(model1, opt1, 0.400005, 0.400005)
    assert controller.get_best_epoch() == 5
    controller.load_model_and_optimizer_for_epoch(model3, opt3, 5)
    with pytest.raises(IOError):
        controller.load_model_and_optimizer_for_epoch(model3, opt3, 1)
    controller.update_for_epoch(model1, opt1, 0.4, 0.4)
    controller.load_model_and_optimizer_for_epoch(model3, opt3, 6)
    controller.load_model_and_optimizer_for_epoch(model3, opt3, 5)


def test_controller_add_entry(tmp_path):
    csv = str(tmp_path / "hist.csv")
    model, opt = _make()
    controller = TrainingStateController(TrainingStateParams(), state_csv_path=csv)
    controller.add_entry("important", int)
    controller.update_for_epoch(model, opt, 0.1, 0.1, important=3)
    controller.update_for_epoch(model, opt, 0.2, 0.01, important=4)
    assert controller[1]["important"] == 3
    assert controller[2]["important"] == 4
    with pytest.raises(TypeError):
        controller.update_for_epoch(model, opt, 0.1, 0.1)
    with pytest.raises(TypeError):
        controller.update_for_epoch(model, opt, 0.1, 0.1, bogus=1)
    with pytest.raises(ValueError):
        controller.add_entry("lr")
    controller2 = TrainingStateController(TrainingStateParams(), state_csv_path=csv)
    controller2.add_entry("important", int)
    assert controller2[2]["important"] == 4


def test_keep_last_and_best_only(tmp_path):
    model, opt = _make(lr=1.0)
    controller = TrainingStateController(
        TrainingStateParams(keep_last_and_best_only=True), state_dir=str(tmp_path)
    )
    for met in (0.5, 0.3, 0.7, 0.8):
        controller.update_for_epoch(model, opt, met, met)
    assert sorted(os.listdir(tmp_path)) == [
        "model_002.pt", "model_004.pt", "optim_002.pt", "optim_004.pt",
    ]


def test_checkpoints_are_state_dicts_and_load_onto_the_models_device(tmp_path):
    model, opt = _make(4)
    _step(model, opt)
    controller = TrainingStateController(TrainingStateParams(), state_dir=str(tmp_path))
    controller.update_for_epoch(model, opt, 1.0, 1.0)
    sd = torch.load(str(tmp_path / "model_001.pt"), weights_only=True)
    assert set(sd) == {"weight", "bias"}
    assert "state" in torch.load(str(tmp_path / "optim_001.pt"), weights_only=True)
    assert not [f for f in os.listdir(tmp_path) if f.startswith("tmp")]


@pytest.mark.parametrize("reduce", [False, True])
def test_history_csv_equals_jax_byte_for_byte(tmp_path, reduce):
    """Both controllers, fed the same metrics and a user entry, write the
    same CSV bytes, the rate reductions included."""
    mets = [3.2, 2.9, 2.9, 2.9, 2.85, 2.1, 2.1, 2.1, 1.0, 0.99]
    kw = dict(num_epochs=12, reduce_lr_threshold=0.1 if reduce else 0.0,
              reduce_lr_patience=2, reduce_lr_factor=0.5,
              early_stopping_threshold=0.05, early_stopping_patience=4)
    jcsv, pcsv = str(tmp_path / "j.csv"), str(tmp_path / "p.csv")
    jc = jtraining.TrainingStateController(jtraining.TrainingStateParams(**kw), jcsv)
    pc = TrainingStateController(TrainingStateParams(**kw), pcsv)
    for c in (jc, pc):
        c.add_entry("wer", float, "{:.3f}")
    jparams = {"w": jnp.zeros(3)}
    jopt = optax.inject_hyperparams(optax.adam)(learning_rate=3e-3)
    jstate = jopt.init(jparams)
    model, opt = _make(lr=3e-3)
    for i, m in enumerate(mets):
        jcont, jstate = jc.update_for_epoch(jparams, jstate, m + 0.5, m, wer=i / 7)
        pcont = pc.update_for_epoch(model, opt, m + 0.5, m, wer=i / 7)
        assert jcont == pcont
    with open(jcsv, "rb") as f, open(pcsv, "rb") as g:
        assert f.read() == g.read()
    assert float(np.asarray(jstate.hyperparams["learning_rate"])) == pytest.approx(_lr(opt))


def test_suggest_params_with_a_fake_trial_matches_jax():
    """The optuna hook draws the same names and values in both packages
    from one duck-typed trial (optuna itself is optional)."""

    class Trial:
        def __init__(self):
            self.rng = np.random.RandomState(3)
            self.log = []

        def suggest_int(self, name, low, high, step=1, log=False):
            self.log.append(name)
            return int(self.rng.randint(low, high + 1))

        def suggest_float(self, name, low, high, step=None, log=False):
            self.log.append(name)
            return float(self.rng.uniform(low, high))

        def suggest_categorical(self, name, choices):
            self.log.append(name)
            return choices[int(self.rng.randint(len(choices)))]

    tj, tp = Trial(), Trial()
    a = jtraining.TrainingStateParams.suggest_params(tj, prefix="t.")
    b = TrainingStateParams.suggest_params(tp, prefix="t.")
    assert tj.log == tp.log
    from dataclasses import asdict

    assert asdict(a) == asdict(b)


def test_optuna_suggest_params():
    optuna = pytest.importorskip("optuna")

    def objective(trial):
        params = TrainingStateParams.suggest_params(trial)
        assert params.num_epochs >= 1
        return 0.0

    study = optuna.create_study(sampler=optuna.samplers.RandomSampler(seed=5))
    study.optimize(objective, n_trials=3)


def test_unsupported_format_string_warns():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        TrainingStateController(TrainingStateParams(saved_model_fmt="model.pt"))
    assert any("does not contain" in str(x.message) for x in w)


def test_two_processes_under_torch_distributed(tmp_path):
    """Two gloo processes on the CPU: a base_seed of None is rank 0's draw
    on both ranks, the seeded samplers take disjoint strided shards of the
    JAX package's permutation, all_reduce_metrics means across ranks, and
    the controller records the reduced metrics, rank 0 writing."""
    import json
    import socket
    import subprocess
    import sys

    from pydrobert_tpu import data as jdata

    worker = os.path.join(os.path.dirname(__file__), "_torch_dist_worker.py")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(r), "2", str(port), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for r in range(2)
    ]
    logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-2000:]
    outs = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    assert outs[0]["auto_seed"] == outs[1]["auto_seed"]
    serial = jdata.EpochRandomSampler(list(range(12)), base_seed=42)
    for epoch in (0, 1):
        exp = [int(i) for i in serial.get_samples_for_epoch_ignoring_distributed(epoch)]
        assert [o[f"epoch{epoch}"] for o in outs] == [exp[0::2], exp[1::2]]
    for o in outs:
        assert o["reduced"] == {"met": 1.5}
        assert (o["train_met"], o["val_met"]) == (1.5, 2.5)
    assert sorted(os.listdir(tmp_path / "states")) == ["model_001.pt", "optim_001.pt"]
    with open(tmp_path / "hist.csv") as f:
        assert len(f.read().splitlines()) == 2
