"""The harness is driven by data: a configuration, a traffic mix, a cell
and a metric added as new files in a copy of the benchmark are found by
their names and run; a run without a card fails and prints no result."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

ROOT = tiny.ROOT

NEW_METRIC = '''"""Units the traced window ran."""


def read(run):
    return len(run.units) if run.records is not None else None
'''


def add_files(root):
    """A new configuration, mix, cell and per-layer metric, as files."""
    bench = os.path.join(root, "portbench")
    with open(os.path.join(bench, "configs", "conformer_l_ctc.json")) as f:
        cfg = json.load(f)
    cfg.update(name="conformer_x_ctc", num_layers=1)
    tiny.write(os.path.join(bench, "configs", "conformer_x_ctc.json"), cfg)
    tiny.write(os.path.join(bench, "traffic", "offline_tiny.json"),
               dict(source="made up for the test", batch=2,
                    lengths_s=dict(mean=0.4, log_sd=0.2, min=0.3, max=0.5), pad_to=50,
                    hop_s=0.01))
    tiny.write(os.path.join(bench, "workloads", "ctc_x.prefix4.json"),
               dict(entry="ctc_recognizer", head={"scale": 32.0}, width=4, warmup_units=1,
                    trace_units=1, limits=dict(logit_gap=1e-3, hyp_ll_gap=1e-3,
                                               top_hyp_gap=1e-6, beam_mass_rel=1e-4)))
    with open(os.path.join(bench, "metrics", "units_traced.py"), "w") as f:
        f.write(NEW_METRIC)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["configs"].append(dict(name="conformer_x_ctc",
                                    source="https://arxiv.org/abs/2005.08100",
                                    file="portbench/configs/conformer_x_ctc.json", reduced=[],
                                    why="one block"))
    manifest["workloads"].append(dict(name="ctc_x.prefix4", config="conformer_x_ctc",
                                      traffic="offline_tiny", chips=1, why="added as files"))
    for m in manifest["end_to_end"]:
        if m["name"] == "offline_audio_s_per_s":
            m["workloads"].append("ctc_x.prefix4")
    manifest["per_layer"].append(dict(name="units_traced", unit="units", better="higher",
                                      source="host_clock", layer="harness",
                                      moves="offline_audio_s_per_s", workloads=["ctc_x.prefix4"]))
    tiny.write(path, manifest)


def test_added_files_are_found(tree):
    add_files(tree)
    result, _ = tiny.run(tree, "ctc_x.prefix4")
    assert result["correct"]
    assert set(result["metrics"]) == {"offline_audio_s_per_s", "setup_s"}
    traced, _ = tiny.run(tree, "ctc_x.prefix4", trace=True)
    assert traced["metrics"]["units_traced"]["value"] == 1
    assert "search_ms.prefix16" not in traced["metrics"]


def test_metrics_follow_the_manifest(tree):
    cell = harness.Cell("rnnt_m.stream", tree)
    assert sorted(m["name"] for m in cell.metrics(False)) == ["push_p95_ms", "setup_s"]
    names = {m["name"] for m in cell.metrics(True)}
    assert {"mfu.stream", "launches_per_push.stream", "idle_share.stream"} <= names
    assert "mfu.serve" not in names


def test_same_seed_same_inputs(tree):
    from portbench import traffic

    cell = harness.Cell("ctc_l.prefix16", tree)
    big = 2 ** 31 + 77
    a = traffic.make_batch(harness.Context(cell, big, torch.device("cpu")), 3, 16)
    b = traffic.make_batch(harness.Context(cell, big, torch.device("cpu")), 3, 16)
    c = traffic.make_batch(harness.Context(cell, big + 1, torch.device("cpu")), 3, 16)
    assert torch.equal(a["feats"], b["feats"]) and (a["lens"] == b["lens"]).all()
    assert not torch.equal(a["feats"], c["feats"])
    # lengths drawn independently from the mix's range
    lo, hi = (round(cell.traffic["lengths_s"][k] / cell.traffic["hop_s"]) for k in ("min", "max"))
    for lens in (a["lens"], c["lens"]):
        assert lens.shape == (cell.traffic["batch"],)
        assert lo <= lens.min() and lens.max() <= hi


def test_lengths_follow_the_source():
    """The log-normal's mean and its kept range, over many draws."""
    import numpy as np

    from portbench import traffic

    path = os.path.join(ROOT, "portbench", "traffic", "offline_librispeech_b256.json")
    with open(path) as f:
        tr = dict(json.load(f), batch=4096)
    secs = traffic.lengths(tr, np.random.default_rng(5)) * tr["hop_s"]
    dist = tr["lengths_s"]
    assert dist["min"] <= secs.min() and secs.max() <= dist["max"]
    assert abs(secs.mean() - dist["mean"]) < 0.05 * dist["mean"]


def test_judge_rows_hold_the_longest(tree):
    cell = harness.Cell("ctc_l.prefix16", tree)
    ctx = harness.Context(cell, 2 ** 31 + 5, torch.device("cpu"))
    lens = [5, 9, 3, 7, 1, 8]
    ctx.spec = dict(ctx.spec, judge_rows=3)
    rows = ctx.judge_rows(0, lens)
    assert len(rows) == 3 and 1 in rows and rows == sorted(rows)
    assert rows == ctx.judge_rows(0, lens)
    ctx.spec = dict(ctx.spec, judge_rows=10)
    assert ctx.judge_rows(0, lens) == list(range(6))


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would go ahead")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "portbench", "run.py"),
                        "--workload", "ctc_l.prefix16", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, cwd=ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_only_the_benchmark_needed(tmp_path):
    """Alone in a directory with BENCHMARK.json and portbench/, without the
    port, a run fails and prints no result."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ctc_l.prefix16",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path, env=env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
