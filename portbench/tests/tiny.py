"""A copy of the benchmark at a size the CPU holds: the same cells,
entries and metrics, with the configurations and mixes shrunk (a few
narrow layers, batches of four short utterances), for the tests."""

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

# float32 compute, so that a sound run reads the reference to rounding and
# every planted fault stands out
SMALL = dict(num_layers=2, d_model=32, num_heads=4, conv_kernel=5, num_filts=16,
             subsample_channels=8, vocab_size=40, dtype="float32")
SMALL_RNNT = dict(SMALL, pred_dim=16, joint_dim=16, attention_context=[4, 0])
# limits at this size: the program computes in float32 here and reads the
# reference to rounding (the cells' own limits are set from chip readings)
LIMITS = {
    "logit_gap": 1e-3, "hyp_ll_gap": 1e-3, "top_hyp_gap": 1e-6, "beam_mass_rel": 1e-4,
    "token_gap": 1e-3,
}
# the transducer's emissions at this size: about one token a frame
TINY_EMIT_SHARE = 0.5
# batches of four utterances of 0.4-0.8 s (raw frames 40-80)
TINY_LENGTHS = dict(mean=0.6, log_sd=0.2, min=0.4, max=0.8)
TRAFFIC = {
    "offline_librispeech_b256": dict(batch=4, lengths_s=TINY_LENGTHS, pad_to=80),
    "offline_librispeech_b512": dict(batch=4, lengths_s=TINY_LENGTHS, pad_to=80),
    "stream_librispeech_n128": dict(batch=4, lengths_s=TINY_LENGTHS, pad_to=96),
}
# the judge reads three of the four rows: a row left out must not matter
JUDGE_ROWS = 3


def make_tree(dst):
    """``dst`` as a checkout holding ``BENCHMARK.json`` and a shrunk copy
    of ``portbench/``; returns ``dst``."""
    shutil.copytree(BENCH, os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("_cache", "__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        path = os.path.join(dst, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(SMALL_RNNT if cfg["model"] == "ConformerTransducer" else SMALL)
        write(path, cfg)
    write(os.path.join(dst, "BENCHMARK.json"), bench)
    for w in bench["workloads"]:
        path = os.path.join(dst, "portbench", "workloads", w["name"] + ".json")
        with open(path) as f:
            spec = json.load(f)
        spec["limits"] = {k: LIMITS[k] for k in spec["limits"]}
        spec["judge_rows"] = JUDGE_ROWS
        if "blank_emit_share" in spec.get("head", {}):
            spec["head"]["blank_emit_share"] = TINY_EMIT_SHARE
        write(path, spec)
    for name, small in TRAFFIC.items():
        path = os.path.join(dst, "portbench", "traffic", name + ".json")
        with open(path) as f:
            tr = json.load(f)
        tr.update(small)
        write(path, tr)
    return dst


def write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def run(root, cell, seed=11, seconds=0.3, trace=False, control=False, hook=None):
    from portbench import harness

    return harness.run_cell(harness.Cell(cell, root), seed, seconds, trace, control,
                            device="cpu", entry_hook=hook)
