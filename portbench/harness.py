"""One run of one cell: find its files by name, set it up, drive its entry
for the measured window, judge what the window produced against the plain
reference, and print the result.

Everything that belongs to one configuration, traffic mix, entry or metric
lives in a file of its own that this module finds by the name that
``BENCHMARK.json`` gives:

- ``portbench/workloads/<cell>.json``: the cell's entry, its options, the
  limits of the numbers that decide ``correct`` and how many units the
  traced run traces;
- the configuration's ``file`` from ``BENCHMARK.json``;
- ``portbench/traffic/<traffic>.json``: the mix, read by :mod:`portbench.traffic`;
- ``portbench/entries/<entry>.py``: a class ``Entry`` (see below);
- ``portbench/metrics/<metric>.py``: ``read(run)``, the metric's value or
  None when the run holds nothing to read.

An entry is built with a :class:`Context` and has ``SPAN`` (the name of one
unit of its closed loop: a request, a step, a call), ``setup()`` (weights,
inputs and warm-up; counted in ``setup_s``), ``unit(i)`` (the ``i``-th unit
of the window, which ends when the device has finished it; returns a dict
that the metrics read), ``release()`` (drops the program's state) and
``compare(control)``, a list of ``(name, value, limit)``: the run is correct
when every value lies within its limit.

With ``--trace 1`` a run drives the same closed loop untraced for the
window's seconds (the per-layer metrics that time a part of a unit, and
``mfu.*``, read those units) and then ``trace_units`` more units under
``torch.profiler`` (launches, kernels' device time, the idle share).
"""

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "optax", "pydrobert_tpu")
TRACE_PREFIX = "portbench."


class RunError(RuntimeError):
    """A run that cannot give a result: no card, a missing file."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: str = ROOT):
    """``<root>/portbench/<kind>/<name>.py`` as a module (names may hold
    dots)."""
    path = os.path.join(root, "portbench", kind, name + ".py")
    if not os.path.isfile(path):
        raise RunError(f"no {kind[:-1]} file {os.path.relpath(path, ROOT)}")
    mod_name = f"portbench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seed_words(*keys) -> list:
    """32-bit words of a seed and keys (ints or strings), for numpy's
    ``SeedSequence``; any integer seed, however large, is taken whole."""
    words = []
    for k in keys:
        if isinstance(k, str):
            words.append(zlib.crc32(k.encode()))
            continue
        k = int(k)
        words.append(1 if k < 0 else 0)
        k = abs(k)
        while True:
            words.append(k & 0xFFFFFFFF)
            k >>= 32
            if not k:
                break
    return words


def mixed_seed(*keys) -> int:
    """A 63-bit seed for a ``torch.Generator`` from a seed and keys."""
    lo, hi = np.random.SeedSequence(seed_words(*keys)).generate_state(2, np.uint32)
    return (int(hi) << 32 | int(lo)) & ((1 << 63) - 1)


class Cell:
    """The cell's entries in ``<root>/BENCHMARK.json`` and its files."""

    def __init__(self, name: str, root: str = ROOT):
        path = os.path.join(root, "BENCHMARK.json")
        if not os.path.isfile(path):
            raise RunError("BENCHMARK.json not found at the checkout's root")
        manifest = load_json(path)
        self.root = root
        self.manifest = manifest
        found = [w for w in manifest["workloads"] if w["name"] == name]
        if not found:
            raise RunError(f"no cell {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = found[0]
        self.chips = int(self.entry["chips"])
        cfg_entry = [c for c in manifest["configs"] if c["name"] == self.entry["config"]][0]
        here = os.path.join(root, "portbench")
        self.config = load_json(os.path.join(root, cfg_entry["file"]))
        self.spec = load_json(os.path.join(here, "workloads", name + ".json"))
        self.traffic = load_json(os.path.join(here, "traffic", self.entry["traffic"] + ".json"))

    def module(self, kind, name):
        return load_module(kind, name, self.root)

    def metrics(self, trace: bool):
        """The metrics this cell reports: its end-to-end ones untraced, its
        per-layer ones traced."""
        e2e = [
            m for m in self.manifest["end_to_end"]
            if "workloads" not in m or self.name in m["workloads"]
        ]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [
            m for m in self.manifest["per_layer"]
            if self.name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in moved)
        ]


class Context:
    """What an entry is given: the cell, its seed and its device."""

    def __init__(self, cell: Cell, seed: int, device):
        self.cell = cell
        self.seed = int(seed)
        self.device = device
        self.config = cell.config
        self.spec = cell.spec
        self.traffic = cell.traffic
        self.trace = False

    def rng(self, *keys) -> np.random.Generator:
        return np.random.default_rng(seed_words(self.seed, *keys))

    def generator(self, *keys):
        import torch

        g = torch.Generator(device=self.device)
        g.manual_seed(mixed_seed(self.seed, *keys))
        return g

    def judge_rows(self, key, lens) -> list:
        """The rows of a batch that the judge reads: ``judge_rows`` of the
        cell's file drawn from the seed, the longest utterance among them
        (all rows when the batch holds no more)."""
        n = int(self.spec.get("judge_rows", len(lens)))
        if n >= len(lens):
            return list(range(len(lens)))
        longest = int(np.argmax(lens))
        rest = [r for r in range(len(lens)) if r != longest]
        keys = key if isinstance(key, tuple) else (key,)
        pick = self.rng("judge_rows", *keys).choice(rest, n - 1, replace=False)
        return sorted([longest] + [int(r) for r in pick])


class Stamps:
    """Points in a unit on the device's timeline: CUDA events on a card,
    which time the device's work without stalling the host, the host's
    clock elsewhere (where every call has finished when it returns)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, a, b) -> float:
        """Milliseconds from mark ``a`` to mark ``b`` (both done)."""
        return float(a.elapsed_time(b)) if self.cuda else (b - a) * 1e3


class Run:
    """What the metrics read: the window's units and times, and with
    ``--trace 1`` the profiler's records of the traced units and, in
    ``plain_units``, the units of the untraced window driven before them
    (the profiler's host costs slow a launch-bound unit severalfold, so
    times of a unit or its parts are read from these)."""

    def __init__(self, cell, setup_s, window_s, units, records=None, power_limit_w=None,
                 plain_units=()):
        self.cell = cell
        self.plain_units = list(plain_units)
        self.config = cell.config
        self.traffic = cell.traffic
        self.spec = cell.spec
        self.setup_s = setup_s
        self.window_s = window_s
        self.units = units
        self.records = records
        self.power_limit_w = power_limit_w


def power_limit_w():
    """The card's power limit in watts, from ``nvidia-smi`` (None when it
    cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30,
        )
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def timed_unit(entry, i):
    """Unit ``i``'s record, with its wall ms unless the entry timed it."""
    u0 = time.perf_counter()
    rec = entry.unit(i)
    rec.setdefault("ms", (time.perf_counter() - u0) * 1e3)
    return rec


def drive(entry, seconds: float, sync):
    """The closed loop: units back to back until ``seconds`` have passed;
    the window ends with the unit that crosses it."""
    units = []
    t0 = time.perf_counter()
    while not units or time.perf_counter() - t0 < seconds:
        units.append(timed_unit(entry, len(units)))
    sync()
    return units, time.perf_counter() - t0


def drive_traced(entry, seconds: float, count: int, sync):
    """The untraced closed loop for ``seconds``, then ``count`` more units
    under ``torch.profiler``, each inside a ``portbench.<SPAN>`` range;
    returns both lists of units and the records."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .records import Records

    plain, _ = drive(entry, seconds, sync)
    units = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(len(plain), len(plain) + count):
            with record_function(TRACE_PREFIX + entry.SPAN):
                units.append(timed_unit(entry, i))
        sync()
    return plain, units, Records(prof, TRACE_PREFIX + entry.SPAN)


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, control: int = 0,
             device="cuda", t_start=None, entry_hook=None):
    """Set up, drive and judge one cell; returns the result's dict and the
    compared numbers. ``device`` other than ``cuda`` (tests only) skips
    nothing else; ``entry_hook(entry)`` lets a test break the timed path."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        from pydrobert_tpu_torch.utils.cache import enable_cache

        enable_cache(os.path.join(HERE, "_cache", "build"))
    ctx = Context(cell, seed, torch.device(device))
    ctx.trace = bool(trace)
    entry = cell.module("entries", cell.spec["entry"]).Entry(ctx)
    if entry_hook is not None:
        entry_hook(entry)
    entry.setup()
    sync()
    setup_s = time.perf_counter() - t_start
    records, plain = None, []
    if trace:
        plain, units, records = drive_traced(entry, seconds, int(cell.spec["trace_units"]),
                                             sync)
        window_s = records.window_s
    else:
        units, window_s = drive(entry, seconds, sync)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    entry.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = entry.compare(control=control) or [("compared", math.inf, 0)]
    for line in getattr(entry, "notes", lambda: [])():
        print(line, file=sys.stderr)
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    run = Run(cell, setup_s, window_s, units, records, power_limit_w() if on_card else None,
              plain)
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {
        "platform": "gpu" if on_card else torch.device(device).type,
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
        "power_limit_w": run.power_limit_w,
    }
    if records is not None:
        dev["busy_s"] = records.busy_s
        dev["window_s"] = records.window_s
    result = {
        "correct": correct,
        "attempted": len(plain) + len(units),
        "failed": sum(1 for u in units if u.get("failed")),
        "metrics": metrics,
        "device": dev,
    }
    if records is not None:
        result["breakdown"] = records.breakdown()
    result["checks"] = {
        name: {"value": float(v) if math.isfinite(v) else str(v), "limit": lim}
        for name, v, lim in checks
    }
    return result, checks


def main(args, t_start):
    import torch

    try:
        cell = Cell(args.workload)
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark runs on the card only")
        if torch.cuda.device_count() < cell.chips:
            raise RunError(
                f"cell {cell.name} needs {cell.chips} cards, found {torch.cuda.device_count()}"
            )
        result, checks = run_cell(
            cell, args.seed, args.seconds, bool(args.trace), int(args.control),
            t_start=t_start,
        )
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = banned_modules()
    if found:
        print(f"portbench: the run imported {', '.join(found)}", file=sys.stderr)
        return 3
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
