"""The port's profiling utilities (``utils.profiling``, ``utils.hlostats``,
``utils.cache``) against the JAX package's, each test named after the JAX
test it mirrors (``tests/test_foundation.py``, ``tests/test_decoding.py``):
the same host fingerprint, the same loop trip counts, and the same FLOPs
and transcendentals where both count the same operations (exactly)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pydrobert_tpu.utils import cache as jcache
from pydrobert_tpu.utils import hlostats as jstats
from pydrobert_tpu.utils import profiling as jprof
from pydrobert_tpu_torch.ops._loops import frame_loop
from pydrobert_tpu_torch.utils import cache as pcache
from pydrobert_tpu_torch.utils import hlostats as pstats
from pydrobert_tpu_torch.utils import profiling as pprof


def test_host_keyed_compile_cache(tmp_path, monkeypatch):
    fp = pcache.host_fingerprint()
    assert fp and fp == pcache.host_fingerprint() == jcache.host_fingerprint()
    d = pcache.compilation_cache_dir(str(tmp_path / "pdt"))
    assert d.endswith(fp) and str(tmp_path) in d  # no card here
    from pydrobert_tpu_torch import native
    from pydrobert_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_BUILD_DIR", _build._BUILD_DIR)
    monkeypatch.setattr(native, "_BUILD_DIR", native._BUILD_DIR)
    monkeypatch.delenv("PDT_CACHE_DIR", raising=False)
    got = pcache.enable_cache(str(tmp_path / "pdt"))
    assert got == d == _build._BUILD_DIR and os.path.isdir(d)
    assert native._BUILD_DIR == str(tmp_path / "pdt") + "-" + fp


def _port_loop(x, trips):
    def body(c, fr, t):
        return c * 1.0001 + 1.0

    return frame_loop(body, x, (), 0, trips, "test")


def test_profile_program_reports_loop_and_timing():
    """A 23-trip loop in both packages: trips, launches a trip (the port
    counts one multiply and one add, XLA one fused kernel), timing and the
    sync overhead."""

    def f(x):
        def step(c, _):
            return c * 1.0001 + 1.0, None

        out, _ = jax.lax.scan(step, x, None, length=23)
        return out

    jst = jprof.profile_program(f, jnp.ones((16,)), calls=2, reps=2)
    st = pprof.profile_program(_port_loop, torch.ones(16), 23, calls=2, reps=2)
    assert st["loop_trip_count"] == jst["loop_trip_count"] == 23
    assert st["loop_kernels"] == 2 and jst["loop_kernels"] >= 1
    assert st["seconds_per_call"] > 0 and "us_per_kernel" in st
    assert st["loop_op_histogram"] == {"aten::mul": 1, "aten::add": 1}
    assert set(jst) <= set(st) | {"loop_op_histogram"}
    assert pprof.measure_sync_overhead(reps=3) > 0


def test_count_body_kernels_trip_counts():
    """Nested loops in an exported program: an outer body of 5 trips and
    an inner one of 37, as the JAX package finds them in HLO."""
    from torch._higher_order_ops.scan import scan

    def f(x):
        def step(c, _):
            return c * 1.0001 + 1.0, None

        def outer(c, _):
            c2, _ = jax.lax.scan(step, c, None, length=37)
            return c2 * 0.999, None

        return jax.lax.scan(outer, x, None, length=5)[0]

    jb = jstats.count_body_kernels(jax.jit(f).lower(jnp.ones((4,))).compile().as_text())

    class M(torch.nn.Module):
        def forward(self, x):
            def inner(c, t):
                return [c[0] * 1.0001 + 1.0], []

            def outer(c, t):
                (c2,), _ = scan(inner, c, [torch.arange(37)])
                return [c2 * 0.999], []

            return scan(outer, [x], [torch.arange(5)])[0][0]

    ep = torch.export.export(M(), (torch.ones(4),), strict=False)
    pb = pstats.count_body_kernels(ep)
    loops = {k: v for k, v in pb.items() if k != "main"}
    trips = sorted(b["trip_count"] for b in loops.values())
    assert trips == sorted(b["trip_count"] for b in jb.values()) == [5, 37]
    hot = max(loops.values(), key=lambda b: (b["trip_count"], b["kernels"]))
    assert hot["trip_count"] == 37 and hot["ops"]["mul"] == 1 and hot["kernels"] == 2


def test_compiled_stats_counts_match_xla_on_a_matmul():
    """FLOPs of a matrix product and the transcendentals of an exponential
    as XLA's cost analysis counts them; the keys of the JAX dict."""
    rng = np.random.RandomState(0)
    a, b = rng.randn(8, 12).astype(np.float32), rng.randn(12, 5).astype(np.float32)

    def jf(a, b):
        return jnp.exp(a @ b)

    js = jstats.compiled_stats(jf, a, b)
    ps = pstats.compiled_stats(lambda a, b: torch.exp(a @ b), torch.from_numpy(a),
                               torch.from_numpy(b))
    assert ps["flops"] == 2 * 8 * 12 * 5 <= js["flops"]
    assert ps["transcendentals"] == js["transcendentals"] == 8 * 5
    # inputs read and the product written, then read and the exponential
    # written: XLA fuses the exponential into the product's output
    assert ps["bytes_accessed"] == 4 * (8 * 12 + 12 * 5 + 3 * 8 * 5)
    assert set(js) <= set(ps)
    assert ps["loop_kernels"] == 0 and ps["loop_op_histogram"] == {}


def test_trace_and_annotate_write_a_chrome_trace(tmp_path):
    with pprof.trace(str(tmp_path)):
        with pprof.annotate("pdt_region", step=3):
            torch.ones(4).add_(1.0)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    events = json.load(open(tmp_path / files[0]))["traceEvents"]
    assert any(e.get("name") == "pdt_region step=3" for e in events)


def test_compiled_stats_on_the_transducer_greedy_loop():
    """The greedy search's trips are marked: one trip a frame or an
    emission, each the same operators."""
    from pydrobert_tpu_torch.ops.transducer import transducer_greedy_search

    g = torch.Generator().manual_seed(0)
    enc = torch.randn(3, 7, 5, generator=g)
    proj = torch.randn(5, 6, generator=g)

    def joint(e, p):
        return e @ proj + p

    def pred(tok, state):
        return state + tok[:, None].float() * 0.01, state

    st = pstats.compiled_stats(
        transducer_greedy_search, enc, torch.tensor([7, 5, 2]), pred, joint,
        torch.zeros(3, 6), 5, 2,
    )
    assert st["loop_name"] == "transducer_greedy"
    assert 7 <= st["loop_trip_count"] <= 7 * 3
    assert st["loop_kernels"] > 5
