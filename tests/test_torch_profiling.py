"""The port's profiling utilities (``utils.profiling``, ``utils.hlostats``,
``utils.cache``) against the JAX package's, each test named after the JAX
test it mirrors (``tests/test_foundation.py``, ``tests/test_decoding.py``):
the same host fingerprint, the same loop trip counts, and the same FLOPs
and transcendentals where both count the same operations (exactly). The
port's own spans (``profiling.span``) are held to the work they mark: a
streaming push or finish, the searches, their loop trips and host syncs."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydrobert_tpu.utils import cache as jcache
from pydrobert_tpu.utils import hlostats as jstats
from pydrobert_tpu.utils import profiling as jprof
from pydrobert_tpu_torch import config as pconfig
from pydrobert_tpu_torch import serving as pserving
from pydrobert_tpu_torch.models import conformer as pconf
from pydrobert_tpu_torch.models import transducer as prnnt
from pydrobert_tpu_torch.ops import decoding as pdec
from pydrobert_tpu_torch.ops import transducer as ptrans
from pydrobert_tpu_torch.ops._loops import frame_loop
from pydrobert_tpu_torch.utils import cache as pcache
from pydrobert_tpu_torch.utils import hlostats as pstats
from pydrobert_tpu_torch.utils import profiling as pprof

# the span tests run on the serving tests' tiny causal CTC and transducer
# models: tests/conftest.py only registers markers, so a fixture that two
# modules share is imported from the one that defines it (a third module
# needing them would move them to a helper module, as tests/_lm_dicts.py)
from test_torch_serving import RNNT_ENC, models, rnnt  # noqa: F401


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


# ---- the port's spans: which range holds which, and that they change nothing ----


def _pydt_ranges(prof):
    """``(name, names of the ranges around it)`` of every ``pydt.`` range
    of a profile, in order."""
    out = []
    for e in prof.events():
        if not e.name.startswith("pydt."):
            continue
        outer, p = [], e.cpu_parent
        while p is not None:
            outer.append(p.name)
            p = p.cpu_parent
        out.append((e.name, outer))
    return out


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _pydt_ranges(prof)


def _greedy_session(pmodel):
    return pserving.StreamingTransducerRecognizer(
        pmodel, chunk=4, mode="greedy", max_symbols_per_frame=3, max_frames=32
    )


@pytest.mark.parametrize("size, windows", [(3, 0), (16, 1), (45, 2)])
def test_push_span_holds_its_encodes_advances_and_syncs(rnnt, size, windows, monkeypatch):
    """One push is one ``pydt.stream/push``. Inside it: an encode (one
    ``pydt.stream/encode`` holding one ``pydt.stream/encode_cached``) and a
    greedy advance for each chunk it decodes (``size // 4 // 4`` at chunk
    4), the two length copies of each, and one ``pydt.sync/transducer_greedy``
    for each check the loop made (counted here: one before each run of
    trips, and the last, which finds nothing left)."""
    _, _, pmodel, feats, lens = rnnt
    made = {"advances": 0, "runs": 0}
    advance, loop = ptrans.transducer_greedy_advance, ptrans.frame_loop

    def counted_advance(*args, **kwargs):
        made["advances"] += 1
        return advance(*args, **kwargs)

    def counted_loop(*args, **kwargs):
        made["runs"] += 1
        return loop(*args, **kwargs)

    monkeypatch.setattr(ptrans, "transducer_greedy_advance", counted_advance)
    monkeypatch.setattr(ptrans, "frame_loop", counted_loop)
    rec = _greedy_session(pmodel)
    sess = rec.start(feats.shape[0])
    _, ranges = _profiled(
        lambda: rec.push(sess, torch.from_numpy(feats[:, :size]), np.clip(lens, 0, size))
    )
    checks = made["advances"] + made["runs"]
    assert made["advances"] == windows and checks >= 2 * windows
    names = [n for n, _ in ranges]
    assert names.count("pydt.stream/push") == 1
    want = {
        "pydt.stream/encode": windows,
        "pydt.stream/encode_cached": windows,
        "pydt.search/transducer_greedy": windows,
        "pydt.sync/stream_window": windows,
        "pydt.sync/stream_advance": windows,
        "pydt.sync/transducer_greedy": checks,
    }
    assert {n: names.count(n) for n in want} == want
    for name, outer in ranges:
        if name != "pydt.stream/push" and not name.startswith("pydt.loop/"):
            assert "pydt.stream/push" in outer, name
    for name, outer in ranges:
        if name == "pydt.sync/transducer_greedy":
            assert "pydt.search/transducer_greedy" in outer
            assert not any(o.startswith("pydt.loop/") for o in outer)
        if name == "pydt.sync/stream_window":
            assert "pydt.stream/encode_cached" in outer
        if name == "pydt.stream/encode_cached":
            assert outer[0] == "pydt.stream/encode"


def _finish_ranges(pmodel, feats, lens, size, monkeypatch, owner, encoder):
    """A greedy session's finish after a push of ``size`` frames, profiled:
    the calls it made of ``owner.encoder``, of the greedy advance and of
    the frame loops, and its ``pydt.`` ranges, each checked to lie inside
    the one ``pydt.stream/finish``."""
    made = {"encodes": 0, "advances": 0, "runs": 0}

    def counted(key, fn):
        def call(*args, **kwargs):
            made[key] += 1
            return fn(*args, **kwargs)

        return call

    rec = _greedy_session(pmodel)
    sess = rec.start(feats.shape[0])
    rec.push(sess, torch.from_numpy(feats[:, :size]), np.clip(lens, 0, size))
    monkeypatch.setattr(owner, encoder, counted("encodes", getattr(owner, encoder)))
    monkeypatch.setattr(ptrans, "transducer_greedy_advance",
                        counted("advances", ptrans.transducer_greedy_advance))
    monkeypatch.setattr(ptrans, "frame_loop", counted("runs", ptrans.frame_loop))
    _, ranges = _profiled(lambda: rec.finish(sess))
    names = [n for n, _ in ranges]
    assert names.count("pydt.stream/finish") == 1
    for name, outer in ranges:
        if name != "pydt.stream/finish":
            assert "pydt.stream/finish" in outer, name
        if name == "pydt.stream/encode_cached":
            assert outer[0] == "pydt.stream/encode"
    return made, names


@pytest.mark.parametrize("size, windows, tail", [(16, 0, 0), (21, 1, 0), (45, 1, 1)])
def test_finish_span_holds_its_encodes_advances_and_syncs(rnnt, size, windows, tail,
                                                          monkeypatch):
    """A finish after a push of ``size`` frames is one
    ``pydt.stream/finish``. Inside it: an encode (one
    ``pydt.stream/encode_cached`` in one ``pydt.stream/encode``), its
    length copy, an advance and its length copy for each chunk still on
    the frontier; for the deferred tails, whose frames were kept when their
    chunks were encoded, one more advance and its length copy, and no
    encode; and one ``pydt.sync/transducer_greedy`` for each check the
    loops made."""
    _, _, pmodel, feats, lens = rnnt
    made, names = _finish_ranges(pmodel, feats, lens, size, monkeypatch, pserving,
                                 "encoder_stream_step")
    assert made["encodes"] == windows and made["advances"] == windows + tail
    want = {
        "pydt.stream/encode": windows,
        "pydt.stream/encode_cached": windows,
        "pydt.search/transducer_greedy": windows + tail,
        "pydt.sync/stream_window": windows,
        "pydt.sync/stream_advance": windows + tail,
        "pydt.sync/stream_tail": 0,
        "pydt.sync/transducer_greedy": made["advances"] + made["runs"],
    }
    assert {n: names.count(n) for n in want} == want


@pytest.mark.parametrize("size, windows, tail", [(16, 0, 0), (21, 1, 0), (45, 1, 1)])
def test_window_route_finish_span_encodes_the_deferred_tails(rnnt, size, windows, tail,
                                                             monkeypatch):
    """A mixture-of-experts session keeps the window route: its finish
    holds an encode (no ``pydt.stream/encode_cached``), its length copy,
    an advance and its length copy for each window still on the frontier;
    for the deferred tails one more encode and advance, their length
    copies, and the tail pick's copy (``pydt.sync/stream_tail``)."""
    _, _, _, feats, lens = rnnt
    enc = pconf.ConformerConfig(dtype=torch.float32, **dict(RNNT_ENC, num_experts=4))
    pmodel = prnnt.ConformerTransducer(
        prnnt.TransducerConfig(encoder=enc, pred_dim=12, joint_dim=12), device="cpu",
        generator=torch.Generator().manual_seed(0),
    )
    made, names = _finish_ranges(pmodel, feats, lens, size, monkeypatch, pmodel, "encode")
    assert made["encodes"] == made["advances"] == windows + tail
    want = {
        "pydt.stream/encode": windows + tail,
        "pydt.stream/encode_cached": 0,
        "pydt.search/transducer_greedy": windows + tail,
        "pydt.sync/stream_window": windows + tail,
        "pydt.sync/stream_advance": windows + tail,
        "pydt.sync/stream_tail": tail,
        "pydt.sync/transducer_greedy": made["advances"] + made["runs"],
    }
    assert {n: names.count(n) for n in want} == want


@pytest.mark.parametrize("route", ["scan", "beam"])
def test_prefix_search_span_holds_every_trip(models, route, monkeypatch):
    """``CTCPrefixSearch`` is one ``pydt.search/ctc_prefix``, around every
    trip of its frame loop (one a frame after the first on the scan route,
    none on the raw whole-loop route, whose plain version has no frame
    loop), with no host sync inside a trip."""
    _, _, pmodel, feats, lens = models
    monkeypatch.setattr(pconfig, "USE_BEAM_KERNEL", "auto" if route == "beam" else "0")
    monkeypatch.setattr(pconfig, "DECODE_RENORM", route != "beam")
    with torch.no_grad():
        logits, out_lens = pmodel(torch.from_numpy(feats), torch.from_numpy(lens))
    x = logits.transpose(0, 1).contiguous()
    search = pdec.CTCPrefixSearch(4)
    assert search._takes_beam_route(*x.shape[:2], x.shape[2] - 1) == (route == "beam")
    _, ranges = _profiled(lambda: search(x, out_lens))
    names = [n for n, _ in ranges]
    assert names.count("pydt.search/ctc_prefix") == 1
    trips = [outer for n, outer in ranges if n == "pydt.loop/ctc_prefix_search"]
    assert len(trips) == (x.shape[0] - 1 if route == "scan" else 0)
    assert all("pydt.search/ctc_prefix" in outer for outer in trips)
    for name, outer in ranges:
        if name.startswith(pprof.SYNC_PREFIX):
            assert not any(o.startswith(pprof.LOOP_PREFIX) for o in outer), name


@pytest.mark.parametrize("path", ["stream", "prefix_search"])
def test_spans_are_null_without_a_profiler_and_change_no_output(models, rnnt, path,
                                                                monkeypatch):
    """``span`` is a null context unless a profiler runs, and while export
    or compile traces the code even then; a profiled call's outputs are
    bit-equal to an unprofiled one's."""
    import contextlib

    from torch.profiler import profile

    assert isinstance(pprof.span("x"), contextlib.nullcontext)
    assert isinstance(pprof.loop_trip("x"), contextlib.nullcontext)
    with profile():
        assert not isinstance(pprof.span("x"), contextlib.nullcontext)
        for flag in ("is_exporting", "is_compiling"):
            with monkeypatch.context() as m:
                m.setattr(torch.compiler, flag, lambda: True)
                assert isinstance(pprof.span("x"), contextlib.nullcontext)
    if path == "stream":
        _, _, pmodel, feats, lens = rnnt

        def call():
            rec = _greedy_session(pmodel)
            sess = rec.start(feats.shape[0])
            first = rec.push(sess, torch.from_numpy(feats[:, :21]), np.clip(lens, 0, 21))
            first = tuple(t.clone() for t in first)
            rest = np.clip(lens - 21, 0, feats.shape[1] - 21)
            rec.push(sess, torch.from_numpy(feats[:, 21:]), rest)
            return first + tuple(rec.finish(sess))
    else:
        _, _, pmodel, feats, lens = models
        with torch.no_grad():
            logits, out_lens = pmodel(torch.from_numpy(feats), torch.from_numpy(lens))
        x = logits.transpose(0, 1).contiguous()

        def call():
            return pdec.CTCPrefixSearch(4)(x, out_lens)

    plain = call()
    traced, ranges = _profiled(call)
    assert ranges
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_exported_recognizer_holds_no_profiler_operator(models, tmp_path, monkeypatch):
    """Exported under a running profiler, the recognizer's program on the
    scan route (``USE_BEAM_KERNEL="0"``) holds no profiler operator and the
    same operators in every body as one exported without it."""
    from torch.profiler import profile

    from pydrobert_tpu_torch import export as pexport

    monkeypatch.setattr(pconfig, "USE_BEAM_KERNEL", "0")
    _, _, pmodel, feats, lens = models

    def bodies(path):
        art = pexport.export_ctc_recognizer(str(path), pmodel, specs=[(3, 45)], width=4)
        return pstats.count_body_kernels(art._programs[0])

    plain = bodies(tmp_path / "plain")
    with profile():
        traced = bodies(tmp_path / "traced")
    assert traced == plain
    assert len(plain) == 2  # the main graph and the search's scan body
    ops = [op for b in traced.values() for op in b["ops"]]
    assert ops and not any("record_function" in op or "profiler" in op for op in ops)


@pytest.mark.parametrize(
    "lm_kind, route, eos, max_iters",
    [("seq2seq", "dense", 0, 6), ("seq2seq", "dense", None, 5), ("ngram", "sparse", 3, 9),
     ("ngram", "dense", 3, 9)],
)
def test_beam_search_span_holds_every_trip_and_changes_nothing(lm_kind, route, eos, max_iters,
                                                               monkeypatch):
    """``BeamSearch`` is one ``pydt.search/beam`` around every trip of its
    step loop (``pydt.loop/beam_search``, one a step after the first until
    every element is done); with eos each trip opens with the host's read
    of ``done`` (``pydt.sync/beam_done``) inside it. Traced results are
    bit-equal to untraced ones, and the freeze of finished elements gives
    what it gave before it learned to skip unchanged leaves."""
    from test_torch_search import lookup_pair, s2s_pair

    if lm_kind == "seq2seq":
        _, plm, feats, lens = s2s_pair()
        with torch.no_grad():
            state = plm.initial_state(torch.from_numpy(feats), torch.from_numpy(lens))
        N = feats.shape[0]
    else:
        _, plm = lookup_pair(12, 3, 0)
        state, N = None, 2
        if route == "dense":
            monkeypatch.setattr(pconfig, "SPARSE_FUSION_MAX_CORRECTIONS", 0)
    search = pdec.BeamSearch(plm, 4, eos=eos)
    assert search.takes_sparse_route() == (route == "sparse")
    calls = []
    step = plm.calc_idx_log_probs

    def counted(*args):
        calls.append(1)
        return step(*args)

    monkeypatch.setattr(plm, "calc_idx_log_probs", counted)

    def call():
        with torch.no_grad():
            return search(state, batch_size=N, max_iters=max_iters)

    plain = call()
    made = len(calls)
    traced, ranges = _profiled(call)
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)
    names = [n for n, _ in ranges]
    assert names.count("pydt.search/beam") == 1
    trips = [outer for n, outer in ranges if n == "pydt.loop/beam_search"]
    syncs = [outer for n, outer in ranges if n == "pydt.sync/beam_done"]
    assert all("pydt.search/beam" in outer for outer in trips + syncs)
    assert all("pydt.loop/beam_search" in outer for outer in syncs)
    if eos is None:
        assert len(trips) == max_iters - 1 and not syncs
    else:
        assert len(syncs) == len(trips) and 1 <= len(trips) <= max_iters - 1
    if route == "dense":  # the dense route asks the LM once a trip that runs
        assert made in (len(trips), len(trips) + 1)
    # the seq2seq state is every leaf gathered anew: each trip freezes them
    if lm_kind == "seq2seq" and eos is not None:
        assert search.frozen_bytes > 0
