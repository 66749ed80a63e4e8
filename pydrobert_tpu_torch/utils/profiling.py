"""Profiling and tracing (counterpart of :mod:`pydrobert_tpu.utils.profiling`).

- :func:`trace` / :func:`annotate`: a :mod:`torch.profiler` timeline of
  the enclosed block (a Chrome trace that TensorBoard and Perfetto read),
  and named regions on it (``record_function``, plus an NVTX range on a
  card).
- :func:`measure_sync_overhead`: the cost of one empty launch and a
  synchronize, the floor under any single-call timing.
- :func:`profile_program`: CUDA-event medians of a function with that
  overhead amortized over back-to-back calls, plus
  :func:`~pydrobert_tpu_torch.utils.hlostats.compiled_stats`.
- :func:`span`: the port's named marks on the timeline, ``pydt.<name>``
  ranges while a profiler runs: a streaming push or finish and its window
  encodes, a search, each point where the host waits on the card
  (:data:`SYNC_PREFIX`), and through :func:`loop_trip` each trip of the
  decode loops, from which
  :func:`~pydrobert_tpu_torch.utils.hlostats.compiled_stats` counts the
  device launches of one trip. A mark costs one flag read while no
  profiler runs, and is off while a program is exported or compiled.
"""

import contextlib
import os
import statistics
import time
from typing import Any, Callable, Dict, Iterator

import torch

__all__ = [
    "LOOP_PREFIX",
    "SYNC_PREFIX",
    "annotate",
    "loop_trip",
    "measure_sync_overhead",
    "profile_program",
    "span",
    "trace",
]

LOOP_PREFIX = "pydt.loop/"
"""Name prefix of the profiler ranges :func:`loop_trip` opens."""

SYNC_PREFIX = "pydt.sync/"
"""Name prefix of the spans around a point where the host waits on the
card: it reads a device value, or copies a host array to the card (a
pageable copy that synchronizes the stream)."""


def _profiling() -> bool:
    return torch.autograd.profiler._is_profiler_enabled


def span(name: str):
    """A ``record_function`` range ``"pydt." + name`` while a profiler
    runs; a no-op context otherwise, and always while
    :func:`torch.export.export` or :func:`torch.compile` traces the code, so
    a traced program holds no profiler operator."""
    if _profiling() and not (
        torch.compiler.is_exporting() or torch.compiler.is_compiling()
    ):
        return torch.profiler.record_function("pydt." + name)
    return contextlib.nullcontext()


def loop_trip(name: str):
    """:func:`span` ``"loop/" + name`` around one trip of a loop."""
    return span("loop/" + name)


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False) -> Iterator[Any]:
    """Trace the enclosed block with :mod:`torch.profiler` (host ops, and
    the card's kernels when there is one) and write a Chrome trace,
    ``<log_dir>/<host>_<pid>.<time>.pt.trace.json``, which TensorBoard's
    profiler plugin and Perfetto open. Yields the profiler, whose
    ``key_averages()`` the caller may read. ``create_perfetto_link`` is
    accepted for the JAX signature and ignored: nothing is uploaded."""
    from torch.profiler import profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    with profile(
        activities=_activities(), on_trace_ready=tensorboard_trace_handler(log_dir)
    ) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


@contextlib.contextmanager
def annotate(name: str, **kwargs) -> Iterator[None]:
    """A named region on the timeline: a ``record_function`` range, and on
    a card an NVTX range too. Keyword arguments are appended to the name
    as ``key=value`` (``jax.profiler.TraceAnnotation`` records them as the
    region's metadata)."""
    if kwargs:
        name = name + " " + ",".join(f"{k}={v}" for k, v in sorted(kwargs.items()))
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure_sync_overhead(reps: int = 5, device=None) -> float:
    """Seconds one call costs beyond its device work: the median over
    ``max(3, reps)`` of one tiny kernel's launch and a synchronize (``cuda``
    by default when there is a card; on the CPU, one tiny operator).
    Subtract it from single-call timings, or amortize it over calls."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    tiny = torch.zeros((8,), dtype=torch.float32, device=device)
    tiny.add_(1.0)
    _sync(device)
    times = []
    for _ in range(max(3, reps)):
        t0 = time.perf_counter()
        tiny.add_(1.0)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def profile_program(fn: Callable, *args, calls: int = 8, reps: int = 3, **kwargs) -> Dict[str, Any]:
    """Time ``fn(*args, **kwargs)`` with the per-call overhead amortized:
    each rep queues ``calls`` back-to-back calls between two CUDA events
    (``perf_counter`` and a synchronize on the CPU) after one warm-up call.

    Returns :func:`~pydrobert_tpu_torch.utils.hlostats.compiled_stats` of
    one call (``bytes_accessed``, ``flops``, ``transcendentals``,
    ``loop_kernels``, ``loop_op_histogram``, ``loop_trip_count``) and:

    - ``seconds_per_call``: the median over ``reps`` of a rep's time over
      ``calls``;
    - ``sync_overhead_s``: :func:`measure_sync_overhead`;
    - ``us_per_kernel``: ``seconds_per_call`` over the hottest loop's trips
      and its launches a trip (only when ``fn`` runs a marked loop).
    """
    from .hlostats import compiled_stats

    stats = compiled_stats(fn, *args, **kwargs)
    cuda = torch.cuda.is_available() and any(
        isinstance(a, torch.Tensor) and a.is_cuda for a in args
    )
    fn(*args, **kwargs)  # warm
    times = []
    for _ in range(max(1, reps)):
        if cuda:
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(max(1, calls)):
                fn(*args, **kwargs)
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(max(1, calls)):
                fn(*args, **kwargs)
            secs = time.perf_counter() - t0
        times.append(secs / max(1, calls))
    stats["seconds_per_call"] = statistics.median(times)
    stats["sync_overhead_s"] = measure_sync_overhead(device="cuda" if cuda else "cpu")
    trips, kern = stats.get("loop_trip_count", 0), stats["loop_kernels"]
    if trips and kern:
        stats["us_per_kernel"] = stats["seconds_per_call"] / trips * 1e6 / kern
    return stats
