"""Operator statistics of a program: launches a loop trip, FLOPs and bytes
(counterpart of :mod:`pydrobert_tpu.utils.hlostats`).

The JAX package reads these from XLA's compiled HLO. An eager PyTorch
program has no compiled form, so the counts here come from running it once
(under dispatch modes and :mod:`torch.profiler`), or, for
:func:`count_body_kernels`, from the graph of a
:func:`torch.export.export`-ed program. How each count differs from XLA's
is stated where it is defined.
"""

import operator
import statistics
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .profiling import LOOP_PREFIX

__all__ = ["compiled_stats", "count_body_kernels"]

# ATen operators that launch no kernel: views and metadata
_FREE_OPS = {
    "alias", "as_strided", "detach", "expand", "permute", "reshape", "select",
    "slice", "squeeze", "t", "transpose", "unbind", "unflatten", "unsqueeze",
    "view", "_unsafe_view", "lift_fresh_copy", "sym_size", "sym_numel",
    "sym_stride", "sym_storage_offset", "_assert_tensor_metadata",
}

# operators whose every output element takes one transcendental function
# (softmax, SiLU, GLU and GELU count their exponential or error function)
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh",
    "sigmoid", "sin", "cos", "tan", "erf", "erfc", "rsqrt", "sqrt", "pow",
    "_softmax", "_log_softmax", "silu", "glu", "gelu", "logsumexp",
}


def _op_name(target) -> str:
    """``aten.add.Tensor`` -> ``add``; a custom operator keeps its
    namespace (``pydrobert_tpu_torch::decode_prologue``)."""
    if isinstance(target, torch._ops.HigherOrderOperator):
        return target.name()
    name = getattr(target, "name", None)
    name = name() if callable(name) else str(target)
    ns, _, rest = name.partition("::")
    base = rest.split(".")[0] if rest else name.split(".")[0]
    return base if ns in ("aten", "") else f"{ns}::{base}"


def _body_counts(gm: torch.fx.GraphModule) -> Dict[str, int]:
    ops: Dict[str, int] = {}
    for node in gm.graph.nodes:
        if node.op != "call_function" or node.target is operator.getitem:
            continue
        name = _op_name(node.target)
        ops[name] = ops.get(name, 0) + 1
    return ops


def _loop_kind(node: torch.fx.Node):
    """``"scan"`` or ``"while_loop"`` for a loop node, else None."""
    if node.op == "call_function" and isinstance(node.target, torch._ops.HigherOrderOperator):
        name = node.target.name()
        if name in ("scan", "while_loop"):
            return name
    return None


def _trip_count(node: torch.fx.Node) -> int:
    """A ``scan``'s trips: the leading extent of its first ``xs`` (0 for
    a ``while_loop``, whose trips depend on the data)."""
    if _loop_kind(node) != "scan":
        return 0
    xs = node.args[2]
    val = xs[0].meta.get("val") if xs else None
    return int(val.shape[0]) if val is not None else 0


def count_body_kernels(program) -> Dict[str, Any]:
    """Operator counts of an exported program (an ``ExportedProgram`` or a
    ``GraphModule``): ``{name: {"kernels": int, "ops": {op: count},
    "trip_count": int}}`` for the top-level graph (``"main"``) and for each
    loop body a ``scan`` or ``while_loop`` node calls, under its submodule's
    name (a nested body's joined to its parent's with a dot). ``kernels`` leaves out views and metadata operators, which launch
    nothing; every other node launches about one kernel when it runs
    eagerly. ``trip_count`` is a ``scan``'s static trips, 0 for the main
    graph and for a ``while_loop``.

    Against the JAX package's count of an HLO while body: XLA fuses
    elementwise chains into one kernel, where each node here is its own
    launch, and a loop nested in a loop body is counted as one node of the
    outer body and again as a body of its own."""
    gm = program.graph_module if hasattr(program, "graph_module") else program
    out: Dict[str, Any] = {}

    def visit(g: torch.fx.GraphModule, name: str, trips: int) -> None:
        ops = _body_counts(g)
        out[name] = {
            "kernels": sum(v for k, v in ops.items() if k not in _FREE_OPS),
            "ops": ops,
            "trip_count": trips,
        }
        for node in g.graph.nodes:
            if _loop_kind(node) is None:
                continue
            for arg in node.args[:2]:
                if isinstance(arg, torch.fx.Node) and arg.op == "get_attr":
                    child = arg.target if name == "main" else f"{name}.{arg.target}"
                    visit(getattr(g, arg.target), child, _trip_count(node))

    visit(gm, "main", 0)
    return out


class _BytesMode(TorchDispatchMode):
    """Adds up, for every ATen operator that runs, the bytes of its tensor
    inputs and outputs, and the output elements of the transcendental
    ones."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.transcendentals = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = _op_name(func)
        if name in _FREE_OPS:
            return out
        leaves = []

        def collect(x):
            if isinstance(x, torch.Tensor):
                leaves.append(x)
            elif isinstance(x, (list, tuple)):
                for y in x:
                    collect(y)
            elif isinstance(x, dict):
                for y in x.values():
                    collect(y)

        collect((args, kwargs or {}))
        n_in = len(leaves)
        collect(out)
        self.bytes += sum(t.numel() * t.element_size() for t in leaves)
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in leaves[n_in:])
        return out


def _trip_kernels(prof) -> Dict[str, Any]:
    """Launches a trip of each marked loop in a profile: for every
    ``LOOP_PREFIX`` range, the device kernels launched inside it (the
    operators it calls that are not views, when no card is traced), and
    which operators launched them."""
    from torch.autograd import DeviceType

    loops: Dict[str, list] = {}
    cuda = torch.cuda.is_available()
    for evt in prof.events():
        # the host's range; a traced card repeats it as a device annotation
        if not evt.name.startswith(LOOP_PREFIX) or evt.device_type != DeviceType.CPU:
            continue
        hist: Dict[str, int] = {}
        stack = list(evt.cpu_children)
        while stack:
            e = stack.pop()
            if e.name.startswith(LOOP_PREFIX):
                continue  # a nested loop's trips are its own
            if cuda:
                n = len(e.kernels) if e.kernels else 0
                if n:
                    hist[e.name] = hist.get(e.name, 0) + n
                stack.extend(e.cpu_children)
            elif e.name.split("::")[-1] not in _FREE_OPS:
                # no card: the operators the trip calls, not their insides
                hist[e.name] = hist.get(e.name, 0) + 1
        loops.setdefault(evt.name[len(LOOP_PREFIX):], []).append(hist)
    return loops


def _launches(prof) -> int:
    """Device kernels in a profile (host operators that are not views when
    no card is traced)."""
    from torch.autograd import DeviceType

    if torch.cuda.is_available():
        return sum(len(e.kernels) for e in prof.events() if e.device_type == DeviceType.CPU)

    def outermost(e) -> bool:
        # ranges (a marked loop trip) do not hide the operators inside them
        p = e.cpu_parent
        while p is not None:
            if p.name.startswith("aten::"):
                return False
            p = p.cpu_parent
        return True

    return sum(
        1 for e in prof.events()
        if e.name.startswith("aten::") and e.name.split("::")[-1] not in _FREE_OPS
        and outermost(e)
    )


def compiled_stats(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` twice, once counting and once under
    :mod:`torch.profiler`, and report:

    - ``flops``: :class:`torch.utils.flop_counter.FlopCounterMode`'s total,
      which counts matrix products and convolutions only (XLA also counts
      elementwise arithmetic); the hand-written kernels add none;
    - ``bytes_accessed``: the bytes of every ATen operator's tensor inputs
      and outputs, views excepted, summed over the operators that ran (XLA
      counts a fusion's inputs and outputs once, so its figure is smaller
      wherever it fuses; it also counts a loop body once, where this counts
      every trip);
    - ``transcendentals``: output elements of the exponential, logarithm,
      hyperbolic, trigonometric, error-function, root and power operators
      and of the softmaxes, SiLU, GLU and GELU; 0 is counted for what the
      hand-written kernels compute (the decode prologue's exponentials), as
      their arithmetic is invisible to the dispatcher;
    - ``loop_kernels``: the device launches of one trip of the hottest
      marked loop (:func:`~pydrobert_tpu_torch.utils.profiling.loop_trip`;
      the one with the most trips, launches breaking ties), the median over
      its trips; without a card, the operators a trip calls directly, views
      excepted; 0 when ``fn``
      runs no marked loop. XLA counts the instructions of the loop body,
      where elementwise chains are fused into one;
    - ``loop_op_histogram``: which operators launched them, for a trip with
      the median count;
    - ``loop_trip_count``: that loop's trips in this call;
    - ``kernel_launches``: the device launches of the whole call (without a
      card, its outermost operators that are not views).
    """
    from torch.profiler import profile
    from torch.utils.flop_counter import FlopCounterMode

    from .profiling import _activities

    counter = FlopCounterMode(display=False)
    mode = _BytesMode()
    with counter, mode:
        fn(*args, **kwargs)
    stats: Dict[str, Any] = {
        "flops": float(counter.get_total_flops()),
        "bytes_accessed": float(mode.bytes),
        "transcendentals": float(mode.transcendentals),
    }
    with profile(activities=_activities()) as prof:
        fn(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    loops = _trip_kernels(prof)
    stats["kernel_launches"] = _launches(prof)
    stats["loop_kernels"], stats["loop_op_histogram"], stats["loop_trip_count"] = 0, {}, 0
    if loops:
        def counts(trips):
            return [sum(h.values()) for h in trips]

        name, trips = max(
            loops.items(), key=lambda kv: (len(kv[1]), statistics.median(counts(kv[1])))
        )
        per = counts(trips)
        med = int(statistics.median_low(per))
        stats["loop_kernels"] = med
        stats["loop_op_histogram"] = dict(trips[per.index(med)])
        stats["loop_trip_count"] = len(trips)
        stats["loop_name"] = name
    return stats
