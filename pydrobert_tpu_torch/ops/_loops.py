"""The frame loops of the port's searches: eager Python loops, or one
``scan`` while :func:`torch.export.export` traces them."""

from typing import Any, Callable, Sequence

import torch

from ..utils.profiling import loop_trip


def frame_loop(
    body: Callable,
    carry: Any,
    frames: Sequence[torch.Tensor],
    t0: int,
    t1: int,
    name: str,
    device=None,
) -> Any:
    """``carry = body(carry, tuple(f[t] for f in frames), t)`` for ``t`` in
    ``[t0, t1)``. Eagerly it is a Python loop, each trip marked for the
    profiler (:func:`~pydrobert_tpu_torch.utils.profiling.loop_trip`). While
    :func:`torch.export.export` traces it, it is one ``scan`` whose body is
    traced once (the JAX package's ``lax.scan``), with ``t`` a 0-d tensor,
    so an exported program does not unroll the trips. Both run the same
    operators in a trip. ``carry`` is a pytree whose leaves are tensors or
    None; ``device`` places the trip counter when ``frames`` is empty."""
    if not torch.compiler.is_exporting():
        for t in range(t0, t1):
            with loop_trip(name):
                carry = body(carry, tuple(f[t] for f in frames), t)
        return carry
    if t1 <= t0:
        return carry
    from torch._higher_order_ops.scan import scan
    from torch.utils._pytree import tree_flatten, tree_unflatten

    # scan carries tensors only: the carry's None leaves stay outside
    leaves, spec = tree_flatten(carry)
    held = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]

    def rebuild(tensors):
        full = list(leaves)
        for i, x in zip(held, tensors):
            full[i] = x
        return tree_unflatten(full, spec)

    def step(c, x):
        new = tree_flatten(body(rebuild(c), x[:-1], x[-1]))[0]
        return [new[i] for i in held], []

    dev = frames[0].device if frames else device
    xs = tuple(f[t0:t1] for f in frames) + (torch.arange(t0, t1, device=dev),)
    tensors, _ = scan(step, [leaves[i] for i in held], xs)
    return rebuild(tensors)
