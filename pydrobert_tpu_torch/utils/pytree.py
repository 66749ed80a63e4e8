"""Language-model state utilities (counterpart of
:mod:`pydrobert_tpu.utils.pytree`).

Search loops thread LM state as a dict of tensors, possibly nested in
further dicts, lists or tuples. :func:`extract_by_src` (beam reordering)
and :func:`mix_by_mask` (CTC fusion selection) act on every tensor leaf
along its first axis, so LMs need not implement them by hand.
"""

from typing import Any, Callable, Sequence, Tuple

import torch

__all__ = ["broadcast_shapes", "extract_by_src", "lengths_to_mask", "mix_by_mask", "tree_map"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and of the identically
    structured ``rest``), keeping dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def extract_by_src(state: Any, src: torch.Tensor) -> Any:
    """Index every leaf of ``state`` along its first axis by ``src``.

    Reorders per-beam LM state after a beam shuffle. Leaves without a batch
    axis (scalars) are left untouched.
    """

    def gather(leaf):
        leaf = torch.as_tensor(leaf)
        if leaf.dim() == 0:
            return leaf
        return leaf.index_select(0, src.to(leaf.device, torch.long).reshape(-1))

    return tree_map(gather, state)


def mix_by_mask(state_true: Any, state_false: Any, mask: torch.Tensor) -> Any:
    """Per-batch-element select between two identically structured states:
    ``mask (N,)`` picks along each leaf's first axis."""

    def select(a, b):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        if a.dim() == 0:
            return a
        m = mask.to(a.device).reshape(mask.shape + (1,) * (a.dim() - 1))
        return torch.where(m, a, b)

    return tree_map(select, state_true, state_false)


def lengths_to_mask(lens: torch.Tensor, max_len: int, axis: int = -1) -> torch.Tensor:
    """Boolean mask of shape ``lens.shape + (max_len,)`` (True in the
    sequence), with the new axis moved to ``axis``."""
    arange = torch.arange(max_len, dtype=lens.dtype, device=lens.device)
    mask = lens.unsqueeze(-1) > arange
    if axis != -1:
        mask = torch.movedim(mask, -1, axis)
    return mask


def broadcast_shapes(a: Sequence[int], b: Sequence[int]) -> Tuple[int, ...]:
    """Numpy-style broadcast of two shapes."""
    return tuple(torch.broadcast_shapes(tuple(a), tuple(b)))
