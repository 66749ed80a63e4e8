"""Sharded checkpoints on :mod:`torch.distributed.checkpoint` (counterpart
of :mod:`pydrobert_tpu.parallel.checkpoint`, which wraps Orbax).

- :func:`save_sharded` writes a dict (nested or a state dict) of tensors
  and DTensors to a directory; each rank writes the shards it owns. With
  ``async_save=True`` the call returns once the tensors are staged in host
  memory and the files are written in the background (call
  :func:`wait_for_saves` before relying on them).
- :func:`restore_sharded` reads into the shapes, dtypes and placements of a
  template, so sharded leaves come back distributed where they were.

Orbax's ``force=True`` replaces the directory; ``torch.distributed.
checkpoint`` writes into it and would leave another save's files beside
the new ones, so a save removes the directory first (rank 0, then a
barrier). An asynchronous save needs a CPU backend in the process group
(``init_process_group("cpu:gloo,cuda:nccl")`` on the card); without a
group everything runs in this process.
"""

import os
import shutil
import threading
from typing import Any, Dict

import torch

__all__ = ["restore_sharded", "save_sharded", "wait_for_saves"]

_ASYNC = []  # futures of in-flight asynchronous saves
_LOCK = threading.Lock()


def _group() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def _clear(path: str) -> None:
    """Remove ``path`` as Orbax's ``force=True`` does, once, before every
    rank writes."""
    rank = torch.distributed.get_rank() if _group() else 0
    if rank == 0 and os.path.exists(path):
        shutil.rmtree(path)
    if _group():
        torch.distributed.barrier()


def save_sharded(path: str, tree: Dict[str, Any], async_save: bool = False) -> None:
    """Write ``tree`` (a dict of tensors or DTensors, nested or flat) to
    directory ``path``, replacing it. Every rank of the group calls it
    (collective); each writes the shards it owns. ``async_save=True``
    returns once the tensors are staged; finish with
    :func:`wait_for_saves`."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    wait_for_saves()  # a pending save may still write under path
    _clear(path)
    if async_save:
        fut = dcp.async_save(tree, checkpoint_id=path)
        with _LOCK:
            _ASYNC.append(fut)
        return
    dcp.save(tree, checkpoint_id=path)


def wait_for_saves() -> None:
    """Block until every in-flight :func:`save_sharded` (async) is
    written."""
    with _LOCK:
        pending, _ASYNC[:] = _ASYNC[:], []
    for fut in pending:
        fut.result()


def _empty_like(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _empty_like(v) for k, v in tree.items()}
    return torch.empty_like(tree)


def restore_sharded(path: str, template: Dict[str, Any]) -> Dict[str, Any]:
    """A dict like ``template`` read from ``path``: each leaf in its
    template's shape, dtype, device and, for a DTensor, placements (read
    straight into the local shards). ``template`` itself is not
    written."""
    import torch.distributed.checkpoint as dcp

    state = _empty_like(template)
    dcp.load(state, checkpoint_id=os.path.abspath(path))
    return state
