"""Multi-process helpers (counterpart of :mod:`pydrobert_tpu.parallel`;
only :func:`all_reduce_metrics` so far)."""

from typing import Dict

import torch

__all__ = ["all_reduce_metrics"]


def all_reduce_metrics(metrics: Dict[str, float], op: str = "mean") -> Dict[str, float]:
    """Reduce scalar metrics across the processes of the initialized
    :mod:`torch.distributed` group: ``"mean"`` (the default) or ``"sum"``.
    Without a group of more than one process this is the identity. The
    values travel as one float64 tensor, on the card under NCCL and on the
    CPU otherwise."""
    if op not in ("mean", "sum"):
        raise ValueError(f"unknown op {op!r}")
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return dict(metrics)
    keys = sorted(metrics)
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    if op == "mean":
        t = t / dist.get_world_size()
    return {k: float(v) for k, v in zip(keys, t.tolist())}
