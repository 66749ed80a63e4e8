"""Device meshes and sharding over :mod:`torch.distributed` (counterpart of
:mod:`pydrobert_tpu.parallel.mesh`).

JAX lays one process over all its devices and shards arrays by name;
:mod:`torch.distributed` runs one process per device. A mesh here is a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks of the
initialized process group (NCCL on the card, gloo on the CPU), and a
sharding is a tuple of DTensor placements, one per mesh axis. The rules
stay in JAX's terms: a :class:`PartitionSpec` names, for each tensor axis,
the mesh axes it is split over, and :func:`placements` turns it into
placements.
"""

from typing import Any, Callable, Dict, Sequence, Tuple

import torch

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "PartitionSpec",
    "all_reduce_metrics",
    "batch_sharding",
    "gather_params",
    "host_shard_info",
    "make_mesh",
    "mesh_over",
    "param_partition_specs",
    "place",
    "placements",
    "replicated_sharding",
    "sequence_sharding",
    "shard_params",
]

# "data" shards the batch (data parallelism); "model" shards weight
# matrices (tensor parallelism)
DATA_AXIS = "data"
MODEL_AXIS = "model"


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: for each leading tensor axis, the
    mesh axis (a name, a tuple of names, or None) it is split over; axes
    past the spec's length are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def host_shard_info() -> Tuple[int, int]:
    """``(rank, world_size)`` of the initialized process group, ``(0, 1)``
    without one: each process takes a strided shard of the samples."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _device_type(devices) -> str:
    if isinstance(devices, str):
        return devices
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs an initialized torch.distributed process group "
            "(init_process_group with NCCL on the card, gloo on the CPU)"
        )
    return "cuda" if "nccl" in str(dist.get_backend()) else "cpu"


def mesh_over(shape: Sequence[int], axis_names: Sequence[str], devices=None):
    """A :class:`~torch.distributed.device_mesh.DeviceMesh` of ``shape``
    over the group's first ``prod(shape)`` ranks, in row-major order.
    ``devices`` is the device type (``"cuda"`` or ``"cpu"``), by default
    the backend's."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    device_type = _device_type(devices)
    _, world = host_shard_info()
    n = 1
    for s in shape:
        n *= int(s)
    if n == world:
        return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))
    if n > world:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the group has {world}")
    ranks = torch.arange(n).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def make_mesh(
    model_parallelism: int = 1,
    devices=None,
    axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS),
):
    """A 2-D ``(data, model)`` mesh over the ranks of the initialized group:
    ``model_parallelism`` ranks cooperate on each model replica, the rest of
    the world is data parallelism. ``devices`` is the device type, by
    default ``cuda`` under NCCL and ``cpu`` under gloo."""
    _, n = host_shard_info()
    if model_parallelism < 1 or n % model_parallelism:
        raise ValueError(
            f"model_parallelism {model_parallelism} must divide the world size {n}"
        )
    return mesh_over((n // model_parallelism, model_parallelism), axis_names, devices)


def placements(mesh, spec: Sequence[Any]) -> Tuple[Any, ...]:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh axis that tensor axis ``d`` is split over, ``Replicate()`` on the
    others. A tensor axis over several mesh axes is split over them in the
    spec's order."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        for a in (axis,) if isinstance(axis, str) else tuple(axis):
            out[list(mesh.mesh_dim_names).index(a)] = Shard(d)
    return tuple(out)


def batch_sharding(mesh, axis_name: str = DATA_AXIS) -> Tuple[Any, ...]:
    """Placements that split the leading (batch) axis over ``axis_name``."""
    return placements(mesh, PartitionSpec(axis_name))


def sequence_sharding(mesh, batch_axis: str = DATA_AXIS, seq_axis: str = MODEL_AXIS):
    """Placements of ``(batch, time, ...)`` activations split over the data
    axis along the batch and over the model axis along time."""
    return placements(mesh, PartitionSpec(batch_axis, seq_axis))


def replicated_sharding(mesh) -> Tuple[Any, ...]:
    """Placements that replicate a tensor on every rank of the mesh."""
    return placements(mesh, PartitionSpec())


def _paths(params: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """``(key, path, leaf)`` of a dict of tensors, nested or a state dict;
    a state dict's dotted names split into the path's parts."""
    for k, v in params.items():
        path = prefix + tuple(str(k).split("."))
        if isinstance(v, dict):
            for key, p, leaf in _paths(v, path):
                yield (k,) + key, p, leaf
        else:
            yield (k,), path, v


def _set(tree: Dict[str, Any], key: Tuple[str, ...], value) -> None:
    for k in key[:-1]:
        tree = tree.setdefault(k, {})
    tree[key[-1]] = value


def _mesh_size(mesh, axis) -> int:
    names = list(mesh.mesh_dim_names)
    size = 1
    for a in (axis,) if isinstance(axis, str) else tuple(axis):
        size *= mesh.size(names.index(a))
    return size


def param_partition_specs(
    params: Dict[str, Any],
    mesh,
    rules: Callable[[Tuple[str, ...], torch.Tensor], PartitionSpec],
) -> Dict[str, Any]:
    """The effective :class:`PartitionSpec` of every tensor in ``params``
    (a state dict or a nested dict), congruent with it: ``rules(path,
    leaf)``, except that a leaf whose axes do not divide their mesh axes is
    replicated (a ``V + 1`` CTC head on an even model axis, say), as
    :func:`shard_params` places it. ``path`` is the leaf's names, a state
    dict's dotted names split at the dots."""
    out: Dict[str, Any] = {}
    for key, path, leaf in _paths(params):
        spec = PartitionSpec(*rules(path, leaf))
        for d, axis in enumerate(spec):
            if axis is not None and leaf.shape[d] % _mesh_size(mesh, axis):
                spec = PartitionSpec()
                break
        _set(out, key, spec)
    return out


def place(leaf: torch.Tensor, mesh, spec: Sequence[Any]):
    """``leaf`` as a DTensor on ``mesh`` split as ``spec`` says (every rank
    passes the same full tensor)."""
    from torch.distributed.tensor import distribute_tensor

    dev = mesh.device_type
    return distribute_tensor(leaf.detach().to(dev), mesh, placements(mesh, spec))


def shard_params(
    params: Dict[str, Any],
    mesh,
    rules: Callable[[Tuple[str, ...], torch.Tensor], PartitionSpec],
) -> Dict[str, Any]:
    """Place ``params`` (a state dict or a nested dict of full tensors, the
    same on every rank) on ``mesh`` as DTensors split by ``rules`` with
    :func:`param_partition_specs`' fallback; see
    :func:`pydrobert_tpu_torch.models.conformer_partition_rules`. A
    DTensor's ``full_tensor()`` gives the leaf back bit for bit."""
    specs = param_partition_specs(params, mesh, rules)
    out: Dict[str, Any] = {}
    for key, _, leaf in _paths(params):
        spec = specs
        for k in key:
            spec = spec[k]
        _set(out, key, place(leaf, mesh, spec))
    return out


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
    dev = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    t = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    if op == "mean":
        t = t / dist.get_world_size()
    return {k: float(v) for k, v in zip(keys, t.tolist())}


def gather_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Full tensors of a dict of DTensors (a collective over their mesh),
    other leaves as they are."""
    out: Dict[str, Any] = {}
    for key, _, leaf in _paths(params):
        _set(out, key, leaf.full_tensor() if hasattr(leaf, "full_tensor") else leaf)
    return out
