"""GPipe pipeline parallelism over a ``pipe`` mesh axis (counterpart of
:mod:`pydrobert_tpu.parallel.pipeline`).

The layer stack is split into ``pp`` stages, one per rank along the mesh's
``pipe`` axis; ``m`` microbatches stream through them, each stage's
activations sent to the next with :func:`torch.distributed.send`. The
microbatch rows are split over every non-pipe axis that divides them (the
``model`` axis then adds data parallelism inside the stages; stage weights
are whole on every rank), as the JAX package splits them.

JAX differentiates its ``ppermute`` loop. ``send`` and ``recv`` are not
differentiable, so :func:`pipeline_apply` schedules the backward pass by
hand: an autograd function whose backward runs the reverse GPipe schedule,
each stage receiving its output's gradient from the next stage, running its
saved microbatch graphs backward and sending its input's gradient to the
previous one. Every rank ends with the full gradients of the stage
parameters and of the input, summed over the ranks that computed them, as
JAX's gradient of the global arrays. The bubble fraction is ``(pp - 1) /
(m + pp - 1)``.
"""

from typing import Any, Callable, List, Sequence, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from .mesh import DATA_AXIS, MODEL_AXIS, host_shard_info, mesh_over

__all__ = ["PIPE_AXIS", "make_pipeline_mesh", "pipeline_apply"]

PIPE_AXIS = "pipe"


def make_pipeline_mesh(
    pipeline_parallelism: int,
    model_parallelism: int = 1,
    devices=None,
    axis_names: Tuple[str, str, str] = (DATA_AXIS, MODEL_AXIS, PIPE_AXIS),
):
    """A 3-D ``(data, model, pipe)`` mesh over the initialized group's ranks:
    ``pipeline_parallelism`` consecutive ranks hold the stages,
    ``model_parallelism`` cooperate within a stage, the rest of the world
    is data parallelism. ``devices`` is the device type, by default the
    backend's."""
    _, n = host_shard_info()
    pp, tp = pipeline_parallelism, model_parallelism
    if pp < 1 or tp < 1 or n % (pp * tp):
        raise ValueError(
            f"pipeline_parallelism {pp} x model_parallelism {tp} must divide "
            f"the world size {n}"
        )
    return mesh_over((n // (pp * tp), tp, pp), axis_names, devices)


class _Layout:
    """Where this rank sits: its stage, its rows of each microbatch, and
    whether it duplicates another rank's work (a non-pipe axis the rows
    are not split over)."""

    def __init__(self, mesh, pipe_axis: str, batch_axis: str, mb: int):
        names = list(mesh.mesh_dim_names)
        sizes = [mesh.size(i) for i in range(len(names))]
        coord = mesh.get_coordinate()
        self.mesh, self.names, self.coord = mesh, names, coord
        self.p = names.index(pipe_axis)
        self.pp, self.s = sizes[self.p], coord[self.p]
        rows_all = [i for i, n in enumerate(names) if i != self.p and sizes[i] > 1]
        cands = (rows_all, [i for i in rows_all if names[i] == batch_axis])
        self.row_dims = None
        for cand in cands:
            ext = 1
            for i in cand:
                ext *= sizes[i]
            if mb % ext == 0:
                self.row_dims, self.R = cand, ext
                break
        if self.row_dims is None:
            raise ValueError(
                f"microbatch size {mb} not divisible by the data axis "
                f"({sizes[names.index(batch_axis)]})"
            )
        r = 0
        for i in self.row_dims:
            r = r * sizes[i] + coord[i]
        self.r = r
        self.dup = any(
            coord[i] != 0 for i in range(len(names))
            if i != self.p and i not in self.row_dims
        )
        self.mbl = mb // self.R
        _, self.world = host_shard_info()

    def peer(self, stage: int) -> int:
        """The global rank of this rank's counterpart at ``stage``."""
        c = list(self.coord)
        c[self.p] = stage
        return int(self.mesh.mesh[tuple(c)])

    def owners(self, stage: int) -> List[Tuple[int, int]]:
        """``(global rank, row index)`` of the ranks at ``stage`` whose
        results count (the duplicates left out)."""
        out = []
        mesh = self.mesh.mesh
        for idx in torch.cartesian_prod(*[torch.arange(n) for n in mesh.shape]).reshape(
            -1, mesh.dim()
        ).tolist():
            if idx[self.p] != stage:
                continue
            if any(idx[i] != 0 for i in range(mesh.dim()) if i != self.p and i not in self.row_dims):
                continue
            r = 0
            for i in self.row_dims:
                r = r * mesh.shape[i] + idx[i]
            out.append((int(mesh[tuple(idx)]), r))
        return out

    def gather_rows(self, local: torch.Tensor, stage: int) -> torch.Tensor:
        """``(m, mb, ...)`` from each owner at ``stage``'s ``(m, mbl, ...)``
        (an all-gather over the world)."""
        if self.world == 1:
            return local
        parts = [torch.empty_like(local) for _ in range(self.world)]
        torch.distributed.all_gather(parts, local.contiguous())
        rows = [None] * self.R
        for rank, r in self.owners(stage):
            rows[r] = parts[rank]
        return torch.cat(rows, 1)


class _GPipe:
    """One call's schedule; keeps each microbatch's graph for the
    backward."""

    def __init__(self, stage_fn, spec, lay: _Layout, m: int, extras_mb):
        self.stage_fn, self.spec, self.lay, self.m = stage_fn, spec, lay, m
        self.extras_mb = extras_mb
        self.saved = []

    def rows(self, a: torch.Tensor) -> torch.Tensor:
        lay = self.lay
        return a[:, lay.r * lay.mbl : (lay.r + 1) * lay.mbl]

    def forward(self, x_mb: torch.Tensor, leaves: Sequence[torch.Tensor], grad: bool):
        lay, m = self.lay, self.m
        self.local = [
            leaf[lay.s].detach().requires_grad_(grad and leaf.requires_grad) for leaf in leaves
        ]
        params = tree_unflatten(self.local, self.spec)
        xr = self.rows(x_mb)
        er = tree_map(self.rows, self.extras_mb)
        out = torch.zeros_like(xr)
        for i in range(m):
            if lay.s == 0:
                h = xr[i].detach()
            else:
                h = torch.empty_like(xr[i])
                torch.distributed.recv(h, src=lay.peer(lay.s - 1))
            with torch.enable_grad() if grad else torch.no_grad():
                h.requires_grad_(grad)
                y = self.stage_fn(params, h, tree_map(lambda a: a[i], er))
            if grad:
                self.saved.append((h, y))
            if lay.s < lay.pp - 1:
                torch.distributed.send(y.detach().contiguous(), dst=lay.peer(lay.s + 1))
            else:
                out[i] = y.detach()
        return lay.gather_rows(out, lay.pp - 1).reshape(x_mb.shape)

    def backward(self, g: torch.Tensor, leaves: Sequence[torch.Tensor], x_grad: bool):
        lay, m = self.lay, self.m
        g_mb = self.rows(g)  # g is shaped as the (m, mb, ...) output
        gx = torch.zeros_like(g_mb)
        acc = [torch.zeros_like(p) for p in self.local]
        for i in reversed(range(m)):
            h, y = self.saved[i]
            if lay.s == lay.pp - 1:
                gy = g_mb[i]
            else:
                gy = torch.empty_like(y)
                torch.distributed.recv(gy, src=lay.peer(lay.s + 1))
            wrt = [h] + [p for p in self.local if p.requires_grad]
            grads = torch.autograd.grad(y, wrt, gy, allow_unused=True)
            it = iter(grads[1:])
            for j, p in enumerate(self.local):
                if p.requires_grad:
                    gp = next(it)
                    if gp is not None:
                        acc[j] = acc[j] + gp
            gh = grads[0] if grads[0] is not None else torch.zeros_like(h)
            if lay.s > 0:
                torch.distributed.send(gh.contiguous(), dst=lay.peer(lay.s - 1))
            else:
                gx[i] = gh
        self.saved = []
        leaf_grads = []
        for leaf, a in zip(leaves, acc):
            if not leaf.requires_grad:
                leaf_grads.append(None)
                continue
            full = torch.zeros_like(leaf)
            if not lay.dup:
                full[lay.s] = a
            if lay.world > 1:
                torch.distributed.all_reduce(full)
            leaf_grads.append(full)
        x_g = lay.gather_rows(gx, 0).reshape(g.shape) if x_grad else None
        return x_g, leaf_grads


class _PipelineFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run: _GPipe, x_mb, *leaves):
        ctx.run = run
        ctx.save_for_backward(*leaves)
        return run.forward(x_mb, leaves, True)

    @staticmethod
    def backward(ctx, g):
        leaves = ctx.saved_tensors
        x_g, leaf_grads = ctx.run.backward(g, leaves, ctx.needs_input_grad[1])
        return (None, x_g, *leaf_grads)


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor, Any], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    extras: Any = None,
    *,
    mesh,
    n_microbatches: int,
    batch_axis: str = DATA_AXIS,
    pipe_axis: str = PIPE_AXIS,
) -> torch.Tensor:
    """Run ``x`` through the ``pp`` pipeline stages of ``stage_fn`` on
    ``mesh``; every rank calls it with the same arguments.

    ``stage_params`` is a pytree whose leaves have a leading stage axis of
    size ``pp = mesh.size(pipe_axis)``, whole on every rank; stage ``s``
    applies ``stage_fn(params[s], x_mb, extras_mb)``, which returns a tensor
    of ``x_mb``'s shape and dtype. ``x (B, ...)`` splits into
    ``n_microbatches`` along its first axis (``B`` divisible by it, and the
    microbatch by the data axis); ``extras`` is an optional pytree of
    ``(B, ...)`` side inputs (a padding mask), sliced alongside.

    Returns the last stage's ``(B, ...)`` output on every rank.
    Differentiable with respect to ``stage_params`` and ``x`` (see the
    module's notes): the loss must be the same on every rank, as it is when
    it is computed from the returned tensor.
    """
    B = x.shape[0]
    m = n_microbatches
    if B % m:
        raise ValueError(f"batch size {B} not divisible by microbatches {m}")
    lay = _Layout(mesh, pipe_axis, batch_axis, B // m)

    def to_mb(a):
        return a.reshape((m, B // m) + a.shape[1:])

    leaves, spec = tree_flatten(stage_params)
    for leaf in leaves:
        if leaf.shape[0] != lay.pp:
            raise ValueError(
                f"stage parameters need a leading axis of {lay.pp} stages, got {tuple(leaf.shape)}"
            )
    run = _GPipe(stage_fn, spec, lay, m, tree_map(to_mb, extras))
    x_mb = to_mb(x)
    grad = torch.is_grad_enabled() and (x.requires_grad or any(l.requires_grad for l in leaves))
    if grad:
        out = _PipelineFn.apply(run, x_mb, *leaves)
    else:
        out = run.forward(x_mb, leaves, False)
    return out.reshape(x.shape)
