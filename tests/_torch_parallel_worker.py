"""One rank of the port's multi-process parallel tests under
torch.distributed (gloo, CPU): ``python _torch_parallel_worker.py RANK
WORLD PORT DIR``. Imports only torch, numpy and the port. Reads the inputs
and JAX parameters ``tests/test_torch_parallel.py`` wrote to
``DIR/inputs.npz`` and writes ``DIR/rank<r>.json``: for each pipeline case
of this world size the output and the gradients of its sum, the pipelined
conformer forward and train step, the transducer train step, the
placements of ``shard_params`` and an asynchronous sharded checkpoint's
round trip, and a mesh artifact's hypotheses."""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from pydrobert_tpu_torch import export as pexport
from pydrobert_tpu_torch import parallel
from pydrobert_tpu_torch.models import conformer as pconf
from pydrobert_tpu_torch.models import transducer as ptrans

# (pp, tp, microbatches) per world size
PIPE_CASES = {2: [(2, 1, 4), (2, 1, 8), (1, 1, 4)], 4: [(2, 2, 4), (4, 1, 4), (4, 1, 8)]}
TOY = dict(B=32, T=6, D=16)
CTC = dict(
    vocab_size=32, num_filts=8, d_model=16, num_layers=4, num_heads=2,
    subsample_channels=4, conv_kernel=5, dropout=0.0,
)
SGD_LR = 1e-2


def toy(seed, pp, B=TOY["B"], T=TOY["T"], D=TOY["D"]):
    """The JAX test's ``_toy`` inputs: stage weights, activations, mask."""
    rng = np.random.RandomState(seed)
    Ws = (rng.randn(pp, D, D) * 0.1).astype(np.float32)
    x = rng.randn(B, T, D).astype(np.float32)
    mask = rng.rand(B, T) > 0.3
    return Ws, x, mask


def toy_stage(W, h, m):
    return torch.tanh(h @ W) * m[..., None]


def ctc_batch(N=8, T=32):
    rng = np.random.RandomState(17)
    feats = rng.randn(N, T, CTC["num_filts"]).astype(np.float32)
    lens = rng.randint(T // 2, T + 1, (N,)).astype(np.int32)
    rng = np.random.RandomState(3)
    refs = rng.randint(0, CTC["vocab_size"], (N, 3)).astype(np.int32)
    return feats, lens, refs, np.full((N,), 3, np.int32)


def rnnt_batch(N=8, T=24, U=3):
    rng = np.random.RandomState(23)
    feats = rng.randn(N, T, CTC["num_filts"]).astype(np.float32)
    lens = rng.randint(T // 2, T + 1, (N,)).astype(np.int32)
    refs = rng.randint(0, CTC["vocab_size"], (N, U)).astype(np.int32)
    ref_lens = rng.randint(1, U + 1, (N,)).astype(np.int32)
    return feats, lens, refs, ref_lens


def _flax(z, prefix):
    return pexport.unflatten_arrays(
        {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}
    )


def _list(t):
    return t.detach().double().tolist()


def pipeline_cases(world):
    out = {}
    for pp, tp, m in PIPE_CASES[world]:
        mesh = parallel.make_pipeline_mesh(pp, tp)
        Ws, x, mask = toy(0, pp)
        Ws = torch.tensor(Ws, requires_grad=True)
        x = torch.tensor(x, requires_grad=True)
        y = parallel.pipeline_apply(
            toy_stage, Ws, x, extras=torch.from_numpy(mask), mesh=mesh, n_microbatches=m
        )
        y.sum().backward()
        out[f"{pp},{tp},{m}"] = {"y": _list(y), "gW": _list(Ws.grad), "gx": _list(x.grad)}
    return out


def conformer_cases(z):
    cfg = pconf.ConformerConfig(dtype=torch.float32, **CTC)
    model = pconf.ConformerCTC(cfg, device="cpu")
    model.load_state_dict(pconf.state_dict_from_jax(_flax(z, "ctc/")), strict=True)
    feats, lens, refs, ref_lens = (torch.from_numpy(a) for a in ctc_batch())
    mesh = parallel.make_pipeline_mesh(2, 2)
    pparams = pconf.stack_block_params(
        {k: v.detach().clone().requires_grad_() for k, v in model.state_dict().items()}, 2
    )
    with torch.no_grad():
        logits, out_lens = pconf.make_pipelined_forward(model, mesh, 4)(pparams, feats, lens)
    opt = torch.optim.SGD(list(pparams.values()), lr=SGD_LR)
    step = pconf.make_pipeline_train_step(model, opt, mesh, 4)
    loss = step(pparams, None, feats, lens, refs, ref_lens)
    return {
        "logits": _list(logits), "out_lens": out_lens.tolist(), "loss": float(loss),
        "params": {k: _list(v) for k, v in pconf.unstack_block_params(pparams).items()},
    }


def transducer_case(z):
    cfg = ptrans.TransducerConfig(
        encoder=pconf.ConformerConfig(dtype=torch.float32, **CTC), pred_dim=12, joint_dim=12
    )
    model = ptrans.ConformerTransducer(cfg, device="cpu")
    model.load_state_dict(ptrans.state_dict_from_jax(_flax(z, "rnnt/")), strict=True)
    feats, lens, refs, ref_lens = (torch.from_numpy(a) for a in rnnt_batch())
    mesh = parallel.make_pipeline_mesh(2, 2)
    pparams = ptrans.transducer_stack_block_params(
        {k: v.detach().clone().requires_grad_() for k, v in model.state_dict().items()}, 2
    )
    opt = torch.optim.SGD(list(pparams.values()), lr=SGD_LR)
    step = ptrans.make_transducer_pipeline_train_step(model, opt, mesh, 4)
    loss = step(pparams, None, feats, lens, refs, ref_lens)
    return {
        "loss": float(loss),
        "params": {
            k: _list(v) for k, v in ptrans.transducer_unstack_block_params(pparams).items()
        },
    }


def sharding_case(z, out_dir, world):
    """shard_params with the divisibility fallback on a (world / 2, 2)
    mesh, and an asynchronous sharded checkpoint's round trip."""
    from torch.distributed.tensor import Shard

    cfg = pconf.ConformerConfig(dtype=torch.float32, **CTC)
    model = pconf.ConformerCTC(cfg, device="cpu")
    model.load_state_dict(pconf.state_dict_from_jax(_flax(z, "ctc/")), strict=True)
    sd = model.state_dict()
    mesh = parallel.make_mesh(2)
    specs = parallel.param_partition_specs(sd, mesh, pconf.conformer_partition_rules)
    sp = parallel.shard_params(sd, mesh, pconf.conformer_partition_rules)
    exact = all(torch.equal(sp[k].full_tensor(), v) for k, v in sd.items())
    sharded = sorted(k for k, v in sp.items() if any(isinstance(p, Shard) for p in v.placements))
    local_rows = {k: list(sp[k].to_local().shape) for k in sharded}
    path = os.path.join(out_dir, "ckpt")
    parallel.save_sharded(path, sp, async_save=True)
    parallel.wait_for_saves()
    back = parallel.restore_sharded(path, sp)
    same_local = all(torch.equal(back[k].to_local(), sp[k].to_local()) for k in sp)
    same_place = all(back[k].placements == sp[k].placements for k in sp)
    # a second save replaces the directory, as Orbax's force=True does:
    # a file the first left behind is gone
    if dist.get_rank() == 0:
        open(os.path.join(path, "stray"), "w").close()
    dist.barrier()
    parallel.save_sharded(path, {"only": sp["ctc_head.bias"]})
    stray_left = os.path.exists(os.path.join(path, "stray"))
    return {
        "specs": {k: [None if a is None else a for a in v] for k, v in specs.items()},
        "sharded": sharded, "local_shapes": local_rows, "full_exact": exact,
        "restored_local_exact": same_local, "restored_placements": same_place,
        "stray_left": stray_left,
    }


def artifact_case(z, out_dir):
    """A mesh artifact on a (2, 2) mesh: exported by rank 0, served by
    every rank (each its rows, gathered over the data axis)."""
    cfg = pconf.ConformerConfig(dtype=torch.float32, **CTC)
    model = pconf.ConformerCTC(cfg, device="cpu")
    model.load_state_dict(pconf.state_dict_from_jax(_flax(z, "ctc/")), strict=True)
    mesh = parallel.make_mesh(2)
    path = os.path.join(out_dir, "art")
    if dist.get_rank() == 0:
        pexport.export_ctc_recognizer(
            path, model, specs=[(4, 32)], mesh=mesh,
            partition_rules=pconf.conformer_partition_rules,
        )
    dist.barrier()
    art = pexport.ServingArtifact.load(path, device="cpu")
    feats, lens = ctc_batch(N=4)[:2]
    hyps, hyp_lens = art(feats, lens)
    h3, l3 = art(feats[:3], lens[:3])
    return {
        "mesh": art.meta["mesh"]["shape"], "hyps": hyps.tolist(), "lens": hyp_lens.tolist(),
        "hyps3": h3.tolist(), "lens3": l3.tolist(),
    }


def main(rank, world, port, out_dir):
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world
    )
    torch.manual_seed(0)
    with np.load(os.path.join(out_dir, "inputs.npz")) as f:
        z = {k: f[k] for k in f.files}
    out = {"rank": rank, "pipeline": pipeline_cases(world)}
    if world == 4:
        out["conformer"] = conformer_cases(z)
        out["transducer"] = transducer_case(z)
        out["artifact"] = artifact_case(z, out_dir)
    else:
        out["sharding"] = sharding_case(z, out_dir, world)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
