#!/usr/bin/env python
"""End-to-end CTC ASR recipe on the PyTorch port: data dir -> train ->
decode -> score.

``examples/train_ctc_asr.py``'s workflow, flag for flag, through
:mod:`pydrobert_tpu_torch`:

1. (optionally) synthesize a valid SpectDataSet directory (``feat/`` +
   ``ref/`` of per-utterance ``.pt`` tensors, the same draws as the JAX
   script's);
2. build a Conformer-CTC model on the card (``--device cpu`` for the
   CPU), its weights drawn from a ``torch.Generator`` seeded by ``--seed``;
3. train with SpecAugment (on the card, the ``spec_augment_apply``
   kernel), the CTC loss and AdamW, driven by
   :class:`pydrobert_tpu_torch.training.TrainingStateController` (CSV
   history, checkpoints, early stopping, learning-rate reduction): re-running
   the script continues where it stopped;
4. greedy-decode the training set into ``hyp/``;
5. score with the ``compute-torch-token-data-dir-error-rates`` command into
   ``wer.txt``.

Run::

   python examples/train_ctc_asr_torch.py --work-dir /tmp/ctc_demo
   python examples/train_ctc_asr_torch.py --work-dir /tmp/ctc_cpu --device cpu

``--model-parallelism M`` above 1 needs a :mod:`torch.distributed` process
group whose world size ``M`` divides: initialized by the caller before
:func:`main`, or by the script from the environment ``torchrun`` sets
(``torchrun --nproc-per-node 2 examples/train_ctc_asr_torch.py
--model-parallelism 2 ...``). The ranks form the ``(data, model)`` mesh of
:func:`pydrobert_tpu_torch.parallel.make_mesh`, and the model's
parameters, gradients and AdamW state are sharded over its model axis and
replicated over its data axis (``fully_shard``): each rank keeps ``1 / M``
of them and gathers a parameter for its compute. Each rank reads its own
share of the utterances. Checkpoints hold full tensors; rank 0 writes the
hypotheses and the score.
"""

import argparse
import os
import sys

import numpy as np

try:
    import pydrobert_tpu_torch  # noqa: F401
except ImportError:  # running from a source checkout without installing
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch


def make_synthetic_dir(root: str, num_utts: int, vocab: int, seed: int = 0):
    """Write a small but valid SpectDataSet dir of random utterances."""
    from pydrobert_tpu_torch.utils.serial import save_tensor

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "feat"), exist_ok=True)
    os.makedirs(os.path.join(root, "ref"), exist_ok=True)
    for n in range(num_utts):
        T = int(rng.randint(20, 32))
        save_tensor(
            torch.from_numpy(rng.randn(T, 8).astype(np.float32)),
            os.path.join(root, "feat", f"utt{n:03d}.pt"),
        )
        R = int(rng.randint(1, 4))
        save_tensor(
            torch.from_numpy(rng.randint(0, vocab, (R,)).astype(np.int64)),
            os.path.join(root, "ref", f"utt{n:03d}.pt"),
        )


class _FullState:
    """What the controller saves and loads for a sharded model or its
    optimizer: full tensors, gathered by every rank before the controller
    is called (the controller saves on rank 0 only, and a gather is a
    collective)."""

    def __init__(self, model, optimizer=None):
        self.model, self.optimizer = model, optimizer
        if optimizer is not None:  # the controller reads and sets the rate
            self.param_groups = optimizer.param_groups
        self.full = None

    def gather(self):
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions, get_model_state_dict, get_optimizer_state_dict,
        )

        opts = StateDictOptions(full_state_dict=True)
        if self.optimizer is None:
            self.full = get_model_state_dict(self.model, options=opts)
        else:
            self.full = get_optimizer_state_dict(self.model, self.optimizer, options=opts)

    def state_dict(self):
        return self.full

    def load_state_dict(self, state, strict: bool = True):
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions, set_model_state_dict, set_optimizer_state_dict,
        )

        opts = StateDictOptions(full_state_dict=True, strict=strict)
        if self.optimizer is None:
            set_model_state_dict(self.model, state, options=opts)
        else:
            set_optimizer_state_dict(self.model, self.optimizer, state, options=opts)

    def parameters(self):
        # the checkpoints' map_location: full tensors load on the host
        return iter([torch.empty(0)])


def _process_group(model_parallelism: int, device: str):
    """The initialized group a sharded run needs, initialized here from
    ``torchrun``'s environment when the caller has not; raises when there
    is none or ``model_parallelism`` does not divide its world size."""
    dist = torch.distributed
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if device.startswith("cuda") else "gloo")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % model_parallelism:
        raise RuntimeError(
            f"--model-parallelism {model_parallelism} needs a torch.distributed "
            f"process group whose world size it divides, and this process has "
            f"{'a group of ' + str(world) if dist.is_initialized() else 'none'}: "
            "initialize one before main() or launch with torchrun "
            f"--nproc-per-node {model_parallelism}"
        )
    return dist.get_rank(), world


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--work-dir", required=True)
    parser.add_argument("--data-dir", default=None,
                        help="existing SpectDataSet dir (default: synthesize)")
    parser.add_argument("--num-utts", type=int, default=16)
    parser.add_argument("--vocab-size", type=int, default=13)
    parser.add_argument("--num-epochs", type=int, default=4)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--model-parallelism", type=int, default=1)
    parser.add_argument("--feat-pad-to", type=int, default=None)
    parser.add_argument("--ref-pad-to", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu; each rank of a sharded run "
                        "takes cuda:<local rank>")
    parser.add_argument("--seed", type=int, default=1,
                        help="seeds the weights, SpecAugment and dropout")
    args = parser.parse_args(argv)
    if args.model_parallelism < 1:
        raise ValueError(f"--model-parallelism must be positive, got {args.model_parallelism}")

    from pydrobert_tpu_torch import command_line, default_device
    from pydrobert_tpu_torch.data import SpectDataLoader, SpectDataLoaderParams, SpectDataSet
    from pydrobert_tpu_torch.functional import spec_augment
    from pydrobert_tpu_torch.models import ConformerConfig, ConformerCTC, adamw, make_train_step
    from pydrobert_tpu_torch.ops.decoding import ctc_greedy_search
    from pydrobert_tpu_torch.training import TrainingStateController, TrainingStateParams

    sharded = args.model_parallelism > 1
    rank = 0
    device = args.device
    if sharded:
        rank, _ = _process_group(args.model_parallelism, device)
        if device == "cuda":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
            torch.cuda.set_device(device)
    dev = default_device(device)

    os.makedirs(args.work_dir, exist_ok=True)
    data_dir = args.data_dir
    if data_dir is None:
        data_dir = os.path.join(args.work_dir, "data")
        if rank == 0:
            make_synthetic_dir(data_dir, args.num_utts, args.vocab_size)
            print(f"synthesized {args.num_utts} utterances under {data_dir}")
        if sharded:
            torch.distributed.barrier()

    # --- model (sharded over the mesh's model axis when asked) -------------
    cfg = ConformerConfig(
        vocab_size=args.vocab_size, num_filts=8, d_model=16, num_layers=1,
        num_heads=2, subsample_channels=4, conv_kernel=5, dtype=torch.float32,
    )
    host_gen = torch.Generator().manual_seed(args.seed)
    model = ConformerCTC(cfg, device=dev, generator=host_gen)
    if sharded:
        from torch.distributed.fsdp import fully_shard

        from pydrobert_tpu_torch.parallel import make_mesh

        mesh = make_mesh(args.model_parallelism, devices=dev.type)
        fully_shard(model, mesh=mesh)
        if rank == 0:
            print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    optimizer = adamw(model.parameters(), 3e-3)

    def augment(g, f, lens):
        return spec_augment(
            g, f, max_time_warp=2.0, max_time_mask=4, max_freq_mask=2,
            lengths=lens.float(),
        )

    step = make_train_step(model, optimizer, augment=augment)

    # --- training, resumable via the state controller ----------------------
    tparams = TrainingStateParams(
        num_epochs=args.num_epochs, seed=args.seed,
        early_stopping_threshold=0.0, early_stopping_patience=2,
    )
    controller = TrainingStateController(
        tparams,
        os.path.join(args.work_dir, "hist.csv"),
        os.path.join(args.work_dir, "states"),
    )
    saved_model, saved_optim = model, optimizer
    if sharded:
        saved_model, saved_optim = _FullState(model), _FullState(model, optimizer)
    # one seed per epoch, drawn up front: a resumed epoch draws what it
    # would have drawn in an uninterrupted run
    epoch_seeds = torch.randint(2**62, (tparams.num_epochs,), generator=host_gen)
    lparams = SpectDataLoaderParams(batch_size=args.batch_size, do_mvn=True)
    start = controller.get_last_epoch()
    if 0 < start < tparams.num_epochs:  # resume from the last checkpoint
        controller.load_model_and_optimizer_for_epoch(saved_model, saved_optim, start)
    for epoch in range(start, tparams.num_epochs):
        loader = SpectDataLoader(
            data_dir, lparams, seed=7, init_epoch=epoch, device=dev,
            feat_pad_to=args.feat_pad_to, ref_pad_to=args.ref_pad_to,
        )
        gen = torch.Generator(device=dev).manual_seed(int(epoch_seeds[epoch]))
        epoch_losses = []
        for feats, refs, feat_lens, ref_lens in loader:
            loss = step(gen, feats, feat_lens, refs.clamp(min=0), ref_lens)
            epoch_losses.append(float(loss))
        mean_loss = float(np.mean(epoch_losses))
        if rank == 0:
            print(f"epoch {epoch + 1}: loss {mean_loss:.4f}")
        if sharded:
            saved_model.gather()
            saved_optim.gather()
        if not controller.update_for_epoch(saved_model, saved_optim, mean_loss, mean_loss):
            if epoch + 1 < tparams.num_epochs and rank == 0:
                print("early stop")
            break
    else:
        if start >= tparams.num_epochs:  # resumed past the final epoch: load best
            controller.load_model_for_epoch(saved_model, controller.get_best_epoch())

    # --- decode + score -----------------------------------------------------
    # every rank runs the forward (a sharded one gathers with the others);
    # rank 0 writes
    ds = SpectDataSet(data_dir, params=lparams)
    with torch.no_grad():
        for i, utt_id in enumerate(ds.utt_ids):
            feat = torch.as_tensor(ds[i][0], device=dev)[None]
            lens_i = torch.tensor([feat.shape[1]], device=dev)
            logits, out_lens = model(feat, lens_i)
            _, paths, out_l = ctc_greedy_search(logits, out_lens, batch_first=True)
            if rank == 0:
                ds.write_hyp(utt_id, paths[0, : int(out_l[0])].cpu().long())
    rc = 0
    if rank == 0:
        wer_file = os.path.join(args.work_dir, "wer.txt")
        rc = command_line.compute_torch_token_data_dir_error_rates(
            [os.path.join(data_dir, "ref"), os.path.join(data_dir, "hyp"),
             wer_file, "--quiet", "--device", dev.type]
        )
        if not rc:
            with open(wer_file) as f:
                print(f"error rate: {float(f.read()):.4f} (-> {wer_file})")
    if sharded:
        torch.distributed.barrier()
    return rc


if __name__ == "__main__":
    sys.exit(main())
