"""One rank of the port's two-process test under torch.distributed (gloo,
CPU): ``python _torch_dist_worker.py RANK WORLD PORT OUT_DIR``. Imports
only torch and the port. Writes ``rank<r>.json``."""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from pydrobert_tpu_torch.data import EpochRandomSampler
from pydrobert_tpu_torch.parallel import all_reduce_metrics
from pydrobert_tpu_torch.training import TrainingStateController, TrainingStateParams


def main(rank, world, port, out_dir):
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world
    )
    np.random.seed(100 + rank)  # the ranks' global draws differ
    auto = EpochRandomSampler(list(range(12)))
    seeded = EpochRandomSampler(list(range(12)), base_seed=42)
    out = {
        "auto_seed": auto.base_seed,
        "epoch0": [int(i) for i in seeded],
        "epoch1": [int(i) for i in seeded],
        "reduced": all_reduce_metrics({"met": float(rank + 1)}),
    }
    model = torch.nn.Linear(2, 2)
    optim = torch.optim.SGD(model.parameters(), lr=0.5)
    ctl = TrainingStateController(
        TrainingStateParams(num_epochs=2), os.path.join(out_dir, "hist.csv"),
        os.path.join(out_dir, "states"),
    )
    ctl.update_for_epoch(model, optim, float(rank + 1), float(rank + 2))
    out["train_met"], out["val_met"] = ctl[1]["train_met"], ctl[1]["val_met"]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
