"""Set-up: from the process's start (imports, the CUDA context, the
kernels' build on a checkout's first run, seeded weights) to the end of
the warm-up of the cell's shapes, on the host's clock."""


def read(run):
    return run.setup_s
