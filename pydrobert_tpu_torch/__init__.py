"""PyTorch/CUDA port of :mod:`pydrobert_tpu`.

A second package beside the JAX one, with the same module names so each
counterpart is easy to find. Plain tensor code is PyTorch; every Pallas
kernel of the JAX package on a ported path is a CUDA kernel written for
Hopper (``sm_90a``) under ``csrc/``, built on first use by
:mod:`pydrobert_tpu_torch.ops._build`.

Device policy: entry points run on ``cuda`` unless the caller passes a CPU
device, and raise when no card is present. A kernel wrapper given a CPU
tensor runs the kernel's plain PyTorch version; given a CUDA tensor it
launches the kernel or raises.

This package imports ``torch`` and ``numpy`` only, never ``jax`` or
:mod:`pydrobert_tpu`.
"""

import torch

# the public submodules, as the JAX package lists them, and the device
# policy
__all__ = [
    "argcheck",
    "config",
    "data",
    "default_device",
    "distributions",
    "estimators",
    "export",
    "functional",
    "models",
    "modules",
    "ops",
    "parallel",
    "serving",
    "training",
    "utils",
]


def default_device(device=None) -> torch.device:
    """Resolve an entry point's ``device`` argument.

    ``None`` means ``cuda``; asking for ``cuda`` on a host without a card
    raises instead of falling back to the CPU.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return device
