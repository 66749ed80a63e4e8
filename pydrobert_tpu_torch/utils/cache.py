"""Where the port's compiled libraries are kept (counterpart of
:mod:`pydrobert_tpu.utils.cache`).

The JAX package keys XLA's persistent compilation cache. The port compiles
two libraries of its own on first use: the kernels' library
(:mod:`pydrobert_tpu_torch.ops._build`, ``nvcc`` for ``sm_90a``), which
depends on the card's compute capability and not on the host, and the
native batch reader (:mod:`pydrobert_tpu_torch.native`, ``g++``), which
depends on the host's CPU. Both land in ``pydrobert_tpu_torch/_build/`` by
default, named by a hash of their sources and flags; :func:`enable_cache`
moves them under a directory of the caller's, the kernels' library keyed
by the card and the reader by :func:`host_fingerprint`.
"""

import hashlib
import os
import platform

__all__ = ["compilation_cache_dir", "enable_cache", "host_fingerprint"]


def host_fingerprint() -> str:
    """A short stable id of this machine's CPU: a hash of its instruction
    set flags and its family, model and stepping (two hosts with the same
    flags but another model tune ``-O3`` code apart)."""
    feats = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats.append(" ".join(sorted(line.split(":", 1)[1].split())))
                    break
                if line.startswith(("cpu family", "model", "stepping")):
                    feats.append(line.strip())
    except OSError:
        pass
    raw = f"{platform.machine()}|{'|'.join(feats)}"
    return hashlib.sha1(raw.encode()).hexdigest()[:10]


def _card_tag():
    """``sm<major><minor>`` of card 0, or None without a card."""
    import torch

    if not torch.cuda.is_available():
        return None
    major, minor = torch.cuda.get_device_capability(0)
    return f"sm{major}{minor}"


def compilation_cache_dir(base: str) -> str:
    """The kernels' library directory for this process: ``<base>-sm<cc>``
    on a card (the library depends on its compute capability, so hosts
    with the same card share it), ``<base>-<host fingerprint>`` without
    one."""
    base = base.rstrip(os.sep)
    tag = _card_tag()
    return f"{base}-{tag}" if tag else f"{base}-{host_fingerprint()}"


def enable_cache(base: str) -> str:
    """Build and look up the compiled libraries under ``base``: the kernels'
    library in :func:`compilation_cache_dir` (or ``PDT_CACHE_DIR`` when
    set), the native reader in ``<base>-<host fingerprint>``. Returns the
    kernels' directory. Takes effect for a library not loaded yet."""
    from .. import native
    from ..ops import _build

    d = os.environ.get("PDT_CACHE_DIR") or compilation_cache_dir(base)
    host = f"{base.rstrip(os.sep)}-{host_fingerprint()}"
    os.makedirs(d, exist_ok=True)
    os.makedirs(host, exist_ok=True)
    _build._BUILD_DIR = d
    native._BUILD_DIR = host
    return d
