"""Name-level inventory of the port: the JAX package is walked module by
module, and every public name of each JAX module (its ``__all__``, or its
public non-module attributes where it has none) exists in its counterpart
in ``pydrobert_tpu_torch``, except the names that ``NOT_PORTED`` gives with
their reasons. A JAX module with no counterpart must be in
``NOT_PORTED_MODULES``; ``QUEUED`` would hold names that ROADMAP.md still
queues, and a queued name that is already ported fails the test, so the
list can only shrink."""

import importlib
import inspect
import pkgutil

import pytest

import pydrobert_tpu

# "" is the package itself
MODULES = [
    "",
    "argcheck",
    "command_line",
    "config",
    "data",
    "data.dataloaders",
    "data.datasets",
    "data.params",
    "data.parsing",
    "data.textgrid",
    "datamodule",
    "distributions",
    "estimators",
    "export",
    "functional",
    "layers",
    "lm",
    "models",
    "models.conformer",
    "models.seq2seq",
    "models.transducer",
    "modules",
    "native",
    "ops",
    "ops.attn",
    "ops.combinatorics",
    "ops.decoding",
    "ops.feats",
    "ops.img",
    "ops.mc",
    "ops.pad",
    "ops.rl",
    "ops.straight_through",
    "ops.string",
    "ops.topk",
    "ops.transducer",
    "parallel",
    "parallel.checkpoint",
    "parallel.mesh",
    "parallel.pipeline",
    "serving",
    "training",
    "util",
    "utils",
    "utils.cache",
    "utils.hlostats",
    "utils.profiling",
    "utils.pytree",
    "utils.serial",
]

# JAX names the port leaves out on purpose: XLA and TPU tuning knobs with
# nothing to tune in eager PyTorch on a card, and the TPU kernel gate
NOT_PORTED = {
    "config": {
        "USE_JIT": "wraps functionals in jax.jit; the port runs eager PyTorch",
        "USE_PALLAS": "turns the Pallas TPU kernels off; a CUDA tensor always takes the "
        "port's kernel, a CPU tensor its plain version",
        "USE_PALLAS_BEAM": "the TPU calibration gate of the beam kernel; the port's "
        "counterpart is USE_BEAM_KERNEL",
        "USE_PALLAS_TOPM": "the TPU calibration gate of the Pallas top-M; the card's "
        "prologue always runs the port's kernel",
        "DECODE_SCAN_UNROLL": "unrolls XLA's scan body; the port's frame loop is a Python "
        "loop",
        "DECODE_PACK_LOGITS": "packs the XLA scan's inputs into one array; the port slices "
        "each frame's tensors directly",
        "DECODE_BUF_F16": "carries XLA's one-hot path buffer in float16; the port's path "
        "buffer is an integer tensor written by index",
        "FUSED_TOPK_TWOSTAGE": "an XLA top-k formulation measured on a TPU; the port ranks "
        "with one exact_top_k",
        "TOPK_COMPACT_MIN_BATCH": "the batch gate of an XLA sort-free top-k; the port ranks "
        "with one exact_top_k",
        "AM_ONEHOT_MAX_ELEMS": "the size gate of XLA's one-hot acoustic fetch; the port "
        "gathers",
    },
    "ops.topk": {
        "kernel_top_m_ok": "the TPU gate of the Pallas top-M (VMEM fit, calibration); a "
        "CUDA tensor always takes the port's kernel",
    },
}

# JAX modules with no counterpart module
NOT_PORTED_MODULES = {
    "ops.pallas": "the five Pallas TPU kernels; each has a Hopper kernel under "
    "pydrobert_tpu_torch/csrc/ (PERF.md, the kernel table under Findings)",
}

# names still to port (ROADMAP.md queue A); empty since A8 landed
QUEUED = {}


def _modname(pkg, name):
    return pkg + (f".{name}" if name else "")


def _public(mod):
    """A module's public names: its ``__all__``, else its attributes that
    are neither private nor modules."""
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [
        n for n in vars(mod) if not n.startswith("_") and not inspect.ismodule(getattr(mod, n))
    ]


def _has(pmod, name):
    """``name`` is an attribute of ``pmod`` or, for a package, a submodule
    of it (what ``from pmod import *`` would import)."""
    if hasattr(pmod, name):
        return True
    if not hasattr(pmod, "__path__"):
        return False
    try:
        importlib.import_module(f"{pmod.__name__}.{name}")
    except ModuleNotFoundError:
        return False
    return True


@pytest.mark.parametrize("name", MODULES)
def test_port_has_every_public_name(name):
    jmod = importlib.import_module(_modname("pydrobert_tpu", name))
    pmod = importlib.import_module(_modname("pydrobert_tpu_torch", name))
    skip = QUEUED.get(name, set()) | set(NOT_PORTED.get(name, {}))
    public = _public(jmod)
    missing = sorted(n for n in public if n not in skip and not _has(pmod, n))
    assert not missing, f"pydrobert_tpu_torch.{name} lacks {missing}"
    if hasattr(jmod, "__all__"):
        listed = sorted(n for n in public if n not in skip and n not in pmod.__all__)
        assert not listed, f"pydrobert_tpu_torch.{name}.__all__ lacks {listed}"
    done = sorted(n for n in QUEUED.get(name, set()) if hasattr(pmod, n))
    assert not done, f"{done} are ported: take them off QUEUED"


@pytest.mark.parametrize("name", sorted(NOT_PORTED))
def test_names_not_ported_are_still_jax_names(name):
    """Each name left out is still public in the JAX module, absent from
    the port, and given with a reason."""
    jmod = importlib.import_module(_modname("pydrobert_tpu", name))
    pmod = importlib.import_module(_modname("pydrobert_tpu_torch", name))
    for n, reason in NOT_PORTED[name].items():
        assert n in jmod.__all__, f"pydrobert_tpu.{name}.{n} is gone: take it off NOT_PORTED"
        assert not hasattr(pmod, n), f"pydrobert_tpu_torch.{name}.{n} exists: take it off"
        assert reason
    assert sum(len(v) for v in NOT_PORTED.values()) == 11


def test_every_jax_module_is_inventoried():
    """Walk the JAX package: each module is in ``MODULES`` or in
    ``NOT_PORTED_MODULES``, and every listed module exists there."""
    walked = {""} | {
        m.name[len("pydrobert_tpu."):]
        for m in pkgutil.walk_packages(pydrobert_tpu.__path__, "pydrobert_tpu.")
    }
    unlisted = sorted(walked - set(MODULES) - set(NOT_PORTED_MODULES))
    assert not unlisted, f"JAX modules neither inventoried nor named as not ported: {unlisted}"
    stale = sorted((set(MODULES) | set(NOT_PORTED_MODULES)) - walked)
    assert not stale, f"listed modules the JAX package does not have: {stale}"
    assert set(MODULES).isdisjoint(NOT_PORTED_MODULES)
    for name in NOT_PORTED_MODULES:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(_modname("pydrobert_tpu_torch", name))
