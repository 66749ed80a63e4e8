"""What the benchmark may import: nothing under ``portbench/`` imports JAX,
flax, optax or the JAX package (top-level names compared whole, since the
port's name begins with the JAX package's), and the reference imports
nothing of the port, its plain kernels or its tests."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "flax", "optax", "pydrobert_tpu"}


def sources(sub=""):
    top = os.path.join(BENCH, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not set(top_names(path)) & BANNED


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_is_plain(path):
    names = set(top_names(path))
    assert not names & {"pydrobert_tpu_torch", "tests", "chip_smoke"}
    assert names <= {"torch", "numpy", "math", "contextlib"}, names


def test_names_compared_whole():
    # the port's own name is not the JAX package's
    assert "pydrobert_tpu_torch".split(".")[0] not in BANNED
