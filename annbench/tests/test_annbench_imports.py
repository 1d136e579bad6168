"""What the benchmark may import: nothing of JAX or the JAX package
anywhere, and nothing of the port outside the module that runs it."""

from __future__ import annotations

import ast
import os
import sys

import pytest

from annbench import run as run_mod
from annbench.tests.helpers import ROOT

BENCH = os.path.join(ROOT, "annbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "sptag_tpu"}
PORT = "sptag_tpu_torch"
# the one module that runs the port
PROGRAM = os.path.join(BENCH, "program.py")


def sources():
    for root, _, names in os.walk(BENCH):
        for name in sorted(names):
            if name.endswith(".py"):
                yield os.path.join(root, name)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    names.add(arg.value.split(".")[0])
    return names


def test_the_sources_are_found():
    found = {os.path.relpath(p, BENCH) for p in sources()}
    assert {"run.py", "reference.py", "program.py"} <= found


@pytest.mark.parametrize("path", list(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_or_jax_package(path):
    # whole top-level names: the port's name begins with the JAX
    # package's, and is no match for it
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in sources() if p != PROGRAM
             and os.path.dirname(p) != os.path.join(BENCH, "tests")],
    ids=lambda p: os.path.relpath(p, BENCH))
def test_only_the_program_module_imports_the_port(path):
    # the reference, the data and the metric arithmetic take nothing of
    # the program; of the tests, the one that breaks the port imports it
    assert PORT not in top_level_imports(path)


def test_the_program_module_imports_the_port():
    assert PORT in top_level_imports(PROGRAM)


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sptag_tpu_torch_lookalike",
                        sys.modules[__name__])
    assert run_mod.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        sys.modules[__name__])
    monkeypatch.setitem(sys.modules, "sptag_tpu.ops", sys.modules[__name__])
    assert run_mod.forbidden_modules() == ["jaxlib", "sptag_tpu"]
