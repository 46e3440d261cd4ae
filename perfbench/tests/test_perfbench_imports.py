"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port. Top-level names are compared
whole: ``repro_torch`` is allowed where ``repro`` is not."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from perfbench.tests import tiny
from perfbench import harness

FILES = sorted(p for p in harness.HERE.rglob("*.py")
               if "__pycache__" not in p.parts)


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((harness.HERE / "reference").glob(
    "*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert top_level_imports(path) <= {"__future__", "math", "typing",
                                       "numpy", "torch", "perfbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                "perfbench"):
            assert node.module.startswith("perfbench.reference")


def test_nothing_reads_the_jax_benchmarks():
    for path in FILES:
        if "tests" not in path.relative_to(harness.HERE).parts:
            assert "benchmarks/" not in path.read_text()


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process leaves no forbidden module."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from perfbench.tests import tiny\n"
            "from perfbench import harness\n"
            "for name in tiny.CELLS:\n"
            "    assert tiny.run(name)['correct']\n"
            "print(harness.forbidden_loaded())\n"
            % (str(tiny.REPO), str(tiny.REPO / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
