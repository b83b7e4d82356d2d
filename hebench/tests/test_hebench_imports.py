"""Nothing under hebench/ imports JAX or the JAX package, and the reference
imports nothing of the program, top-level names compared whole."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from hebench import harness
from hebench.tests.conftest import REPO

FILES = sorted((REPO / "hebench").rglob("*.py"))
REFERENCE = sorted((REPO / "hebench" / "reference").rglob("*.py"))


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "she_tpu"}


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: str(p.relative_to(REPO)))
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "hashlib", "numpy", "torch"}
    relative = [n for n in ast.walk(ast.parse(path.read_text())) if isinstance(n, ast.ImportFrom) and n.level]
    assert all(n.level == 1 for n in relative)  # only the reference's own modules


def test_the_port_alone_loads_no_jax():
    """The port's name begins with the JAX package's: the check compares
    whole top-level names, so she_tpu_torch passes and she_tpu does not."""
    code = ("import sys; from hebench import harness; import she_tpu_torch.pir.serving, "
            "she_tpu_torch.pir.process_database; print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_compares_whole_names():
    assert harness.forbidden_modules(["she_tpu_torch", "she_tpu_torch.pir.serving", "jax_like", "numpy"]) == []
    assert harness.forbidden_modules(["she_tpu.ops.ntt", "jaxlib.xla_client", "flax", "jax"]) == [
        "flax", "jax", "jaxlib", "she_tpu"]
