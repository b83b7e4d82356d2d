"""Import hygiene and device selection of the port.

she_tpu_torch and chip_smoke.py import neither jax nor anything of she_tpu:
each file is parsed and every import statement checked. Nor do they import
a top-level `apple` package or edit sys.path: the port's generated protobuf
modules import one another package-relative, so an `apple` import resolved
through sys.path would load she_tpu's copies instead. Entry points run on
the CUDA card unless the caller names a device, and raise where there is no
card.
"""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "she_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "she_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_she_tpu_imports(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _apple_imports_and_path_edits(path: Path) -> list[str]:
    """Absolute imports whose top level is `apple`, and every mention of
    sys.path (an assignment, an insert, an append, an import of it)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imported_modules(path) if n.split(".")[0] == "apple"]
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr == "path" and getattr(node.value, "id", None) == "sys":
            bad.append(f"sys.path at line {node.lineno}")
        elif isinstance(node, ast.ImportFrom) and node.module == "sys" and any(a.name == "path" for a in node.names):
            bad.append(f"from sys import path at line {node.lineno}")
    return bad


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_apple_imports_or_sys_path_edits(path):
    bad = _apple_imports_and_path_edits(path)
    assert not bad, f"{path.relative_to(ROOT)}: {bad}"


def test_hygiene_check_catches_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom she_tpu.ops import ntt\nfrom she_tpu_torch import params\n")
    assert [n for n in _imported_modules(probe) if _forbidden(n)] == ["jax.numpy", "she_tpu.ops"]


def test_hygiene_check_catches_apple_imports_and_path_edits(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import sys\nfrom sys import path\nsys.path.insert(0, 'x')\n"
        "from apple.swift_homomorphic_encryption.v1 import he_pb2\nfrom . import pir_pb2\n"
    )
    assert sorted(_apple_imports_and_path_edits(probe)) == [
        "apple.swift_homomorphic_encryption.v1", "from sys import path at line 2", "sys.path at line 3"]


def test_entry_points_need_a_card_unless_told_otherwise():
    from she_tpu_torch import params as tparams
    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.device import resolve_device

    ep = tparams.from_predefined("insecure_n_8_logq_5x18_logt_5", 32)
    if torch.cuda.is_available():
        assert bfv.get_bfv_context(ep).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            bfv.get_bfv_context(ep)
        with pytest.raises(RuntimeError):
            resolve_device(None)
    assert bfv.get_bfv_context(ep, device="cpu").device == torch.device("cpu")


def test_kernel_modules_build_nothing_when_imported():
    """Importing the dim-0 MAC's modules (and the serving modules that
    dispatch to it) builds and loads no kernel: nvcc runs only inside a
    launch on the card. Every CUDA source is registered for the build."""
    import importlib

    from she_tpu_torch.ops import kernel_build

    loaded = set(kernel_build._loaded)
    for name in ("she_tpu_torch.ops.dim0_mac", "she_tpu_torch.ops.dim0_mac_cuda", "she_tpu_torch.pir.serving",
                 "she_tpu_torch.pnns.serving", "she_tpu_torch.bfv.bfv"):
        importlib.import_module(name)
    assert set(kernel_build._loaded) == loaded
    assert set(kernel_build.SOURCES.values()) == {p.name for p in (ROOT / "she_tpu_torch" / "csrc").glob("*.cu")}

