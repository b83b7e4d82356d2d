"""Each cell of BENCHMARK.json, briefly, on the card, as the benchmark's
command runs it (both trace modes). Skips where there is no CUDA card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from hebench.tests.conftest import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell, trace):
    out = subprocess.run([sys.executable, "-m", "hebench.run", "--workload", cell, "--seed", "2147483659",
                          "--seconds", "2", "--trace", str(trace)], cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    if trace:
        assert result["device"]["busy_s"] > 0
        assert 0 < result["metrics"]["kernels.bound_share"]["value"] <= 100
