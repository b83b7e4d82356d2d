"""The harness finds every part of a cell by its name, and a new config,
mix and metric are files and BENCHMARK.json entries alone."""

from __future__ import annotations

import json
import time

import pytest

from hebench import harness, loader
from hebench.tests.conftest import REPO, TINY_SEED

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_parts(workload):
    cell = loader.cell(REPO, workload)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["batch"] > 0
    kind = loader.server_kind(REPO, cell.config["server"])
    assert callable(kind.build)
    for metric in cell.end_to_end + cell.per_layer:
        assert callable(loader.metric_reader(REPO, metric["name"]).read)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert cell.per_layer


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        loader.cell(REPO, "no_such_cell.b1")


def test_a_config_mix_and_metric_added_as_files_alone(tiny_root):
    """A copy of the benchmark gains a configuration, a mix and a metric by
    adding files and BENCHMARK.json entries; the harness runs the new cell
    on the CPU and reports the new metric."""
    config = json.loads((tiny_root / "hebench" / "configs" / "mulpir_tiny.json").read_text())
    config["name"] = "mulpir_tiny_copy"
    (tiny_root / "hebench" / "configs" / "mulpir_tiny_copy.json").write_text(json.dumps(config))
    (tiny_root / "hebench" / "traffic" / "b2.json").write_text(
        json.dumps({"batch": 2, "pool_batches": 1, "absent_every": 2}))
    (tiny_root / "hebench" / "metrics" / "batch_max_ms.py").write_text(
        "def read(run):\n    return 1e3 * max(run.batch_s)\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="mulpir_tiny_copy", source="test", file="hebench/configs/mulpir_tiny_copy.json",
                                 reduced=[], why="test"))
    bench["workloads"].append(dict(name="mulpir_tiny_copy.b2", config="mulpir_tiny_copy", traffic="b2", chips=1,
                                   why="test"))
    bench["end_to_end"].append(dict(name="batch_max_ms", unit="ms", better="lower", bound=0.25, source="host_clock"))
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, extra = harness.run_cell(tiny_root, "mulpir_tiny_copy.b2", TINY_SEED, 0.2, False, "cpu",
                                     time.perf_counter())
    assert result["correct"]
    assert set(result["metrics"]) == {"queries_per_s", "batch_p95_ms", "setup_s", "batch_max_ms"}
    assert result["metrics"]["batch_max_ms"]["value"] == pytest.approx(1e3 * max(extra["run"].batch_s))
    assert list(result)[-1] == "checks"


def test_a_measurement_run_without_a_card_fails(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(REPO)
    code = harness.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
                        time.perf_counter())
    assert code != 0
    assert capsys.readouterr().out == ""
