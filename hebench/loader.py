"""Finds a cell's parts by the names in BENCHMARK.json.

Everything that belongs to one configuration, traffic mix, server kind or
metric sits in a file of its own:

- a configuration: the `file` its BENCHMARK.json entry names (JSON);
- a traffic mix: hebench/traffic/<traffic>.json;
- a server kind: hebench/servers/<server>.py, the `server` key of the
  configuration, with `build(config, traffic, seed, device, log)`;
- a metric: hebench/metrics/<name>.py with `read(run)`, which returns the
  metric's value or None where the run has nothing to read.

Paths are relative to `root`, the directory that holds BENCHMARK.json.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

PACKAGE = "hebench"


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list  # metric entries this cell reports with --trace 0
    per_layer: list  # and with --trace 1


def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(root: Path, name: str) -> Cell:
    root = Path(root)
    bench = load_benchmark(root)
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(workloads)}")
    workload = workloads[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[workload["config"]]["file"]).read_text())
    traffic = json.loads((root / PACKAGE / "traffic" / f"{workload['traffic']}.json").read_text())
    return Cell(
        name=name, workload=workload, config=config, traffic=traffic,
        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"],
    )


def _module(path: Path, label: str):
    if not path.is_file():
        raise FileNotFoundError(f"{label}: no file {path}")
    spec = importlib.util.spec_from_file_location(f"{PACKAGE}_{label}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def server_kind(root: Path, kind: str):
    return _module(Path(root) / PACKAGE / "servers" / f"{kind}.py", f"server_{kind}")


def metric_reader(root: Path, name: str):
    return _module(Path(root) / PACKAGE / "metrics" / f"{name}.py", f"metric_{name}")
