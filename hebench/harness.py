"""One run of one cell: set-up, a closed-loop window, the trace, the check.

A batch-synchronous PIR server answers one batch at a time: the harness
calls the cell's entry with a batch of query objects and the batch ends
when torch.cuda.synchronize() returns, when its answers are ready to send.
The batches come from a pool made in set-up from the seed and cycled.

- set-up (`setup_s`, from the harness's first line to the first timed
  batch): the kernel sources the configuration lists are built
  (ops/kernel_build, cached in the checkout), the database, keys and query
  pool are made from the seed, and WARMUP_BATCHES batches run;
- the program runs as it is: the harness leaves Python's collector alone;
- the window: batches until `seconds` have passed; every batch counts;
- with --trace 1 the window also records a CUDA event at each stage mark
  the server passes and the host CPU time each batch's call takes, and
  PROFILED_BATCHES more batches run under torch.profiler;
- the check (checks.py): the answers of SAMPLE_BATCHES batches of the
  window, drawn from the seed, judged by the plain reference once the
  window has closed, the peak memory has been read and the program's
  state is freed.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from hebench import checks, floor, loader

FORBIDDEN = ("jax", "jaxlib", "flax", "she_tpu")
WARMUP_BATCHES = 3
SAMPLE_BATCHES = 4
PROFILED_BATCHES = 3


@dataclass
class Run:
    """What a run measured, for the metric readers (hebench/metrics/)."""

    cell: str
    config: dict
    traffic: dict
    setup_s: float
    batch_s: list  # host seconds of each batch of the window, call to synchronize
    window_s: float
    queries: int
    floor: dict  # floor.floor_bytes of one batch
    host_s: list = field(default_factory=list)  # --trace 1: host CPU seconds of each batch's call
    stage_ms: list = field(default_factory=list)  # --trace 1: per batch, device ms by stage span
    profile: dict | None = None  # --trace 1: trace.read of the profiled batches
    window_peak_bytes: int | None = None


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(names=None) -> list:
    """Of `names` (the modules loaded in this process), the top-level names
    that are JAX's or the JAX package's, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi: none"


class Reservoir:
    """A uniform sample of `size` of a stream of items, drawn from a seed."""

    def __init__(self, size: int, seed: int):
        self.size, self.items, self.seen = size, [], 0
        self._rng = np.random.default_rng([seed, 5])

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
            return
        j = int(self._rng.integers(0, self.seen))
        if j < self.size:
            self.items[j] = item


def _stage_spans(marks: list) -> dict:
    """marks: [(name, cuda event)] of one batch, the first at its start;
    the span that ends at a mark belongs to that mark's stage."""
    out: dict = {}
    for (_, a), (name, b) in zip(marks, marks[1:]):
        out[name] = out.get(name, 0.0) + a.elapsed_time(b)
    return out


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, device, started: float,
             patch=None) -> tuple[dict, dict]:
    """One run; returns (the result line, what else the run holds: the
    Run record and the served cell). `patch(served)`, for tests, may
    replace parts of the served cell before set-up ends."""
    import torch

    cuda = torch.device(device).type == "cuda"

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize()

    cell = loader.cell(root, name)
    kind = loader.server_kind(root, cell.config["server"])
    if cuda:
        from she_tpu_torch.ops import kernel_build

        built = kernel_build.build(cell.config["kernels"])
        log(f"[{name}] kernels built (s, 0 where cached): {built}")
    served = kind.build(cell.config, cell.traffic, seed, device, log)
    if served.shape_mismatch:
        raise RuntimeError(f"the program's shapes differ from the configuration's (got, stated): {served.shape_mismatch}")
    if patch is not None:
        patch(served)
    pool = served.pool
    for i in range(WARMUP_BATCHES):
        served.serve(pool[i % len(pool)])
        sync()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - started
    log(f"[{name}] set-up {setup_s:.3f} s; a pool of {len(pool)} batches of {cell.traffic['batch']}")

    sample = Reservoir(SAMPLE_BATCHES, seed)
    batch_s, host_s, marks = [], [], []
    i = 0
    t_start = time.perf_counter()
    while True:
        queries = pool[i % len(pool)]
        batch_marks = []
        on_stage = None
        if trace and cuda:
            def on_stage(stage: str, batch_marks=batch_marks) -> None:
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                batch_marks.append((stage, event))

            on_stage("batch_start")
        t0 = time.perf_counter()
        c0 = time.process_time()
        responses = served.serve(queries, on_stage)
        c1 = time.process_time()
        sync()
        t1 = time.perf_counter()
        batch_s.append(t1 - t0)
        host_s.append(c1 - c0)
        marks.append(batch_marks)
        sample.offer((i % len(pool), responses))
        i += 1
        if t1 - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    del responses
    window_peak = torch.cuda.max_memory_allocated() if cuda else None
    memory_peak = max(setup_peak, window_peak) if cuda else 0
    log(f"[{name}] window: {len(batch_s)} batches in {window_s:.3f} s")

    run = Run(cell=name, config=cell.config, traffic=cell.traffic, setup_s=setup_s,
              batch_s=batch_s, window_s=window_s, queries=len(batch_s) * cell.traffic["batch"],
              floor=floor.floor_bytes(cell.config["shape"], cell.traffic["batch"]), window_peak_bytes=window_peak)
    if trace:
        from hebench import trace as tracemod

        run.host_s = host_s
        run.stage_ms = [_stage_spans(m) for m in marks if m]
        if cuda:
            run.profile = tracemod.profile(served.serve, [pool[j % len(pool)] for j in range(PROFILED_BATCHES)], sync)

    # the check, once the program's state is freed
    answers = [(p, served.answer_tensor(r).cpu()) for p, r in sample.items]
    sample.items.clear()
    served.server = served.evaluation_key = served.pool = pool = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    judged = checks.judge(served, answers, cell.config["limits"], device=device)
    log(f"[{name}] {judged['checked']} answers of {len(answers)} batches judged in {time.perf_counter() - t0:.3f} s")

    readers = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for metric in readers:
        value = loader.metric_reader(root, metric["name"]).read(run)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    result = {
        "correct": checks.passes(judged["numbers"]),
        "attempted": run.queries,
        "failed": judged["numbers"]["wrong"]["value"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell.workload["chips"],
            "memory_peak_bytes": memory_peak,
        },
    }
    if run.profile is not None:
        result["device"]["busy_s"] = run.profile["busy_s"]
        result["device"]["window_s"] = run.profile["window_s"]
        result["breakdown"] = {"device_ops": run.profile["device_ops"], "idle_gaps": run.profile["idle_gaps"]}
    result["checks"] = judged["numbers"]
    return result, {"run": run, "served": served, "answers": answers, "judged": judged}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m hebench.run", description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv, started: float) -> int:
    args = parse_args(argv)
    root = Path.cwd()
    cell = loader.cell(root, args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {card_line()}; HBM peak taken as 3.35 TB/s (H100 SXM data sheet)")
    result, _ = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", started)
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or of the JAX package were loaded: {found}")
        return 3
    for key, number in result["checks"].items():
        log(f"check {key}: {number['value']} (limit {number['limit']})")
    print(json.dumps(result), flush=True)
    return 0
