"""The program's own spans in a cell: the tracer of she_tpu_torch
(she_tpu_torch/trace.py), read into numbers a batch.

Two passes over batches of the cell's pool, each with the tracer on and
drained after every batch (once the device is synchronized):

- the span pass, SPAN_BATCHES batches with no profiler and, on a card, a
  CUDA event at each end of every span: for every span name its host ms,
  device ms and hand-written kernel launches a batch (`by_span`);
- on a card, the profiled pass, PROFILED_BATCHES batches under
  torch.profiler, where every span is also a record_function range on the
  device trace's clock: each idle gap of the device (between two spans of
  its busy time, as hebench/trace.py finds them) is labelled by the
  innermost span open on the host at the gap's end, or `outside` where
  none is (`idle_by_span`); and the device's launches less the registry's
  hand-written launches over the same batches (PyTorch's own launches).

`measure` returns the numbers of both: the metrics below, the two
breakdowns and the consistency checks (each span count against the
registry's count). `python3 -m hebench.spans --workload <cell> --seed <n>`
runs a cell's set-up as the harness does, then turns of tracing off and
on (the tracer's cost) and both passes, and prints them as one JSON line.

The metrics, a batch, of the span pass unless said otherwise:
  host.stack_ms          host ms of `server.stack`
  host.assemble_ms       host ms of `server.assemble`
  host.gc_ms             host ms of every `gc` span (the collector's runs)
  expand.key_switch_ms   device ms (CUDA events) of the `key_switch` spans under `expand`
  server.torch_launches  the profiled pass's device launches less the registry's launch.* counts
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from typing import NamedTuple

SPAN_BATCHES = 128
PROFILED_BATCHES = 3
OUTSIDE = "outside"
TOP = 10
METRICS = ("host.stack_ms", "host.assemble_ms", "host.gc_ms", "expand.key_switch_ms", "server.torch_launches")


class Record(NamedTuple):
    """A drained span without its attrs: a tuple of numbers and strings,
    which the collector stops tracking, so that a pass's records add no
    work to the collections they measure."""

    name: str
    id: int
    parent: int | None
    start_ns: int
    end_ns: int
    launches: int
    device_ms: float | None


def _served_batches(serve, batches: list, sync) -> list:
    """serve each batch with the tracer on; the spans of all of them."""
    from she_tpu_torch import trace

    records = []
    for queries in batches:
        serve(queries)
        sync()
        records.extend(Record(s.name, s.id, s.parent, s.start_ns, s.end_ns, s.launches, s.device_ms)
                       for s in trace.drain())
    return records


def span_pass(serve, batches: list, sync, device_events: bool) -> dict:
    """The spans of `batches` served with the tracer on, and the
    registry's counts over them."""
    from she_tpu_torch import trace

    sync()
    trace.drain()
    before, launches0 = dict(trace.counters), trace.launch_total
    trace.enable(device_events=device_events)
    try:
        spans = _served_batches(serve, batches, sync)
    finally:
        trace.disable()
    counted = {k: v - before.get(k, 0) for k, v in trace.counters.items() if v != before.get(k, 0)}
    return dict(spans=spans, counted=counted, launches=trace.launch_total - launches0, batches=len(batches))


def profiled_span_pass(serve, batches: list, sync) -> dict:
    """span_pass under torch.profiler (no CUDA events): its spans as above,
    and from the trace the device's busy intervals, its launches and the
    host's span ranges, in seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = span_pass(serve, batches, sync, device_events=False)
    names = {s.name for s in traced["spans"]}
    device, ranges = [], []
    for e in prof.events():
        interval = (e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.name in names:  # a span's range (on the device's timeline too, where the profiler projects it)
            if e.device_type != DeviceType.CUDA:
                ranges.append(interval + (e.name,))
        elif e.device_type == DeviceType.CUDA:
            device.append(interval)
    traced.update(device=device, ranges=ranges)
    return traced


def _union(intervals: list) -> list:
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def label_gaps(device: list, ranges: list) -> list:
    """device: (start, end) of every kernel and copy; ranges: (start, end,
    name) of the host's spans. Each idle gap between two busy spans of the
    device, once: (the innermost span open at the gap's end, or OUTSIDE,
    the gap's seconds)."""
    busy = _union(device)
    out = []
    for (_, idle_from), (idle_to, _) in zip(busy, busy[1:]):
        open_spans = [r for r in ranges if r[0] <= idle_to < r[1]]
        # spans nest, so the innermost open one began last
        label = max(open_spans, key=lambda r: (r[0], -r[1]))[2] if open_spans else OUTSIDE
        out.append((label, idle_to - idle_from))
    return out


def idle_by_span(gaps: list, batches: int) -> list:
    """The TOP labels by idle seconds a batch: [[label, s], ...]."""
    total: dict = {}
    for label, seconds in gaps:
        total[label] = total.get(label, 0.0) + seconds
    return [[k, v / batches] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def by_span(spans: list, batches: int) -> list:
    """For every span name, [name, host ms, device ms (None without CUDA
    events), hand-written launches], each a batch, by host ms."""
    rows: dict = {}
    for s in spans:
        row = rows.setdefault(s.name, [s.name, 0.0, None, 0])
        row[1] += (s.end_ns - s.start_ns) * 1e-6
        if s.device_ms is not None:
            row[2] = (row[2] or 0.0) + s.device_ms
        row[3] += s.launches
    out = [[name, host / batches, None if device is None else device / batches, launches / batches]
           for name, host, device, launches in rows.values()]
    return sorted(out, key=lambda r: -r[1])


def _under(span, ancestor: str, by_id: dict) -> bool:
    parent = by_id.get(span.parent)
    while parent is not None:
        if parent.name == ancestor:
            return True
        parent = by_id.get(parent.parent)
    return False


def host_ms(spans: list, name: str, batches: int):
    """Host ms a batch of the spans named `name`; None where there are none,
    except `gc`, which may rightly not run."""
    chosen = [s for s in spans if s.name == name]
    if not chosen and name != "gc":
        return None
    return sum((s.end_ns - s.start_ns) * 1e-6 for s in chosen) / batches


def key_switch_ms(spans: list, batches: int):
    """Device ms a batch of the key switches inside the expansion."""
    by_id = {s.id: s for s in spans}
    chosen = [s for s in spans if s.name == "key_switch" and _under(s, "expand", by_id)]
    if not chosen or any(s.device_ms is None for s in chosen):
        return None
    return sum(s.device_ms for s in chosen) / batches


def torch_launches(profiled: dict | None):
    """The profiled pass's device launches a batch that the registry did
    not count: PyTorch's copies, cats and elementwise kernels."""
    if profiled is None or not profiled["device"]:
        return None
    return (len(profiled["device"]) - profiled["launches"]) / profiled["batches"]


def checks(traced: dict) -> dict:
    """Spans against the registry over one pass, a batch: key_switch spans
    and counts, expand.level spans and expansion_level counts, the roots'
    launch deltas and the registry's launch.* counts."""
    spans, batches, counted = traced["spans"], traced["batches"], traced["counted"]

    def spans_of(name):
        return sum(s.name == name for s in spans) / batches

    roots = [s for s in spans if s.parent is None and s.name != "gc"]
    return {
        "key_switch": [spans_of("key_switch"), counted.get("key_switch", 0) / batches],
        "expansion_level": [spans_of("expand.level"), counted.get("expansion_level", 0) / batches],
        "root_launches": [sum(s.launches for s in roots) / batches, traced["launches"] / batches],
        "roots": [len(roots) / batches, 1],
    }


def measure(serve, pool: list, sync, cuda: bool, span_batches: int = SPAN_BATCHES,
            profiled_batches: int = PROFILED_BATCHES) -> dict:
    """Both passes over the pool, cycled: the metrics (None where a pass
    has nothing to read: the device ones off a card), the breakdowns and
    the checks."""
    traced = span_pass(serve, [pool[i % len(pool)] for i in range(span_batches)], sync, device_events=cuda)
    spans, batches = traced["spans"], traced["batches"]
    profiled = profiled_span_pass(serve, [pool[i % len(pool)] for i in range(profiled_batches)], sync) if cuda else None
    metrics = {
        "host.stack_ms": host_ms(spans, "server.stack", batches),
        "host.assemble_ms": host_ms(spans, "server.assemble", batches),
        "host.gc_ms": host_ms(spans, "gc", batches),
        "expand.key_switch_ms": key_switch_ms(spans, batches),
        "server.torch_launches": torch_launches(profiled),
    }
    out = dict(metrics=metrics, breakdown={"by_span": by_span(spans, batches)}, checks={"span_pass": checks(traced)},
               counted={k: v / batches for k, v in traced["counted"].items()})
    if profiled is not None:
        gaps = label_gaps(profiled["device"], profiled["ranges"])
        out["breakdown"]["idle_by_span"] = idle_by_span(gaps, profiled["batches"])
        out["checks"]["profiled_pass"] = checks(profiled)
        out["checks"]["idle_s"] = [sum(s for _, s in out["breakdown"]["idle_by_span"]) * profiled["batches"],
                                   sum(s for _, s in gaps)]
    return out


def on_cost(serve, pool: list, sync, seconds: float, turns: int, device_events: bool) -> list:
    """Windows of `seconds` with the tracer off and on in turns (off, on,
    on, off, ... for `turns` rounds), each drained after every batch: per
    window [tracing, queries/s, host CPU ms a batch, batches]."""
    from she_tpu_torch import trace

    out = []
    batch = len(pool[0])
    for on in [False, True, True, False] * turns:
        sync()
        if on:
            trace.enable(device_events=device_events)
        host, count, i = 0.0, 0, 0
        t_start = time.perf_counter()
        try:
            while time.perf_counter() - t_start < seconds:
                c0 = time.process_time()
                serve(pool[i % len(pool)])
                host += time.process_time() - c0
                sync()
                trace.drain()
                count, i = count + 1, i + 1
        finally:
            trace.disable()
        window = time.perf_counter() - t_start
        out.append([on, count * batch / window, 1e3 * host / count, count])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m hebench.spans", description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--turns", type=int, default=2, help="rounds of (off, on, on, off) windows")
    parser.add_argument("--turn-seconds", type=float, default=10.0)
    args = parser.parse_args(argv)

    import torch

    from hebench import harness, loader
    from hebench import trace as tracemod
    from she_tpu_torch.ops import kernel_build

    if not torch.cuda.is_available():
        harness.log("this tool needs a CUDA card")
        return 2
    root = Path.cwd()
    cell = loader.cell(root, args.workload)
    kernel_build.build(cell.config["kernels"])
    served = loader.server_kind(root, cell.config["server"]).build(cell.config, cell.traffic, args.seed, "cuda",
                                                                   harness.log)
    if served.shape_mismatch:
        raise RuntimeError(f"the program's shapes differ from the configuration's: {served.shape_mismatch}")
    pool = served.pool
    for i in range(harness.WARMUP_BATCHES):
        served.serve(pool[i % len(pool)])
    torch.cuda.synchronize()
    card = harness.card_line()
    harness.log(f"card: {card}")
    turns = on_cost(served.serve, pool, torch.cuda.synchronize, args.turn_seconds, args.turns, device_events=True)
    for on, rate, host, count in turns:
        harness.log(f"tracing {'on' if on else 'off'}: {rate:.1f} queries/s, host {host:.3f} ms a batch, "
                    f"{count} batches")
    baseline = tracemod.profile(served.serve, [pool[j % len(pool)] for j in range(PROFILED_BATCHES)],
                                torch.cuda.synchronize)
    result = measure(served.serve, pool, torch.cuda.synchronize, cuda=True)
    result.update(cell=args.workload, seed=args.seed, card=card, on_cost=turns,
                  on_cost_median={k: [statistics.median(t[j] for t in turns if t[0] == on) for j in (1, 2)]
                                  for k, on in (("off", False), ("on", True))},
                  baseline_profile={k: baseline[k] for k in ("busy_s", "window_s", "batches", "launches",
                                                             "busy_s_per_batch", "idle_gaps")})
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
