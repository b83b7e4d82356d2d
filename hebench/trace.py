"""Reading the device's timeline of a few batches from torch.profiler.

The harness profiles whole batches, marking on the host (as zero-length
record_function ranges) the start of each batch and each stage mark the
server passes. From the trace: the device's busy time (the union of its
kernels and copies), the launches, the operations that took the most time,
and the device's idle gaps, each labelled by the last host mark before the
gap's end (what the host was doing while the device waited).
"""

from __future__ import annotations

import time

MARK = "hebench.mark."
BATCH = "batch_start"


def _union(intervals: list) -> list:
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def read(events, wall_s: float, batches: int) -> dict:
    """events: prof.events() of `batches` profiled batches that took
    `wall_s` host seconds. Times in seconds."""
    from torch.autograd import DeviceType

    marks, device = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            device.append((e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name))
        elif e.name.startswith(MARK):
            marks.append((e.time_range.start * 1e-6, e.name[len(MARK):]))
    marks.sort()
    busy_spans = _union([(s, e) for s, e, _ in device])
    busy_s = sum(e - s for s, e in busy_spans)
    by_name: dict = {}
    for s, e, name in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    gaps = []
    for (_, end), (start, _) in zip(busy_spans, busy_spans[1:]):
        label = "none"
        for ts, name in marks:
            if ts > start:
                break
            label = name
        gaps.append((f"after {label}", start - end))
    starts = [ts for ts, name in marks if name == BATCH]
    per_batch = []
    for i, first in enumerate(starts):
        last = starts[i + 1] if i + 1 < len(starts) else float("inf")
        per_batch.append(sum(e - s for s, e in _union([(s, e) for s, e, _ in device if first <= s < last])))
    return dict(
        busy_s=busy_s, window_s=wall_s, batches=batches, launches=len(device),
        busy_s_per_batch=per_batch,
        device_ops=sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:10],
        idle_gaps=[[n, s] for n, s in sorted(gaps, key=lambda x: -x[1])[:10]],
    )


def profile(serve, batches: list, sync) -> dict:
    """Profile serve(queries, on_stage) over each batch of `batches`."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    def mark(name: str) -> None:
        with record_function(MARK + name):
            pass

    sync()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for queries in batches:
            mark(BATCH)
            serve(queries, mark)
            sync()
        wall_s = time.perf_counter() - t0
    return read(prof.events(), wall_s, len(batches))
