"""The port's tracer: one registry of counters, always on, and spans, recorded while tracing is on.

Counters: `counters` is one collections.Counter for the whole process;
`count(name, n)` adds to it and `reset()` clears it. A hand-written
kernel's launch is counted by `launch(kernel)`, which also keeps the
running total of every launch in `launch_total`; while tracing is on, its
caller also counts the launch by shape (`count_shape`) in `launch_shapes`,
keyed by (kernel, the wrapper's launch key). The names:

- `launch.<kernel>`: launches of a hand-written kernel (ops/*_cuda.py);
- `plain_on_cuda.<op>`: plain versions run on CUDA tensors, which only a
  comparison against the kernels makes (ops/ntt, ntt_mxu, key_switch,
  behz, dim0_mac);
- `key_switch`, `mod_switch`, `behz.tensor_product`, `behz.floor`: key
  switches, mod switches, BEHZ tensor products and floors run (bfv/);
- `expansion_level`, `leaf_level`: expansion levels combined, and of them
  those that wrote leaves (pir/expansion.py);
- `collective.staged_bytes`, `collective.staged_s`: what the collectives
  copied through the host for gloo, and the seconds the copies took
  (parallel/collectives.py);
- `gc.gen<k>`: collections of generation k while tracing was on.

Spans: `with span(name, **attrs):` around a piece of work. While tracing
is off, `span` returns one shared object that records nothing. While it
is on (`enable`), a span records its name, id, parent (the innermost span
open when it began), the id of its root (one a served batch), its host
start and end (time.perf_counter_ns), its attrs and the kernel launches
counted inside it, children included. While a profiler records, a span
is also a torch.profiler.record_function range, so the spans lie on the
device trace's clock (outside one, the range would record nothing and
cost more than the rest of the span). With `enable(device_events=True)`
it records a CUDA event at its begin and its end (from a reused pool) on
the stream current at `enable`, which the port launches every kernel on,
so its device ms runs in stream order and counts the kernels that ctypes
launches inside it, which the profiler links to no range. While
tracing is on, each collection the collector runs is a `gc` span
(attrs generation, collected) under the span open when it ran. Finished
spans stay in memory until `drain()` returns them; call it after
synchronizing the device. Spans are one thread's: the batch server's.
"""

from __future__ import annotations

import gc
import time
from collections import Counter

import torch
from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function

counters: Counter = Counter()
launch_shapes: Counter = Counter()  # (kernel, launch key) -> launches, counted while tracing is on
launch_total = 0  # every launch.* count, for the spans' deltas

_on = False
_stream = None  # with device events: the stream current when tracing was enabled
_open: list = []  # the spans open now, outermost first
_done: list = []  # finished spans, until drained
_free_events: list = []
_next_id = 0
_gc_started = None  # (start ns, its record_function range) of the collection running now


def count(name: str, n=1) -> None:
    counters[name] += n


def launch(kernel: str) -> bool:
    """Count one launch of `kernel` as launch.<kernel>. Returns whether
    tracing is on: the caller then counts the launch by shape
    (count_shape), whose key costs nothing to build while it is off."""
    global launch_total
    counters["launch." + kernel] += 1
    launch_total += 1
    return _on


def count_shape(kernel: str, key) -> None:
    launch_shapes[kernel, key] += 1


def reset() -> None:
    """Clear every counter and the launches by shape."""
    global launch_total
    counters.clear()
    launch_shapes.clear()
    launch_total = 0


def tracing() -> bool:
    return _on


class _Off:
    """What `span` returns while tracing is off: one object, no record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _event():
    return _free_events.pop() if _free_events else torch.cuda.Event(enable_timing=True)


class Span:
    """One span: name, id, parent (None for a root), batch (its root's
    id), attrs, start_ns and end_ns (time.perf_counter_ns), launches (the
    hand-written kernel launches inside it) and device_ms (begin to end on
    the stream, from CUDA events, once drained; None without them)."""

    __slots__ = ("name", "id", "parent", "batch", "attrs", "start_ns", "end_ns", "launches", "device_ms",
                 "_events", "_launch0", "_range")

    def __init__(self, name: str, attrs: dict):
        global _next_id
        _next_id += 1
        parent = _open[-1] if _open else None
        self.name, self.id, self.attrs = name, _next_id, attrs
        self.parent = parent.id if parent is not None else None
        self.batch = parent.batch if parent is not None else self.id
        self.start_ns = self.end_ns = None
        self.launches, self.device_ms, self._events, self._range = 0, None, None, None

    def __enter__(self):
        if _profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        if _stream is not None:
            self._events = (_event(), _event())
            self._events[0].record(_stream)
        self._launch0 = launch_total
        _open.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        self.launches = launch_total - self._launch0
        if self._events is not None:
            self._events[1].record(_stream)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        _open.pop()  # spans nest: this is the innermost
        _done.append(self)
        return False


def span(name: str, **attrs):
    """A context manager around a piece of work: a Span while tracing is
    on, else the shared object that records nothing."""
    if not _on:
        return _OFF
    return Span(name, attrs)


def _on_gc(phase: str, info: dict) -> None:
    global _gc_started
    if phase == "start":
        rng = record_function("gc") if _profiler_enabled() else None
        if rng is not None:
            rng.__enter__()
        _gc_started = (time.perf_counter_ns(), rng)
        return
    start_ns, rng = _gc_started
    _gc_started = None
    end_ns = time.perf_counter_ns()
    if rng is not None:
        rng.__exit__(None, None, None)
    record = Span("gc", {"generation": info["generation"], "collected": info["collected"]})
    record.start_ns, record.end_ns = start_ns, end_ns
    _done.append(record)
    counters[f"gc.gen{info['generation']}"] += 1


def enable(device_events: bool = False) -> None:
    """Start recording spans and the collector's collections; with
    `device_events`, CUDA events on the stream current now, which every
    kernel of the port is launched on (it switches no stream)."""
    global _on, _stream
    if _on:
        raise RuntimeError("tracing is on already")
    if device_events and not torch.cuda.is_available():
        raise RuntimeError("device events need a CUDA card")
    _on, _stream = True, torch.cuda.current_stream() if device_events else None
    gc.callbacks.append(_on_gc)


def disable() -> None:
    """Stop recording; the finished spans wait for `drain`."""
    global _on, _stream
    if not _on:
        return
    _on, _stream = False, None
    gc.callbacks.remove(_on_gc)


def drain() -> list:
    """The spans finished since the last drain, in the order they ended,
    with their device ms. Call it after synchronizing the device."""
    global _done
    out, _done = _done, []
    for s in out:
        if s._events is not None:
            s.device_ms = s._events[0].elapsed_time(s._events[1])
            _free_events.extend(s._events)
            s._events = None
    return out
