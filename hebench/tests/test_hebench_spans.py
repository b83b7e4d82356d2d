"""hebench/spans.py: idle gaps labelled by the program's spans, the span
metrics on synthetic records, and the span passes of a tiny keyword cell
on the CPU."""

from __future__ import annotations

import pytest

from hebench import loader, spans
from hebench.spans import Record
from hebench.tests.conftest import TINY_SEED

MS = 1_000_000  # ns


def record(name, id, parent, start_ms, end_ms, launches=0, device_ms=None) -> Record:
    return Record(name, id, parent, int(start_ms * MS), int(end_ms * MS), launches, device_ms)


def test_a_gap_takes_the_innermost_span_open_at_its_end():
    device = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (6.0, 7.0), (9.0, 9.5), (9.5, 10.0), (12.0, 13.0)]
    ranges = [(0.0, 11.0, "server.batch"), (2.5, 8.0, "expand"), (2.8, 3.5, "expand.level"),
              (5.0, 6.5, "key_switch")]
    gaps = spans.label_gaps(device, ranges)
    # busy [0, 2], [3, 4], [6, 7], [9, 10], [12, 13]: four gaps, each once
    assert gaps == [("expand.level", 1.0), ("key_switch", 2.0), ("server.batch", 2.0), (spans.OUTSIDE, 2.0)]
    assert sum(s for _, s in gaps) == pytest.approx(13.0 - 2.0 - 1.0 - 1.0 - 1.0 - 1.0)


def test_no_gap_no_label():
    assert spans.label_gaps([(0.0, 1.0), (0.2, 0.4)], [(0.0, 2.0, "server.batch")]) == []


def test_idle_by_span_sums_a_batch_and_keeps_the_top():
    gaps = [(f"span{i}", 0.001 * (i + 1)) for i in range(12)] + [("span0", 0.001)]
    top = spans.idle_by_span(gaps, batches=2)
    assert len(top) == spans.TOP and top[0] == ["span11", pytest.approx(0.006)]
    assert dict(top).get("span0") is None  # 0.002 in all, below the ten largest
    assert [k for k, _ in spans.idle_by_span([("a", 1.0), ("b", 3.0), ("a", 1.0)], 1)] == ["b", "a"]


def synthetic_batch(base: int, offset_ms: float) -> list:
    """One batch's records: stack, an expansion with two key switches on two
    levels, a relinearize's key switch outside it, assembly and a gc."""
    t = offset_ms
    return [
        record("server.stack", base + 1, base, t + 0.0, t + 1.0),
        record("key_switch", base + 4, base + 3, t + 1.5, t + 2.0, launches=5, device_ms=2.0),
        record("expand.level", base + 3, base + 2, t + 1.2, t + 2.5, launches=6, device_ms=3.0),
        record("key_switch", base + 6, base + 5, t + 2.6, t + 3.0, launches=5, device_ms=4.0),
        record("expand.level", base + 5, base + 2, t + 2.5, t + 3.5, launches=6, device_ms=5.0),
        record("expand", base + 2, base, t + 1.0, t + 4.0, launches=12, device_ms=9.0),
        record("key_switch", base + 8, base + 7, t + 4.5, t + 5.0, launches=5, device_ms=1.0),
        record("relinearize", base + 7, base, t + 4.2, t + 5.5, launches=5, device_ms=1.5),
        record("gc", base + 9, base, t + 5.6, t + 5.9),
        record("server.assemble", base + 10, base, t + 6.0, t + 6.5),
        record("server.batch", base, None, t + 0.0, t + 7.0, launches=17, device_ms=15.0),
    ]


def test_metrics_of_synthetic_records():
    records = synthetic_batch(100, 0.0) + synthetic_batch(200, 10.0) + [record("gc", 300, None, 20.0, 20.4)]
    assert spans.host_ms(records, "server.stack", 2) == pytest.approx(1.0)
    assert spans.host_ms(records, "server.assemble", 2) == pytest.approx(0.5)
    assert spans.host_ms(records, "gc", 2) == pytest.approx((0.3 * 2 + 0.4) / 2)  # every collection, in a batch or not
    assert spans.host_ms([], "gc", 2) == 0.0 and spans.host_ms([], "server.stack", 2) is None
    # the two key switches under `expand`, not the relinearize's
    assert spans.key_switch_ms(records, 2) == pytest.approx(6.0)
    assert spans.key_switch_ms([r._replace(device_ms=None) for r in records], 2) is None
    rows = {r[0]: r[1:] for r in spans.by_span(records, 2)}
    assert rows["key_switch"] == [pytest.approx(1.4), pytest.approx(7.0), 15.0]
    assert rows["server.batch"] == [pytest.approx(7.0), pytest.approx(15.0), 17]
    assert rows["gc"][1] is None
    assert spans.by_span(records, 2)[0][0] == "server.batch"


def test_checks_hold_spans_against_the_registry():
    records = synthetic_batch(100, 0.0) + synthetic_batch(200, 10.0)
    traced = dict(spans=records, batches=2, launches=34, counted={"key_switch": 6, "expansion_level": 4})
    assert spans.checks(traced) == {"key_switch": [3.0, 3.0], "expansion_level": [2.0, 2.0],
                                    "root_launches": [17.0, 17.0], "roots": [1.0, 1]}


def test_torch_launches_are_the_device_launches_the_registry_did_not_count():
    profiled = dict(device=[(0.0, 1.0)] * 700, launches=258, batches=3)
    assert spans.torch_launches(profiled) == pytest.approx((700 - 258) / 3)
    assert spans.torch_launches(None) is None
    assert spans.torch_launches(dict(device=[], launches=0, batches=3)) is None


def test_tiny_keyword_cell_on_the_cpu_reads_the_host_metrics(tiny_root):
    """The span pass of a tiny keyword cell on the CPU: the three host
    metrics, the device ones None, and every check holds."""
    cell = loader.cell(tiny_root, "keyword_tiny.b4")
    served = loader.server_kind(tiny_root, cell.config["server"]).build(cell.config, cell.traffic, TINY_SEED, "cpu",
                                                                       lambda msg: None)
    out = spans.measure(served.serve, served.pool, lambda: None, cuda=False, span_batches=3)
    metrics = out["metrics"]
    assert set(metrics) == set(spans.METRICS)
    assert all(metrics[k] is not None and metrics[k] >= 0 for k in ("host.stack_ms", "host.assemble_ms", "host.gc_ms"))
    assert metrics["host.stack_ms"] > 0
    assert metrics["expand.key_switch_ms"] is None and metrics["server.torch_launches"] is None
    check = out["checks"]["span_pass"]
    assert check["key_switch"][0] == check["key_switch"][1] > 0
    assert check["expansion_level"][0] == check["expansion_level"][1] > 0
    assert check["root_launches"] == [0, 0] and check["roots"] == [1, 1]
    names = [row[0] for row in out["breakdown"]["by_span"]]
    assert {"server.batch", "server.stack", "expand", "key_switch", "dim0.mac", "mod_switch"} <= set(names)
    assert "idle_by_span" not in out["breakdown"]
