"""The end-to-end metrics are taken over every batch of the window."""

from __future__ import annotations

import statistics

import pytest

from hebench import harness, loader
from hebench.tests.conftest import REPO


def synthetic_run(batch_s: list, batch: int = 128, gap_s: float = 0.0) -> harness.Run:
    return harness.Run(cell="synthetic", config={}, traffic={"batch": batch}, setup_s=12.5,
                       batch_s=batch_s, window_s=sum(batch_s) + gap_s * len(batch_s),
                       queries=batch * len(batch_s), floor={"total": 1.0})


def read(name: str, run) -> float:
    return loader.metric_reader(REPO, name).read(run)


def test_rate_counts_every_batch_and_the_whole_window():
    run = synthetic_run([0.05] * 99 + [1.0], gap_s=0.001)
    assert read("queries_per_s", run) == pytest.approx(128 * 100 / (0.05 * 99 + 1.0 + 0.1))


def test_a_stall_moves_the_rate():
    steady = synthetic_run([0.05] * 100)
    stalled = synthetic_run([0.05] * 99 + [2.0])
    assert read("queries_per_s", stalled) < 0.8 * read("queries_per_s", steady)


def test_p95_is_over_every_batch():
    times = [0.010 + 0.0001 * i for i in range(200)]
    run = synthetic_run(times)
    want = statistics.quantiles(times, n=100, method="inclusive")[94]
    assert read("batch_p95_ms", run) == pytest.approx(1e3 * want)
    # 11 slow batches of 200 lie beyond the 95th percentile and lift it
    slow = synthetic_run(times[:189] + [0.5] * 11)
    assert read("batch_p95_ms", slow) > 100


def test_setup_is_the_runs():
    assert read("setup_s", synthetic_run([0.05] * 3)) == 12.5


def test_per_layer_readers_read_nothing_from_an_untraced_run():
    run = synthetic_run([0.05] * 10)
    for name in ("server.host_ms", "server.launches", "stage.expand_ms", "stage.dim0_ms", "stage.behz_ms",
                 "kernels.bound_share", "device.idle_share", "device.peak_gib"):
        assert read(name, run) is None


def test_traced_readers():
    run = synthetic_run([0.010] * 4)
    run.host_s = [0.002, 0.004]
    run.stage_ms = [{"expand": 3.0, "dim0": 1.0, "fold_dimensions": 2.0}, {"expand": 5.0, "dim0": 1.0}]
    run.profile = {"batches": 3, "launches": 300, "busy_s_per_batch": [0.008, 0.007, 0.009]}
    run.window_peak_bytes = 3 * 2**30
    assert read("server.host_ms", run) == pytest.approx(3.0)
    assert read("server.launches", run) == 100
    assert read("stage.expand_ms", run) == pytest.approx(4.0)
    assert read("stage.dim0_ms", run) == pytest.approx(1.0)
    assert read("stage.behz_ms", run) == pytest.approx(2.0)
    assert read("device.idle_share", run) == pytest.approx(20.0)
    assert read("device.peak_gib", run) == pytest.approx(3.0)
    assert read("kernels.bound_share", run) == pytest.approx(100 * 1.0 / 3.35e12 / 0.008)
