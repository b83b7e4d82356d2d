"""The port's tracer (she_tpu_torch/trace.py) around a small batch of the
batched MulPIR server on the CPU: spans nest, one root a batch, their
counts agree with the counter registry, the collector's collections are
spans, and the spans are torch.profiler ranges; with tracing off nothing
is recorded."""

import gc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from she_tpu_torch import params as tparams
from she_tpu_torch import trace
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.pir import index_pir as tip
from she_tpu_torch.pir import serving as tserving
from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr

PARAMS = "insecure_n_8_logq_5x18_logt_5"
ENTRIES = 40
INDICES = [3, 17, 38]


@pytest.fixture(scope="module")
def served():
    ctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, 32), device="cpu")
    config = tip.IndexPirConfig(entry_count=ENTRIES, entry_size_in_bytes=1, dimension_count=2, batch_size=1,
                                uneven_dimensions=True, key_compression=tip.PirKeyCompression("noCompression"),
                                encoding_entry_size=False)
    param = tip.generate_parameter(config, ctx)
    database = [bytes([(7 * i + 3) % 256]) for i in range(ENTRIES)]
    processed = tip.MulPirServer.process(database, ctx, param)
    client = tip.MulPirClient(param, ctx)
    sk = tbfv.generate_secret_key(ctx, nist_aes128_ctr(bytes(32)))
    ek = client.generate_evaluation_key(sk, nist_aes128_ctr(bytes(range(32))))
    queries = [client.generate_query([i], sk) for i in INDICES]
    server = tserving.BatchedMulPirServer(param, ctx, [processed])
    return dict(server=server, ek=ek, queries=queries, client=client, sk=sk, database=database)


@pytest.fixture
def tracing():
    """Tracing on for one test, off and drained after it, whatever it did."""
    trace.drain()
    trace.enable()
    yield
    trace.disable()
    trace.drain()


def _serve(served, batches: int) -> list:
    return [served["server"].compute_response_batch(served["queries"], served["ek"]) for _ in range(batches)]


def _within(child, parent) -> bool:
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_spans_of_a_batch_nest_and_agree_with_the_registry(served, tracing):
    before = dict(trace.counters)
    responses = _serve(served, 2)
    spans = trace.drain()
    program = [s for s in spans if s.name != "gc"]
    by_id = {s.id: s for s in spans}
    roots = [s for s in program if s.parent is None]
    assert [s.name for s in roots] == ["server.batch", "server.batch"]
    assert len({s.batch for s in roots}) == 2
    assert all(s.attrs == {"B": len(INDICES), "indices": 1} for s in roots)
    for s in spans:
        if s.parent is not None:
            assert _within(s, by_id[s.parent]), (s.name, by_id[s.parent].name)
            assert s.batch == by_id[s.parent].batch
    names = {s.name for s in program}
    assert {"server.stack", "expand", "expand.level", "key_switch", "expand.combine", "dim0.to_eval", "dim0.mac",
            "dim0.to_coeff", "fold", "behz.tensor_product", "behz.floor", "relinearize", "mod_switch",
            "server.assemble"} <= names

    def delta(name):
        return trace.counters[name] - before.get(name, 0)

    assert sum(s.name == "key_switch" for s in program) == delta("key_switch") > 0
    assert sum(s.name == "expand.level" for s in program) == delta("expansion_level") > 0
    assert sum(s.name == "mod_switch" for s in program) == delta("mod_switch") > 0
    assert sum(s.name == "behz.tensor_product" for s in program) == delta("behz.tensor_product") > 0
    levels = [s for s in program if s.name == "expand.level"]
    assert all(by_id[s.parent].name == "expand" for s in levels)
    assert all(s.attrs["applies"] >= 1 and s.attrs["parents"] >= 1 for s in levels)
    # key switches both under an expansion level and under relinearize
    assert {by_id[s.parent].name for s in program if s.name == "key_switch"} == {"expand.level", "relinearize"}
    # the CPU launches no hand-written kernel; no device events were asked for
    assert all(s.launches == 0 and s.device_ms is None for s in spans)
    for response, index in zip(responses[-1], INDICES):
        assert served["client"].decrypt(response, [index], served["sk"]) == [served["database"][index]]


def test_launch_delta_of_a_span_counts_its_children():
    trace.enable()
    try:
        with trace.span("outer"):
            trace.launch("ntt_forward")
            with trace.span("inner"):
                assert trace.launch("ks_mac")
                trace.count_shape("ks_mac", ("shape",))
    finally:
        trace.disable()
    inner, outer = trace.drain()
    assert (inner.name, inner.launches, outer.name, outer.launches) == ("inner", 1, "outer", 2)
    assert inner.parent == outer.id and inner.batch == outer.batch == outer.id
    assert trace.launch_shapes["ks_mac", ("shape",)] >= 1
    assert not trace.launch("ntt_forward")  # tracing off: the caller builds no shape key


def test_collection_inside_a_span_is_a_gc_span_under_it(tracing):
    with trace.span("work") as work:
        before = trace.counters["gc.gen2"]
        gc.collect()
    spans = trace.drain()
    collections = [s for s in spans if s.name == "gc"]
    assert collections and all(s.parent == work.id and _within(s, work) for s in collections)
    assert any(s.attrs["generation"] == 2 and s.attrs["collected"] >= 0 for s in collections)
    assert trace.counters["gc.gen2"] > before


def test_spans_are_nested_profiler_ranges(served, tracing):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(served, 1)
        with trace.span("collecting"):
            gc.collect()
    spans = trace.drain()
    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append(e.time_range)
    for name in ("server.batch", "expand", "expand.level", "key_switch", "gc"):
        assert name in ranges, name
    assert len(ranges["key_switch"]) == sum(s.name == "key_switch" for s in spans)
    (batch,) = ranges["server.batch"]
    assert all(batch.start <= r.start and r.end <= batch.end for name in ("expand", "key_switch", "mod_switch")
               for r in ranges[name])
    (collecting,) = ranges["collecting"]
    assert any(collecting.start <= r.start and r.end <= collecting.end for r in ranges["gc"])


def test_tracing_off_records_nothing(served):
    callbacks = list(gc.callbacks)
    trace.drain()
    first = trace.span("server.batch", B=1)
    assert trace.span("key_switch") is first
    with first as entered:
        assert entered is first
    _serve(served, 1)
    gc.collect()
    assert trace.drain() == []
    assert gc.callbacks == callbacks
    trace.enable()
    assert gc.callbacks != callbacks
    trace.disable()
    assert gc.callbacks == callbacks
    trace.drain()


def test_reset_clears_the_registry():
    trace.count("key_switch", 3)
    trace.launch("ntt_forward")
    trace.reset()
    assert not trace.counters and not trace.launch_shapes and trace.launch_total == 0


def test_enable_twice_raises():
    trace.enable()
    try:
        with pytest.raises(RuntimeError):
            trace.enable()
    finally:
        trace.disable()
        trace.drain()


def test_device_events_need_a_card(monkeypatch):
    callbacks = list(gc.callbacks)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        trace.enable(device_events=True)
    assert not trace.tracing() and gc.callbacks == callbacks
