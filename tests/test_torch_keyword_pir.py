"""Keyword PIR: the port against she_tpu's keyword_pir.py, bit for bit.

Hashing, bucket bytes, the cuckoo table built from the same random.Random
(evictions, expansions and rng draws included), sharding and database
processing agree with she_tpu's. Then the two-index, two-sub-table batched
path: she_tpu's evaluation key and keyword queries are carried across with
she_tpu_torch.convert, the port's BatchedKeywordPirServer must answer with
exactly the ciphertexts of she_tpu's per-query KeywordPirServer, and the
port's client must decrypt present keywords to their values and absent
ones to None. At the tiny parameter set a plaintext holds 4 bytes, so
every bucket spans several plaintexts. This file runs at 32-bit scalars;
tests/test_torch_keyword_pir64.py holds the 64-bit case (she_tpu's 64-bit
per-query server is slow on the CPU, so it answers one query there).
"""

import random

import numpy as np
import pytest
import torch

from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.pir import keyword_pir as jkp
from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng
from she_tpu_torch import convert, errors
from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.pir import keyword_pir as tkp
from she_tpu_torch.pir import process_database as tpd
from she_tpu_torch.pir import serving as tserving

PARAMS = "insecure_n_8_logq_5x18_logt_5"


def _limbs(ct):
    return [np.asarray(p.data) for p in ct.polys]


def _rows(count, value_size, seed):
    rng = np.random.default_rng(seed)
    return [(f"kw{i}".encode(), rng.integers(0, 256, size=value_size, dtype=np.uint8).tobytes()) for i in range(count)]


@pytest.mark.parametrize("bucket_count,functions", [(3, 2), (17, 2), (1000, 3)])
def test_hash_indices_and_bucket_bytes_match(bucket_count, functions):
    for i in range(40):
        kw = f"keyword-{i}".encode()
        assert tkp.keyword_hash(kw) == jkp.keyword_hash(kw)
        assert tkp.hash_indices(kw, bucket_count, functions) == jkp.hash_indices(kw, bucket_count, functions)
    slots = [(jkp.keyword_hash(kw), val) for kw, val in _rows(5, 3, bucket_count)] + [(7, b"")]
    data = tkp.HashBucket(slots).serialize()
    assert data == jkp.HashBucket(slots).serialize()
    assert tkp.HashBucket.deserialize(data).slots == slots
    assert tkp.HashBucket(slots).serialized_size() == len(data)
    assert tkp.default_max_serialized_bucket_size(bucket_count, 2048) == jkp.default_max_serialized_bucket_size(
        bucket_count, 2048
    )


def _cuckoo_cases():
    # (rows, bucket config, max bucket size, max evictions)
    varied = [(f"v{i}".encode(), bytes([i % 251]) * (1 + i % 7)) for i in range(120)]
    return {
        "default": (_rows(300, 4, 1), tkp.CuckooBucketConfig("allowExpansion", 1.1, 0.9), 64, 100),
        # a full load target and few evictions: evicts, then expands
        "evicts_and_expands": (varied, tkp.CuckooBucketConfig("allowExpansion", 1.1, 1.0), 40, 3),
        "fixed_size": (_rows(40, 2, 2), tkp.CuckooBucketConfig("fixedSize", bucket_count=20), 48, 100),
    }


@pytest.mark.parametrize("case", ["default", "evicts_and_expands", "fixed_size"])
def test_cuckoo_table_matches(case):
    rows, bucket_config, size, evictions = _cuckoo_cases()[case]
    tconfig = tkp.CuckooTableConfig(2, evictions, size, bucket_config)
    jconfig = jkp.CuckooTableConfig(2, evictions, size, jkp.CuckooBucketConfig(
        bucket_config.kind, bucket_config.expansion_factor, bucket_config.target_load_factor,
        bucket_config.bucket_count))
    t_events, j_events = [], []
    trng, jrng_ = random.Random(5), random.Random(5)
    rows = rows + rows[:3]  # duplicate keywords are ignored
    table = tkp.CuckooTable(tconfig, rows, rng=trng, on_event=lambda *e: t_events.append(e))
    want = jkp.CuckooTable(jconfig, rows, rng=jrng_, on_event=lambda *e: j_events.append(e))
    assert table.buckets == want.buckets
    assert t_events == j_events
    assert trng.getstate() == jrng_.getstate()
    assert table.summarize() == want.summarize()
    assert table.serialize_buckets() == want.serialize_buckets()
    for kw, val in rows:
        assert table.get(kw) == val
    assert table.get(b"absent") is None
    if case == "evicts_and_expands":
        assert trng.getstate() != random.Random(5).getstate()  # evicted at least once
        assert any(kind == "expandedTable" for kind, _ in t_events)


def test_fixed_size_table_refuses_when_full():
    config = tkp.CuckooTableConfig(2, 5, 24, tkp.CuckooBucketConfig("fixedSize", bucket_count=2))
    with pytest.raises(errors.PirError, match="full"):
        tkp.CuckooTable(config, _rows(20, 2, 3), rng=random.Random(1))
    with pytest.raises(errors.PirError, match="exceeds"):
        tkp.CuckooTable(config, [(b"k", bytes(20))], rng=random.Random(1))


def test_sharding_matches():
    rows = dict(_rows(100, 1, 4))
    for sharding in (tkp.Sharding("shardCount", 4), tkp.Sharding("entryCountPerShard", 25)):
        want = jkp.shard_database(rows, jkp.Sharding(sharding.kind, sharding.count))
        assert tkp.shard_database(rows, sharding) == want
    fn = tkp.ShardingFunction("doubleMod", other_shard_count=8)
    want = jkp.shard_database(rows, jkp.Sharding("shardCount", 4), jkp.ShardingFunction("doubleMod", 8))
    assert tkp.shard_database(rows, tkp.Sharding("shardCount", 4), fn) == want


@pytest.fixture(scope="module")
def setup():
    bits = 32
    jctx = jbfv.get_bfv_context(jparams.from_predefined(PARAMS, bits))
    tctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, bits), device="cpu")
    rows = [(f"kw{i}".encode(), bytes([i, 255 - i])) for i in range(12)]
    bucket_size = tkp.default_max_serialized_bucket_size(2, tctx.params.bytes_per_plaintext)
    tconfig = tkp.KeywordPirConfig(2, tkp.CuckooTableConfig.default_keyword_pir(bucket_size))
    jconfig = jkp.KeywordPirConfig(2, jkp.CuckooTableConfig.default_keyword_pir(bucket_size))
    tprocessed = tkp.KeywordPirServer.process(rows, tconfig, tctx, rng=random.Random(7))
    jprocessed = jkp.KeywordPirServer.process(rows, jconfig, jctx, rng=random.Random(7))
    jsk = jbfv.generate_secret_key(jctx, jrng((b"s" * 32)[:32]))
    tsk = convert.secret_key_from_limbs(tctx, np.asarray(jsk.poly.data))
    jclient = jkp.KeywordPirClient(jprocessed.keyword_pir_parameter, jprocessed.pir_parameter, jctx)
    jek = jclient.generate_evaluation_key(jsk, jrng((b"k" * 32)[:32]))
    galois = {e: [_limbs(ct) for ct in k.ciphertexts] for e, k in jek.galois_key.keys.items()}
    relin = [_limbs(ct) for ct in jek.relinearization_key.key_switch_key.ciphertexts]
    tek = convert.evaluation_key_from_limbs(tctx, galois, relin)
    keywords = [b"kw3", b"kw10", b"absent"]
    jqueries = [jclient.generate_query(kw, jsk) for kw in keywords]
    tqueries = [
        convert.query_from_limbs(tctx, [_limbs(ct) for ct in q.ciphertexts], q.indices_count) for q in jqueries
    ]
    return dict(
        bits=bits, jctx=jctx, tctx=tctx, rows=dict(rows), tconfig=tconfig, tprocessed=tprocessed,
        jprocessed=jprocessed, jsk=jsk, tsk=tsk, jek=jek, tek=tek, keywords=keywords,
        jqueries=jqueries, tqueries=tqueries,
    )


def test_keyword_processing_matches(setup):
    tp, jp = setup["tprocessed"], setup["jprocessed"]
    assert tp.pir_parameter.dimensions == jp.pir_parameter.dimensions
    assert tp.pir_parameter.entry_count == jp.pir_parameter.entry_count
    assert tp.pir_parameter.entry_size_in_bytes == jp.pir_parameter.entry_size_in_bytes
    assert tp.pir_parameter.batch_size == 2
    assert tp.pir_parameter.evaluation_key_config.galois_elements == jp.pir_parameter.evaluation_key_config.galois_elements
    assert tp.keyword_pir_parameter.hash_function_count == jp.keyword_pir_parameter.hash_function_count
    assert tp.pir_parameter.entry_size_in_bytes > setup["tctx"].params.bytes_per_plaintext  # several chunks
    limbs = convert.processed_database_to_limbs(tp.database)
    assert [p is None for p in limbs] == [p is None for p in jp.database.plaintexts]
    assert any(p is None for p in limbs)  # zero plaintexts, and so zero columns
    for g, w in zip(limbs, jp.database.plaintexts):
        if w is not None:
            np.testing.assert_array_equal(g, np.asarray(w.poly.data))
    assert tp.database.serialize() == jp.database.serialize(setup["jctx"])


def _assert_responses_equal(port_responses, jax_responses):
    assert len(port_responses) == len(jax_responses)
    for pr, jr in zip(port_responses, jax_responses):
        assert len(pr.ciphertexts) == len(jr.ciphertexts) == 2
        for p_reply, j_reply in zip(pr.ciphertexts, jr.ciphertexts):
            assert len(p_reply) == len(j_reply) > 1
            for pc, jc in zip(p_reply, j_reply):
                for got, want in zip(convert.ciphertext_to_limbs(pc), _limbs(jc)):
                    np.testing.assert_array_equal(got, want)


def test_batched_keyword_server_matches_she_tpu(setup):
    tctx = setup["tctx"]
    server = tserving.BatchedKeywordPirServer(tctx, setup["tprocessed"])
    # the sub-tables are views of the processed tensor
    data = setup["tprocessed"].database.data
    for table in server.index_server.chunks:
        for chunk in table:
            assert chunk.untyped_storage().data_ptr() == data.untyped_storage().data_ptr()
    got = server.compute_response_batch(setup["tqueries"], setup["tek"])
    jserver = jkp.KeywordPirServer(setup["jctx"], setup["jprocessed"])
    want = [jserver.compute_response(q, setup["jek"]) for q in setup["jqueries"]]
    _assert_responses_equal(got, want)
    _assert_responses_equal(
        [tkp.KeywordPirServer(tctx, setup["tprocessed"]).compute_response(setup["tqueries"][0], setup["tek"])],
        want[:1],
    )
    client = tkp.KeywordPirClient(setup["tprocessed"].keyword_pir_parameter, setup["tprocessed"].pir_parameter, tctx)
    for kw, response in zip(setup["keywords"], got):
        assert client.decrypt(response, kw, setup["tsk"]) == setup["rows"].get(kw)
    assert client.count_entries_in_response(got[0], setup["tsk"]) >= 1
    # the stream answers as the batches do
    stream = server.compute_response_stream([setup["tqueries"][:2], setup["tqueries"][2:]], setup["tek"])
    for s, b in zip(stream, got):
        for s_reply, b_reply in zip(s.ciphertexts, b.ciphertexts):
            for sc, bc in zip(s_reply, b_reply):
                assert torch.equal(sc.stacked(), bc.stacked())


def test_process_database_shards_and_unions(setup):
    tctx = setup["tctx"]
    config = tpd.KeywordDatabaseConfig(tkp.Sharding("shardCount", 2), setup["tconfig"])
    arguments = tpd.Arguments(config, tctx.params)
    rows = setup["rows"]
    processed = tpd.process(rows, arguments, rng=random.Random(3), device="cpu")
    shards = tkp.shard_database(rows, tkp.Sharding("shardCount", 2))
    assert sorted(processed.shards) == sorted(shards)
    elements = set()
    for shard_id, p in processed.shards.items():
        want = tkp.KeywordPirServer.process(list(shards[shard_id].items()), setup["tconfig"], tctx,
                                            rng=random.Random(0))
        assert p.pir_parameter == want.pir_parameter
        elements |= set(p.pir_parameter.evaluation_key_config.galois_elements)
    assert processed.evaluation_key_config.galois_elements == tuple(sorted(elements))
    assert processed.evaluation_key_config.has_relinearization_key
    with pytest.raises(errors.PirError, match="Symmetric PIR"):
        tpd.Arguments(config, tctx.params, symmetric_pir_config=object())


@pytest.mark.parametrize("batch", [1, 3])
def test_stage_marks_follow_the_batch(setup, batch):
    """on_stage sees stack, expand, then per index and chunk dim0,
    fold_dimensions and mod_switch, and the answers do not change."""
    server = tserving.BatchedKeywordPirServer(setup["tctx"], setup["tprocessed"])
    queries = setup["tqueries"][:batch]
    want = server.compute_response_batch(queries, setup["tek"])
    marks = []
    got = server.compute_response_batch(queries, setup["tek"], on_stage=marks.append)
    chunks = len(server.index_server.chunks[0])
    assert marks == ["stack", "expand"] + ["dim0", "fold_dimensions", "mod_switch"] * (2 * chunks)
    for g, w in zip(got, want, strict=True):
        for g_reply, w_reply in zip(g.ciphertexts, w.ciphertexts, strict=True):
            for gc, wc in zip(g_reply, w_reply, strict=True):
                assert torch.equal(gc.stacked(), wc.stacked())
