"""Index PIR over entries larger than one plaintext, against she_tpu.

At insecure_n_8_logq_5x18_logt_5 a plaintext holds 4 bytes, so a 9-byte
entry (10 with its size prefix) takes three plaintexts, one per chunk. The
port's MulPirServer.process must give she_tpu's _process_split_large_entries
plaintexts (chunk-major, reordered by dimension, zero chunks not present);
the port's BatchedMulPirServer, fed she_tpu's evaluation key and queries,
must answer with exactly she_tpu's per-query ciphertexts, and the port's
client must decrypt them to the entries.
"""

import numpy as np
import pytest

from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.pir import index_pir as jip
from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng
from she_tpu_torch import convert
from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.pir import index_pir as tip
from she_tpu_torch.pir import serving as tserving

PARAMS = "insecure_n_8_logq_5x18_logt_5"
ENTRIES = 10
ENTRY_SIZE = 9
INDICES = [2, 5, 9]


def _limbs(ct):
    return [np.asarray(p.data) for p in ct.polys]


def _database():
    rng = np.random.default_rng(9)
    db = [rng.integers(1, 256, size=ENTRY_SIZE, dtype=np.uint8).tobytes() for _ in range(ENTRIES)]
    db[2] = db[2][:4] + bytes(5)  # its second chunk is all zeros
    db[5] = db[5][:5]  # a short entry: its last chunk is empty
    db[8] = db[9] = b""  # empty entries
    return db


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "size_prefixed"])
def setup(request):
    encoding = request.param
    config = dict(entry_count=ENTRIES, entry_size_in_bytes=ENTRY_SIZE, encoding_entry_size=encoding)
    jctx = jbfv.get_bfv_context(jparams.from_predefined(PARAMS, 32))
    tctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, 32), device="cpu")
    jparam = jip.generate_parameter(jip.IndexPirConfig(**config), jctx)
    tparam = tip.generate_parameter(tip.IndexPirConfig(**config), tctx)
    database = _database()
    jprocessed = jip.MulPirServer.process(database, jctx, jparam)
    tprocessed = tip.MulPirServer.process(database, tctx, tparam)
    jsk = jbfv.generate_secret_key(jctx, jrng((b"s" * 32)[:32]))
    jclient = jip.MulPirClient(jparam, jctx)
    jek = jclient.generate_evaluation_key(jsk, jrng((b"k" * 32)[:32]))
    jqueries = [jclient.generate_query([i], jsk) for i in INDICES]
    galois = {e: [_limbs(ct) for ct in k.ciphertexts] for e, k in jek.galois_key.keys.items()}
    relin = [_limbs(ct) for ct in jek.relinearization_key.key_switch_key.ciphertexts]
    return dict(
        encoding=encoding, jctx=jctx, tctx=tctx, jparam=jparam, tparam=tparam, database=database,
        jprocessed=jprocessed, tprocessed=tprocessed, jsk=jsk, jclient=jclient, jek=jek, jqueries=jqueries,
        tsk=convert.secret_key_from_limbs(tctx, np.asarray(jsk.poly.data)),
        tek=convert.evaluation_key_from_limbs(tctx, galois, relin),
        tqueries=[convert.query_from_limbs(tctx, [_limbs(ct) for ct in q.ciphertexts], 1) for q in jqueries],
    )


def test_split_processing_matches_she_tpu(setup):
    assert tip.chunk_count(setup["tparam"], setup["tctx"]) == 3
    assert setup["tparam"].dimensions == setup["jparam"].dimensions
    limbs = convert.processed_database_to_limbs(setup["tprocessed"])
    want = setup["jprocessed"].plaintexts
    assert len(limbs) == len(want) == 3 * ENTRIES
    assert [p is None for p in limbs] == [p is None for p in want]
    assert sum(p is None for p in limbs) >= 5  # zero chunks, and the empty entries
    for g, w in zip(limbs, want):
        if w is not None:
            np.testing.assert_array_equal(g, np.asarray(w.poly.data))
    assert setup["tprocessed"].serialize() == setup["jprocessed"].serialize(setup["jctx"])


def test_batched_multichunk_responses_match_she_tpu(setup):
    tctx = setup["tctx"]
    server = tserving.BatchedMulPirServer(setup["tparam"], tctx, [setup["tprocessed"]])
    assert len(server.chunks[0]) == 3
    got = server.compute_response_batch(setup["tqueries"], setup["tek"])
    jref = jip.MulPirServer(setup["jparam"], setup["jctx"], [setup["jprocessed"]])
    client = tip.MulPirClient(setup["tparam"], tctx)
    for index, response, jq in zip(INDICES, got, setup["jqueries"]):
        want = jref.compute_response(jq, setup["jek"])
        assert len(response.ciphertexts[0]) == len(want.ciphertexts[0]) == 3
        for pc, jc in zip(response.ciphertexts[0], want.ciphertexts[0]):
            for g, w in zip(convert.ciphertext_to_limbs(pc), _limbs(jc)):
                np.testing.assert_array_equal(g, w)
        entry = setup["database"][index]
        expected = entry if setup["encoding"] else entry + bytes(ENTRY_SIZE - len(entry))
        assert client.decrypt(response, [index], setup["tsk"]) == [expected]
        assert setup["jclient"].decrypt(want, [index], setup["jsk"]) == [expected]


def test_port_serves_large_entries_on_its_own(setup):
    """The port alone: process, keys, queries, batched answers decrypt."""
    from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr

    tctx, param = setup["tctx"], setup["tparam"]
    client = tip.MulPirClient(param, tctx)
    sk = tbfv.generate_secret_key(tctx, nist_aes128_ctr(bytes(32)))
    ek = client.generate_evaluation_key(sk, nist_aes128_ctr(bytes(range(32))))
    queries = [client.generate_query([i], sk) for i in (0, 2, 8)]
    server = tserving.BatchedMulPirServer(param, tctx, [setup["tprocessed"]])
    per_query = tip.MulPirServer(param, tctx, [setup["tprocessed"]])
    for index, query, response in zip((0, 2, 8), queries, server.compute_response_batch(queries, ek)):
        entry = setup["database"][index]
        expected = entry if setup["encoding"] else entry + bytes(ENTRY_SIZE - len(entry))
        assert client.decrypt(response, [index], sk) == [expected]
        want = per_query.compute_response(query, ek)
        for pc, wc in zip(response.ciphertexts[0], want.ciphertexts[0]):
            assert (pc.stacked() == wc.stacked()).all()
