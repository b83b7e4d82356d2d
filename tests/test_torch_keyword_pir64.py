"""Keyword PIR at 64-bit scalars: the port against she_tpu, bit for bit.

At insecure_n_8_logq_5x18_logt_5 with 64-bit scalars a bucket of 12 bytes
spans three 4-byte plaintexts. Processing, including the cuckoo table for
a fixed seed, must equal she_tpu's; the port's BatchedKeywordPirServer,
fed she_tpu's evaluation key and queries (carried across by
she_tpu_torch.convert), must answer query 0 with exactly the ciphertexts
of she_tpu's per-query KeywordPirServer, which runs once for the module
(its eager 64-bit arithmetic is the expensive part on the CPU), and every
query with exactly the port's per-query server's; the port's client must
decrypt present keywords to their values and an absent one to None.
"""

import random

import numpy as np
import pytest

from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.pir import keyword_pir as jkp
from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng
from she_tpu_torch import convert
from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.pir import index_pir as tip
from she_tpu_torch.pir import keyword_pir as tkp
from she_tpu_torch.pir import serving as tserving

PARAMS = "insecure_n_8_logq_5x18_logt_5"
ROWS = [(f"kw{i}".encode(), bytes([17 * i + 5])) for i in range(3)]
KEYWORDS = [b"kw1", b"kw2", b"absent"]


def _limbs(ct):
    return [np.asarray(p.data) for p in ct.polys]


@pytest.fixture(scope="module")
def slice64():
    jctx = jbfv.get_bfv_context(jparams.from_predefined(PARAMS, 64))
    tctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, 64), device="cpu")
    bucket_size = tkp.default_max_serialized_bucket_size(1, tctx.params.bytes_per_plaintext)
    tprocessed = tkp.KeywordPirServer.process(
        ROWS, tkp.KeywordPirConfig(2, tkp.CuckooTableConfig.default_keyword_pir(bucket_size)), tctx,
        rng=random.Random(11))
    jprocessed = jkp.KeywordPirServer.process(
        ROWS, jkp.KeywordPirConfig(2, jkp.CuckooTableConfig.default_keyword_pir(bucket_size)), jctx,
        rng=random.Random(11))
    jsk = jbfv.generate_secret_key(jctx, jrng(b"s" * 32))
    jclient = jkp.KeywordPirClient(jprocessed.keyword_pir_parameter, jprocessed.pir_parameter, jctx)
    jek = jclient.generate_evaluation_key(jsk, jrng(b"k" * 32))
    jqueries = [jclient.generate_query(kw, jsk) for kw in KEYWORDS]
    want = jkp.KeywordPirServer(jctx, jprocessed).compute_response(jqueries[0], jek)
    galois = {e: [_limbs(ct) for ct in k.ciphertexts] for e, k in jek.galois_key.keys.items()}
    relin = [_limbs(ct) for ct in jek.relinearization_key.key_switch_key.ciphertexts]
    tek = convert.evaluation_key_from_limbs(tctx, galois, relin)
    tqueries = [convert.query_from_limbs(tctx, [_limbs(ct) for ct in q.ciphertexts], 2) for q in jqueries]
    got = tserving.BatchedKeywordPirServer(tctx, tprocessed).compute_response_batch(tqueries, tek)
    return dict(jctx=jctx, tctx=tctx, tprocessed=tprocessed, jprocessed=jprocessed, jsk=jsk, tek=tek,
                tqueries=tqueries, want=want, got=got,
                tsk=convert.secret_key_from_limbs(tctx, np.asarray(jsk.poly.data)))


def test_keyword_processing_matches_at_64_bits(slice64):
    tp, jp = slice64["tprocessed"], slice64["jprocessed"]
    assert tp.pir_parameter.dimensions == jp.pir_parameter.dimensions
    assert tp.pir_parameter.entry_size_in_bytes == jp.pir_parameter.entry_size_in_bytes == 12
    assert tp.database.count == jp.database.count
    assert tip.chunk_count(tp.pir_parameter, slice64["tctx"]) == 3
    limbs = convert.processed_database_to_limbs(tp.database)
    assert [p is None for p in limbs] == [p is None for p in jp.database.plaintexts]
    for g, w in zip(limbs, jp.database.plaintexts):
        if w is not None:
            np.testing.assert_array_equal(g, np.asarray(w.poly.data))
    assert tp.database.serialize() == jp.database.serialize(slice64["jctx"])


def test_batched_keyword_response_matches_she_tpu_at_64_bits(slice64):
    got, want = slice64["got"][0], slice64["want"]
    assert len(got.ciphertexts) == len(want.ciphertexts) == 2
    for g_reply, w_reply in zip(got.ciphertexts, want.ciphertexts):
        assert len(g_reply) == len(w_reply) == 3
        for gc, wc in zip(g_reply, w_reply):
            for g, w in zip(convert.ciphertext_to_limbs(gc), _limbs(wc)):
                np.testing.assert_array_equal(g, w)


def test_keyword_answers_decrypt_at_64_bits(slice64):
    s = slice64
    tctx = s["tctx"]
    per_query = tkp.KeywordPirServer(tctx, s["tprocessed"])
    client = tkp.KeywordPirClient(s["tprocessed"].keyword_pir_parameter, s["tprocessed"].pir_parameter, tctx)
    rows = dict(ROWS)
    for kw, query, response in zip(KEYWORDS, s["tqueries"], s["got"]):
        want = per_query.compute_response(query, s["tek"])
        for g_reply, w_reply in zip(response.ciphertexts, want.ciphertexts, strict=True):
            for gc, wc in zip(g_reply, w_reply, strict=True):
                assert (gc.stacked() == wc.stacked()).all()
        assert client.decrypt(response, kw, s["tsk"]) == rows.get(kw)
