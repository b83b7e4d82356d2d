"""The port's w64 MulPIR path on its own, and its PIR packing at the
served parameters n_8192_logq_3x55_logt_24 (t = 2^23 + 16385, 23 bits a
coefficient, 23,552 bytes a plaintext) against she_tpu.

Every comparison is exact (tolerance 0).
"""

import os

import numpy as np
import pytest
import torch

from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.io import serialize as jserialize
from she_tpu.pir import index_pir as jip
from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng
from she_tpu_torch import convert
from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.io import coeffs as tcoeffs
from she_tpu_torch.pir import index_pir as tip
from she_tpu_torch.pir import serving as tserving
from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr as trng

SERVED = "n_8192_logq_3x55_logt_24"


def _port(name, entries, seed):
    ctx = tbfv.get_bfv_context(tparams.from_predefined(name, 64), device="cpu")
    param = tip.generate_parameter(tip.IndexPirConfig(entry_count=entries, entry_size_in_bytes=1), ctx)
    database = np.random.default_rng(seed).integers(0, 256, size=(entries, 1), dtype=np.uint8)
    processed = tip.MulPirServer.process(database, ctx, param)
    client = tip.MulPirClient(param, ctx)
    sk = tbfv.generate_secret_key(ctx, trng(bytes([seed]) * 32))
    ek = client.generate_evaluation_key(sk, trng(bytes([seed + 1]) * 32))
    return ctx, param, database, processed, client, sk, ek


@pytest.mark.parametrize("name,entries", [("insecure_n_8_logq_5x18_logt_5", 12),
                                          ("insecure_n_512_logq_4x60_logt_20", 5000)])
def test_batched_w64_answers_equal_per_query_server(name, entries):
    """The port alone, end to end: three queries answered in one batch equal
    the per-query server's answers and decrypt to their entries."""
    ctx, param, database, processed, client, sk, ek = _port(name, entries, 4)
    indices = [0, entries // 3, entries - 1]
    queries = [client.generate_query([i], sk) for i in indices]
    batched = tserving.BatchedMulPirServer(param, ctx, [processed]).compute_response_batch(queries, ek)
    reference = tip.MulPirServer(param, ctx, [processed])
    for index, query, got in zip(indices, queries, batched):
        want = reference.compute_response(query, ek)
        for gc, wc in zip(got.ciphertexts[0], want.ciphertexts[0]):
            assert torch.equal(gc.stacked(), wc.stacked())
        assert client.decrypt(got, [index], sk) == [database[index].tobytes()]
        assert tbfv.noise_budget(got.ciphertexts[0][0], sk) > 0


def test_served_parameters_pack_23_bits_a_coefficient():
    ctx = tbfv.get_bfv_context(tparams.from_predefined(SERVED, 64), device="cpu")
    assert ctx.plaintext_modulus == (1 << 23) + 16385
    assert ctx.params.bytes_per_plaintext == 23552
    param = tip.generate_parameter(tip.IndexPirConfig(entry_count=1_000_000, entry_size_in_bytes=1), ctx)
    assert param.dimensions == (11, 4)
    assert param.evaluation_key_config.galois_elements == (1025, 2049, 4097, 8193)
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, size=23552, dtype=np.uint8).tobytes()
    coeffs = tcoeffs.bytes_to_coefficients(data, 23, decode=False)
    np.testing.assert_array_equal(coeffs, np.asarray(jserialize.bytes_to_coefficients(data, 23, decode=False),
                                                     dtype=np.int64))
    assert tcoeffs.coefficients_to_bytes(coeffs, 23) == data


@pytest.fixture(scope="module")
def served():
    """Both packages at the served parameters, with the same secret key and,
    through a counter in place of os.urandom, the same query seeds."""
    jctx = jbfv.get_bfv_context(jparams.from_predefined(SERVED, 64))
    tctx = tbfv.get_bfv_context(tparams.from_predefined(SERVED, 64), device="cpu")
    config = dict(entry_count=30_000, entry_size_in_bytes=1, dimension_count=2, batch_size=1,
                  uneven_dimensions=True)
    jparam = jip.generate_parameter(jip.IndexPirConfig(**config), jctx)
    tparam = tip.generate_parameter(tip.IndexPirConfig(**config), tctx)
    jsk = jbfv.generate_secret_key(jctx, jrng(b"v" * 32))
    tsk = tbfv.generate_secret_key(tctx, trng(b"v" * 32))
    database = np.random.default_rng(12).integers(0, 256, size=(30_000, 1), dtype=np.uint8)
    return dict(jctx=jctx, tctx=tctx, jparam=jparam, tparam=tparam, jsk=jsk, tsk=tsk, database=database)


def _counter_urandom():
    state = [0]

    def urandom(n):
        state[0] += 1
        return state[0].to_bytes(4, "little") * (n // 4) + bytes(n % 4)

    return urandom


def test_served_processing_matches_she_tpu(served):
    s = served
    assert s["tparam"].dimensions == s["jparam"].dimensions
    want = jip.MulPirServer.process([bytes(e) for e in s["database"]], s["jctx"], s["jparam"])
    got = tip.MulPirServer.process(s["database"], s["tctx"], s["tparam"])
    for g, w in zip(convert.processed_database_to_limbs(got), want.plaintexts):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g, np.asarray(w.poly.data))


def test_served_query_and_decryption_match_she_tpu(served, monkeypatch):
    s = served
    index = 23_456
    monkeypatch.setattr(os, "urandom", _counter_urandom())
    jquery = jip.MulPirClient(s["jparam"], s["jctx"]).generate_query([index], s["jsk"])
    monkeypatch.setattr(os, "urandom", _counter_urandom())
    tclient = tip.MulPirClient(s["tparam"], s["tctx"])
    tquery = tclient.generate_query([index], s["tsk"])
    assert len(tquery.ciphertexts) == len(jquery.ciphertexts)
    for tc, jc in zip(tquery.ciphertexts, jquery.ciphertexts):
        for g, w in zip(convert.ciphertext_to_limbs(tc), [np.asarray(p.data) for p in jc.polys]):
            np.testing.assert_array_equal(g, w)
    # a single-modulus ciphertext decrypts to the same bytes in both clients
    tct = tbfv.mod_switch_down_to_single(tquery.ciphertexts[0])
    jct = jbfv.mod_switch_down_to_single(jquery.ciphertexts[0])
    jclient = jip.MulPirClient(s["jparam"], s["jctx"])
    got = tclient.decrypt(tip.Response([[tct]]), [index], s["tsk"])
    assert got == jclient.decrypt(jip.Response([[jct]]), [index], s["jsk"])
