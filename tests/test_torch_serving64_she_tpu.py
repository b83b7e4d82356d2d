"""The w64 slice as a whole against she_tpu, bit for bit.

At insecure_n_8_logq_5x18_logt_5 with 64-bit scalars (wide BEHZ, cheap in
JAX), the port's BatchedMulPirServer(device="cpu") is fed she_tpu's
processed database, evaluation key and query (carried across by
she_tpu_torch.convert) and must answer with exactly the ciphertexts of
she_tpu's per-query ip.MulPirServer; she_tpu's client must decrypt the
port's answer to the entry. The she_tpu reference runs once for the
module (its eager w64 server is the expensive part on XLA:CPU).
"""

import jax.numpy as jnp
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
ENTRIES = 12
INDEX = 5


def _limbs(ct):
    return [np.asarray(p.data) for p in ct.polys]


@pytest.fixture(scope="module")
def slice64():
    jctx = jbfv.get_bfv_context(jparams.from_predefined(PARAMS, 64))
    tctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, 64), device="cpu")
    jsk = jbfv.generate_secret_key(jctx, jrng(b"s" * 32))
    config = dict(entry_count=ENTRIES, entry_size_in_bytes=1, dimension_count=2, batch_size=1,
                  uneven_dimensions=True)
    jparam = jip.generate_parameter(
        jip.IndexPirConfig(**config, key_compression=jip.PirKeyCompression.NO_COMPRESSION), jctx)
    tparam = tip.generate_parameter(
        tip.IndexPirConfig(**config, key_compression=tip.PirKeyCompression.NO_COMPRESSION), tctx)
    database = [bytes([(7 * i + 3) % 256]) for i in range(ENTRIES)]
    jprocessed = jip.MulPirServer.process(database, jctx, jparam)
    jclient = jip.MulPirClient(jparam, jctx)
    jek = jclient.generate_evaluation_key(jsk, jrng(b"k" * 32))
    jquery = jclient.generate_query([INDEX], jsk)
    want = jip.MulPirServer(jparam, jctx, [jprocessed]).compute_response(jquery, jek)

    galois = {e: [_limbs(ct) for ct in k.ciphertexts] for e, k in jek.galois_key.keys.items()}
    relin = [_limbs(ct) for ct in jek.relinearization_key.key_switch_key.ciphertexts]
    tek = convert.evaluation_key_from_limbs(tctx, galois, relin)
    tquery = convert.query_from_limbs(tctx, [_limbs(ct) for ct in jquery.ciphertexts], jquery.indices_count)
    tprocessed = convert.processed_database_from_limbs(
        tctx, [None if p is None else np.asarray(p.poly.data) for p in jprocessed.plaintexts])
    got = tserving.BatchedMulPirServer(tparam, tctx, [tprocessed]).compute_response_batch([tquery], tek)[0]
    return dict(jctx=jctx, tctx=tctx, jsk=jsk, jparam=jparam, tparam=tparam, jclient=jclient,
                database=database, jprocessed=jprocessed, tprocessed=tprocessed, want=want, got=got)


def test_parameters_and_processing_match(slice64):
    s = slice64
    assert s["tparam"].dimensions == s["jparam"].dimensions
    assert s["tparam"].evaluation_key_config.galois_elements == s["jparam"].evaluation_key_config.galois_elements
    ours = tip.MulPirServer.process(s["database"], s["tctx"], s["tparam"])
    for g, w in zip(convert.processed_database_to_limbs(ours), s["jprocessed"].plaintexts):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g, np.asarray(w.poly.data))


def test_batched_w64_response_matches_she_tpu_per_query_server(slice64):
    s = slice64
    assert len(s["got"].ciphertexts) == len(s["want"].ciphertexts) == 1
    for pc, jc in zip(s["got"].ciphertexts[0], s["want"].ciphertexts[0]):
        for g, w in zip(convert.ciphertext_to_limbs(pc), _limbs(jc)):
            np.testing.assert_array_equal(g, w)


def test_she_tpu_client_decrypts_the_ports_answer(slice64):
    s = slice64
    jreply = [convert.ciphertext_to_limbs(ct) for ct in s["got"].ciphertexts[0]]
    jresp = jip.Response([[
        jbfv.Ciphertext(s["jctx"], [jbfv.PolyRq(jnp.asarray(p), s["jctx"].ciphertext_context.get_context(1),
                                                jbfv.COEFF) for p in polys])
        for polys in jreply
    ]])
    assert s["jclient"].decrypt(jresp, [INDEX], s["jsk"]) == [s["database"][INDEX]]
