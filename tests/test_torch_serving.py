"""The slice as a whole: the port's MulPIR database processing, expansion
and batched server against she_tpu's, bit for bit.

The port's BatchedMulPirServer(device="cpu") is fed she_tpu's processed
database, evaluation key and queries (carried across by
she_tpu_torch.convert) and must answer with exactly the ciphertexts of
she_tpu.pir.serving.BatchedMulPirServer and of she_tpu's per-query
ip.MulPirServer; the port's client must decrypt them to the entries.
"""

import numpy as np
import pytest
import torch

from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.pir import index_pir as jip
from she_tpu.pir import serving as jserving
from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng
from she_tpu_torch import convert
from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.pir import index_pir as tip
from she_tpu_torch.pir import serving as tserving

PARAMS = "insecure_n_8_logq_5x18_logt_5"
ENTRIES = 40


def _limbs(ct):
    return [np.asarray(p.data) for p in ct.polys]


def _values(ct):
    """she_tpu ciphertext -> int64 [polys, L, N]."""
    return np.stack([convert.limbs_to_int64(a) for a in _limbs(ct)])


def _jax_ek_limbs(ek):
    galois = {e: [_limbs(ct) for ct in k.ciphertexts] for e, k in ek.galois_key.keys.items()}
    relin = [_limbs(ct) for ct in ek.relinearization_key.key_switch_key.ciphertexts]
    return galois, relin


def _config(compression=jip.PirKeyCompression.NO_COMPRESSION, encoding=False):
    return dict(
        entry_count=ENTRIES,
        entry_size_in_bytes=1,
        dimension_count=2,
        batch_size=1,
        uneven_dimensions=True,
        key_compression=compression,
        encoding_entry_size=encoding,
    )


def _t_config(compression="noCompression", encoding=False):
    cfg = _config(encoding=encoding)
    cfg["key_compression"] = tip.PirKeyCompression(compression)
    return tip.IndexPirConfig(**cfg)


@pytest.fixture(scope="module")
def setup():
    jctx = jbfv.get_bfv_context(jparams.from_predefined(PARAMS, 32))
    tctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, 32), device="cpu")
    jsk = jbfv.generate_secret_key(jctx, jrng((b"s" * 32)[:32]))
    tsk = convert.secret_key_from_limbs(tctx, np.asarray(jsk.poly.data))
    jparam = jip.generate_parameter(jip.IndexPirConfig(**_config()), jctx)
    tparam = tip.generate_parameter(_t_config(), tctx)
    rng = np.random.default_rng(21)
    database = [bytes([int(v)]) for v in rng.integers(0, 256, size=ENTRIES)]
    jprocessed = jip.MulPirServer.process(database, jctx, jparam)
    jclient = jip.MulPirClient(jparam, jctx)
    jek = jclient.generate_evaluation_key(jsk, jrng((b"k" * 32)[:32]))
    tek = convert.evaluation_key_from_limbs(tctx, *_jax_ek_limbs(jek))
    indices = [0, 17, 39]
    jqueries = [jclient.generate_query([i], jsk) for i in indices]
    tqueries = [
        convert.query_from_limbs(tctx, [_limbs(ct) for ct in q.ciphertexts], q.indices_count)
        for q in jqueries
    ]
    return dict(
        jctx=jctx, tctx=tctx, jsk=jsk, tsk=tsk, jparam=jparam, tparam=tparam,
        database=database, jprocessed=jprocessed, jek=jek, tek=tek,
        indices=indices, jqueries=jqueries, tqueries=tqueries,
    )


def _assert_responses_equal(port_responses, jax_responses):
    assert len(port_responses) == len(jax_responses)
    for pr, jr in zip(port_responses, jax_responses):
        for p_reply, j_reply in zip(pr.ciphertexts, jr.ciphertexts):
            assert len(p_reply) == len(j_reply)
            for pc, jc in zip(p_reply, j_reply):
                for got, want in zip(convert.ciphertext_to_limbs(pc), _limbs(jc)):
                    np.testing.assert_array_equal(got, want)


def test_parameters_match(setup):
    assert setup["tparam"].dimensions == setup["jparam"].dimensions == (5, 2)
    assert setup["tparam"].evaluation_key_config.galois_elements == setup["jparam"].evaluation_key_config.galois_elements


@pytest.mark.parametrize("encoding", [False, True])
def test_processed_database_matches(setup, encoding):
    jctx, tctx, database = setup["jctx"], setup["tctx"], setup["database"]
    database = database[:-3] + [b""] * 3  # trailing empty entries pad with zeros
    jparam = jip.generate_parameter(jip.IndexPirConfig(**_config(encoding=encoding)), jctx)
    tparam = tip.generate_parameter(_t_config(encoding=encoding), tctx)
    want = jip.MulPirServer.process(database, jctx, jparam)
    got = tip.MulPirServer.process(database, tctx, tparam)
    limbs = convert.processed_database_to_limbs(got)
    assert [p is None for p in limbs] == [p is None for p in want.plaintexts]
    for g, w in zip(limbs, want.plaintexts):
        if w is not None:
            np.testing.assert_array_equal(g, np.asarray(w.poly.data))
    # a uint8 array of entries processes like the list of bytes
    arr = np.frombuffer(b"".join(setup["database"]), dtype=np.uint8).reshape(ENTRIES, 1)
    from_array = tip.MulPirServer.process(arr, tctx, tparam)
    from_list = tip.MulPirServer.process(setup["database"], tctx, tparam)
    assert torch.equal(from_array.data, from_list.data)


@pytest.mark.parametrize("count", [2, 3, 5, 7, 8])
def test_expansion_plan_and_expand_match(setup, count):
    jplan = jserving.build_expansion_plan(count)
    tplan = tserving.build_expansion_plan(count)
    assert (tplan.levels, tplan.leaves, tplan.slot_count) == (jplan.levels, jplan.leaves, jplan.slot_count)
    query = setup["jqueries"][1]
    want = jip.expand(query.ciphertexts, count, setup["jek"])
    stacked = [torch.stack([setup["tqueries"][1].ciphertexts[0].stacked()])]
    got = tserving.expand_batched(stacked, count, setup["tek"], setup["tctx"])
    assert got.shape[0] == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), _values(w))


@pytest.mark.parametrize("compression", ["hybridCompression", "maxCompression"])
def test_expand_with_key_compression(setup, compression):
    """Fewer Galois keys: a level applies the largest key element repeatedly."""
    jctx, tctx = setup["jctx"], setup["tctx"]
    cfg = jip.IndexPirConfig(**_config(jip.PirKeyCompression(compression)))
    jparam = jip.generate_parameter(cfg, jctx)
    jek = jip.MulPirClient(jparam, jctx).generate_evaluation_key(setup["jsk"], jrng((b"h" * 32)[:32]))
    tek = convert.evaluation_key_from_limbs(tctx, *_jax_ek_limbs(jek))
    count = jparam.expanded_query_count
    query = setup["jqueries"][2]
    want = jip.expand(query.ciphertexts, count, jek)
    stacked = [setup["tqueries"][2].ciphertexts[0].stacked()[None]]
    got = tserving.expand_batched(stacked, count, tek, tctx)
    ref = tip.expand(setup["tqueries"][2].ciphertexts, count, tek)
    for g, r, w in zip(got, ref, want):
        np.testing.assert_array_equal(g[0].numpy(), _values(w))
        assert torch.equal(g[0], r.stacked())


def test_batched_server_matches_she_tpu(setup):
    tctx = setup["tctx"]
    tprocessed = convert.processed_database_from_limbs(
        tctx, [None if p is None else np.asarray(p.poly.data) for p in setup["jprocessed"].plaintexts]
    )
    server = tserving.BatchedMulPirServer(setup["tparam"], tctx, [tprocessed])
    got = server.compute_response_batch(setup["tqueries"], setup["tek"])

    jserver = jserving.BatchedMulPirServer(setup["jparam"], setup["jctx"], [setup["jprocessed"]])
    _assert_responses_equal(got, jserver.compute_response_batch(setup["jqueries"], setup["jek"]))
    jref = jip.MulPirServer(setup["jparam"], setup["jctx"], [setup["jprocessed"]])
    tref = tip.MulPirServer(setup["tparam"], tctx, [tprocessed])
    client = tip.MulPirClient(setup["tparam"], tctx)
    for i, (index, jq, tq) in enumerate(zip(setup["indices"], setup["jqueries"], setup["tqueries"])):
        _assert_responses_equal([got[i]], [jref.compute_response(jq, setup["jek"])])
        _assert_responses_equal([tref.compute_response(tq, setup["tek"])], [jref.compute_response(jq, setup["jek"])])
        assert client.decrypt(got[i], [index], setup["tsk"]) == [setup["database"][index]]


def test_port_end_to_end_on_its_own(setup):
    """The port alone: process, keys, queries, batched answers decrypt."""
    tctx = setup["tctx"]
    from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr

    param = setup["tparam"]
    processed = tip.MulPirServer.process(setup["database"], tctx, param)
    client = tip.MulPirClient(param, tctx)
    sk = tbfv.generate_secret_key(tctx, nist_aes128_ctr(bytes(32)))
    ek = client.generate_evaluation_key(sk, nist_aes128_ctr(bytes(range(32))))
    indices = [3, 38]
    queries = [client.generate_query([i], sk) for i in indices]
    responses = tserving.BatchedMulPirServer(param, tctx, [processed]).compute_response_batch(queries, ek)
    for index, r in zip(indices, responses):
        assert client.decrypt(r, [index], sk) == [setup["database"][index]]
