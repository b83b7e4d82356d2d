"""The port's PNNS (she_tpu_torch.pnns.pnns) against she_tpu's, bit for
bit, at insecure_n_8_logq_5x18_logt_5 (32-bit scalars; t = 17 gives 2 x 4
SIMD slots): the three packings and their unpacking, signed values, the
BSGS mul_transpose with 1-3 query rows and with more database rows than N
(R > 1), database processing, plaintext CRT over an extra plaintext
modulus, the client's scores, and validate_database (the port's side of
test_pnns.py).

Encryption and evaluation keys draw fresh seeds, so she_tpu's query
ciphertexts and keys are carried across with she_tpu_torch.convert.
"""

import numpy as np
import pytest
import torch

from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.bfv import keys as jkeys
from she_tpu.pnns import pnns as jpnns
from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng
from she_tpu_torch import convert, errors
from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.pnns import pnns as tpnns
from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr as trng

PARAMS = "insecure_n_8_logq_5x18_logt_5"
CRT_MODULI = (131249, 131297, 131441, 131489, 131617)


def _seed(tag):
    return (tag * 32)[:32]


@pytest.fixture(scope="module")
def ctxs():
    return (jbfv.get_bfv_context(jparams.from_predefined(PARAMS, 32)),
            tbfv.get_bfv_context(tparams.from_predefined(PARAMS, 32), device="cpu"))


def _packings(kind, cols):
    if kind == "diagonal":
        return (jpnns.MatrixPacking.diagonal(jpnns.BabyStepGiantStep.create(cols)),
                tpnns.MatrixPacking.diagonal(tpnns.BabyStepGiantStep.create(cols)))
    if kind == "denseRow":
        return jpnns.MatrixPacking.dense_row(), tpnns.MatrixPacking.dense_row()
    return jpnns.MatrixPacking.dense_column(), tpnns.MatrixPacking.dense_column()


def _pt_limbs(pt):
    return convert.limbs_to_int64(np.asarray(pt.poly.data))


def _assert_matrix_equal(tmatrix, jmatrix):
    assert len(tmatrix.plaintexts) == len(jmatrix.plaintexts)
    for tp, jp in zip(tmatrix.plaintexts, jmatrix.plaintexts):
        assert tp.poly.fmt == jp.poly.fmt
        np.testing.assert_array_equal(tp.poly.data.numpy(), _pt_limbs(jp))


def _ct_limbs(ct):
    return [np.asarray(p.data) for p in ct.polys]


def _assert_cts_equal(tcts, jcts):
    assert len(tcts) == len(jcts)
    for tct, jct in zip(tcts, jcts):
        assert tct.fmt == jct.fmt
        for got, want in zip(convert.ciphertext_to_limbs(tct), _ct_limbs(jct)):
            np.testing.assert_array_equal(got, want)


def _carry_keys(tctx, jek):
    galois = {e: [_ct_limbs(ct) for ct in k.ciphertexts] for e, k in jek.galois_key.keys.items()}
    return convert.evaluation_key_from_limbs(tctx, galois, None)


def _carry_query(tcontexts, jquery, tpacking):
    m0 = jquery.ciphertext_matrices[0]
    return convert.pnns_query_from_limbs(
        tcontexts, (m0.row_count, m0.column_count), tpacking,
        [[_ct_limbs(ct) for ct in m.ciphertexts] for m in jquery.ciphertext_matrices],
    )


@pytest.mark.parametrize(
    "kind,rows,cols",
    [
        ("denseRow", 2, 3),
        ("denseRow", 5, 2),
        ("denseRow", 1, 4),
        ("denseColumn", 2, 3),
        ("denseColumn", 4, 2),
        ("denseColumn", 9, 2),
        ("diagonal", 3, 3),
        ("diagonal", 5, 2),
        ("diagonal", 4, 4),
        ("diagonal", 10, 3),
    ],
)
def test_matrix_pack_unpack_match(ctxs, kind, rows, cols):
    jctx, tctx = ctxs
    jpacking, tpacking = _packings(kind, cols)
    dims = (rows, cols)
    values = [int(v) for v in np.random.default_rng(rows * 10 + cols).integers(0, 17, size=rows * cols)]
    jm = jpnns.PlaintextMatrix.from_values(jctx, jpnns.MatrixDimensions(*dims), jpacking, values)
    tm = tpnns.PlaintextMatrix.from_values(tctx, tpnns.MatrixDimensions(*dims), tpacking, values)
    assert len(tm.plaintexts) == tpnns.plaintext_count(tctx, tm.dimensions, tpacking)
    _assert_matrix_equal(tm, jm)
    assert tm.unpack() == values == jm.unpack()
    tev = tm.to_eval()
    _assert_matrix_equal(tev, jm.to_eval())
    assert tev.unpack() == values


@pytest.mark.parametrize("kind", ["denseRow", "diagonal"])
def test_matrix_signed_roundtrip(ctxs, kind):
    jctx, tctx = ctxs
    jpacking, tpacking = _packings(kind, 2)
    values = [int(v) for v in np.random.default_rng(3).integers(-8, 9, size=6)]
    tm = tpnns.PlaintextMatrix.from_signed_values(tctx, tpnns.MatrixDimensions(3, 2), tpacking, values)
    jm = jpnns.PlaintextMatrix.from_signed_values(jctx, jpnns.MatrixDimensions(3, 2), jpacking, values)
    _assert_matrix_equal(tm, jm)
    assert tm.unpack_signed() == values
    with pytest.raises(errors.PnnsError):
        tpnns.PlaintextMatrix.from_signed_values(tctx, tpnns.MatrixDimensions(3, 2), tpacking, [9] * 6)
    reduced = tpnns.PlaintextMatrix.from_signed_values(tctx, tpnns.MatrixDimensions(3, 2), tpacking, [9] * 6,
                                                       reduce=True)
    assert reduced.unpack() == [9] * 6


def test_matrix_encrypt_decrypt(ctxs):
    _, tctx = ctxs
    sk = tbfv.generate_secret_key(tctx, trng(_seed(b"s")))
    values = [int(v) for v in np.random.default_rng(4).integers(0, 17, size=6)]
    m = tpnns.PlaintextMatrix.from_values(tctx, tpnns.MatrixDimensions(2, 3), tpnns.MatrixPacking.dense_row(), values)
    ct = m.encrypt(sk, err_rng=trng(_seed(b"e")))
    assert ct.decrypt(sk).unpack() == values
    assert ct.noise_budget(sk) > 0


@pytest.mark.parametrize("db_rows,dim,queries", [(2, 2, 1), (4, 2, 1), (2, 4, 2), (3, 2, 2), (3, 2, 3), (10, 2, 1),
                                                 (9, 3, 2)])
def test_bsgs_mul_transpose_match(ctxs, db_rows, dim, queries):
    """mul_transpose_matrix with carried keys and query: the same result
    ciphertexts as she_tpu's, decrypting to db @ q^T mod t (db_rows > 8
    gives two result ciphertexts)."""
    jctx, tctx = ctxs
    t = tctx.plaintext_modulus
    rng = np.random.default_rng(db_rows * 100 + dim * 10 + queries)
    jsk = jbfv.generate_secret_key(jctx, jrng(_seed(b"s")))
    tsk = convert.secret_key_from_limbs(tctx, np.asarray(jsk.poly.data))
    jconfig = jpnns.matmul_evaluation_key_config(jctx, jpnns.MatrixDimensions(db_rows, dim), queries)
    tconfig = tpnns.matmul_evaluation_key_config(tctx, tpnns.MatrixDimensions(db_rows, dim), queries)
    assert (tconfig.galois_elements, tconfig.has_relinearization_key) == (
        jconfig.galois_elements, jconfig.has_relinearization_key)
    jek = jkeys.generate_evaluation_key(jctx, jconfig, jsk, jrng(_seed(b"k")))
    tek = _carry_keys(tctx, jek)
    db_vals = [int(v) for v in rng.integers(0, t, size=db_rows * dim)]
    q_vals = [int(v) for v in rng.integers(0, t, size=queries * dim)]
    jdiag, tdiag = _packings("diagonal", dim)
    jpt = jpnns.PlaintextMatrix.from_values(jctx, jpnns.MatrixDimensions(db_rows, dim), jdiag, db_vals)
    tpt = tpnns.PlaintextMatrix.from_values(tctx, tpnns.MatrixDimensions(db_rows, dim), tdiag, db_vals)
    jq = jpnns.PlaintextMatrix.from_values(jctx, jpnns.MatrixDimensions(queries, dim),
                                           jpnns.MatrixPacking.dense_row(), q_vals)
    jct = jq.encrypt(jsk, err_rng=jrng(_seed(b"e"))).to_coeff()
    tct = _carry_query([tctx], jpnns.Query([jct]), tpnns.MatrixPacking.dense_row()).ciphertext_matrices[0]
    jres = jpnns.mul_transpose_matrix(jpt, jct, jek)
    tres = tpnns.mul_transpose_matrix(tpt, tct, tek)
    assert tres.dimensions == tpnns.MatrixDimensions(db_rows, queries)
    _assert_cts_equal(tres.ciphertexts, jres.ciphertexts)
    expected = (np.array(db_vals).reshape(db_rows, dim) @ np.array(q_vals).reshape(queries, dim).T) % t
    assert tres.decrypt(tsk).unpack() == [int(v) for v in expected.reshape(-1)]


def _configs(pkg, ctx, ep, db_rows, dim, extra=()):
    sf = pkg.max_scaling_factor(dim, [ep.plaintext_modulus, *extra])
    ek_config = pkg.matmul_evaluation_key_config(ctx, pkg.MatrixDimensions(db_rows, dim), 1)
    client = pkg.ClientConfig.create(ep, sf, pkg.MatrixPacking.dense_row(), dim, ek_config,
                                     extra_plaintext_moduli=extra)
    return client, pkg.ServerConfig(client, pkg.MatrixPacking.diagonal(pkg.BabyStepGiantStep.create(dim)))


def _databases(vectors):
    rows = range(len(vectors))
    return (jpnns.Database([jpnns.DatabaseRow(i, b"", vectors[i]) for i in rows]),
            tpnns.Database([tpnns.DatabaseRow(i, b"", vectors[i]) for i in rows]))


def test_scaling_helpers_match():
    v = np.random.default_rng(9).standard_normal((20, 7)).astype(np.float32)
    v[3] = 0  # a zero row stays zero
    for sf in (7.0, 181.0, 3000.0):
        np.testing.assert_array_equal(tpnns.normalized_scaled_and_rounded(v, sf),
                                      jpnns.normalized_scaled_and_rounded(v, sf))
    for dim, moduli in ((2, [17]), (128, [65537]), (4, [17, 97]), (128, [65537, 40961])):
        assert tpnns.max_scaling_factor(dim, moduli) == jpnns.max_scaling_factor(dim, moduli)


@pytest.mark.parametrize("db_rows,dim", [(4, 2), (11, 3)])
def test_process_database_and_response_match(ctxs, db_rows, dim):
    """process_database's Eval plaintexts, the per-query server's response
    (carried keys and query) and the client's distances equal she_tpu's."""
    jctx, tctx = ctxs
    jclient_config, jserver_config = _configs(jpnns, jctx, jctx.params, db_rows, dim)
    tclient_config, tserver_config = _configs(tpnns, tctx, tctx.params, db_rows, dim)
    vectors = np.random.default_rng(db_rows).standard_normal((db_rows, dim)).astype(np.float32)
    jdb, tdb = _databases(vectors)
    jprocessed = jpnns.process_database(jdb, jserver_config)
    tprocessed = tpnns.process_database(tdb, tserver_config, device="cpu")
    for got, want in zip(convert.pnns_processed_database_to_limbs(tprocessed), jprocessed.plaintext_matrices):
        for g, w in zip(got, want.plaintexts):
            np.testing.assert_array_equal(g, np.asarray(w.poly.data))
    jclient = jpnns.Client(jclient_config)
    jsk = jclient.generate_secret_key(jrng(_seed(b"s")))
    jek = jclient.generate_evaluation_key(jsk, jrng(_seed(b"k")))
    tsk = convert.secret_key_from_limbs(tctx, np.asarray(jsk.poly.data))
    tek = _carry_keys(tctx, jek)
    qv = np.random.default_rng(7).standard_normal((1, dim)).astype(np.float32)
    jquery = jclient.generate_query(qv, jsk, err_rng=jrng(_seed(b"q")))
    tquery = _carry_query(tprocessed.contexts, jquery, tpnns.MatrixPacking.dense_row())
    jresponse = jpnns.Server(jprocessed).compute_response(jquery, jek)
    tresponse = tpnns.Server(tprocessed).compute_response(tquery, tek)
    _assert_cts_equal(tresponse.ciphertext_matrices[0].ciphertexts, jresponse.ciphertext_matrices[0].ciphertexts)
    tclient = tpnns.Client(tclient_config, device="cpu")
    got, ids, _ = tclient.decrypt(tresponse, tsk)
    want, _, _ = jclient.decrypt(jresponse, jsk)
    assert got.dtype == want.dtype == np.float32 and got.shape == (db_rows, 1)
    np.testing.assert_array_equal(got, want)
    assert ids == list(range(db_rows))
    sf = tclient_config.scaling_factor
    exact = tpnns.normalized_scaled_and_rounded(vectors, sf) @ tpnns.normalized_scaled_and_rounded(qv, sf).T
    np.testing.assert_array_equal(tclient.scores(tresponse, tsk), exact)
    assert tresponse.noise_budget(tsk) > 0


def test_pnns_end_to_end(ctxs):
    _, tctx = ctxs
    client_config, server_config = _configs(tpnns, tctx, tctx.params, 2, 2)
    sf = client_config.scaling_factor
    vectors = np.array([[1.0, 0.0], [0.6, 0.8]], dtype=np.float32)
    processed = tpnns.process_database(_databases(vectors)[1], server_config, device="cpu")
    client = tpnns.Client(client_config, device="cpu")
    sk = client.generate_secret_key(trng(_seed(b"s")))
    ek = client.generate_evaluation_key(sk, trng(_seed(b"k")))
    query_vec = np.array([[0.8, 0.6]], dtype=np.float32)
    response = tpnns.Server(processed).compute_response(client.generate_query(query_vec, sk, trng(_seed(b"q"))), ek)
    assert response.noise_budget(sk) > 0
    distances, entry_ids, _ = client.decrypt(response, sk)

    def fp_cosine(a, b):
        ar = np.round(a / np.linalg.norm(a) * sf)
        br = np.round(b / np.linalg.norm(b) * sf)
        return float(ar @ br) / (sf * sf)

    for i in range(2):
        assert abs(float(distances[i, 0]) - fp_cosine(vectors[i], query_vec[0])) < 1e-6
    assert entry_ids == [0, 1]


def test_pnns_plaintext_crt_match():
    """Two plaintext moduli (17 and 97) through CRT, both packages: the
    processed matrices and the responses bit for bit, the distances equal."""
    def base(pkg):
        return pkg.EncryptionParameters(poly_degree=8, plaintext_modulus=17, coefficient_moduli=CRT_MODULI,
                                        security_level=pkg.SecurityLevel.UNCHECKED, scalar_bits=32)

    jep, tep = base(jparams), base(tparams)
    jctx, tctx = jbfv.get_bfv_context(jep), tbfv.get_bfv_context(tep, device="cpu")
    jclient_config, jserver_config = _configs(jpnns, jctx, jep, 2, 2, (97,))
    tclient_config, tserver_config = _configs(tpnns, tctx, tep, 2, 2, (97,))
    vectors = np.array([[1.0, 0.0], [0.0, 1.0]], dtype=np.float32)
    jdb, tdb = _databases(vectors)
    jprocessed = jpnns.process_database(jdb, jserver_config)
    tprocessed = tpnns.process_database(tdb, tserver_config, device="cpu")
    assert [c.plaintext_modulus for c in tprocessed.contexts] == [17, 97]
    for got, want in zip(convert.pnns_processed_database_to_limbs(tprocessed), jprocessed.plaintext_matrices):
        for g, w in zip(got, want.plaintexts):
            np.testing.assert_array_equal(g, np.asarray(w.poly.data))
    jclient = jpnns.Client(jclient_config)
    jsk = jclient.generate_secret_key(jrng(_seed(b"s")))
    jek = jclient.generate_evaluation_key(jsk, jrng(_seed(b"k")))
    jquery = jclient.generate_query(np.array([[1.0, 0.0]], dtype=np.float32), jsk, err_rng=jrng(_seed(b"q")))
    tquery = _carry_query(tprocessed.contexts, jquery, tpnns.MatrixPacking.dense_row())
    jresponse = jpnns.Server(jprocessed).compute_response(jquery, jek)
    tresponse = tpnns.Server(tprocessed).compute_response(tquery, _carry_keys(tctx, jek))
    for tm, jm in zip(tresponse.ciphertext_matrices, jresponse.ciphertext_matrices):
        _assert_cts_equal(tm.ciphertexts, jm.ciphertexts)
    tsk = convert.secret_key_from_limbs(tctx, np.asarray(jsk.poly.data))
    got, _, _ = tpnns.Client(tclient_config, device="cpu").decrypt(tresponse, tsk)
    np.testing.assert_array_equal(got, jclient.decrypt(jresponse, jsk)[0])
    assert abs(float(got[0, 0]) - 1.0) < 1e-5 and abs(float(got[1, 0])) < 1e-5


def test_pnns_validate_database(ctxs):
    """validate_database runs fresh-key trials against the fixed-point
    reference (ProcessedDatabase.swift:93-160)."""
    _, tctx = ctxs
    _, server_config = _configs(tpnns, tctx, tctx.params, 3, 2)
    vectors = np.array([[1.0, 0.0], [0.6, 0.8], [-0.7, 0.7]], dtype=np.float32)
    processed = tpnns.process_database(_databases(vectors)[1], server_config, device="cpu")
    result = tpnns.validate_database(processed, trials=2)
    assert result.noise_budget > 0
    assert result.max_abs_error < 1e-6
    assert result.query_time_s > 0 and result.response_time_s > 0


def test_pnns_entry_points_need_a_card_unless_told_otherwise():
    ep = tparams.from_predefined(PARAMS, 32)
    ctx = tbfv.get_bfv_context(ep, device="cpu")
    client_config, server_config = _configs(tpnns, ctx, ep, 2, 2)
    database = _databases(np.eye(2, dtype=np.float32))[1]
    if torch.cuda.is_available():
        assert tpnns.Client(client_config).contexts[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tpnns.Client(client_config)
        with pytest.raises(RuntimeError):
            tpnns.process_database(database, server_config)
    assert tpnns.process_database(database, server_config, device="cpu").contexts[0].device == torch.device("cpu")
