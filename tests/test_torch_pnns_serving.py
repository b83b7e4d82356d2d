"""The port's batched PNNS server (she_tpu_torch.pnns.serving) at 32-bit
scalars: bit-identical to she_tpu's BatchedPnnsServer and to the port's
per-query pnns.Server on the same (carried) keys and queries, the stream
equal to the batch, the stages marked in order, the packed diagonal
matrix and the BSGS MAC equal to she_tpu's, plaintext CRT over two
moduli, more database rows than N (R = 2), and every score equal to the
integer dot product of the rounded vectors.

insecure_n_8_logq_5x18_logt_5 (t = 17 gives SIMD at N = 8). The 64-bit
scalar path (the wide route) is test_torch_pnns_serving64.py.
"""

import numpy as np
import pytest
import torch

from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.pnns import pnns as jpnns
from she_tpu.pnns import serving as jserving
from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng
from she_tpu_torch import convert
from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.pnns import pnns as tpnns
from she_tpu_torch.pnns import serving as tserving

PARAMS = "insecure_n_8_logq_5x18_logt_5"
CRT_MODULI = (131249, 131297, 131441, 131489, 131617)
STAGES = ["stack", "baby_steps", "to_eval", "bsgs_mac", "inverse_ntt", "rotate_and_sum", "mod_switch"]


def _seed(tag):
    return (tag * 32)[:32]


def _ct_limbs(ct):
    return [np.asarray(p.data) for p in ct.polys]


def assert_responses_equal(port_responses, jax_responses):
    assert len(port_responses) == len(jax_responses)
    for got, want in zip(port_responses, jax_responses):
        got_limbs = convert.pnns_response_to_limbs(got)
        want_limbs = [[_ct_limbs(ct) for ct in m.ciphertexts] for m in want.ciphertext_matrices]
        assert len(got_limbs) == len(want_limbs)
        for gm, wm, tm in zip(got_limbs, want_limbs, got.ciphertext_matrices):
            assert tm.packing.kind == "denseColumn" and tm.dimensions.column_count == 1
            assert len(gm) == len(wm)
            for gc, wc in zip(gm, wm):
                for gp, wp in zip(gc, wc):
                    np.testing.assert_array_equal(gp, wp)


def assert_port_responses_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for gm, wm in zip(g.ciphertext_matrices, w.ciphertext_matrices, strict=True):
            assert gm.dimensions == wm.dimensions
            for gc, wc in zip(gm.ciphertexts, wm.ciphertexts, strict=True):
                assert gc.poly_context() is wc.poly_context()
                assert torch.equal(gc.stacked(), wc.stacked())


def build(ep_pair, db_rows, dim, n_queries, seed, extra=()):
    """Both packages' processed databases, client, keys and queries on the
    same inputs; the port's keys and queries are she_tpu's, carried."""
    jep, tep = ep_pair
    jctx, tctx = jbfv.get_bfv_context(jep), tbfv.get_bfv_context(tep, device="cpu")
    out = {}
    for name, pkg, ctx, ep in (("j", jpnns, jctx, jep), ("t", tpnns, tctx, tep)):
        sf = pkg.max_scaling_factor(dim, [ep.plaintext_modulus, *extra])
        ek_config = pkg.matmul_evaluation_key_config(ctx, pkg.MatrixDimensions(db_rows, dim), 1)
        client_config = pkg.ClientConfig.create(ep, sf, pkg.MatrixPacking.dense_row(), dim, ek_config,
                                                extra_plaintext_moduli=extra)
        out[name + "client_config"] = client_config
        out[name + "server_config"] = pkg.ServerConfig(
            client_config, pkg.MatrixPacking.diagonal(pkg.BabyStepGiantStep.create(dim)))
    rng = np.random.default_rng(seed)
    vectors = rng.standard_normal((db_rows, dim)).astype(np.float32)
    out["vectors"] = vectors
    out["jdb"] = jpnns.process_database(
        jpnns.Database([jpnns.DatabaseRow(i, b"", vectors[i]) for i in range(db_rows)]), out["jserver_config"])
    out["tdb"] = tpnns.process_database(
        tpnns.Database([tpnns.DatabaseRow(i, b"", vectors[i]) for i in range(db_rows)]), out["tserver_config"],
        device="cpu")
    jclient = jpnns.Client(out["jclient_config"])
    out["jclient"] = jclient
    out["jsk"] = jclient.generate_secret_key(jrng(_seed(b"s")))
    out["jek"] = jclient.generate_evaluation_key(out["jsk"], jrng(_seed(b"k")))
    galois = {e: [_ct_limbs(ct) for ct in k.ciphertexts] for e, k in out["jek"].galois_key.keys.items()}
    out["tek"] = convert.evaluation_key_from_limbs(tctx, galois, None)
    out["tsk"] = convert.secret_key_from_limbs(tctx, np.asarray(out["jsk"].poly.data))
    out["qvecs"] = rng.standard_normal((n_queries, 1, dim)).astype(np.float32)
    out["jqueries"] = [jclient.generate_query(v, out["jsk"], err_rng=jrng(_seed(bytes([i]))))
                       for i, v in enumerate(out["qvecs"])]
    out["tqueries"] = [
        convert.pnns_query_from_limbs(out["tdb"].contexts, (1, dim), tpnns.MatrixPacking.dense_row(),
                                      [[_ct_limbs(ct) for ct in m.ciphertexts] for m in q.ciphertext_matrices])
        for q in out["jqueries"]
    ]
    out["tclient"] = tpnns.Client(out["tclient_config"], device="cpu")
    return out


def _eps(pkg, t=None):
    if t is None:
        return pkg.from_predefined(PARAMS, 32)
    return pkg.EncryptionParameters(poly_degree=8, plaintext_modulus=t, coefficient_moduli=CRT_MODULI,
                                    security_level=pkg.SecurityLevel.UNCHECKED, scalar_bits=32)


@pytest.fixture(scope="module")
def env():
    return build((_eps(jparams), _eps(tparams)), db_rows=4, dim=2, n_queries=3, seed=5)


def assert_scores_exact(env, responses):
    """Every score, decoded signed and CRT-composed before the scaling,
    equals the integer dot product of the rounded vectors."""
    sf = env["tclient_config"].scaling_factor
    db = tpnns.normalized_scaled_and_rounded(env["vectors"], sf)
    for qv, response in zip(env["qvecs"], responses):
        want = db @ tpnns.normalized_scaled_and_rounded(qv, sf).T
        np.testing.assert_array_equal(env["tclient"].scores(response, env["tsk"]), want)


def test_batched_matches_she_tpu_batched_server(env):
    want = jserving.BatchedPnnsServer(env["jdb"]).compute_response_batch(env["jqueries"], env["jek"])
    got = tserving.BatchedPnnsServer(env["tdb"]).compute_response_batch(env["tqueries"], env["tek"])
    assert_responses_equal(got, want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(env["tclient"].decrypt(g, env["tsk"])[0],
                                      env["jclient"].decrypt(w, env["jsk"])[0])
    assert_scores_exact(env, got)


def test_batched_matches_per_query_server(env):
    server = tserving.BatchedPnnsServer(env["tdb"])
    got = server.compute_response_batch(env["tqueries"], env["tek"])
    reference = tpnns.Server(env["tdb"])
    assert_port_responses_equal(got, [reference.compute_response(q, env["tek"]) for q in env["tqueries"]])
    assert got[0].entry_ids == env["tdb"].entry_ids
    assert min(r.noise_budget(env["tsk"]) for r in got) > 0


def test_stream_equals_batch(env):
    server = tserving.BatchedPnnsServer(env["tdb"])
    q = env["tqueries"]
    batch = server.compute_response_batch(q, env["tek"])
    stream = server.compute_response_stream([q[:2], q[2:], q], env["tek"])
    assert_port_responses_equal(stream, batch + batch)


def test_stages_marked_in_order(env):
    server = tserving.BatchedPnnsServer(env["tdb"])
    marks = []
    got = server.compute_response_batch(env["tqueries"], env["tek"], on_stage=marks.append)
    assert marks == STAGES
    assert_port_responses_equal(got, server.compute_response_batch(env["tqueries"], env["tek"]))


def test_pack_diagonal_matrix_matches(env):
    matrix = env["jdb"].plaintext_matrices[0]
    ctx = env["jdb"].contexts[0].ciphertext_context
    want = convert.limbs_to_int64(np.moveaxis(jserving.pack_diagonal_matrix(matrix, ctx), 3, 0))
    got = tserving.pack_diagonal_matrix(env["tdb"].plaintext_matrices[0], env["tdb"].contexts[0].ciphertext_context)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("J,G,R", [(2, 1, 1), (4, 3, 2)])
def test_bsgs_inner_products_match(env, J, G, R):
    """The MAC alone on random residues, one query, against she_tpu's
    bsgs_inner_products."""
    tctx = env["tdb"].contexts[0].ciphertext_context
    jctx = env["jdb"].contexts[0].ciphertext_context
    rng = np.random.default_rng(J * 10 + G)
    q = np.array(tctx.moduli)[:, None]
    db = rng.integers(0, q, size=(G, J, R, len(tctx.moduli), 8))
    rot = rng.integers(0, q, size=(J, 1, 2, len(tctx.moduli), 8))
    got = tserving.bsgs_inner_products(torch.from_numpy(db), torch.from_numpy(rot), tctx)  # [G, R, 1, 2, L, N]
    want = jserving.bsgs_inner_products(convert.int64_to_limbs(db, 1).transpose(1, 2, 3, 0, 4, 5),
                                        convert.int64_to_limbs(rot[:, 0], 1).transpose(1, 2, 0, 3, 4), jctx)
    np.testing.assert_array_equal(got[:, :, 0].numpy(), convert.limbs_to_int64(np.moveaxis(np.asarray(want), 3, 0)))


def test_more_database_rows_than_n():
    """11 rows at N = 8: two result ciphertexts a query."""
    env = build((_eps(jparams), _eps(tparams)), db_rows=11, dim=3, n_queries=2, seed=11)
    server = tserving.BatchedPnnsServer(env["tdb"])
    assert server.packed[0].shape[2] == 2
    got = server.compute_response_batch(env["tqueries"], env["tek"])
    assert len(got[0].ciphertext_matrices[0].ciphertexts) == 2
    want = [jpnns.Server(env["jdb"]).compute_response(q, env["jek"]) for q in env["jqueries"]]
    assert_responses_equal(got, want)
    assert_scores_exact(env, got)


def test_plaintext_crt_batched():
    """t = 17 and 97 through CRT: one packed matrix and one response matrix
    per plaintext modulus, equal to she_tpu's per-query server."""
    env = build((_eps(jparams, 17), _eps(tparams, 17)), db_rows=3, dim=2, n_queries=2, seed=3, extra=(97,))
    server = tserving.BatchedPnnsServer(env["tdb"])
    assert len(server.packed) == 2
    marks = []
    got = server.compute_response_batch(env["tqueries"], env["tek"], on_stage=marks.append)
    assert marks == STAGES[:1] + STAGES[1:] * 2
    want = [jpnns.Server(env["jdb"]).compute_response(q, env["jek"]) for q in env["jqueries"]]
    assert_responses_equal(got, want)
    assert_scores_exact(env, got)
