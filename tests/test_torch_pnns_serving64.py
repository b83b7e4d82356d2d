"""The port's batched PNNS server at 64-bit scalars, the wide route:
insecure_n_512_logq_4x60_logt_20 (60-bit moduli; every modular product of
the port goes through ops/wide.py, she_tpu's through two-limb words), a
diagonal BSGS over 4 dimensions (2 baby steps, 2 giant steps), 2 queries.
Bit-identical to she_tpu's eager w64 BatchedPnnsServer (its default off
the TPU) and to the port's per-query pnns.Server, the stream equal to the
batch, every score exact. In a file of its own: she_tpu's eager w64
server takes most of a minute here."""

from she_tpu import params as jparams
from she_tpu.pnns import serving as jserving
from she_tpu_torch import params as tparams
from she_tpu_torch.pnns import pnns as tpnns
from she_tpu_torch.pnns import serving as tserving
from test_torch_pnns_serving import assert_port_responses_equal, assert_responses_equal, assert_scores_exact, build

PARAMS = "insecure_n_512_logq_4x60_logt_20"


def test_batched_w64_matches_she_tpu_and_per_query_server(monkeypatch):
    monkeypatch.delenv("SHE_TPU_STAGED_SERVING", raising=False)
    monkeypatch.delenv("SHE_TPU_W64_FUSED_SERVING", raising=False)
    env = build((jparams.from_predefined(PARAMS, 64), tparams.from_predefined(PARAMS, 64)),
                db_rows=8, dim=4, n_queries=2, seed=7)
    assert max(env["tdb"].contexts[0].ciphertext_context.moduli) > 1 << 31  # the wide route
    server = tserving.BatchedPnnsServer(env["tdb"])
    assert server.packed[0].shape[:3] == (2, 2, 1)  # G, J, R
    got = server.compute_response_batch(env["tqueries"], env["tek"])
    want = jserving.BatchedPnnsServer(env["jdb"]).compute_response_batch(env["jqueries"], env["jek"])
    assert_responses_equal(got, want)
    reference = tpnns.Server(env["tdb"])
    assert_port_responses_equal(got, [reference.compute_response(q, env["tek"]) for q in env["tqueries"]])
    assert_port_responses_equal(server.compute_response_stream([env["tqueries"][:1], env["tqueries"]], env["tek"]),
                                got[:1] + got)
    assert_scores_exact(env, got)
    assert min(r.noise_budget(env["tsk"]) for r in got) > 0
