"""The port's multi-device serving (she_tpu_torch.parallel.mesh) against
she_tpu, bit for bit, with gloo ranks on the CPU.

The counterpart of tests/test_parallel.py (she_tpu's 8-device virtual mesh)
and of tests/test_multihost.py (two jax processes): in the port a mesh rank
is a process, so one world of 4 spawned ranks and one of 2 cover both. The
ranks meet through a FileStore (parallel.mesh.run_ranks) and run
tests/torch_mesh_ranks.py; each world is spawned once, in a module
fixture, and returns every case's output from every rank, which the
parametrized tests below compare with she_tpu's single-device functions on
the same numpy-seeded inputs (she_tpu's keys and queries carried across
with she_tpu_torch.convert). Tolerance 0: exact equality.

insecure_n_8_logq_5x18_logt_5 at 32 and 64 bits, 16 one-byte entries with
uneven_dimensions=False (dims 2 x 2), 8 queries at 32 bits and 4 at 64;
dim-0 also on random residues with d0 = 8 so that 4 ranks divide it; PNNS
over 3 rows of dimension 2. The 64-bit serving cases are held to she_tpu's
per-query server, as in test_torch_serving64_she_tpu.py (its batched
64-bit program compiles too slowly on XLA:CPU); the ranks run while it
answers.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import torch_mesh_ranks
from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.pir import index_pir as jip
from she_tpu.pir import serving as jserving
from she_tpu.pnns import pnns as jpnns
from she_tpu.pnns import serving as jpnns_serving
from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng
from she_tpu_torch import convert, errors
from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.core.context import get_poly_context
from she_tpu_torch.ops import ntt
from she_tpu_torch.parallel import mesh as meshmod
from she_tpu_torch.parallel import sharded
from she_tpu_torch.pir import index_pir as tip
from she_tpu_torch.pir import serving as tserving

PARAMS = "insecure_n_8_logq_5x18_logt_5"
B = 8
# queries a batch by scalar width: she_tpu answers the 64-bit ones one at a
# time, some 6 s each on XLA:CPU
BATCH = {32: B, 64: 4}
WORLDS = (2, 4)


def _seed(tag):
    return (tag * 32)[:32]


def _limbs(ct):
    return [np.asarray(p.data) for p in ct.polys]


def _values(ct):
    """she_tpu ciphertext -> int64 [polys, L, N]."""
    return np.stack([convert.limbs_to_int64(a) for a in _limbs(ct)])


def _config(port: bool) -> dict:
    compression = tip.PirKeyCompression("noCompression") if port else jip.PirKeyCompression.NO_COMPRESSION
    return dict(entry_count=16, entry_size_in_bytes=1, dimension_count=2, batch_size=1, uneven_dimensions=False,
                key_compression=compression)


def _words(values: np.ndarray, nlimbs: int, axis: int) -> np.ndarray:
    """int64 [..., L, N] -> she_tpu's uint32 words with W at `axis`."""
    return np.moveaxis(convert.int64_to_limbs(values, nlimbs), 0, axis)


def _pir(bits: int) -> dict:
    """she_tpu's side of one scalar width: the PIR spec the ranks rebuild
    the port's server from, and what she_tpu's functions give."""
    jctx = jbfv.get_bfv_context(jparams.from_predefined(PARAMS, bits))
    jsk = jbfv.generate_secret_key(jctx, jrng(_seed(b"s")))
    jparam = jip.generate_parameter(jip.IndexPirConfig(**_config(False)), jctx)
    database = [bytes([int(v)]) for v in np.random.default_rng(3).integers(0, 256, size=16)]
    jprocessed = jip.MulPirServer.process(database, jctx, jparam)
    jclient = jip.MulPirClient(jparam, jctx)
    jek = jclient.generate_evaluation_key(jsk, jrng(_seed(b"k")))
    indices = [i % 16 for i in range(3, 3 + BATCH[bits])]
    jqueries = [jclient.generate_query([i], jsk) for i in indices]
    galois = {e: [_limbs(ct) for ct in k.ciphertexts] for e, k in jek.galois_key.keys.items()}
    relin = [_limbs(ct) for ct in jek.relinearization_key.key_switch_key.ciphertexts]
    spec = dict(params=PARAMS, bits=bits, config=_config(True), database=database, ek=(galois, relin),
                queries=[[_limbs(ct) for ct in q.ciphertexts] for q in jqueries])
    # dim-0 on the database's first chunk and the first query's expansion
    ct_ctx = jctx.ciphertext_context
    d0 = jparam.dimensions[0]
    chunk = np.asarray(jserving.pack_database_chunk(
        jprocessed.plaintexts[: jprocessed.count // jip.chunk_count(jparam, jctx)], d0, ct_ctx))
    expanded = jip.expand(jqueries[0].ciphertexts, jparam.expanded_query_count, jek)
    query_eval = np.stack([[np.asarray(p.data) for p in jbfv.ct_to_eval(c).polys] for c in expanded[:d0]])
    W = ct_ctx.nlimbs
    to_values = lambda words: convert.limbs_to_int64(np.moveaxis(words, 2, 0))  # noqa: E731
    chunk_case = dict(degree=jctx.degree, moduli=tuple(ct_ctx.moduli), bits=bits, db=to_values(chunk),
                      query=to_values(query_eval), S=2, int8=False)
    chunk_case["want"] = to_values(np.asarray(jserving.dim0_inner_products(chunk, query_eval, ct_ctx)))
    # the same chunk's moduli, random residues, d0 = 8
    rng = np.random.default_rng(bits)
    moduli = ct_ctx.moduli

    def residues(shape):
        return np.stack([rng.integers(0, q, size=shape + (jctx.degree,)) for q in moduli], axis=-2)

    db, query = residues((2, 8)), residues((8, 2))
    want = to_values(np.asarray(jserving.dim0_inner_products(_words(db, W, 2), _words(query, W, 2), ct_ctx)))
    random_case = dict(degree=jctx.degree, moduli=tuple(moduli), bits=bits, db=db, query=query, want=want)
    return dict(jctx=jctx, jsk=jsk, jparam=jparam, jprocessed=jprocessed, jek=jek, jqueries=jqueries,
                indices=indices, database=database, spec=spec, chunk_case=chunk_case, random_case=random_case)


def _pnns() -> dict:
    ep = jparams.from_predefined(PARAMS, 32)
    jctx = jbfv.get_bfv_context(ep)
    dim, rows = 2, 3
    sf = jpnns.max_scaling_factor(dim, [ep.plaintext_modulus])
    ek_config = jpnns.matmul_evaluation_key_config(jctx, jpnns.MatrixDimensions(rows, dim), 1)
    client_config = jpnns.ClientConfig.create(ep, sf, jpnns.MatrixPacking.dense_row(), dim, ek_config)
    server_config = jpnns.ServerConfig(client_config, jpnns.MatrixPacking.diagonal(jpnns.BabyStepGiantStep.create(dim)))
    rng = np.random.default_rng(3)
    vectors = rng.standard_normal((rows, dim)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    jdb = jpnns.process_database(jpnns.Database([jpnns.DatabaseRow(i, b"", v) for i, v in enumerate(vectors)]),
                                 server_config)
    client = jpnns.Client(client_config)
    jsk = client.generate_secret_key(jrng(_seed(b"s")))
    jek = client.generate_evaluation_key(jsk, jrng(_seed(b"k")))
    jqueries = [client.generate_query(rng.standard_normal((1, dim)).astype(np.float32), jsk,
                                      err_rng=jrng(_seed(bytes([i])))) for i in range(B)]
    want = jpnns_serving.BatchedPnnsServer(jdb).compute_response_batch(jqueries, jek)
    spec = dict(params=PARAMS, bits=32, dim=dim, vectors=vectors,
                ek={e: [_limbs(ct) for ct in k.ciphertexts] for e, k in jek.galois_key.keys.items()},
                queries=[[[_limbs(ct) for ct in m.ciphertexts] for m in q.ciphertext_matrices] for q in jqueries])
    want = np.stack([np.stack([_values(ct) for ct in r.ciphertext_matrices[0].ciphertexts]) for r in want])
    return dict(spec=spec, want=want)


def _spawn_worlds(spec: dict) -> dict:
    """Per world size, every rank's outputs: each world spawned once."""
    return {S: meshmod.run_ranks(torch_mesh_ranks.parallel_ranks, (S,), ("batch",), "gloo", "cpu", spec)
            for S in WORLDS}


@pytest.fixture(scope="module")
def she_tpu_side():
    pir = {f"w{bits}": _pir(bits) for bits in (32, 64)}
    w32 = pir["w32"]
    batch = jserving.BatchedMulPirServer(w32["jparam"], w32["jctx"], [w32["jprocessed"]])
    want = {"w32": np.stack([_values(r.ciphertexts[0][0]) for r in batch.compute_response_batch(
        w32["jqueries"], w32["jek"])])}
    dim0 = {}
    for name, p in pir.items():
        dim0[f"{name}-chunk-S2"] = p["chunk_case"]
        for S in (2, 4):
            dim0[f"{name}-random-S{S}"] = dict(p["random_case"], S=S, int8=False)
    dim0["w32-random-S4-int8"] = dict(pir["w32"]["random_case"], S=4, int8=True)
    pnns = _pnns()
    spec = dict(pir={k: p["spec"] for k, p in pir.items()}, dim0=dim0, pnns=pnns["spec"])
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        worlds = pool.submit(_spawn_worlds, spec)
        w64 = pir["w64"]
        server = jip.MulPirServer(w64["jparam"], w64["jctx"], [w64["jprocessed"]])
        want["w64"] = np.stack([_values(server.compute_response(q, w64["jek"]).ciphertexts[0][0])
                                for q in w64["jqueries"]])
        worlds = worlds.result()
    return dict(pir=pir, want=want, dim0=dim0, pnns_want=pnns["want"], spec=spec, worlds=worlds)


@pytest.fixture(scope="module")
def ranks(she_tpu_side):
    return she_tpu_side["worlds"]


def _decrypts(she_tpu_side, name: str, values: np.ndarray) -> None:
    p = she_tpu_side["pir"][name]
    tctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, p["spec"]["bits"]), device="cpu")
    tsk = convert.secret_key_from_limbs(tctx, np.asarray(p["jsk"].poly.data))
    client = tip.MulPirClient(tip.generate_parameter(tip.IndexPirConfig(**_config(True)), tctx), tctx)
    single = tctx.ciphertext_context.get_context(1)
    for v, index in zip(values, p["indices"]):
        response = tip.Response([[tbfv.Ciphertext.from_stacked(tctx, torch.from_numpy(v), single)]])
        assert client.decrypt(response, [index], tsk) == [p["database"][index]]


@pytest.mark.parametrize("S", WORLDS)
@pytest.mark.parametrize("name", ["w32", "w64"])
def test_batch_parallel_response(ranks, she_tpu_side, name, S):
    """Each of S ranks serves B/S queries; every rank returns all B
    responses, equal to the single-device batched server's."""
    for out in ranks[S]:
        np.testing.assert_array_equal(out[f"batch_parallel/{name}"], she_tpu_side["want"][name])
    _decrypts(she_tpu_side, name, ranks[S][0][f"batch_parallel/{name}"])


DIM0_CASES = ["w32-chunk-S2", "w64-chunk-S2", "w32-random-S2", "w32-random-S4", "w64-random-S2",
              "w64-random-S4", "w32-random-S4-int8"]


@pytest.mark.parametrize("case", DIM0_CASES)
def test_dim0_partial_psum(ranks, she_tpu_side, case):
    """d0 split over S ranks: at 32 bits the one-shot sum (the int8 digit
    form too), at 64 bits the butterfly of exact modular adds; the chunk
    cases are the two-process reduction of tests/test_multihost.py."""
    c = she_tpu_side["dim0"][case]
    for out in ranks[c["S"]]:
        np.testing.assert_array_equal(out[f"dim0/{case}"], c["want"])


@pytest.mark.parametrize("case", ["w32", "w32-int8", "w64"])
def test_two_axis_response(ranks, she_tpu_side, case):
    """A (batch 2, db 2) mesh of 4 ranks: the raw responses of the single
    server, and every answer decrypts."""
    name = case.split("-")[0]
    for out in ranks[4]:
        np.testing.assert_array_equal(out[f"two_axis/{case}"], she_tpu_side["want"][name])
    _decrypts(she_tpu_side, name, ranks[4][0][f"two_axis/{case}"])


def test_batch_parallel_pnns_response(ranks, she_tpu_side):
    for out in ranks[4]:
        np.testing.assert_array_equal(out["pnns"], she_tpu_side["pnns_want"])


@pytest.mark.parametrize("S", WORLDS)
def test_every_rank_returns_every_case(ranks, S):
    keys = set(ranks[S][0])
    assert all(set(out) == keys for out in ranks[S])
    assert len(ranks[S]) == S and keys >= {"batch_parallel/w32", "batch_parallel/w64"}


class _Mesh:
    """A stand-in for parallel.mesh.Mesh with the sizes and index the
    validations read; it has no process group, so nothing can be sent."""

    def __init__(self, **sizes):
        self.shape, self.axis_names = sizes, tuple(sizes)

    def size(self, axis):
        return self.shape[axis]

    def index(self, axis):
        return 0


@pytest.mark.parametrize("shape", [(3,), (2, 6), (0,)])
def test_mesh_axes_must_be_powers_of_two(shape):
    names = ("batch", "db")[: len(shape)]
    with pytest.raises(errors.InvalidArgument, match="power of two"):
        meshmod.run_ranks(torch_mesh_ranks.parallel_ranks, shape, names, "gloo", "cpu", {})
    with pytest.raises(errors.InvalidArgument, match="power of two"):
        meshmod.make_mesh(shape, names, "gloo", "cpu")


def test_run_ranks_refuses_what_it_cannot_run():
    with pytest.raises(errors.InvalidArgument):
        meshmod.run_ranks(torch_mesh_ranks.parallel_ranks, (2,), ("batch",), "mpi", "cpu", {})
    with pytest.raises(errors.InvalidArgument):
        meshmod.run_ranks(torch_mesh_ranks.parallel_ranks, (2,), ("batch",), "nccl", "cpu", {})


def test_d0_must_divide_over_the_axis():
    ct_ctx = get_poly_context(8, (131249, 131297), 32, torch.device("cpu"))
    db, query = torch.zeros((2, 6, 2, 8), dtype=torch.int64), torch.zeros((6, 2, 2, 8), dtype=torch.int64)
    with pytest.raises(errors.InvalidArgument, match="d0=6"):
        meshmod.dim0_partial_psum(db, query, ct_ctx, _Mesh(db=4))


def test_batch_must_divide_over_the_axis(she_tpu_side):
    _, server, ek, queries = torch_mesh_ranks.pir_server(she_tpu_side["pir"]["w32"]["spec"])
    with pytest.raises(errors.InvalidArgument, match="query batch=3"):
        meshmod.batch_parallel_response(server, queries[:3], ek, _Mesh(batch=2))
    with pytest.raises(errors.InvalidArgument, match="query batch=6"):
        meshmod.two_axis_response(server, queries[:6], ek, _Mesh(batch=4, db=1))


def test_limbs_must_divide_over_the_axis():
    tables = ntt.build_ntt_tables(((1 << 27) - 40959, (1 << 28) - 65535, (1 << 28) - 73727), 64,
                                  torch.device("cpu"))
    with pytest.raises(errors.InvalidArgument, match="L=3"):
        sharded.limb_parallel_ntt_fns(_Mesh(limb=2), tables, "limb")


def test_compute_response_batch_from_stacked(she_tpu_side):
    """The batched servers' entry point for stacked queries (she_tpu
    serving.py:946, pnns/serving.py:339): the answers of
    compute_response_batch, and a refusal of stacks that do not hold B
    queries."""
    _, server, ek, queries = torch_mesh_ranks.pir_server(she_tpu_side["pir"]["w32"]["spec"])
    stacked, n_ct, indices_count = server.stack_queries_device(queries)
    got = server.compute_response_batch_from_stacked(stacked, ek, B, n_ct, indices_count)
    np.testing.assert_array_equal(torch_mesh_ranks.response_values(got), she_tpu_side["want"]["w32"])
    with pytest.raises(errors.InvalidArgument):
        server.compute_response_batch_from_stacked(stacked, ek, B - 1, n_ct, indices_count)
    pnns_server, pek, pqueries = torch_mesh_ranks.pnns_server(she_tpu_side["spec"]["pnns"])
    pstacked = pnns_server.stack_queries_device(pqueries)
    got = pnns_server.compute_response_batch_from_stacked(pstacked, pek, B)
    np.testing.assert_array_equal(torch_mesh_ranks.pnns_values(got), she_tpu_side["pnns_want"])
    with pytest.raises(errors.InvalidArgument):
        pnns_server.compute_response_batch_from_stacked(pstacked + pstacked, pek, B)


def test_slice_digits_are_packed_once(she_tpu_side):
    """BatchedMulPirServer keeps the int8 digits of a d0 slice: packed on
    first use as the slice's own chunk would be, the same tensor after;
    all of d0 is the chunk's digits."""
    _, server, _, _ = torch_mesh_ranks.pir_server(she_tpu_side["pir"]["w32"]["spec"], use_dim0_int8=True)
    d0 = server.parameter.dimensions[0]
    rows = slice(d0 // 2, d0)
    digits = server.slice_digits(0, 0, rows)
    want = tserving.pack_database_chunk_digits(server.chunks[0][0][:, rows].contiguous(), server.ct_ctx)
    assert torch.equal(digits, want) and server.slice_digits(0, 0, rows) is digits
    assert server.slice_digits(0, 0, slice(0, d0)) is server.chunk_digits[0][0]


def test_a_rank_without_a_card_raises():
    """Ranks asked for the card find none here and raise; run_ranks stops
    the others and raises too: nothing falls back to the host."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(Exception, match="finds no CUDA device"):
        meshmod.run_ranks(torch_mesh_ranks.parallel_ranks, (2,), ("batch",), "gloo", "cuda", {})
