"""The int8 digit form of dim-0 against she_tpu, and its kernel on the card.

The plain digit form (serving.dim0_inner_products_int8) must equal
she_tpu's dim0_inner_products_mxu at w32 (d0 = 5 and 97, 28-bit moduli,
D = 4 digits) and she_tpu's 128-bit MAC at w64 (55-bit moduli, D = 8), bit
for bit, and the port's int64 / wide MAC up to 9 digits. The batched
server with use_dim0_int8=True must answer exactly as she_tpu's servers at
insecure_n_8_logq_5x18_logt_5, 32 and 64 bits. Tests marked `gpu` hold the
CUDA kernel (csrc/dim0_int8.cu) equal to the plain form on the card; they
import nothing of jax or she_tpu, so on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_dim0_int8.py

(the she_tpu cases import it inside their fixtures and skip without it).
"""

import random

import numpy as np
import pytest
import torch

from she_tpu_torch import convert
from she_tpu_torch import params as tparams
from she_tpu_torch import trace
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.core.context import get_poly_context
from she_tpu_torch.ops import digits as dg
from she_tpu_torch.ops import dim0_cuda
from she_tpu_torch.pir import index_pir as tip
from she_tpu_torch.pir import keyword_pir as tkp
from she_tpu_torch.pir import serving as tserving
from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr as trng

PARAMS = "insecure_n_8_logq_5x18_logt_5"
W32 = (134176769, 268369921)  # n_4096_logq_27_28_28's ciphertext moduli: 4 digits
W64 = (36028797018652673, 36028797017571329, 36028797017456641)  # 3 x 55 bits: 8 digits
W62 = ((1 << 62) - 57, (1 << 61) - 1)  # 9 digits


def _she_tpu():
    """she_tpu's modules, imported only by the tests that compare with it."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from she_tpu import params as jparams
    from she_tpu.bfv import bfv as jbfv
    from she_tpu.core.context import get_poly_context as jpoly_context
    from she_tpu.pir import index_pir as jip
    from she_tpu.pir import serving as jserving
    from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng

    return dict(jnp=jnp, params=jparams, bfv=jbfv, poly_context=jpoly_context, ip=jip, serving=jserving,
                rng=jrng)


def _residues(moduli, shape, seed, fill="random"):
    """int64 [*shape[:-1], L, N] residues; shape = (..., N)."""
    rng = np.random.default_rng(seed)
    rows = [np.full(shape, q - 1) if fill == "max" else rng.integers(0, q, size=shape) for q in moduli]
    return np.stack(rows, axis=-2).astype(np.int64)


def _operands(moduli, C, d0, P, N, seed=0, fill="random"):
    return _residues(moduli, (C, d0, N), seed, fill), _residues(moduli, (d0, P, N), seed + 1, fill)


def _limbs_last(values, nlimbs):
    """int64 [..., L, N] -> she_tpu's uint32 limbs with W before (L, N)."""
    return np.moveaxis(convert.int64_to_limbs(values, nlimbs), 0, -3)


def _plain(moduli, db, query, bits=64):
    ctx = get_poly_context(db.shape[-1], tuple(moduli), bits, torch.device("cpu"))
    digits = tserving.pack_database_chunk_digits(torch.from_numpy(db), ctx)
    got = tserving.dim0_inner_products_int8(digits, torch.from_numpy(query), ctx)
    mac = tserving.dim0_inner_products(torch.from_numpy(db), torch.from_numpy(query), ctx)
    return ctx, digits, got, mac


@pytest.mark.parametrize("d0", [5, 97])
@pytest.mark.parametrize("fill", ["random", "max"])
def test_plain_digit_form_matches_she_tpu_mxu(d0, fill):
    j = _she_tpu()
    db, query = _operands(W32, 3, d0, 6, 8, seed=d0, fill=fill)
    _, digits, got, mac = _plain(W32, db, query, bits=32)
    assert digits.shape == (2, 8, 4 * 3, dim0_cuda.padded_depth(d0))
    jctx = j["poly_context"](8, W32, 32)
    jdigits = j["serving"].pack_database_chunk_digits(_limbs_last(db, 1), jctx)  # [D, L, N, C, d0]
    np.testing.assert_array_equal(
        digits[..., :d0].reshape(2, 8, 4, 3, d0).permute(2, 0, 1, 3, 4).numpy(), jdigits)
    want = j["serving"].dim0_inner_products_mxu(j["jnp"].asarray(jdigits), j["jnp"].asarray(_limbs_last(query, 1)),
                                                jctx)
    np.testing.assert_array_equal(got.numpy(), convert.limbs_to_int64(np.moveaxis(np.asarray(want), 2, 0)))
    assert torch.equal(got, mac)


@pytest.mark.parametrize("fill", ["random", "max"])
def test_plain_digit_form_w64_matches_she_tpu(fill):
    """At 55-bit moduli (8 digits) against she_tpu's 128-bit MAC
    (_dim0_inner_products_w64): she_tpu's own digit form compiles slowly on
    XLA:CPU at two limbs, and serves the MAC at w64."""
    j = _she_tpu()
    db, query = _operands(W64, 4, 11, 6, 8, seed=3, fill=fill)
    ctx, _, got, mac = _plain(W64, db, query)
    assert dg.digit_count(ctx.moduli) == 8
    jctx = j["poly_context"](8, W64, 64)
    want = j["serving"]._dim0_inner_products_w64(
        j["jnp"].asarray(_limbs_last(db, 2)), j["jnp"].asarray(_limbs_last(query, 2)), jctx)
    np.testing.assert_array_equal(got.numpy(), convert.limbs_to_int64(np.moveaxis(np.asarray(want), 2, 0)))
    assert torch.equal(got, mac)


@pytest.mark.parametrize("fill", ["random", "max"])
def test_plain_digit_form_up_to_nine_digits(fill):
    db, query = _operands(W62, 2, 7, 4, 8, seed=5, fill=fill)
    ctx, _, got, mac = _plain(W62, db, query)
    assert dg.digit_count(ctx.moduli) == 9
    assert torch.equal(got, mac)


def test_digits_and_recombination():
    q = get_poly_context(8, W62, 64, torch.device("cpu")).q_col
    x = torch.from_numpy(_residues(W62, (5, 8), 7))
    parts = dg.value_digits(x, 9)
    assert all(p.dtype == torch.int8 and int(p.min()) >= 0 for p in parts)
    assert torch.equal(sum(p.to(torch.int64) << (7 * d) for d, p in enumerate(parts)), x)
    rng = np.random.default_rng(8)
    partials = [torch.from_numpy(rng.integers(0, 1 << 31, size=(5, 2, 8))) for _ in range(17)]
    want = [[[sum(int(p[a, b, c]) << (7 * k) for k, p in enumerate(partials)) % W62[b] for c in range(8)]
             for b in range(2)] for a in range(5)]
    assert dg.recombine_partials(partials, q).tolist() == want


def test_int32_partial_bound_raises():
    dg.assert_int32_partial_bound(33_000, 4)
    with pytest.raises(OverflowError):
        dg.assert_int32_partial_bound(33_500, 4)
    with pytest.raises(OverflowError):
        dg.assert_int32_partial_bound(16_700, 8)
    db, query = _operands(W64, 1, 16_700, 1, 8, seed=9)
    ctx = get_poly_context(8, W64, 64, torch.device("cpu"))
    digits = tserving.pack_database_chunk_digits(torch.from_numpy(db), ctx)
    with pytest.raises(OverflowError):
        tserving.dim0_inner_products_int8(digits, torch.from_numpy(query), ctx)


def test_kernel_wrapper_refuses_cpu_tensors():
    db, query = _operands(W32, 2, 5, 2, 8)
    ctx = get_poly_context(8, W32, 32, torch.device("cpu"))
    digits = tserving.pack_database_chunk_digits(torch.from_numpy(db), ctx)
    before = trace.counters["launch.dim0_int8"]
    with pytest.raises(ValueError, match="CUDA"):
        dim0_cuda.dim0_int8(digits, torch.from_numpy(query), ctx)
    assert trace.counters["launch.dim0_int8"] == before


# -- the batched servers ---------------------------------------------------------


def _index_setup(j, bits, entries):
    jctx = j["bfv"].get_bfv_context(j["params"].from_predefined(PARAMS, bits))
    tctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, bits), device="cpu")
    jsk = j["bfv"].generate_secret_key(jctx, j["rng"](b"s" * 32))
    config = dict(entry_count=entries, entry_size_in_bytes=1, dimension_count=2, batch_size=1,
                  uneven_dimensions=True)
    jparam = j["ip"].generate_parameter(
        j["ip"].IndexPirConfig(**config, key_compression=j["ip"].PirKeyCompression.NO_COMPRESSION), jctx)
    tparam = tip.generate_parameter(
        tip.IndexPirConfig(**config, key_compression=tip.PirKeyCompression.NO_COMPRESSION), tctx)
    database = [bytes([(11 * i + 5) % 256]) for i in range(entries)]
    jprocessed = j["ip"].MulPirServer.process(database, jctx, jparam)
    jclient = j["ip"].MulPirClient(jparam, jctx)
    jek = jclient.generate_evaluation_key(jsk, j["rng"](b"k" * 32))
    limbs = lambda ct: [np.asarray(p.data) for p in ct.polys]  # noqa: E731
    galois = {e: [limbs(ct) for ct in k.ciphertexts] for e, k in jek.galois_key.keys.items()}
    relin = [limbs(ct) for ct in jek.relinearization_key.key_switch_key.ciphertexts]
    tek = convert.evaluation_key_from_limbs(tctx, galois, relin)
    tprocessed = convert.processed_database_from_limbs(
        tctx, [None if p is None else np.asarray(p.poly.data) for p in jprocessed.plaintexts])
    return dict(jctx=jctx, tctx=tctx, jsk=jsk, jparam=jparam, tparam=tparam, database=database,
                jprocessed=jprocessed, jclient=jclient, jek=jek, tek=tek, tprocessed=tprocessed, limbs=limbs)


def _assert_same(port_response, jax_response, limbs):
    for p_reply, j_reply in zip(port_response.ciphertexts, jax_response.ciphertexts, strict=True):
        for pc, jc in zip(p_reply, j_reply, strict=True):
            for got, want in zip(convert.ciphertext_to_limbs(pc), limbs(jc), strict=True):
                np.testing.assert_array_equal(got, want)


def test_batched_server_int8_matches_she_tpu_w32(monkeypatch):
    """Against she_tpu's batched server on its MXU form (forced on the CPU
    with SHE_TPU_DIM0_MXU=1, as tests/test_serving.py does)."""
    j = _she_tpu()
    monkeypatch.setenv("SHE_TPU_DIM0_MXU", "1")
    s = _index_setup(j, 32, 40)
    indices = [0, 17, 39]
    jqueries = [s["jclient"].generate_query([i], s["jsk"]) for i in indices]
    tqueries = [convert.query_from_limbs(s["tctx"], [s["limbs"](ct) for ct in q.ciphertexts], q.indices_count)
                for q in jqueries]
    jserver = j["serving"].BatchedMulPirServer(s["jparam"], s["jctx"], [s["jprocessed"]])
    assert jserver.use_dim0_mxu
    want = jserver.compute_response_batch(jqueries, s["jek"])
    server = tserving.BatchedMulPirServer(s["tparam"], s["tctx"], [s["tprocessed"]], use_dim0_int8=True)
    assert server.use_dim0_int8 and len(server.chunk_digits[0]) == 1
    got = server.compute_response_batch(tqueries, s["tek"])
    client = tip.MulPirClient(s["tparam"], s["tctx"])
    tsk = convert.secret_key_from_limbs(s["tctx"], np.asarray(s["jsk"].poly.data))
    for index, g, w in zip(indices, got, want):
        _assert_same(g, w, s["limbs"])
        assert client.decrypt(g, [index], tsk) == [s["database"][index]]


def test_batched_server_int8_matches_she_tpu_w64():
    """Against she_tpu's per-query server at 64-bit scalars (its batched w64
    server compiles for minutes on XLA:CPU): one query."""
    j = _she_tpu()
    s = _index_setup(j, 64, 12)
    jquery = s["jclient"].generate_query([5], s["jsk"])
    want = j["ip"].MulPirServer(s["jparam"], s["jctx"], [s["jprocessed"]]).compute_response(jquery, s["jek"])
    tquery = convert.query_from_limbs(s["tctx"], [s["limbs"](ct) for ct in jquery.ciphertexts],
                                      jquery.indices_count)
    server = tserving.BatchedMulPirServer(s["tparam"], s["tctx"], [s["tprocessed"]], use_dim0_int8=True)
    assert dg.digit_count(s["tctx"].ciphertext_context.moduli) == 3
    _assert_same(server.compute_response_batch([tquery], s["tek"])[0], want, s["limbs"])


@pytest.mark.parametrize("bits", [32, 64])
def test_default_form_on_the_cpu_is_the_mac(bits):
    tctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, bits), device="cpu")
    param = tip.generate_parameter(tip.IndexPirConfig(8, 1, 2, 1, True, tip.PirKeyCompression.NO_COMPRESSION), tctx)
    processed = tip.MulPirServer.process([bytes([i]) for i in range(8)], tctx, param)
    server = tserving.BatchedMulPirServer(param, tctx, [processed])
    assert not server.use_dim0_int8 and server.chunk_digits == [[]]


def test_keyword_server_passes_the_form_on():
    """The keyword server's two sub-tables through the int8 form answer
    exactly as through the MAC."""
    ep = tparams.from_predefined(PARAMS, 32)
    ctx = tbfv.get_bfv_context(ep, device="cpu")
    rows = [(f"kw{i}".encode(), bytes([i, 255 - i])) for i in range(20)]
    config = tkp.KeywordPirConfig(2, tkp.CuckooTableConfig.default_keyword_pir(
        tkp.default_max_serialized_bucket_size(2, ep.bytes_per_plaintext)))
    processed = tkp.KeywordPirServer.process(rows, config, ctx, rng=random.Random(3))
    sk = tbfv.generate_secret_key(ctx, trng(bytes(32)))
    client = tkp.KeywordPirClient(processed.keyword_pir_parameter, processed.pir_parameter, ctx)
    ek = client.generate_evaluation_key(sk, trng(bytes(range(32))))
    keywords = [b"kw3", b"kw19", b"absent"]
    queries = [client.generate_query(kw, sk) for kw in keywords]
    int8 = tserving.BatchedKeywordPirServer(ctx, processed, use_dim0_int8=True)
    mac = tserving.BatchedKeywordPirServer(ctx, processed, use_dim0_int8=False)
    assert int8.index_server.use_dim0_int8 and not mac.index_server.use_dim0_int8
    got = int8.compute_response_batch(queries, ek)
    for g, w in zip(got, mac.compute_response_batch(queries, ek)):
        for g_reply, w_reply in zip(g.ciphertexts, w.ciphertexts, strict=True):
            for gc, wc in zip(g_reply, w_reply, strict=True):
                assert torch.equal(gc.stacked(), wc.stacked())
    assert [client.decrypt(r, kw, sk) for r, kw in zip(got, keywords)] == [bytes([3, 252]), bytes([19, 236]), None]


# -- the kernel on the card ---------------------------------------------------------


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("fill", ["random", "max"])
@pytest.mark.parametrize("moduli,C,d0,P,N", [
    (W32, 3, 5, 6, 8),            # tiny
    (W32, 9, 55, 256, 64),        # the w32 index cell, cut in n
    (W32, 31, 97, 256, 64),       # the keyword cell, cut in n
    (W32, 31, 97, 20, 16),        # a ragged last p tile
    (W64, 4, 11, 256, 64),        # the w64 shape, cut in n: 8 digits
    ((262139, 262133), 2, 3, 2, 8),        # 3 digits
    ((2147483647,), 5, 40, 9, 8),          # a 31-bit modulus: 5 digits
    (W32, 21, 228, 64, 64),       # the keyword_large cell, cut in n: K = 256, 4 n a block
    (W32, 21, 228, 20, 16),       # 4 n a block, P not a multiple of its 16-p tile
    (W32, 31, 97, 13, 16),        # 8 n a block, P not a multiple of its 8-p tile
    (W32, 31, 97, 256, 8),        # N = 8: one n group
    (W32, 7, 33, 24, 16),         # 28 rows: not a multiple of 16
    (W32, 40, 33, 9, 16),         # C > 32: two blocks along c
    (W64, 17, 11, 256, 16),       # 8 digits, 2 m tiles, the w64 check's p tiling
    # deeper K than the first layouts hold: the launch falls back to smaller blocks
    (W32, 31, 288, 20, 16),       # 8 n, one m tile a block, two blocks along c
    (W32, 21, 260, 20, 16),       # the same layout at keyword_large's C
    ((2147483647,), 17, 228, 20, 16),      # 5 digits: 4 n, one m tile a block
    (W64, 17, 320, 20, 16),       # 8 digits: 2 n, one m tile a block
    (W64, 3, 570, 9, 8),          # 8 digits, K = 576: the deepest the kernel takes
], ids=["tiny", "index", "keyword", "ragged", "w64", "d3", "d5", "large", "large_ragged", "ragged8",
        "one_group", "rows28", "c40", "w64_mt2", "k288", "k288_c21", "d5_c17", "w64_k320", "w64_k576"])
def test_kernel_matches_plain(moduli, C, d0, P, N, fill):
    dev = _card()
    db, query = _operands(moduli, C, d0, P, N, seed=C + d0, fill=fill)
    ctx = get_poly_context(N, tuple(moduli), 64, dev)
    db_t, query_t = torch.from_numpy(db).to(dev), torch.from_numpy(query).to(dev)
    digits = tserving.pack_database_chunk_digits(db_t, ctx)
    before = trace.counters["launch.dim0_int8"]
    got = tserving.dim0_int8(digits, query_t, ctx)
    torch.cuda.synchronize()
    assert trace.counters["launch.dim0_int8"] == before + 1
    assert torch.equal(got, tserving.dim0_inner_products_int8(digits, query_t, ctx))
    assert torch.equal(got, tserving.dim0_inner_products(db_t, query_t, ctx))


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take():
    dev = _card()
    db, query = _operands(W32, 2, 5, 2, 12)
    ctx = get_poly_context(8, W32, 32, dev)
    digits = tserving.pack_database_chunk_digits(torch.from_numpy(db).to(dev), ctx)
    with pytest.raises(ValueError, match="multiple of 8"):
        dim0_cuda.dim0_int8(digits, torch.from_numpy(query).to(dev), ctx)
    wide = ((1 << 61) - 1,)
    db, query = _operands(wide, 2, 5, 2, 8)
    ctx = get_poly_context(8, wide, 64, dev)
    digits = tserving.pack_database_chunk_digits(torch.from_numpy(db).to(dev), ctx)
    with pytest.raises(ValueError, match="2\\^56"):
        dim0_cuda.dim0_int8(digits, torch.from_numpy(query).to(dev), ctx)
    db, query = _operands(W64, 3, 600, 9, 8)  # K = 608 at 8 digits: no block holds it
    ctx = get_poly_context(8, W64, 64, dev)
    digits = tserving.pack_database_chunk_digits(torch.from_numpy(db).to(dev), ctx)
    with pytest.raises(ValueError, match="K \\+ 16"):
        dim0_cuda.dim0_int8(digits, torch.from_numpy(query).to(dev), ctx)


@pytest.mark.gpu
@pytest.mark.parametrize("params,bits,expected", [
    (PARAMS, 32, True),
    (PARAMS, 64, False),  # she_tpu serves the MAC at 64-bit scalars, whatever the moduli
    ("n_8192_logq_3x55_logt_24", 64, False),
])
def test_default_form_on_the_card(params, bits, expected):
    dev = _card()
    ctx = tbfv.get_bfv_context(tparams.from_predefined(params, bits), device=dev)
    param = tip.generate_parameter(tip.IndexPirConfig(8, 1, 2, 1, True, tip.PirKeyCompression.NO_COMPRESSION), ctx)
    processed = tip.MulPirServer.process([bytes([i]) for i in range(8)], ctx, param)
    server = tserving.BatchedMulPirServer(param, ctx, [processed])
    assert server.use_dim0_int8 is expected
