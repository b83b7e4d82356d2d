"""The CUDA NTT kernels against their plain PyTorch version, on the card.

Marked `gpu`: each test decides inside itself whether a card exists and
skips where there is none. This file imports only the port (no jax, no
she_tpu), so it also runs on a machine without jax:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_kernels.py

Both kernel routes are covered: 32-bit words (every modulus below 2^30,
here the three largest NTT primes below 2^30) and 64-bit words (moduli in
[2^30, 2^31), and the 55-bit moduli of n_8192_logq_3x55_logt_24, which the
plain version takes through the wide route, and against the big-int
reference). The wide modular arithmetic (ops/wide.py, plain PyTorch) is
held bit-equal between CUDA and CPU tensors.
"""

import numpy as np
import pytest
import torch

from she_tpu_torch import trace
from she_tpu_torch.core import rns
from she_tpu_torch.ops import modarith as ma
from she_tpu_torch.ops import ntt as tntt
from she_tpu_torch.ops import ntt_cuda, wide
from she_tpu_torch.utils import nt, refimpl

ROUTE_MODULI = {
    32: tuple(nt.generate_primes([30] * 3, preferring_small=False, ntt_degree=8192)),
    64: tuple(nt.generate_primes([31] * 3, preferring_small=True, ntt_degree=8192)),
}
W32_MODULI = ((1 << 27) - 40959, (1 << 28) - 65535, (1 << 28) - 73727)
W64_MODULI = ((1 << 55) - 311295, (1 << 55) - 1392639, (1 << 55) - 1507327)
SERVED_MODULI = (36028797018652673, 36028797017571329, 36028797017456641)  # 3x55, N=8192
BSK_MODULI = tuple(rns.bsk_prime_pool(8192, 3, 64))  # the 61-bit B_sk primes of the w64 cell's BEHZ products
# the row walk's moduli by L: the w64 cell's q, and 55-bit q beside 61-bit B_sk rows
WALK_MODULI = {2: (SERVED_MODULI[0], BSK_MODULI[0]), 3: SERVED_MODULI, 5: SERVED_MODULI[1:] + BSK_MODULI[:3]}
# the largest NTT primes of 57, 58 and 59 bits at N = 8192: the row walk runs
# lazily (sums unreduced) below 2^58 and reduces every stage above
EDGE_MODULI = {b: nt.generate_primes([b], preferring_small=False, ntt_degree=8192)[0] for b in (57, 58, 59)}
WIDE_MODULI = ((1 << 31) + 11, 36028797018652673, 1152921504606830593, 2305843009213554689,
               (1 << 62) - 40797, 1 << 32)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rows(moduli, degree, batch, seed=0, fill="random"):
    rng = np.random.default_rng(seed)
    rows = np.zeros((batch, len(moduli), degree), dtype=np.int64)
    for i, q in enumerate(moduli):
        if fill == "random":
            rows[:, i, :] = rng.integers(0, q, size=(batch, degree))
        elif fill == "max":
            rows[:, i, :] = q - 1
    return torch.from_numpy(rows)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,nmod", [(1, 1), (1, 3), (5, 1)], ids=["1row", "3rows", "5rows"])
@pytest.mark.parametrize("fill", ["zero", "max", "random"])
@pytest.mark.parametrize("degree", [2, 4, 8, 16, 32, 256, 4096, 8192])
@pytest.mark.parametrize("word_bits", [32, 64])
def test_kernel_matches_plain(word_bits, degree, fill, batch, nmod):
    dev = _card()
    moduli = ROUTE_MODULI[word_bits][:nmod]
    tables = tntt.build_ntt_tables(moduli, degree, dev)
    assert tables.word_bits == word_bits
    x = _rows(moduli, degree, batch, seed=degree, fill=fill).to(dev)
    before = dict(trace.counters)
    fwd = ntt_cuda.forward(x, tables)
    assert torch.equal(fwd, tntt.forward_ntt_plain(x, tables))
    inv = ntt_cuda.inverse(fwd, tables)
    assert torch.equal(inv, tntt.inverse_ntt_plain(fwd, tables))
    assert torch.equal(inv, x)
    assert trace.counters["launch.ntt_forward"] == before.get("launch.ntt_forward", 0) + 1
    assert trace.counters["launch.ntt_inverse"] == before.get("launch.ntt_inverse", 0) + 1


@pytest.mark.gpu
@pytest.mark.parametrize("fill", ["zero", "max", "random"])
def test_kernel_w64_moduli_round_trip_and_reference(fill):
    dev = _card()
    tables = tntt.build_ntt_tables(W64_MODULI, 8192, dev)
    assert tables.word_bits == 64
    x = _rows(W64_MODULI, 8192, batch=2, seed=3, fill=fill).to(dev)
    before = dict(trace.counters)
    fwd = ntt_cuda.forward(x, tables)
    assert fwd[0, 2].tolist() == refimpl.forward_ntt(x[0, 2].tolist(), W64_MODULI[2])
    assert torch.equal(ntt_cuda.inverse(fwd, tables), x)
    assert trace.counters["launch.ntt_forward"] == before.get("launch.ntt_forward", 0) + 1
    assert trace.counters["launch.ntt_inverse"] == before.get("launch.ntt_inverse", 0) + 1


@pytest.mark.gpu
def test_dispatch_launches_kernel_for_cuda_tensors():
    dev = _card()
    tables = tntt.build_ntt_tables(W32_MODULI, 256, dev)
    x = _rows(W32_MODULI, 256, batch=1).to(dev)
    plain_before = [trace.counters["plain_on_cuda." + k] for k in ("ntt_forward", "ntt_inverse")]
    before = trace.counters["launch.ntt_forward"]
    tntt.forward_ntt(x, tables)
    assert trace.counters["launch.ntt_forward"] == before + 1
    assert [trace.counters["plain_on_cuda." + k] for k in ("ntt_forward", "ntt_inverse")] == plain_before


@pytest.mark.gpu
@pytest.mark.parametrize("batch,nmod", [(1, 1), (1, 3), (5, 1)], ids=["1row", "3rows", "5rows"])
@pytest.mark.parametrize("fill", ["zero", "max", "random"])
def test_kernel_matches_plain_at_served_55_bit_moduli(fill, batch, nmod):
    """The 64-bit route at N=8192 against the plain version, which takes
    55-bit moduli through the wide route."""
    dev = _card()
    moduli = SERVED_MODULI[:nmod]
    tables = tntt.build_ntt_tables(moduli, 8192, dev)
    assert tables.word_bits == 64
    x = _rows(moduli, 8192, batch, seed=55, fill=fill).to(dev)
    fwd = ntt_cuda.forward(x, tables)
    assert torch.equal(fwd, tntt.forward_ntt_plain(x, tables))
    inv = ntt_cuda.inverse(fwd, tables)
    assert torch.equal(inv, tntt.inverse_ntt_plain(fwd, tables))
    assert torch.equal(inv, x)


@pytest.mark.gpu
@pytest.mark.parametrize("fill", ["zero", "max", "random"])
@pytest.mark.parametrize("batch", [1, 131, 132, 133, 265, 5377])
@pytest.mark.parametrize("L", [2, 3, 5])
def test_row_walk_matches_plain_at_served_moduli(L, batch, fill):
    """The 64-bit route at N = 8192, where a persistent block of one
    modulus walks the rows l, l + L, ... with the next row's bulk copy in
    flight: bit-equal to the plain version at the w64 cell's 55-bit q and
    the 61-bit B_sk primes, at batches of rows around the grid (132 SMs,
    132 / L blocks a modulus), each block walking a ragged number of rows."""
    dev = _card()
    moduli = WALK_MODULI[L]
    assert len(moduli) == L and all(55 <= q.bit_length() <= 61 for q in moduli)
    tables = tntt.build_ntt_tables(moduli, 8192, dev)
    assert tables.word_bits == 64
    x = _rows(moduli, 8192, batch, seed=batch + L, fill=fill).to(dev)
    before = dict(trace.counters)
    fwd = ntt_cuda.forward(x, tables)
    assert torch.equal(fwd, tntt.forward_ntt_plain(x, tables))
    inv = ntt_cuda.inverse(fwd, tables)
    assert torch.equal(inv, tntt.inverse_ntt_plain(fwd, tables))
    assert torch.equal(inv, x)
    assert trace.counters["launch.ntt_forward"] == before.get("launch.ntt_forward", 0) + 1
    assert trace.counters["launch.ntt_inverse"] == before.get("launch.ntt_inverse", 0) + 1


@pytest.mark.gpu
@pytest.mark.parametrize("fill", ["max", "random"])
@pytest.mark.parametrize("moduli", [(57,), (58,), (59,), (58, 59), (57, 58, 58)],
                         ids=["57", "58", "59", "58+59", "57+58+58"])
def test_row_walk_at_the_lazy_edge(moduli, fill):
    """Both directions at N = 8192 on their own inputs (the inverse too, so
    its lazy bounds start from the largest words) for moduli on each side
    of the lazy edge and a launch mixing both sides."""
    dev = _card()
    qs = tuple(EDGE_MODULI[b] for b in moduli)
    assert [q.bit_length() for q in qs] == list(moduli)
    tables = tntt.build_ntt_tables(qs, 8192, dev)
    x = _rows(qs, 8192, 133, seed=sum(moduli), fill=fill).to(dev)
    assert torch.equal(ntt_cuda.forward(x, tables), tntt.forward_ntt_plain(x, tables))
    assert torch.equal(ntt_cuda.inverse(x, tables), tntt.inverse_ntt_plain(x, tables))


@pytest.mark.gpu
@pytest.mark.parametrize("degree", [4096, 8192])
def test_kernel_takes_a_view_at_an_odd_offset(degree):
    """A contiguous view whose data is 8 bytes past a 16-byte boundary (the
    row walk reads rows with 16-byte bulk copies) gives the same bits."""
    dev = _card()
    moduli = SERVED_MODULI
    tables = tntt.build_ntt_tables(moduli, degree, dev)
    x = _rows(moduli, degree, 3, seed=degree).to(dev)
    buf = torch.empty(x.numel() + 1, dtype=torch.int64, device=dev)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    assert torch.equal(ntt_cuda.forward(view, tables), ntt_cuda.forward(x, tables))
    assert torch.equal(ntt_cuda.inverse(view, tables), ntt_cuda.inverse(x, tables))


@pytest.mark.gpu
@pytest.mark.parametrize("q", WIDE_MODULI)
def test_wide_arithmetic_on_cuda_equals_cpu(q):
    """mul_mod, the reduction and the lazy sums of ops/wide.py give the same
    bits on CUDA tensors as on CPU tensors (and as Python ints)."""
    dev = _card()
    rng = np.random.default_rng(q % 1000)
    shape = (7, 3, 4096)
    moduli = (q, q - 2 if q % 2 else q - 1, 17)
    a = np.stack([rng.integers(0, m, size=(7, 4096)) for m in moduli], axis=1)
    b = np.stack([rng.integers(0, m, size=(7, 4096)) for m in moduli], axis=1)
    a[0, :, :2], b[0, :, :2] = np.array(moduli)[:, None] - 1, np.array(moduli)[:, None] - 1
    assert a.shape == shape

    def run(device):
        col = wide.tag(torch.tensor([[m] for m in moduli], device=device), moduli)
        ta, tb = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
        cap = ma.lazy_product_count(moduli)
        terms = [(ta[i], tb[(i + 1) % 7]) for i in range(7)]
        hi, lo = wide.mul_wide(ta, tb)
        return [ma.mul_mod(ta, tb, col, bound=max(moduli)), ma.sum_products_mod(terms, col, cap, max(moduli)),
                wide.reduce_pair(torch.remainder(hi, col), lo, col), wide.mul_mod(ta, tb, q)]

    for got, want in zip(run(dev), run(torch.device("cpu"))):
        assert torch.equal(got.cpu(), want)
    want = [[(int(x) * int(y)) % m for x, y in zip(a[1, i, :64], b[1, i, :64])] for i, m in enumerate(moduli)]
    assert run(dev)[0][1, :, :64].tolist() == want


SIMD_MODULUS = (1 << 16) + 1  # t of n_4096_logq_27_28_28_logt_17: 17 bits, 1 mod 2N up to N = 32768


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [(), (16,), (128,)], ids=["one", "16", "128"])
@pytest.mark.parametrize("degree", [8, 4096])
def test_kernel_matches_plain_at_the_plaintext_modulus(degree, batch):
    """SIMD encoding's NTTs: one 17-bit NTT-friendly modulus (L = 1), at
    [..., 1, N] (one plaintext, a query batch, the PNNS database's 128
    diagonals), on the 32-bit route."""
    dev = _card()
    tables = tntt.build_ntt_tables((SIMD_MODULUS,), degree, dev)
    assert tables.word_bits == 32
    x = _rows((SIMD_MODULUS,), degree, max(1, int(np.prod(batch))), seed=degree).reshape(batch + (1, degree)).to(dev)
    fwd = ntt_cuda.forward(x.contiguous(), tables)
    assert torch.equal(fwd, tntt.forward_ntt_plain(x, tables))
    inv = ntt_cuda.inverse(x.contiguous(), tables)
    assert torch.equal(inv, tntt.inverse_ntt_plain(x, tables))
    assert torch.equal(ntt_cuda.inverse(fwd, tables), x)


@pytest.mark.gpu
def test_simd_encoding_on_the_card_equals_the_cpu():
    """bfv.encode_simd_batch and SIMD decoding at n_4096_logq_27_28_28_logt_17
    launch the kernels on the card and give the CPU's bits."""
    from she_tpu_torch import params as tparams
    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.core.poly import COEFF, PolyRq

    dev = _card()
    ep = tparams.from_predefined("n_4096_logq_27_28_28_logt_17", 32)
    rows = np.random.default_rng(17).integers(0, ep.plaintext_modulus, size=(8, 4096))
    got = {}
    for device in (dev, torch.device("cpu")):
        ctx = bfv.get_bfv_context(ep, device=device)
        before = dict(trace.counters)
        data = bfv.encode_simd_batch(ctx, rows)
        pt = bfv.Plaintext(ctx, PolyRq(data[3], ctx.plaintext_context, COEFF))
        got[device.type] = (data.cpu(), bfv.decode(ctx, pt, "simd"),
                            bfv.plaintext_to_eval(ctx, pt).poly.data.cpu())
        launched = {k: trace.counters["launch." + k] - before.get("launch." + k, 0)
                    for k in ("ntt_forward", "ntt_inverse")}
        on_card = device.type == "cuda"
        assert launched == {"ntt_forward": 2 * on_card, "ntt_inverse": 1 * on_card}
    assert torch.equal(got["cuda"][0], got["cpu"][0]) and torch.equal(got["cuda"][2], got["cpu"][2])
    assert got["cuda"][1] == got["cpu"][1] == rows[3].tolist()


# --- SimplePIR: the u8 tensor-core response product and the NTT at q' ------


def _simple_pir_operands(R, C, k, p_bits, b_bits, seed):
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 1 << p_bits, size=(R, C), dtype=np.int64)
    queries = rng.integers(0, 1 << b_bits, size=(k, C), dtype=np.int64)
    queries[:, :2] = (1 << b_bits) - 1  # the largest words take part
    db[:, :2] = (1 << p_bits) - 1
    return torch.from_numpy(db), torch.from_numpy(queries)


@pytest.mark.gpu
@pytest.mark.parametrize("b_bits", [8, 16, 21, 32, 40, 48, 56, 61])
@pytest.mark.parametrize("C", [31, 32769, 70000])
@pytest.mark.parametrize("k", [1, 7, 8, 9, 32, 33, 64])
def test_simple_pir_matmul_matches_plain(k, C, b_bits):
    """The kernel against its plain version (float64 plane products on the
    card) at a ragged R (131 rows: two blocks of 128 rows, the second with
    one row tile of 3 rows), two D planes (p = 9), every query-plane count
    1-8 (b = 32: the pair (1, 3) is skipped), C under one box, under one
    segment and over several, k in one query tile of 8, 16 or 32 rows and
    in two or three."""
    from she_tpu_torch.ops import simple_pir_cuda as spc

    dev = _card()
    db, queries = _simple_pir_operands(131, C, k, 9, b_bits, seed=C + k + b_bits)
    planes = spc.database_planes(db.to(dev), 9)
    before = trace.counters["launch.simple_pir_matmul"]
    got = spc.simple_pir_matmul(planes, queries.to(dev), b_bits)
    torch.cuda.synchronize()
    assert trace.counters["launch.simple_pir_matmul"] == before + 1
    assert got.shape == (k, 131)
    assert torch.equal(got, spc.simple_pir_matmul_plain(planes, queries.to(dev), b_bits))


@pytest.mark.gpu
@pytest.mark.parametrize("b_bits", [8, 32, 61])
@pytest.mark.parametrize("k", [1, 9, 33])
def test_simple_pir_matmul_one_database_plane(k, b_bits):
    """One D plane (p = 8) at R = 200 (a block of 128 rows and one of 72),
    C = 40,000 over two segments."""
    from she_tpu_torch.ops import simple_pir_cuda as spc

    dev = _card()
    db, queries = _simple_pir_operands(200, 40000, k, 8, b_bits, seed=k + b_bits)
    planes = spc.database_planes(db.to(dev), 8)
    assert planes.data.shape[0] == 1
    got = spc.simple_pir_matmul(planes, queries.to(dev), b_bits)
    assert torch.equal(got, spc.simple_pir_matmul_plain(planes, queries.to(dev), b_bits))


@pytest.mark.gpu
@pytest.mark.parametrize("p_bits,b_bits", [(4, 16), (8, 40), (17, 40), (9, 61)])
def test_simple_pir_matmul_matches_the_exact_product(p_bits, b_bits):
    """The kernel against the exact int64 product on the CPU (the plain
    version's CPU route), at plane counts 1, 1, 3 and 2 of D."""
    from she_tpu_torch.ops import simple_pir_cuda as spc

    dev = _card()
    db, queries = _simple_pir_operands(300, 1000, 5, p_bits, b_bits, seed=p_bits)
    planes = spc.database_planes(db.to(dev), p_bits)
    got = spc.simple_pir_matmul(planes, queries.to(dev), b_bits).cpu()
    want = spc.simple_pir_matmul_plain(spc.database_planes(db, p_bits), queries, b_bits)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_simple_pir_matmul_refuses_what_it_does_not_take():
    from she_tpu_torch.ops import simple_pir_cuda as spc

    dev = _card()
    db, queries = _simple_pir_operands(16, 40, 2, 9, 21, seed=0)
    planes = spc.database_planes(db.to(dev), 9)
    with pytest.raises(ValueError):
        spc.simple_pir_matmul_cuda(planes, queries, 21)  # a CPU query
    wider = torch.zeros((2, 41), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        spc.simple_pir_matmul_cuda(planes, wider, 21)  # 41 columns for a database of 40
    with pytest.raises(ValueError):
        spc.simple_pir_matmul_cuda(planes, queries.to(dev), 63)
    with pytest.raises(ValueError):
        spc.simple_pir_matmul_cuda(planes, queries.to(dev), 0)
    with pytest.raises(TypeError):
        spc.simple_pir_matmul_cuda(spc.DatabasePlanes(planes.data.to(torch.int16), 16, 40), queries.to(dev), 21)
    with pytest.raises(TypeError):
        spc.simple_pir_matmul_cuda(planes, queries.to(dev).to(torch.int32), 21)
    with pytest.raises(ValueError):
        spc.simple_pir_matmul_cuda(spc.DatabasePlanes(planes.data, 70, 40), queries.to(dev), 21)  # 2 row tiles
    with pytest.raises(ValueError):
        spc.simple_pir_matmul_cuda(spc.DatabasePlanes(planes.data, 16, 200), torch.zeros((2, 200), dtype=torch.int64,
                                                                                        device=dev), 21)  # 2 boxes
    with pytest.raises(ValueError):
        spc.simple_pir_matmul_cuda(spc.DatabasePlanes(planes.data[:, :, :, :4096], 16, 40), queries.to(dev), 21)
    with pytest.raises(ValueError):
        spc.simple_pir_matmul_cuda(spc.DatabasePlanes(torch.zeros((9, 1, 1, 8192), dtype=torch.uint8, device=dev),
                                                      16, 40), queries.to(dev), 21)  # nine planes
    with pytest.raises(ValueError):  # a strided query
        spc.simple_pir_matmul_cuda(planes, torch.zeros((2, 80), dtype=torch.int64, device=dev)[:, ::2], 21)


@pytest.mark.gpu
@pytest.mark.parametrize("b_bits,degree", [(21, 1024), (32, 2048), (32, 1024)])
def test_kernel_matches_plain_at_simple_pir_moduli(b_bits, degree):
    """The NTT at SimplePIR's q' (the smallest (b + 1)-bit NTT prime): a
    22-bit modulus on the 32-bit route, 33-bit ones on the 64-bit route,
    at the hint's launch shape [rows, a_poly_count, 1, N]."""
    dev = _card()
    q = nt.generate_primes([b_bits + 1], preferring_small=True, ntt_degree=degree)[0]
    tables = tntt.build_ntt_tables((q,), degree, dev)
    assert tables.word_bits == (32 if b_bits < 29 else 64)
    x = _rows((q,), degree, 3 * 5, seed=b_bits).reshape(3, 5, 1, degree).to(dev)
    fwd = ntt_cuda.forward(x, tables)
    assert torch.equal(fwd, tntt.forward_ntt_plain(x, tables))
    inv = ntt_cuda.inverse(fwd, tables)
    assert torch.equal(inv, tntt.inverse_ntt_plain(fwd, tables))
    assert torch.equal(inv, x)


@pytest.mark.gpu
def test_simple_pir_on_the_card_equals_the_cpu():
    """process_database, the client and the server on the card give the
    CPU's database, hint, queries and answers, and the answer decrypts."""
    from she_tpu_torch import params as tparams
    from she_tpu_torch.ops import simple_pir_cuda as spc
    from she_tpu_torch.pir import simple_pir as sp
    from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr

    dev = _card()
    ep = sp.SimplePirEncryptionParams(9, 32, 64, security_level=tparams.SecurityLevel.UNCHECKED)
    entries = np.random.default_rng(5).integers(0, 256, size=(300, 24), dtype=np.uint8)
    got = {}
    for device in (dev, torch.device("cpu")):
        res = sp.process_database(entries, ep, seed=bytes(32), device=device)
        server = sp.SimplePirServer(res.database, res.hint, res.params, device=device)
        client = sp.SimplePirClient(res.params, res.hint, device=device)
        queries = [client.query(i, rng=nist_aes128_ctr(bytes([i % 256]) * 32)) for i in (0, 7, 299)]
        before = trace.counters["launch.simple_pir_matmul"]
        answers = server.compute_response(torch.cat([q.queries for q in queries]))
        assert trace.counters["launch.simple_pir_matmul"] == before + (device.type == "cuda")
        for i, q in enumerate(queries):
            assert client.decrypt(answers[i : i + 1], q.prepare_response(), q.index) == entries[q.index].tobytes()
        got[device.type] = [t.cpu() for t in (res.database, res.hint, queries[1].queries, answers)]
    for a, b in zip(got["cuda"], got["cpu"]):
        assert torch.equal(a, b)
