"""The dim-0 MAC (ops/dim0_mac.py) and the expansion's leaves, on the CPU
route of their dispatch, against she_tpu bit for bit (tolerance 0).

Inputs come from numpy generators with fixed seeds, at
insecure_n_8_logq_5x18_logt_5's moduli at 32 and 64 bits, and at 55- and
60-62-bit moduli at N <= 512:

* serving.dim0_inner_products against she_tpu's dim0_inner_products and
  _dim0_inner_products_w64 through convert.py's limb layout, with the
  database read through a strided d0 slice and d0 crossing the lazy
  limits (at 62 bits the port's wide accumulator reduces after every
  product, she_tpu's after 8, the kernel's after 16);
* pnns/serving.bsgs_inner_products against she_tpu's bsgs_inner_products
  and _bsgs_inner_products_w64;
* bfv.inner_product_ct_pt against she_tpu's, with skipped plaintexts,
  and its operands read in place where they are rows of one tensor;
* expand_batched against she_tpu's expand_batched at output counts 1, 2,
  3, 15, 64 and 100 at 32 bits (several query ciphertexts at N = 8; 3 and
  15 double some leaves) and against its ip.expand at 3 at 64 bits, and
  expand_combine's leaf path (its plain version) on its own against
  she_tpu's add, sub, shift and doubling;
* BatchedMulPirServer's choice of dim-0 form by SHE_TPU_DIM0_MXU.

The kernels themselves are held to these plain versions on the card by
tests/test_torch_dim0_mac_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.bfv import keys as jkeys
from she_tpu.core import context as jctxmod
from she_tpu.core import poly as jpoly
from she_tpu.ops import word as wordmod
from she_tpu.pir import index_pir as jip
from she_tpu.pir import serving as jserving
from she_tpu.pnns import serving as jpnns_serving
from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng
from she_tpu_torch import convert
from she_tpu_torch import params as tparams
from she_tpu_torch import trace
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.core import context as tctxmod
from she_tpu_torch.core.poly import EVAL, PolyRq
from she_tpu_torch.ops import dim0_mac, dim0_mac_cuda
from she_tpu_torch.ops import key_switch as ks
from she_tpu_torch.pir import index_pir as tip
from she_tpu_torch.pir import serving as tserving
from she_tpu_torch.pnns import serving as tpnns_serving
from she_tpu_torch.utils import nt

PARAMS = "insecure_n_8_logq_5x18_logt_5"
CPU = torch.device("cpu")
# name -> (moduli, scalar bits, N)
MODULI = {
    "n8_w32": (tuple(tparams.from_predefined(PARAMS, 32).coefficient_moduli[:3]), 32, 8),
    "n8_w64": (tuple(tparams.from_predefined(PARAMS, 64).coefficient_moduli[:3]), 64, 8),
    "w55": (tuple(nt.generate_primes([55] * 3, preferring_small=False, ntt_degree=512)), 64, 64),
    "w62": (tuple(nt.generate_primes([60, 62, 61], preferring_small=False, ntt_degree=512)), 64, 512),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread, as the other port files run under several
    workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _residues(moduli, batch, degree, seed, fill="random"):
    rng = np.random.default_rng(seed)
    out = np.zeros(tuple(batch) + (len(moduli), degree), dtype=np.int64)
    for i, q in enumerate(moduli):
        if fill == "random":
            out[..., i, :] = rng.integers(0, q, size=tuple(batch) + (degree,), dtype=np.int64)
        elif fill == "max":
            out[..., i, :] = q - 1
    return out


def _limbs_at(values, nlimbs, axis):
    """int64 [..., L, N] -> she_tpu's uint32 limbs with W at `axis`."""
    return np.moveaxis(convert.int64_to_limbs(values, nlimbs), 0, axis)


def _from_limbs_at(limbs, axis):
    return convert.limbs_to_int64(np.moveaxis(np.asarray(limbs), axis, 0))


def _contexts(name):
    moduli, bits, degree = MODULI[name]
    return (tctxmod.get_poly_context(degree, moduli, bits, CPU), jctxmod.get_poly_context(degree, moduli, bits),
            1 if bits == 32 else 2)


def _no_kernel_launched(before):
    assert trace.counters["launch.dim0_mac"] == before and trace.counters["plain_on_cuda.dim0_mac"] == 0


# -- the dim-0 MAC against she_tpu ----------------------------------------------


@pytest.mark.parametrize("fill", ["random", "max"])
@pytest.mark.parametrize("d0", [1, 5, 20])
@pytest.mark.parametrize("name", list(MODULI))
def test_dim0_inner_products_match_she_tpu(name, d0, fill):
    """[C, d0] x [d0, P] at C = 3, P = 4, the database read through a
    strided slice of a wider chunk, as a mesh rank reads its rows."""
    tctx, jctx, nlimbs = _contexts(name)
    degree = tctx.degree
    chunk = _residues(tctx.moduli, (3, d0 + 2), degree, seed=d0 + degree, fill=fill)
    query = _residues(tctx.moduli, (d0, 4), degree, seed=7 * d0 + degree, fill=fill)
    db = chunk[:, 1:d0 + 1]
    before = trace.counters["launch.dim0_mac"]
    got = tserving.dim0_inner_products(torch.from_numpy(chunk)[:, 1:d0 + 1], torch.from_numpy(query), tctx)
    _no_kernel_launched(before)
    want = jserving.dim0_inner_products(jnp.asarray(_limbs_at(db, nlimbs, 2)), jnp.asarray(_limbs_at(query, nlimbs, 2)),
                                        jctx)  # [C, P, W, L, N]
    np.testing.assert_array_equal(got.numpy(), _from_limbs_at(want, 2))


def test_d0_crosses_every_lazy_limit():
    """At 60-62-bit moduli the port's wide accumulator takes one product
    between reductions, she_tpu's 8 and the kernel's four-product limb sums
    one: d0 = 20 crosses all three. The 32-bit instance's cap at
    insecure_n_8's moduli is the largest its u64 sum allows."""
    moduli = MODULI["w62"][0]
    tctx = tctxmod.get_poly_context(8, moduli, 64, CPU)
    assert tctx.max_signed_lazy_product_count() < 20
    assert jctxmod.get_poly_context(8, moduli, 64).max_lazy_product_accumulation_count() // 2 < 20
    bits, s = dim0_mac_cuda.word_bits(moduli), dim0_mac_cuda.limb_shift(moduli)
    cap = dim0_mac_cuda.lazy_cap(moduli, bits)
    assert bits == 64 and s == 31 and cap == 1 < 20
    assert (1 << (2 * s)) + 2 * cap * ((1 << s) - 1) ** 2 < 1 << 64 <= (1 << (2 * s)) + 2 * (cap + 1) * ((1 << s) - 1) ** 2
    w32 = MODULI["n8_w32"][0]
    cap = dim0_mac_cuda.lazy_cap(w32, dim0_mac_cuda.word_bits(w32))
    assert cap == min(((1 << 64) - q) // (q - 1) ** 2 for q in w32) > 20


@pytest.mark.parametrize("name", ["n8_w32", "n8_w64", "w55"])
@pytest.mark.parametrize("J,G,R", [(1, 1, 1), (4, 3, 2), (12, 2, 1)])
def test_bsgs_inner_products_match_she_tpu(name, J, G, R):
    """The diagonals [G, J, R] against the rotations [J, 1, 2] (one
    query): the port reads the diagonals as a [G, R, J] view."""
    tctx, jctx, nlimbs = _contexts(name)
    degree = tctx.degree
    db = _residues(tctx.moduli, (G, J, R), degree, seed=J * 10 + G)
    rot = _residues(tctx.moduli, (J, 1, 2), degree, seed=J * 10 + G + 1)
    got = tpnns_serving.bsgs_inner_products(torch.from_numpy(db), torch.from_numpy(rot), tctx)  # [G, R, 1, 2, L, N]
    want = jpnns_serving.bsgs_inner_products(jnp.asarray(_limbs_at(db, nlimbs, 3)),
                                             jnp.asarray(_limbs_at(rot[:, 0], nlimbs, 2)), jctx)  # [G, R, 2, W, L, N]
    np.testing.assert_array_equal(got[:, :, 0].numpy(), _from_limbs_at(want, 3))


@pytest.mark.parametrize("bits", [32, 64])
def test_inner_product_ct_pt_matches_she_tpu(bits):
    """Five ciphertexts against five plaintexts, two of them skipped
    (None): one launch a component on the card, the same stream here."""
    jctx = jbfv.get_bfv_context(jparams.from_predefined(PARAMS, bits))
    tctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, bits), device="cpu")
    nlimbs = 1 if bits == 32 else 2
    ct_ctx, jct_ctx = tctx.ciphertext_context, jctx.ciphertext_context
    cts = _residues(ct_ctx.moduli, (5, 2), tctx.degree, seed=bits)
    pts = _residues(ct_ctx.moduli, (5,), tctx.degree, seed=bits + 1)
    tcts = [convert.ciphertext_from_limbs(tctx, [convert.int64_to_limbs(p, nlimbs) for p in ct], EVAL) for ct in cts]
    jcts = [jbfv.Ciphertext(jctx, [jpoly.PolyRq(jnp.asarray(convert.int64_to_limbs(p, nlimbs)), jct_ctx, jpoly.EVAL)
                                   for p in ct]) for ct in cts]
    keep = [True, False, True, True, False]
    tpts = [tbfv.Plaintext(tctx, PolyRq(torch.from_numpy(p), ct_ctx, EVAL)) if k else None for p, k in zip(pts, keep)]
    jpts = [jbfv.Plaintext(jctx, jpoly.PolyRq(jnp.asarray(convert.int64_to_limbs(p, nlimbs)), jct_ctx, jpoly.EVAL))
            if k else None for p, k in zip(pts, keep)]
    got = tbfv.inner_product_ct_pt(tcts, tpts)
    want = jbfv.inner_product_ct_pt(jcts, jpts)
    for g, w in zip(convert.ciphertext_to_limbs(got), want.polys, strict=True):
        np.testing.assert_array_equal(g, np.asarray(w.data))


@pytest.mark.parametrize("keep", [(1, 1, 1, 1), (1, 0, 1, 1)])
@pytest.mark.parametrize("bits", [32, 64])
def test_inner_product_ct_pt_reads_rows_of_one_tensor_in_place(monkeypatch, bits, keep):
    """Plaintexts that are rows of one tensor (a processed database) and
    ciphertexts made by from_stacked reach the MAC as views, not copies,
    where the present pairs are equally spaced; a skipped plaintext in
    between makes a copy. Either way the sum is the plain stream's."""
    tctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, bits), device="cpu")
    ct_ctx = tctx.ciphertext_context
    db = torch.from_numpy(_residues(ct_ctx.moduli, (4,), tctx.degree, seed=bits + 2))
    queries = torch.from_numpy(_residues(ct_ctx.moduli, (4, 2), tctx.degree, seed=bits + 3))
    cts = [tbfv.Ciphertext.from_stacked(tctx, queries[i], ct_ctx, EVAL) for i in range(4)]
    pts = [tbfv.Plaintext(tctx, PolyRq(db[i], ct_ctx, EVAL)) if k else None for i, k in enumerate(keep)]
    seen, mac = [], dim0_mac.dim0_mac

    def spy(a, b, ctx):
        seen.append((a, b))
        return mac(a, b, ctx)

    monkeypatch.setattr(tbfv.dim0_mac, "dim0_mac", spy)
    got = tbfv.inner_product_ct_pt(cts, pts)
    rows = [i for i, k in enumerate(keep) if k]
    in_place = all(keep)
    assert len(seen) == 2
    for comp, ((a, b), poly) in enumerate(zip(seen, got.polys, strict=True)):
        assert (a.data_ptr() == db.data_ptr() and b.data_ptr() == queries[0, comp].data_ptr()) == in_place
        want = dim0_mac.dim0_mac_plain(db[rows].unsqueeze(0), queries[rows, comp], ct_ctx)[0]
        assert torch.equal(poly.data, want)


@pytest.mark.parametrize("fill", ["zero", "max", "random"])
def test_dim0_mac_plain_reads_strided_and_broadcast_operands(fill):
    """The plain version of any [*M1, J] x [J, *M2] operands, views
    included, equals the exact sum over Python integers."""
    moduli = MODULI["w62"][0]
    degree = 16
    ctx = tctxmod.get_poly_context(degree, moduli, 64, CPU)
    a = torch.from_numpy(_residues(moduli, (2, 1, 6), degree, seed=1, fill=fill)).expand(2, 3, 6, 3, degree)
    b = torch.from_numpy(_residues(moduli, (4, 6), degree, seed=2, fill=fill)).transpose(0, 1)  # [6, 4], a view
    got = dim0_mac.dim0_mac(a, b, ctx)  # [2, 3, 4, L, N]
    av, bv = a.numpy().astype(object), b.numpy().astype(object)
    q = np.array(moduli, dtype=object)[:, None]
    want = np.einsum("xyjln,jzln->xyzln", av, bv) % q
    np.testing.assert_array_equal(got.numpy().astype(object), want)


def test_dispatch_and_wrapper_refuse_what_the_kernel_does_not_take():
    """A CPU tensor takes the plain version through the dispatch and is
    refused by the kernel's wrapper; other dtypes and devices raise; the
    wrapper's plans are ones the kernel takes: a built word, at most 16
    accumulators, 32 to 256 coefficients a block in whole warps."""
    moduli = MODULI["n8_w32"][0]
    ctx = tctxmod.get_poly_context(8, moduli, 32, CPU)
    a = torch.zeros((2, 3, len(moduli), 8), dtype=torch.int64)
    b = torch.zeros((3, 4, len(moduli), 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        dim0_mac_cuda.dim0_mac(a, b, moduli)
    with pytest.raises(TypeError, match="must be int64"):
        dim0_mac_cuda.dim0_mac(a.int(), b, moduli)
    plan = dim0_mac_cuda.plan(2, 4, 3, moduli)
    for bad in (plan._replace(group=17), plan._replace(lanes=9), plan._replace(run=0), plan._replace(depth=3),
                plan._replace(lanes=0), plan._replace(word_bits=16)):
        with pytest.raises(ValueError, match="is not one the kernel takes|does not take moduli"):
            dim0_mac_cuda._check_plan(bad, moduli, 3)
    with pytest.raises(ValueError, match="no dim0_mac for device meta"):
        dim0_mac.dim0_mac(a.to("meta"), b.to("meta"), ctx)
    assert torch.equal(dim0_mac.dim0_mac(a, b, ctx), torch.zeros((2, 4, len(moduli), 8), dtype=torch.int64))
    for m1, m2, j in ((1, 1, 11), (1, 300, 11), (4, 256, 11), (11, 32, 12), (1000, 1, 11), (16, 2, 64), (1, 1, 800),
                      (17, 40, 320), (3, 18, 570)):
        p = dim0_mac_cuda.plan(m1, m2, j, moduli)
        dim0_mac_cuda._check_plan(p, moduli, j)
        assert p.group <= max(m1, 1) and p.lanes <= p.run <= max(m2, 1)
        # the direct instance only where even one lane's staging would not fit
        assert (p.depth == 0) == (dim0_mac_cuda._shared_bytes(p._replace(lanes=1, depth=1), j)
                                  > dim0_mac_cuda.MAX_SHARED_BYTES)


# the widest served launches (M1, M2, J, L, N, parameters, scalar bits): the
# w64 dim-0, PNNS's BSGS MAC at both cells, ct x pt of the service (keyword's
# d0 of 97, w32's 55) and mesh (c)'s d0 slices at 64 bits
SERVED_PLANS = {
    "w64": (4, 256, 11, 2, 8192, "n_8192_logq_3x55_logt_24", 64),
    "pnns_w32": (11, 32, 12, 2, 4096, "n_4096_logq_27_28_28_logt_17", 32),
    "pnns_w64": (11, 32, 12, 2, 4096, "n_4096_logq_27_28_28_logt_17", 64),
    "service_keyword": (1, 1, 97, 2, 4096, "n_4096_logq_27_28_28_logt_5", 32),
    "service_w32": (1, 1, 55, 2, 4096, "n_4096_logq_27_28_28_logt_5", 32),
    "mesh_psum_S2": (4, 32, 16, 2, 8192, "n_8192_logq_3x55_logt_24", 64),
    "mesh_psum_S4": (4, 32, 8, 2, 8192, "n_8192_logq_3x55_logt_24", 64),
}


@pytest.mark.parametrize("cell", list(SERVED_PLANS))
def test_served_plans(cell):
    """Each served launch's plan: the 32-bit instance exactly where every
    ciphertext modulus is below 2^32 (PNNS at both cells, the w32
    service), the Karatsuba limbs at the 55-bit w64 sets; all of M1 in one
    group, up to MAX_LANES m2 at once sharing the block's words of A, each
    lane walking up to STEPS m2 through a ring of two steps (one where it
    walks one), within a block's shared memory."""
    m1, m2, j, L, degree, params, bits = SERVED_PLANS[cell]
    moduli = tuple(tparams.from_predefined(params, bits).coefficient_moduli[:L])
    p = dim0_mac_cuda.plan(m1, m2, j, moduli)
    assert p.word_bits == (60 if cell in ("w64", "mesh_psum_S2", "mesh_psum_S4") else 32)
    assert p.group == m1 and p.lanes == min(m2, dim0_mac_cuda.MAX_LANES)
    assert p.run == min(m2, p.lanes * dim0_mac_cuda.STEPS)
    assert p.depth == (2 if p.run > p.lanes else 1)
    dim0_mac_cuda._check_plan(p, moduli, j)


@pytest.mark.parametrize("m1,groups,group", [(1, 1, 1), (4, 1, 4), (11, 1, 11), (16, 1, 16), (17, 2, 9), (33, 3, 11),
                                             (100, 7, 15)])
def test_plans_split_m1_into_as_few_groups_as_fit(m1, groups, group):
    """M1 above the 16 accumulators a thread keeps is split into
    ceil(M1 / 16) groups of equal size (the last may be short)."""
    p = dim0_mac_cuda.plan(m1, 8, 5, MODULI["w55"][0])
    assert p.group == group and -(-m1 // p.group) == groups


@pytest.mark.parametrize("q,cap32,cap60,cap64", [((1 << 27) - 40959, 1024, (1 << 34) - 1, (1 << 35) - 1),
                                                  ((1 << 31) - 1, 4, (1 << 30) - 1, (1 << 31) - 1),
                                                  ((1 << 32) - 5, 1, (1 << 30) - 1, (1 << 31) - 1),
                                                  ((1 << 55) - 55, None, 63, 127), ((1 << 60) - 93, None, 3, 7),
                                                  ((1 << 62) - 57, None, None, 1)])
def test_lazy_caps_hold_their_bound(q, cap32, cap60, cap64):
    """The 32-bit instance's cap c is the largest with (q - 1) + c (q - 1)^2
    below 2^64: one more product could wrap. The limb instances' sums of
    limbs below 2^s (s = limb_shift) stay below 2^64 for c products after
    a residue below 2^(2s): Karatsuba's middle sum takes c products of limb
    sums below 2^(s + 1), the four-product middle sum 2 c products below
    2^(2s); the folded sum fits the 128-bit reduction. The instance is the
    narrowest the moduli allow: 32 below 2^32, 60 below 2^60, else 64."""
    if cap32 is not None:
        cap = dim0_mac_cuda.lazy_cap((q,), 32)
        assert cap == cap32
        assert (q - 1) + cap * (q - 1) ** 2 < 1 << 64 <= (q - 1) + (cap + 1) * (q - 1) ** 2
    s = dim0_mac_cuda.limb_shift((q,))
    assert q <= 1 << (2 * s) and s <= 31
    limb = (1 << s) - 1
    if cap60 is not None:
        cap = dim0_mac_cuda.lazy_cap((q,), 60)
        assert cap == min(cap60, dim0_mac_cuda.MAX_CAP) and s <= 30 and 2 * limb < 1 << 31
        assert (1 << (2 * s)) + cap * (2 * limb) ** 2 < 1 << 64
    cap = dim0_mac_cuda.lazy_cap((q,), 64)
    assert cap == min(cap64, dim0_mac_cuda.MAX_CAP)
    assert 2 * cap * limb ** 2 < 1 << 64 and (1 << (2 * s)) + cap * limb ** 2 < 1 << 64
    assert (1 << (2 * s)) + cap * (1 << (4 * s)) < 1 << 128
    assert dim0_mac_cuda.word_bits((q,)) == (32 if q < 1 << 32 else 60 if q < 1 << 60 else 64)
    assert dim0_mac_cuda.lazy_cap((2, 3), 32) == dim0_mac_cuda.MAX_CAP


# -- the expansion's leaves ------------------------------------------------------


def _jv(data) -> np.ndarray:
    return wordmod.unpack(np.asarray(data)).astype(np.int64)


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("doubling", [False, True])
def test_leaf_path_plain_matches_she_tpu(bits, doubling):
    """expand_combine's plain version with leaves: three nodes, children
    in the pool and at output positions, some doubled (she_tpu's
    bfv.ct_add(c, c) on the leaf), against she_tpu's add, sub and
    multiply_power_of_x."""
    moduli = tuple(tparams.from_predefined(PARAMS, bits).coefficient_moduli[:2])
    degree, shift = 8, 2
    ctx = tctxmod.get_poly_context(degree, moduli, bits, CPU)
    jctx = jctxmod.get_poly_context(degree, moduli, bits)
    pool = _residues(moduli, (5, 2, 2), degree, seed=bits)
    update = _residues(moduli, (3, 2, 2), degree, seed=bits + 1)
    out = _residues(moduli, (4, 2, 2), degree, seed=bits + 2)
    parents, child0, child1 = [0, 1, 2], [3, -1, -3], [-2, 4, -4]
    mask = [[False, True, False], [True, False, True]] if doubling else None
    want_pool, want_out = pool.copy(), out.copy()

    def jp(v):
        return jpoly.PolyRq.from_values(v.astype(object), jctx, jpoly.COEFF)

    for r, p in enumerate(parents):
        for b in range(2):
            for c in range(2):
                par, upd = jp(pool[p, b, c]), jp(update[r, b, c])
                for k, (child, value) in enumerate(((child0[r], jpoly.add(upd, par)),
                                                    (child1[r], jpoly.multiply_power_of_x(jpoly.sub(par, upd), -shift)))):
                    if mask is not None and mask[k][r]:
                        value = jpoly.add(value, value)
                    target, at = (want_pool, child) if child >= 0 else (want_out, -child - 1)
                    target[at, b, c] = _jv(value.data)
    got_pool, got_out = torch.from_numpy(pool.copy()), torch.from_numpy(out.copy())
    idx = [torch.tensor(v, dtype=torch.int64) for v in (parents, child0, child1)]
    ks.expand_combine_plain(got_pool, torch.from_numpy(update), *idx, shift, ctx, got_out,
                            None if mask is None else torch.tensor(mask))
    np.testing.assert_array_equal(got_pool.numpy(), want_pool)
    np.testing.assert_array_equal(got_out.numpy(), want_out)


def _keyed(bits, queries, cts_a_query):
    """Contexts and an evaluation key with the expansion's elements 9, 5
    and 3 (N = 8), made by she_tpu and carried across, and `cts_a_query`
    query ciphertexts for each of `queries` queries."""
    jctx = jbfv.get_bfv_context(jparams.from_predefined(PARAMS, bits))
    tctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, bits), device="cpu")
    jsk = jbfv.generate_secret_key(jctx, jrng(b"s" * 32))
    jek = jkeys.generate_evaluation_key(jctx, jkeys.EvaluationKeyConfig((9, 5, 3)), jsk, jrng(b"k" * 32))
    limbs = lambda ct: [np.asarray(p.data) for p in ct.polys]  # noqa: E731
    tek = convert.evaluation_key_from_limbs(
        tctx, {e: [limbs(ct) for ct in k.ciphertexts] for e, k in jek.galois_key.keys.items()}, None)
    query_cts = []
    for b in range(queries):
        cts = []
        for i in range(cts_a_query):
            values = [int(v) for v in np.random.default_rng(100 * b + i).integers(0, jctx.plaintext_modulus, size=8)]
            cts.append(jbfv.encrypt(jbfv.encode(jctx, values), jsk, seed=bytes([b + 1, i + 1]) * 16,
                                    err_rng=jrng(bytes([b + 9, i]) * 16)))
        query_cts.append(cts)
    return dict(jctx=jctx, tctx=tctx, jek=jek, tek=tek, queries=query_cts, limbs=limbs)


@pytest.fixture(scope="module")
def keyed():
    """Two queries of 13 ciphertexts (100 outputs at N = 8), 32 bits."""
    return _keyed(32, 2, 13)


def _expand_both(keyed, output_count, reference=jserving.expand_batched):
    """The port's expand_batched of the batch of queries, checked against
    she_tpu's `reference` (expand_batched, or ip.expand, which she_tpu
    holds bit-identical to it) of each query."""
    count_cts = -(-output_count // 8)
    stacked = [torch.stack([convert.ciphertext_from_limbs(keyed["tctx"], keyed["limbs"](q[i])).stacked()
                            for q in keyed["queries"]]) for i in range(count_cts)]  # per ciphertext [B, 2, L, N]
    before = trace.counters["leaf_level"]
    got = tserving.expand_batched(stacked, output_count, keyed["tek"], keyed["tctx"])
    assert tuple(got.shape[:2]) == (output_count, len(keyed["queries"]))
    per_ct = [min(8, output_count - 8 * i) for i in range(count_cts)]
    assert trace.counters["leaf_level"] - before == sum(2 if n in (3, 7) else int(n > 1) for n in per_ct)
    for b, query in enumerate(keyed["queries"]):
        want = (jip.expand(query[:count_cts], output_count, keyed["jek"]) if reference is jip.expand
                else reference(query[:count_cts], output_count, keyed["jek"], keyed["jctx"]))
        assert len(want) == output_count
        for g, w in zip(got[:, b], want):
            np.testing.assert_array_equal(g.numpy(), np.stack([convert.limbs_to_int64(a) for a in keyed["limbs"](w)]))


@pytest.mark.parametrize("output_count", [1, 2, 3, 15, 64, 100])
def test_expand_batched_matches_she_tpu(keyed, output_count):
    """Two queries in one batch at 32 bits against she_tpu's
    expand_batched of each: every leaf written by its level, in output
    order, doubled where the plan says; the levels that write leaves
    counted apart."""
    _expand_both(keyed, output_count)


def test_expand_batched_w64_doubles_like_she_tpu():
    """At 64 bits, 3 outputs (one leaf doubled) of one query against
    she_tpu's per-query ip.expand (bit-identical to its expand_batched, and
    a third of its time eagerly on the CPU: 8 s against 25 s at 64 bits);
    tests/test_torch_key_switch.py holds 8 outputs at 64 bits."""
    _expand_both(_keyed(64, 1, 1), 3, jip.expand)


@pytest.mark.parametrize("output_count,doubled", [(2, 0), (3, 1), (7, 1), (8, 0), (15, 1), (100, 28)])
def test_plans_double_only_where_she_tpu_does(output_count, doubled):
    """The doubling mask is host data of the plan: its leaves doubled are
    build_expansion_plan's, and a level without one has no mask."""
    tserving._plan_on_device.cache_clear()
    _, levels = tserving._plan_on_device(output_count, CPU)
    plan = jserving.build_expansion_plan(output_count)
    assert sum(d for _, d in plan.leaves) == doubled
    masks = [m for *_, m in levels]
    assert sum(int(m.sum()) for m in masks if m is not None) == doubled
    assert all(m is None or bool(m.any()) for m in masks)


# -- the dim-0 form ---------------------------------------------------------------


@pytest.mark.parametrize("flag,form", [("1", True), ("0", False), (None, False)])
def test_she_tpu_dim0_mxu_picks_the_form(monkeypatch, flag, form):
    """SHE_TPU_DIM0_MXU, where set, picks the form as she_tpu's server
    does ("1" the int8 digit form, else the MAC); unset, the CPU serves
    the MAC. Both forms answer with the same bits."""
    ctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, 32), device="cpu")
    param = tip.generate_parameter(tip.IndexPirConfig(entry_count=40, entry_size_in_bytes=1), ctx)
    database = np.random.default_rng(1).integers(0, 256, size=(40, 1), dtype=np.uint8)
    processed = tip.MulPirServer.process(database, ctx, param)
    if flag is None:
        monkeypatch.delenv("SHE_TPU_DIM0_MXU", raising=False)
    else:
        monkeypatch.setenv("SHE_TPU_DIM0_MXU", flag)
    server = tserving.BatchedMulPirServer(param, ctx, [processed])
    assert server.use_dim0_int8 is form
    assert bool(server.chunk_digits[0]) is form
    other = tserving.BatchedMulPirServer(param, ctx, [processed], use_dim0_int8=not form)
    query = torch.from_numpy(_residues(ctx.ciphertext_context.moduli, (param.dimensions[0], 4), ctx.degree, seed=3))
    assert torch.equal(server.dim0(0, 0, query), other.dim0(0, 0, query))
