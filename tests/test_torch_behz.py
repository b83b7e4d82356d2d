"""The BEHZ product's passes (she_tpu_torch/ops/behz.py) and the functions
rewired onto them, against she_tpu, bit for bit, on the CPU.

RnsTool.lift_q_to_qbsk and floor_qbsk_to_q meet she_tpu's RnsTool on the
same residues; multiply_without_scaling, drop_extended_base, ct_mul and
inner_product_ct_ct meet she_tpu's on ciphertexts made from the same
residues (zero, q - 1 and random fills from a numpy seed; the products are
exact arithmetic whatever the values), compared through
she_tpu_torch/convert.py. Parameter sets: insecure_n_8_logq_5x18_logt_5 at
32 and 64 bits, insecure_n_512_logq_4x60_logt_20 (60-bit moduli, where
m_sk and alpha exceed every q_i) and insecure_n_16_logq_60_logt_15 (L = 1);
the floor's scale and the MAC at t = 2^41 + 32769 (t >= 2^31); K = 1, 3, 8
and 31 pairs. The scale-once rule of the mesh's partitioned fold (partial
sums scaled by t on each rank, then summed and floored unscaled) gives the
bits of one inner product. The dispatch takes the plain versions on a CPU
tensor and raises on another device; the CUDA wrappers' refusals are
checked here too, and the kernels themselves are held to these plain
versions on the card by tests/test_torch_behz_kernels.py. Every
comparison is exact (tolerance 0).
"""

import ctypes
import functools

import numpy as np
import pytest
import torch

from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.core import context as jctxmod
from she_tpu.core import poly as jpoly
from she_tpu.core import rns as jrns
from she_tpu.ops import word as wordmod
from she_tpu_torch import convert
from she_tpu_torch import params as tparams
from she_tpu_torch import trace
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.core import rns as trns
from she_tpu_torch.core.context import get_poly_context
from she_tpu_torch.ops import behz
from she_tpu_torch.ops import behz_cuda as bc
from she_tpu_torch.ops import modarith as ma

CPU = torch.device("cpu")
SETS = {
    "n8_w32": ("insecure_n_8_logq_5x18_logt_5", 32),
    "n8_w64": ("insecure_n_8_logq_5x18_logt_5", 64),
    "n512_4x60": ("insecure_n_512_logq_4x60_logt_20", 64),
    "n16_L1": ("insecure_n_16_logq_60_logt_15", 64),
}
FILLS = ["zero", "max", "random"]
WIDE_T = (1 << 41) + 32769  # a plaintext modulus above 2^31 (n_8192_logq_3x55_logt_42's)
KERNELS = ("behz_lift", "behz_tensor_mac", "behz_floor")


def _rand(moduli, batch, degree, seed, fill="random"):
    rng = np.random.default_rng(seed)
    out = np.zeros(tuple(batch) + (len(moduli), degree), dtype=np.int64)
    for i, q in enumerate(moduli):
        if fill == "random":
            out[..., i, :] = rng.integers(0, q, size=tuple(batch) + (degree,), dtype=np.int64)
        elif fill == "max":
            out[..., i, :] = q - 1
    return out


def _word(values, bits):
    return wordmod.as_word(wordmod.pack(np.asarray(values).astype(object), 1 if bits == 32 else 2))


def _jv(word) -> np.ndarray:
    """A she_tpu word -> int64 [L, N]."""
    return wordmod.unpack(np.stack([np.asarray(w) for w in word])).astype(np.int64)


def _jct_values(ct) -> np.ndarray:
    return np.stack([wordmod.unpack(np.asarray(p.data)).astype(np.int64) for p in ct.polys])


@functools.lru_cache(maxsize=None)
def _contexts(label):
    name, bits = SETS[label]
    jctx = jbfv.get_bfv_context(jparams.from_predefined(name, bits))
    tctx = tbfv.get_bfv_context(tparams.from_predefined(name, bits), device="cpu")
    return dict(label=label, bits=bits, jctx=jctx, tctx=tctx, moduli=tctx.ciphertext_context.moduli)


@pytest.fixture(scope="module", params=list(SETS))
def contexts(request):
    return _contexts(request.param)


def _cts(contexts, count, seed, fill):
    """`count` ciphertexts of `fill` residues over the ciphertext moduli,
    in both packages, and the port's stacked [count, 2, L, N]."""
    jctx, tctx, moduli = contexts["jctx"], contexts["tctx"], contexts["moduli"]
    values = _rand(moduli, (count, 2), tctx.degree, seed, fill)
    jctx_poly = jctx.ciphertext_context
    jcts = [jbfv.Ciphertext(jctx, [jpoly.PolyRq.from_values(v.astype(object), jctx_poly, jpoly.COEFF) for v in ct])
            for ct in values]
    stacked = torch.from_numpy(values)
    tcts = [tbfv.Ciphertext.from_stacked(tctx, stacked[i], tctx.ciphertext_context) for i in range(count)]
    return jcts, tcts, stacked


def _assert_ct(port_ct, jax_ct):
    assert len(port_ct.polys) == len(jax_ct.polys)
    for got, want in zip(convert.ciphertext_to_limbs(port_ct), [np.asarray(p.data) for p in jax_ct.polys]):
        np.testing.assert_array_equal(got, want)


# -- the lift and the floor ---------------------------------------------------


@pytest.mark.parametrize("fill", FILLS)
def test_lift_matches_she_tpu(contexts, fill):
    """RnsTool.lift_q_to_qbsk (behz_lift) against she_tpu's on each of a
    batch read through a transposed view; the random fill takes both
    sides of the m~ centring."""
    bits, moduli, n = contexts["bits"], contexts["moduli"], contexts["tctx"].degree
    jt = contexts["jctx"].get_rns_tool(len(moduli))
    tt = contexts["tctx"].get_rns_tool(len(moduli))
    values = _rand(moduli, (1, 2), n, seed=11, fill=fill)
    view = torch.from_numpy(values).transpose(0, 1)  # [2, 1, L, N], strided
    got = tt.lift_q_to_qbsk(view)
    assert got.shape == (2, 1, 2 * len(moduli) + 1, n)
    for a in range(1):
        for b in range(2):
            np.testing.assert_array_equal(got[b, a].numpy(), _jv(jt.lift_q_to_qbsk(_word(values[a, b], bits))))
    if fill == "random":
        r = tt.convert_approximate_bsk_mtilde(torch.from_numpy(values))[..., -1, :]
        r_mt = trns.mul_mod_power_of_two(r, tt.neg_inverse_q_mod_m_tilde, tt.m_tilde)
        assert bool((r_mt < tt.m_tilde // 2).any()) and bool((r_mt >= tt.m_tilde // 2).any())


@pytest.mark.parametrize("fill", FILLS)
def test_floor_matches_she_tpu(contexts, fill):
    """RnsTool.floor_qbsk_to_q (behz_floor) against she_tpu's, unscaled
    and with each row first times t (drop_extended_base's scale, which
    the floor takes after the inverse NTT)."""
    bits, moduli, n = contexts["bits"], contexts["moduli"], contexts["tctx"].degree
    jt = contexts["jctx"].get_rns_tool(len(moduli))
    tt = contexts["tctx"].get_rns_tool(len(moduli))
    ext = tt.q_bsk_context.moduli
    values = _rand(ext, (), n, seed=12, fill=fill)
    t = contexts["tctx"].plaintext_modulus
    for scale in (1, t):
        got = tt.floor_qbsk_to_q(torch.from_numpy(values), scale)
        scaled = np.stack([(v.astype(object) * scale) % m for v, m in zip(values, ext)])
        np.testing.assert_array_equal(got.numpy(), _jv(jt.floor_qbsk_to_q(_word(scaled, bits))))


@pytest.mark.parametrize("fill", FILLS)
def test_wide_t(fill):
    """t = 2^41 + 32769 >= 2^31: the floor scaled by t against she_tpu's
    RnsTool at that t, and the MAC scaled by t against Python integers,
    at insecure_n_512_logq_4x60_logt_20's moduli."""
    name = SETS["n512_4x60"][0]
    moduli = tparams.from_predefined(name, 64).coefficient_moduli[:-1]
    n = 512
    pool = trns.bsk_prime_pool(n, len(moduli), 64)
    jt = jrns.RnsTool(jctxmod.get_poly_context(n, moduli, 64), WIDE_T, pool)
    tt = trns.RnsTool(get_poly_context(n, moduli, 64, CPU), WIDE_T, pool)
    ext = tt.q_bsk_context
    values = _rand(ext.moduli, (), n, seed=13, fill=fill)
    got = tt.floor_qbsk_to_q(torch.from_numpy(values), WIDE_T)
    scaled = np.stack([(v.astype(object) * WIDE_T) % m for v, m in zip(values, ext.moduli)])
    np.testing.assert_array_equal(got.numpy(), _jv(jt.floor_qbsk_to_q(_word(scaled, 64))))
    la, lb = (_rand(ext.moduli, (3, 2), 16, seed=14 + i, fill=fill) for i in range(2))
    got = behz.behz_tensor_mac(torch.from_numpy(la), torch.from_numpy(lb), get_poly_context(16, ext.moduli, 64, CPU),
                               WIDE_T, axis=-4)
    a, b = la.astype(object), lb.astype(object)
    q = np.array(ext.moduli, dtype=object)[:, None]
    want = np.stack([(a[:, 0] * b[:, 0]).sum(0), (a[:, 0] * b[:, 1] + a[:, 1] * b[:, 0]).sum(0),
                     (a[:, 1] * b[:, 1]).sum(0)]) * WIDE_T % q
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# -- the rewired products -----------------------------------------------------


@pytest.mark.parametrize("fill", FILLS)
def test_products_match_she_tpu(contexts, fill):
    """multiply_without_scaling (unscaled, over [q, B_sk]), the public
    drop_extended_base of it (scale t) and ct_mul (scaled once, in the
    MAC) against she_tpu's."""
    jcts, tcts, _ = _cts(contexts, 2, seed=21, fill=fill)
    jprod = jbfv.multiply_without_scaling(jcts[0], jcts[1])
    tprod = tbfv.multiply_without_scaling(tcts[0], tcts[1])
    _assert_ct(tprod, jprod)
    want = jbfv.drop_extended_base(jprod)  # she_tpu's ct_mul
    _assert_ct(tbfv.drop_extended_base(tprod), want)
    _assert_ct(tbfv.ct_mul(tcts[0], tcts[1]), want)


# K pairs by set: she_tpu multiplies pair by pair, at 64 bits op by op
K_CASES = [("n8_w32", 1), ("n8_w32", 3), ("n8_w32", 8), ("n8_w32", 31), ("n8_w64", 1), ("n8_w64", 8),
           ("n512_4x60", 1), ("n512_4x60", 3), ("n16_L1", 3)]


@pytest.mark.parametrize("label,K", K_CASES)
def test_inner_product_matches_she_tpu(label, K):
    """inner_product_ct_ct of K pairs against she_tpu's, and
    inner_product_ct_ct_stacked on the serving layout (a transposed view
    of the query, [B, K, 2, L, N]) against it."""
    contexts = _contexts(label)
    jl, tl, stacked_l = _cts(contexts, K, seed=31 + K, fill="random")
    jr, tr, stacked_r = _cts(contexts, K, seed=41 + K, fill="max" if K == 8 else "random")
    want = jbfv.inner_product_ct_ct(jl, jr)
    _assert_ct(tbfv.inner_product_ct_ct(tl, tr), want)
    tctx, ct_ctx = contexts["tctx"], contexts["tctx"].ciphertext_context
    v0 = torch.stack([stacked_l, stacked_l], dim=1).transpose(0, 1)  # the query's [K, B, ...] read as [B, K, ...]
    v1 = torch.stack([stacked_r, stacked_r])
    got = tbfv.inner_product_ct_ct_stacked(tbfv.Ciphertext.from_stacked(tctx, v0, ct_ctx),
                                           tbfv.Ciphertext.from_stacked(tctx, v1, ct_ctx), axis=-3)
    for b in range(2):
        _assert_ct(tbfv.Ciphertext.from_stacked(tctx, got.stacked()[b], ct_ctx), want)


def test_scale_once_on_the_partitioned_fold(contexts):
    """The mesh's partitioned fold: each rank's partial tensor product
    scaled by t, the partials summed, then one floor unscaled, gives the
    bits of the single inner product (and of scaling after the sum)."""
    jl, tl, stacked_l = _cts(contexts, 3, seed=51, fill="random")
    jr, tr, stacked_r = _cts(contexts, 3, seed=52, fill="random")
    tctx, ct_ctx = contexts["tctx"], contexts["tctx"].ciphertext_context
    t = tctx.plaintext_modulus

    def part(rows, scale):
        return tbfv.tensor_product(tbfv.Ciphertext.from_stacked(tctx, stacked_l[rows].unsqueeze(0), ct_ctx),
                                   tbfv.Ciphertext.from_stacked(tctx, stacked_r[rows].unsqueeze(0), ct_ctx), -3, scale)

    def fold(scale, drop_scale):
        partials = [part(slice(0, 2), scale), part(slice(2, 3), scale)]  # two ranks' pairs
        ext_ctx = partials[0].polys[0].context
        summed = ma.add_mod(tbfv.stacked_view(partials[0]), tbfv.stacked_view(partials[1]), ext_ctx.q_col)
        acc = tbfv.Ciphertext.from_stacked(tctx, summed, ext_ctx, tbfv.EVAL)
        return tbfv.drop_extended_base(acc, scale=drop_scale).stacked()[0]

    want = jbfv.inner_product_ct_ct(jl, jr)
    for scale, drop_scale in ((t, 1), (1, None)):
        _assert_ct(tbfv.Ciphertext.from_stacked(tctx, fold(scale, drop_scale), ct_ctx), want)


def test_stacked_view_reads_in_place(contexts):
    """A ciphertext made by from_stacked is read in place; one of separate
    tensors is stacked."""
    _, tcts, stacked = _cts(contexts, 2, seed=61, fill="random")
    view = tbfv.stacked_view(tcts[1])
    assert view.data_ptr() == stacked[1].data_ptr() and torch.equal(view, stacked[1])
    loose = tbfv.Ciphertext(contexts["tctx"], [tbfv.PolyRq(p.data.clone(), p.context, p.fmt) for p in tcts[1].polys])
    assert torch.equal(tbfv.stacked_view(loose), stacked[1])


# -- dispatch and the CUDA wrappers -------------------------------------------


def _kernel_counts() -> dict:
    """The BEHZ kernels' launches and plain passes on CUDA tensors, as the
    tracer's registry counts them."""
    return {name: trace.counters[prefix + name] for name in KERNELS for prefix in ("launch.", "plain_on_cuda.")}


def test_dispatch_takes_the_plain_versions_on_the_cpu():
    """On CPU tensors the three passes run their plain versions, launch
    nothing and count no plain pass on CUDA; another device raises."""
    tctx = tbfv.get_bfv_context(tparams.from_predefined(SETS["n8_w32"][0], 32), device="cpu")
    tool = tctx.get_rns_tool(len(tctx.ciphertext_context.moduli))
    ext = tool.q_bsk_context
    before = _kernel_counts()
    x = torch.from_numpy(_rand(tool.input_context.moduli, (2,), 8, seed=71))
    lifted = behz.behz_lift(x, tool)
    assert torch.equal(lifted, behz.behz_lift_plain(x, tool))
    prod = behz.behz_tensor_mac(lifted.unsqueeze(0), lifted.unsqueeze(0), ext, 5, axis=-4)
    assert torch.equal(prod, behz.behz_tensor_mac_plain(lifted.unsqueeze(0), lifted.unsqueeze(0), ext, 5, -4))
    assert torch.equal(behz.behz_floor(prod, tool, 3), behz.behz_floor_plain(prod, tool, 3))
    assert _kernel_counts() == before
    meta = torch.empty((2, 2, 8), dtype=torch.int64, device="meta")
    for call in (lambda: behz.behz_lift(meta, tool), lambda: behz.behz_floor(meta, tool),
                 lambda: behz.behz_tensor_mac(meta, meta, ext)):
        with pytest.raises(ValueError, match="device meta"):
            call()


def test_cuda_wrappers_refuse():
    """The wrappers refuse CPU tensors, odd column counts, more than 8
    moduli, a B_sk that is not L + 1 moduli and an empty MAC, before
    anything is built or launched."""
    tctx = tbfv.get_bfv_context(tparams.from_predefined(SETS["n8_w64"][0], 64), device="cpu")
    tool = tctx.get_rns_tool(2)
    q, bsk = tool.input_context.moduli, tool.bsk_context.moduli
    x = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        bc.behz_lift(x, q, bsk, tool.m_tilde)
    with pytest.raises(ValueError, match="even column count"):
        bc.behz_lift(torch.zeros((2, 7), dtype=torch.int64), q, bsk, tool.m_tilde)
    with pytest.raises(ValueError, match="L \\+ 1"):
        bc.behz_floor(torch.zeros((5, 8), dtype=torch.int64), q, bsk[:-1])
    with pytest.raises(ValueError, match="1 to 8"):
        bc.lift_params(tuple(range(3, 21)), tuple(range(3, 22)), 1 << 16)
    with pytest.raises(ValueError, match="power of two"):
        bc.lift_params(q, bsk, 3 << 16)
    with pytest.raises(ValueError, match="CUDA"):
        bc.behz_tensor_mac(torch.zeros((0, 2, 5, 8), dtype=torch.int64), torch.zeros((0, 2, 5, 8), dtype=torch.int64),
                           q + bsk)


def test_parameter_structs():
    """The launch constants as csrc/behz.cu lays them out (words of one
    size: no padding), Barrett words floor(2^128 / q) and Shoup words
    floor(w 2^64 / q); the floor's constants in 32- or 64-bit words by its
    instance, the scale folded in (behz_floor_constants checks each)."""
    words = ctypes.sizeof(ctypes.c_uint64)
    L, B, E = bc.MAX_L, bc.MAX_L + 1, bc.MAX_EXT
    assert ctypes.sizeof(bc.LiftParams) == words * (3 * L + 2 * L + 3 * B + B * L + L + 4 * B + 2)
    floor_words = L + B + 2 * L + 2 * B + 2 * B * L + 2 * L + 2 * L * L + 4 * L
    assert ctypes.sizeof(bc.FloorParams64) == words * floor_words
    assert ctypes.sizeof(bc.FloorParams32) == 4 * floor_words
    assert ctypes.sizeof(bc.MacParams) == words * 5 * E
    q = (1 << 61) - 1
    p = bc.mac_params((q, 97), WIDE_T)
    assert (p.m[0].r_hi << 64 | p.m[0].r_lo) == (1 << 128) // q
    assert p.s[0] == WIDE_T % q and p.ss[0] == ((WIDE_T % q) << 64) // q and p.s[1] == WIDE_T % 97
    tctx = tbfv.get_bfv_context(tparams.from_predefined(SETS["n8_w32"][0], 32), device="cpu")
    tool = tctx.get_rns_tool(4)
    q_moduli, bsk_moduli = tool.input_context.moduli, tool.bsk_context.moduli
    one, scaled = bc.floor_params(q_moduli, bsk_moduli, 1), bc.floor_params(q_moduli, bsk_moduli, 17)
    assert isinstance(one, bc.FloorParams32)
    assert [scaled.zq[i] for i in range(4)] == [17 * one.zq[i] % q for i, q in enumerate(q_moduli)]
    lift = bc.lift_params(tool.input_context.moduli, tool.bsk_context.moduli, tool.m_tilde)
    assert lift.neg_inv_q_mt == tool.neg_inverse_q_mod_m_tilde and lift.m_tilde == 1 << 16


# every moduli set the served cells floor over: (parameters, scalar bits) -> the floor's instance
SERVED_FLOORS = {("n_4096_logq_27_28_28_logt_5", 32): 32, ("n_4096_logq_27_28_28_logt_17", 32): 32,
                 ("n_8192_logq_3x55_logt_24", 64): 64, ("insecure_n_8_logq_5x18_logt_5", 32): 32,
                 ("insecure_n_8_logq_5x18_logt_5", 64): 64, ("insecure_n_512_logq_4x60_logt_20", 64): 64}


@pytest.mark.parametrize("name,bits", list(SERVED_FLOORS))
def test_floor_instance_by_moduli(name, bits):
    """The floor takes 32-bit words where every modulus of q and B_sk is
    below 2^32 (the w32 sets: q of 27-28 bits, B_sk of 29), else 64; at
    every L a product's tool takes."""
    ctx = tbfv.get_bfv_context(tparams.from_predefined(name, bits), device="cpu")
    for L in range(1, len(ctx.ciphertext_context.moduli) + 1):
        tool = ctx.get_rns_tool(L)
        q_moduli, bsk_moduli = tool.input_context.moduli, tool.bsk_context.moduli
        assert bc.floor_word_bits(q_moduli, bsk_moduli) == SERVED_FLOORS[name, bits]
        assert (max(q_moduli + bsk_moduli) < 1 << 32) == (SERVED_FLOORS[name, bits] == 32)
        p = bc.floor_params(q_moduli, bsk_moduli, 1)
        assert isinstance(p, bc.FloorParams32 if SERVED_FLOORS[name, bits] == 32 else bc.FloorParams64)


def _floor_by_constants(p, y, L):
    """floor(x / q) of one column y (L + L + 1 residues over [q, B_sk]) as
    csrc/behz.cu computes it from the folded constants, in Python
    integers: each output one sum of products by constants, reduced, with
    z_i, zb_j and alpha fully reduced before they feed another modulus."""
    q = [p.q[i] for i in range(L)]
    b = [p.b[j] for j in range(L + 1)]
    msk = b[L]
    z = [y[i] * p.zq[i] % q[i] for i in range(L)]
    zb = [(y[L + j] * p.xc[j] + sum(z[i] * p.zc[j][i] for i in range(L))) % b[j] for j in range(L)]
    alpha = (y[2 * L] * p.xc[L] + sum(z[i] * p.zc[L][i] for i in range(L))
             + sum(zb[j] * p.bc[j] for j in range(L))) % msk
    out = []
    for i in range(L):
        corr = (msk - alpha) * p.b_mod_q[i] if alpha > msk >> 1 else alpha * p.neg_b_mod_q[i]
        out.append((sum(zb[j] * p.bq[i][j] for j in range(L)) + corr) % q[i])
    return out


@pytest.mark.parametrize("scale", [1, 17, WIDE_T])
@pytest.mark.parametrize("label", list(SETS))
def test_behz_floor_constants(label, scale):
    """floor_params' constants: each reduced below its modulus with its
    Shoup word floor(w 2^bits / m) at the instance's word size; and the
    kernel's sums over them (scale, Q^-1, (B/b_j)^-1 and B^-1 folded in)
    equal the plain floor on residues of every kind (zero, q - 1, random:
    alpha on both sides of m_sk / 2)."""
    name, scalar_bits = SETS[label]
    tctx = tbfv.get_bfv_context(tparams.from_predefined(name, scalar_bits), device="cpu")
    tool = tctx.get_rns_tool(len(tctx.ciphertext_context.moduli))
    q_moduli, bsk_moduli = tool.input_context.moduli, tool.bsk_context.moduli
    L, bits = len(q_moduli), bc.floor_word_bits(q_moduli, bsk_moduli)
    p = bc.floor_params(q_moduli, bsk_moduli, scale)

    def shoup_ok(w, ws, m):
        return 0 <= w < m and ws == (w << bits) // m

    for i, q in enumerate(q_moduli):
        assert shoup_ok(p.zq[i], p.zq_s[i], q) and shoup_ok(p.b_mod_q[i], p.b_mod_q_s[i], q)
        assert shoup_ok(p.neg_b_mod_q[i], p.neg_b_mod_q_s[i], q)
        assert all(shoup_ok(p.bq[i][j], p.bq_s[i][j], q) for j in range(L))
    for j, m in enumerate(bsk_moduli):
        assert shoup_ok(p.xc[j], p.xc_s[j], m) and all(shoup_ok(p.zc[j][i], p.zc_s[j][i], m) for i in range(L))
    assert all(shoup_ok(p.bc[j], p.bc_s[j], bsk_moduli[-1]) for j in range(L))
    y = np.concatenate([_rand(q_moduli + bsk_moduli, (), 16, seed=3, fill=f) for f in FILLS], axis=-1)
    want = behz.behz_floor_plain(torch.from_numpy(y), tool, scale).numpy()
    msk, alphas = bsk_moduli[-1], set()
    for k in range(y.shape[-1]):
        column = [int(v) for v in y[:, k]]
        assert _floor_by_constants(p, column, L) == [int(v) for v in want[:, k]]
    # both sides of m_sk / 2 are taken among the random columns
    for k in range(32, 48):
        column = [int(v) for v in y[:, k]]
        z = [column[i] * p.zq[i] % q_moduli[i] for i in range(L)]
        zb = [(column[L + j] * p.xc[j] + sum(z[i] * p.zc[j][i] for i in range(L))) % bsk_moduli[j] for j in range(L)]
        alpha = (column[2 * L] * p.xc[L] + sum(z[i] * p.zc[L][i] for i in range(L))
                 + sum(zb[j] * p.bc[j] for j in range(L))) % msk
        alphas.add(alpha > msk >> 1)
    assert alphas == {True, False}
