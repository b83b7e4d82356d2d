"""The dim-0 MAC kernel (csrc/dim0_mac.cu) and the expansion's leaf
instance of expand_combine (csrc/key_switch.cu) against their plain
PyTorch versions (ops/dim0_mac.py, ops/key_switch.py), on the card, bit for
bit.

Marked `gpu`: each test decides inside itself whether a card exists and
skips where there is none. This file imports only the port (no jax, no
she_tpu), so it also runs on a machine without jax:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_dim0_mac_kernels.py

Moduli of three kinds (27-28-bit, 55-bit and 60-62-bit, as
tests/test_torch_behz_kernels.py), N from 8 to 8192, d0 from 1 to 64 (the
kernel reduces after 16 products near 2^62, so 17 and 64 cross it), zero,
q - 1 and random fills, every tile of the kernel, a strided d0 slice,
permuted and broadcast operands, the widest w64 and PNNS shapes, levels
that write leaves with and without doubling, and the dispatch on CUDA
tensors (the kernels launch, no plain pass runs, the bits equal the CPU's).
"""

import numpy as np
import pytest
import torch

from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv
from she_tpu_torch.core.context import get_poly_context
from she_tpu_torch.core.poly import EVAL, PolyRq
from she_tpu_torch.ops import dim0_mac
from she_tpu_torch.ops import dim0_mac_cuda as dc
from she_tpu_torch.ops import key_switch as ks
from she_tpu_torch.ops import key_switch_cuda as kc
from she_tpu_torch.pir import serving
from she_tpu_torch.pnns import serving as pnns_serving
from she_tpu_torch.utils import nt

MODULI = {
    "w32": ((1 << 27) - 40959, (1 << 28) - 65535, (1 << 28) - 73727),
    "w64": tuple(nt.generate_primes([55] * 3, preferring_small=False, ntt_degree=8192)),
    "w62": tuple(nt.generate_primes([62, 60, 61], preferring_small=False, ntt_degree=8192)),
}
DEGREES = [8, 512, 4096, 8192]
FILLS = ["zero", "max", "random"]


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rows(moduli, batch, degree, seed, fill="random"):
    rng = np.random.default_rng(seed)
    out = np.zeros(tuple(batch) + (len(moduli), degree), dtype=np.int64)
    for i, q in enumerate(moduli):
        if fill == "random":
            out[..., i, :] = rng.integers(0, q, size=tuple(batch) + (degree,), dtype=np.int64)
        elif fill == "max":
            out[..., i, :] = q - 1
    return torch.from_numpy(out).cuda()


def _device_rows(moduli, batch, degree, seed):
    """Uniform residues drawn on the card: the widest shapes are gigabytes."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return torch.stack([torch.randint(0, q, tuple(batch) + (degree,), generator=g, device="cuda") for q in moduli],
                       dim=-2)


def _ctx(moduli, degree):
    return get_poly_context(degree, tuple(moduli), 64, torch.device("cuda"))


def _equal(a, b, moduli, degree):
    before = dc.launches["dim0_mac"]
    got = dc.dim0_mac(a, b, moduli)
    assert dc.launches["dim0_mac"] == before + 1
    want = dim0_mac.dim0_mac_plain(a, b, _ctx(moduli, degree))
    assert torch.equal(got, want), (tuple(a.shape), tuple(a.stride()), tuple(b.shape), tuple(b.stride()))


@pytest.mark.gpu
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("route", list(MODULI))
def test_dim0_mac(route, degree, fill):
    """[C, d0] x [d0, P], the database a strided d0 slice of a wider
    chunk, at every depth of a lazy schedule and every kernel tile."""
    _card()
    moduli = MODULI[route]
    shapes = [(1, 1, 1), (4, 17, 6), (9, 64, 3), (11, 16, 32), (2, 15, 40)] if degree <= 512 else [(4, 17, 6), (3, 33, 4)]
    for i, (C, d0, P) in enumerate(shapes):
        chunk = _rows(moduli, (C, d0 + 3), degree, seed=degree + i, fill=fill)
        query = _rows(moduli, (d0, P), degree, seed=2 * degree + i, fill="max" if fill == "max" else "random")
        _equal(chunk[:, 2:d0 + 2], query, moduli, degree)


@pytest.mark.gpu
@pytest.mark.parametrize("m1,m2", [(1, 1), (1, 16), (2, 9), (3, 5), (4, 4), (8, 2), (12, 3), (5, 33)])
def test_every_tile(m1, m2):
    """The wrapper's tile and every built tile, at shapes that leave
    partial tiles at both edges."""
    _card()
    moduli = MODULI["w62"]
    a, b = _rows(moduli, (m1, 18), 512, seed=m1), _rows(moduli, (18, m2), 512, seed=m2)
    _equal(a, b, moduli, 512)
    assert dc.tile(m1, m2) in dc.TILES
    want = dim0_mac.dim0_mac_plain(a, b, _ctx(moduli, 512))
    for tile_shape in dc.TILES:
        assert torch.equal(dc.dim0_mac(a, b, moduli, tile_shape), want), tile_shape


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(MODULI))
def test_permuted_and_broadcast_operands(route):
    """PNNS's diagonals as a [G, R, J] view of [G, J, R]; a broadcast
    (stride 0) row of A and column of B; a transposed B."""
    _card()
    moduli = MODULI[route]
    db = _rows(moduli, (3, 12, 2), 512, seed=1)
    rot = _rows(moduli, (12, 4, 2), 512, seed=2)
    _equal(db.permute(0, 2, 1, 3, 4), rot, moduli, 512)
    a = _rows(moduli, (1, 7), 512, seed=3).expand(5, 7, len(moduli), 512)
    b = _rows(moduli, (7, 1), 512, seed=4).expand(7, 6, len(moduli), 512)
    _equal(a, b, moduli, 512)
    _equal(_rows(moduli, (2, 7), 512, seed=5), _rows(moduli, (3, 7), 512, seed=6).transpose(0, 1), moduli, 512)


# the widest served launches: (A shape before any view, B shape, params, bits)
SERVED = {"w64": ((4, 11), (11, 256), "n_8192_logq_3x55_logt_24", 64),
          "pnns_w32": ((11, 12, 1), (12, 16, 2), "n_4096_logq_27_28_28_logt_17", 32),
          "pnns_w64": ((11, 12, 1), (12, 16, 2), "n_4096_logq_27_28_28_logt_17", 64)}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(SERVED))
def test_widest_served_mac(cell):
    """The w64 cell's [4, 11] x [11, 256] and PNNS's [11, 12, 1] x
    [12, 16, 2] through the functions that serve them."""
    _card()
    a_batch, b_batch, params, bits = SERVED[cell]
    ep = tparams.from_predefined(params, scalar_bits=bits)
    ct_ctx = bfv.get_bfv_context(ep, device="cuda").ciphertext_context
    a = _device_rows(ct_ctx.moduli, a_batch, ct_ctx.degree, seed=7)
    b = _device_rows(ct_ctx.moduli, b_batch, ct_ctx.degree, seed=8)
    plain = dict(dim0_mac.plain_calls_on_cuda)
    if cell == "w64":
        got = serving.dim0_inner_products(a, b, ct_ctx)
        want_a = a
    else:
        got = pnns_serving.bsgs_inner_products(a, b, ct_ctx)
        want_a = a.permute(0, 2, 1, 3, 4)
    assert dim0_mac.plain_calls_on_cuda == plain
    assert torch.equal(got, dim0_mac.dim0_mac_plain(want_a, b, ct_ctx))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [32, 64])
def test_inner_product_ct_pt_on_the_card_equals_the_cpu(bits):
    """One launch a component, no plain MAC on CUDA tensors, the CPU's
    bits."""
    _card()
    ep = tparams.from_predefined("insecure_n_512_logq_4x60_logt_20" if bits == 64 else "insecure_n_8_logq_5x18_logt_5",
                                 scalar_bits=bits)
    out = {}
    for device in ("cpu", "cuda"):
        ctx = bfv.get_bfv_context(ep, device=device)
        ct_ctx = ctx.ciphertext_context
        cts = _rows(ct_ctx.moduli, (5, 2), ctx.degree, seed=9).to(device)
        pts = _rows(ct_ctx.moduli, (5,), ctx.degree, seed=10).to(device)
        tcts = [bfv.Ciphertext.from_stacked(ctx, c, ct_ctx, EVAL) for c in cts]
        tpts = [bfv.Plaintext(ctx, PolyRq(p, ct_ctx, EVAL)) if i % 2 == 0 else None for i, p in enumerate(pts)]
        before, plain = dc.launches["dim0_mac"], dict(dim0_mac.plain_calls_on_cuda)
        out[device] = bfv.inner_product_ct_pt(tcts, tpts).stacked().cpu()
        assert dc.launches["dim0_mac"] - before == (2 if device == "cuda" else 0)
        assert dim0_mac.plain_calls_on_cuda == plain
    assert torch.equal(out["cuda"], out["cpu"])


# -- the expansion's leaves -----------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("route", list(MODULI))
def test_expand_leaves(route, degree, fill):
    """A level whose children are pool slots and output positions, with
    and without doubled leaves, at several shifts."""
    _card()
    moduli = MODULI[route][:2]
    ctx = _ctx(moduli, degree)
    pool = _rows(moduli, (6, 2, 2), degree, seed=degree, fill=fill)
    update = _rows(moduli, (3, 2, 2), degree, seed=degree + 1, fill=fill)
    out = _rows(moduli, (5, 2, 2), degree, seed=degree + 2, fill=fill)
    parents, child0, child1 = (torch.tensor(v, device="cuda") for v in ([0, 1, 2], [3, -1, -3], [-2, 4, -5]))
    masks = [None, torch.tensor([[False, True, True], [True, False, False]], device="cuda")]
    for shift in sorted({1, 2, degree // 4, degree // 2} - {0}):
        for doubled in masks:
            got_pool, got_out, want_pool, want_out = pool.clone(), out.clone(), pool.clone(), out.clone()
            before = kc.launches["expand_leaves"]
            kc.expand_combine(got_pool, update, parents, child0, child1, shift, moduli, got_out, doubled)
            assert kc.launches["expand_leaves"] == before + 1
            ks.expand_combine_plain(want_pool, update, parents, child0, child1, shift, ctx, want_out, doubled)
            assert torch.equal(got_pool, want_pool) and torch.equal(got_out, want_out), (shift, doubled is None)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["keyword", "w64"])
def test_widest_served_leaf_level(cell):
    """The keyword cell's last level (128 nodes, 256 leaves, 128 queries,
    N = 4096) and w64's level 3 (15 outputs: leaves and inner nodes, one
    doubled leaf) through the plan the server uses."""
    _card()
    outputs, queries, params, bits = {"keyword": (256, 128, "n_4096_logq_27_28_28_logt_5", 32),
                                      "w64": (15, 128, "n_8192_logq_3x55_logt_24", 64)}[cell]
    ct_ctx = bfv.get_bfv_context(tparams.from_predefined(params, scalar_bits=bits), device="cuda").ciphertext_context
    inner, levels = serving._plan_on_device(outputs, torch.device("cuda"))
    log_step, parents, child0, child1, writes, doubled = [lv for lv in levels if lv[4]][0]
    shape = (queries, 2, len(ct_ctx.moduli), ct_ctx.degree)
    pool = _device_rows(ct_ctx.moduli, (inner,) + shape[:2], ct_ctx.degree, seed=11)
    update = _device_rows(ct_ctx.moduli, (parents.numel(),) + shape[:2], ct_ctx.degree, seed=12)
    got_pool, want_pool = pool, pool.clone()
    got_out = torch.zeros((outputs,) + shape, dtype=torch.int64, device="cuda")
    want_out = got_out.clone()
    kc.expand_combine(got_pool, update, parents, child0, child1, 1 << (log_step - 1), ct_ctx.moduli, got_out, doubled)
    ks.expand_combine_plain(want_pool, update, parents, child0, child1, 1 << (log_step - 1), ct_ctx, want_out, doubled)
    assert torch.equal(got_pool, want_pool) and torch.equal(got_out, want_out)


@pytest.mark.gpu
@pytest.mark.parametrize("output_count", [1, 2, 3, 15, 64, 100])
def test_expansion_on_the_card_equals_the_cpu(output_count):
    """expand_batched with random keys at insecure_n_8_logq_5x18_logt_5
    (several query ciphertexts above 8 outputs): on the card every level
    launches expand_combine or its leaf instance, no plain pass runs, and
    the bits equal the CPU's."""
    _card()
    from she_tpu_torch.bfv import keys
    from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr

    from she_tpu_torch import convert

    ep = tparams.from_predefined("insecure_n_8_logq_5x18_logt_5", scalar_bits=64)
    cpu_ctx = bfv.get_bfv_context(ep, device="cpu")
    sk = bfv.generate_secret_key(cpu_ctx, nist_aes128_ctr(b"s" * 32))
    # the key's ciphertexts draw fresh seeds: made once, carried to the card
    galois, _ = convert.evaluation_key_to_limbs(
        keys.generate_evaluation_key(cpu_ctx, keys.EvaluationKeyConfig((9, 5, 3)), sk, nist_aes128_ctr(b"k" * 32)))
    out = {}
    for device in ("cpu", "cuda"):
        ctx = bfv.get_bfv_context(ep, device=device)
        ek = convert.evaluation_key_from_limbs(ctx, galois, None)
        ct_ctx = ctx.ciphertext_context
        stacked = [_rows(ct_ctx.moduli, (3, 2), 8, seed=20 + i).to(device) for i in range(-(-output_count // 8))]
        serving.reset_levels_run()
        before, plain = dict(kc.launches), dict(ks.plain_calls_on_cuda)
        out[device] = serving.expand_batched(stacked, output_count, ek, ctx).cpu()
        launched = {k: kc.launches[k] - before[k] for k in ("expand_combine", "expand_leaves")}
        if device == "cuda":
            assert launched == {"expand_combine": serving.levels_run["expansion_level"] - serving.levels_run["leaf_level"],
                                "expand_leaves": serving.levels_run["leaf_level"]}
            assert ks.plain_calls_on_cuda == plain
    assert torch.equal(out["cuda"], out["cpu"])
