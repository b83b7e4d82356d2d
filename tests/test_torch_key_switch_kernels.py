"""The key-switch kernels (csrc/key_switch.cu) against their plain PyTorch
versions (ops/key_switch.py), on the card, bit for bit.

Marked `gpu`: each test decides inside itself whether a card exists and
skips where there is none. This file imports only the port (no jax, no
she_tpu), so it also runs on a machine without jax:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_key_switch_kernels.py

Moduli of three kinds: 28-bit (the w32 sets), 55-bit (the w64 set) and
60-62-bit ones up to 2^62 - 1 in an order where q_j > q_i for some j < i
(the negate-then-reduce order of the Galois digits); N from 8 to 8192,
L_t from 1 to 4 (and 17, where a MAC sum passes 2^128 unless reduced
part-way), zero, q - 1 and random fills, several Galois elements, c0 and
c1 as strided views of a stacked ciphertext and through the slot pool's
index, and the widest shapes the keyword and w64 cells launch. The mod
switch from 2, 3 and 5 moduli down to every target, at the residues'
edges (0, q - 1 and the last modulus's half), and at every shape a path
mod-switches at. The fused route's pair (ks_digits_ntt_mac,
ks_intt_finish) against the split chain's plain versions at 28-bit moduli
(in an order with q_j > q_i), N from 8 to 4096 and L_t from 1 to the
route's limit, at the keyword cell's widest level, and a whole keyword
query tree expanded by both routes.
"""

import numpy as np
import pytest
import torch

from she_tpu_torch import trace
from she_tpu_torch.core.context import get_poly_context
from she_tpu_torch.ops import key_switch as ks
from she_tpu_torch.ops import key_switch_cuda as kc
from she_tpu_torch.ops import ntt
from she_tpu_torch.utils import nt

MODULI = {
    # 5 moduli each: the first L_t and the last (q_ks) of a case
    "w32": ((1 << 27) - 40959, (1 << 28) - 65535, (1 << 28) - 73727, (1 << 28) - 83967, (1 << 28) - 114687),
    "w64": tuple(nt.generate_primes([55] * 5, preferring_small=False, ntt_degree=8192)),
    "w62": tuple(nt.generate_primes([62, 60, 61, 62, 62], preferring_small=False, ntt_degree=8192))[:4]
    + ((1 << 62) - 57,),
}
DEGREES = [8, 512, 4096, 8192]
FILLS = ["zero", "max", "random"]
KS_KERNELS = ("ks_digits", "ks_mac", "ks_finish", "expand_combine", "expand_leaves", "mod_switch")


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


def _ks_moduli(route, l_t):
    base = MODULI[route]
    return base[:l_t] + (base[-1],)


def _ctx(moduli, degree):
    return get_poly_context(degree, tuple(moduli), 64, torch.device("cuda"))


def _elements(degree):
    return [None, 3, 2 * degree - 1, pow(5, 3, 2 * degree)] if degree > 8 else [None, 3, 15]


@pytest.mark.gpu
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("l_t", [1, 2, 3, 4])
@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("route", list(MODULI))
def test_ks_digits(route, degree, l_t, fill):
    _card()
    moduli = _ks_moduli(route, l_t)
    stacked = _rows(moduli[:-1], (3, 2), degree, seed=degree + l_t, fill=fill)  # c1 a strided view
    c1 = stacked[:, 1]
    for element in _elements(degree):
        before = trace.counters["launch.ks_digits"]
        got = kc.ks_digits(c1, moduli, element)
        assert trace.counters["launch.ks_digits"] == before + 1
        assert torch.equal(got, ks.ks_digits_plain(c1, _ctx(moduli, degree), element)), element


@pytest.mark.gpu
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("l_t", [1, 2, 3, 4])
@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("route", list(MODULI))
def test_ks_mac(route, degree, l_t, fill):
    _card()
    moduli = _ks_moduli(route, l_t)
    fwd = _rows(moduli, (3, l_t), degree, seed=7 * degree + l_t, fill=fill)
    key = _rows(moduli, (l_t, 2), degree, seed=11 * degree + l_t, fill="max" if fill == "max" else "random")
    got = kc.ks_mac(fwd, key, moduli)
    assert torch.equal(got, ks.ks_mac_plain(fwd, key, _ctx(moduli, degree)))


@pytest.mark.gpu
@pytest.mark.parametrize("fill", FILLS)
def test_ks_mac_seventeen_digits(fill):
    """17 products of residues below 2^62 pass 2^128: reduced part-way."""
    _card()
    moduli = tuple(nt.generate_primes([62] * 18, preferring_small=False, ntt_degree=8192))
    fwd = _rows(moduli, (2, 17), 64, seed=17, fill=fill)
    key = _rows(moduli, (17, 2), 64, seed=18, fill=fill)
    assert torch.equal(kc.ks_mac(fwd, key, moduli), ks.ks_mac_plain(fwd, key, _ctx(moduli, 64)))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["update", "galois", "relinearize"])
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("l_t", [1, 2, 3, 4])
@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("route", list(MODULI))
def test_ks_finish(route, degree, l_t, fill, mode):
    _card()
    moduli = _ks_moduli(route, l_t)
    ctx = _ctx(moduli, degree)
    inv = _rows(moduli, (3, 2), degree, seed=13 * degree + l_t, fill=fill)
    stacked = _rows(moduli[:-1], (3, 3), degree, seed=19 * degree + l_t, fill=fill)
    c0 = stacked[:, 0] if mode in ("galois", "relinearize") else None
    c1 = stacked[:, 1] if mode == "relinearize" else None
    for element in (_elements(degree)[1:] if mode == "galois" else [None]):
        got = kc.ks_finish(inv, moduli, c0, c1, element)
        assert torch.equal(got, ks.ks_finish_plain(inv, ctx, c0, c1, element)), element


@pytest.mark.gpu
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("l_ct", [1, 2, 4])
@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("route", list(MODULI))
def test_expand_combine(route, degree, l_ct, fill):
    _card()
    moduli = MODULI[route][:l_ct]
    ctx = _ctx(moduli, degree)
    pool = _rows(moduli, (9, 2, 2), degree, seed=23 * degree + l_ct, fill=fill)
    update = _rows(moduli, (3, 2, 2), degree, seed=29 * degree + l_ct, fill=fill)
    parents, child0, child1 = (torch.tensor(v, device="cuda") for v in ([0, 4, 7], [1, 5, 8], [2, 6, 3]))
    for shift in sorted({1, 2, degree // 4, degree // 2} - {0}):
        got, want = pool.clone(), pool.clone()
        kc.expand_combine(got, update, parents, child0, child1, shift, moduli)
        ks.expand_combine_plain(want, update, parents, child0, child1, shift, ctx)
        assert torch.equal(got, want), shift


# the widest served launches: (ciphertext moduli count, nodes, queries, degree, route)
SERVED = {"keyword": (2, 128, 128, 4096, "w32"), "w64": (2, 8, 128, 8192, "w64")}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(SERVED))
def test_widest_served_level(cell):
    """One expansion level at the cell's widest: the parents read from a
    slot pool through their indices, the Galois element N/2^k + 1."""
    _card()
    l_t, nodes, queries, degree, route = SERVED[cell]
    moduli = _ks_moduli(route, l_t)
    ctx, ct_ctx = _ctx(moduli, degree), _ctx(moduli[:-1], degree)
    slots = 2 * nodes + 1 + nodes
    pool = _rows(moduli[:-1], (slots, queries, 2), degree, seed=31)
    order = torch.randperm(slots, generator=torch.Generator().manual_seed(0)).cuda()
    parents, child0, child1 = order[:nodes], order[nodes: 2 * nodes], order[2 * nodes: 3 * nodes]
    element = degree // nodes + 1
    digits = kc.ks_digits(pool[:, :, 1], moduli, element, parents)
    assert torch.equal(digits, ks.ks_digits_plain(pool[:, :, 1], ctx, element, parents))
    key = _rows(moduli, (l_t, 2), degree, seed=32)
    mac = kc.ks_mac(digits, key, moduli)
    assert torch.equal(mac, ks.ks_mac_plain(digits, key, ctx))
    del digits
    out = kc.ks_finish(mac, moduli, pool[:, :, 0], None, element, parents)
    assert torch.equal(out, ks.ks_finish_plain(mac, ctx, pool[:, :, 0], None, element, parents))
    del mac
    got, want = pool.clone(), pool.clone()
    kc.expand_combine(got, out, parents, child0, child1, degree // (2 * nodes) or 1, moduli[:-1])
    ks.expand_combine_plain(want, out, parents, child0, child1, degree // (2 * nodes) or 1, ct_ctx)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_dispatch_takes_the_kernels_on_cuda():
    """On CUDA tensors the four functions of ops/key_switch.py launch the
    kernels (expand_combine's leaf instance where a level writes leaves)
    and run no plain pass."""
    _card()
    moduli = _ks_moduli("w32", 2)
    ctx = _ctx(moduli, 64)
    before = dict(trace.counters)
    c = _rows(moduli[:-1], (2, 2), 64, seed=41)
    digits = ks.ks_digits(c[:, 1], ctx, 3)
    mac = ks.ks_mac(digits, _rows(moduli, (2, 2), 64, seed=42), ctx)
    out = ks.ks_finish(mac, ctx, c[:, 0], None, 3)
    pool = torch.cat([c, out])
    idx = torch.tensor([0, 2, 3], device="cuda")
    ks.expand_combine(pool, out[:1], idx[:1], idx[1:2], idx[2:], 4, _ctx(moduli[:-1], 64))
    leaves = torch.zeros((1,) + tuple(pool.shape[1:]), dtype=torch.int64, device="cuda")
    ks.expand_combine(pool, out[:1], idx[:1], idx[1:2], -idx[:1] - 1, 4, _ctx(moduli[:-1], 64), leaves)
    ks.mod_switch(out, _ctx(moduli[:-1], 64), 1)
    assert {k: trace.counters["launch." + k] - before.get("launch." + k, 0) for k in KS_KERNELS} == dict.fromkeys(
        KS_KERNELS, 1)
    assert {k: trace.counters["plain_on_cuda." + k] - before.get("plain_on_cuda." + k, 0) for k in KS_KERNELS} == (
        dict.fromkeys(KS_KERNELS, 0))


# -- the mod switch ------------------------------------------------------------


def _switch_rows(moduli, batch, degree, seed, fill):
    """Residues of a mod switch's input; `edge`: each one of 0, q_i - 1 and
    floor(q_last / 2) mod q_i and the next value (the rounding's edges)."""
    if fill != "edge":
        return _rows(moduli, batch, degree, seed, fill)
    rng = np.random.default_rng(seed)
    half = moduli[-1] // 2
    out = np.zeros(tuple(batch) + (len(moduli), degree), dtype=np.int64)
    for i, q in enumerate(moduli):
        out[..., i, :] = rng.choice([0, q - 1, half % q, (half + 1) % q], size=tuple(batch) + (degree,))
    return torch.from_numpy(out).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("fill", FILLS + ["edge"])
@pytest.mark.parametrize("count", [2, 3, 5])
@pytest.mark.parametrize("degree", DEGREES)
@pytest.mark.parametrize("route", list(MODULI))
def test_mod_switch(route, degree, count, fill):
    """Every target from count - 1 moduli down to 1, the input a strided
    view of a stacked batch of ciphertexts ([3, 2, L, N] read as
    [2, 3, L, N])."""
    _card()
    moduli = MODULI[route][:count]
    ctx = _ctx(moduli, degree)
    x = _switch_rows(moduli, (3, 2), degree, seed=37 * degree + count, fill=fill).transpose(0, 1)
    for target in range(1, count):
        before = trace.counters["launch.mod_switch"]
        got = kc.mod_switch(x, moduli, target)
        assert trace.counters["launch.mod_switch"] == before + 1
        assert torch.equal(got, ks.mod_switch_plain(x, ctx, target)), target


# every shape a path mod-switches at: (batch, ciphertext moduli, degree,
# route); the batch's last axis is a ciphertext's 2 polys
MOD_SWITCH_SERVED = {
    "w64": ((128, 2), 2, 8192, "w64"),
    "w32 and keyword": ((128, 2), 2, 4096, "w32"),
    "pnns": ((1, 16, 2), 2, 4096, "w32"),
    "per-query": ((2,), 2, 4096, "w32"),
    "keyword_large": ((32, 2), 2, 4096, "w32"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fill", ["random", "edge", "max", "zero"])
@pytest.mark.parametrize("cell", list(MOD_SWITCH_SERVED))
def test_mod_switch_served_shapes(cell, fill):
    """Each served shape read in place as the batched server reads it (its
    columns' [B, 1, 2, L, N] at axis 1), and through bfv's dispatch."""
    _card()
    batch, count, degree, route = MOD_SWITCH_SERVED[cell]
    moduli = MODULI[route][:count]
    ctx = _ctx(moduli, degree)
    columns = _switch_rows(moduli, batch[:-1] + (1, 2), degree, seed=degree + len(batch), fill=fill)
    x = columns.select(-4, 0)
    assert torch.equal(kc.mod_switch(x, moduli, 1), ks.mod_switch_plain(x, ctx, 1))
    assert torch.equal(ks.mod_switch(x, ctx, 1), ks.mod_switch_plain(x.cpu(), get_poly_context(
        degree, moduli, 64, torch.device("cpu")), 1).cuda())


# -- the fused route -------------------------------------------------------------

# 28-bit moduli, q_0 > q_1: the first L_t and the last (q_ks) of a case;
# up to FUSED_MAX_MODULI of them
FUSED = tuple(nt.generate_primes([28, 27, 28, 28, 28, 28, 28, 28], preferring_small=False, ntt_degree=8192))
FUSED_DEGREES = [8, 16, 512, 2048, 4096]
FUSED_L_T = list(range(1, kc.FUSED_MAX_MODULI))


def _fused_moduli(l_t):
    return FUSED[:l_t] + (FUSED[-1],)


@pytest.mark.gpu
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("l_t", FUSED_L_T)
@pytest.mark.parametrize("degree", FUSED_DEGREES)
def test_ks_digits_ntt_mac(degree, l_t, fill):
    """Against ks_digits -> forward NTT -> ks_mac (plain), c1 a strided
    view, then read through a slot pool's index, for each element."""
    _card()
    moduli = _fused_moduli(l_t)
    ctx = _ctx(moduli, degree)
    stacked = _rows(moduli[:-1], (5, 2), degree, seed=degree + l_t, fill=fill)
    c1 = stacked[:, 1]
    key = _rows(moduli, (l_t, 2), degree, seed=3 * degree + l_t, fill="max" if fill == "max" else "random").int()
    index = torch.tensor([4, 0, 2], device="cuda")
    for element in _elements(degree):
        before = trace.counters["launch.ks_digits_ntt_mac"]
        got = kc.ks_digits_ntt_mac(c1, key, moduli, ctx.ntt_tables, element)
        assert trace.counters["launch.ks_digits_ntt_mac"] == before + 1
        assert torch.equal(got, ks.ks_digits_ntt_mac_plain(c1, key, ctx, element)), element
        got = kc.ks_digits_ntt_mac(c1, key, moduli, ctx.ntt_tables, element, index)
        assert torch.equal(got, ks.ks_digits_ntt_mac_plain(c1, key, ctx, element, index)), element


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["update", "galois", "relinearize"])
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("l_t", FUSED_L_T)
@pytest.mark.parametrize("degree", FUSED_DEGREES)
def test_ks_intt_finish(degree, l_t, fill, mode):
    """Against inverse NTT -> ks_finish (plain), c0 and c1 strided views of
    a stacked ciphertext, then read through a slot pool's index."""
    _card()
    moduli = _fused_moduli(l_t)
    ctx = _ctx(moduli, degree)
    products = _rows(moduli, (3, 2), degree, seed=5 * degree + l_t, fill=fill).int()
    stacked = _rows(moduli[:-1], (4, 3), degree, seed=7 * degree + l_t, fill=fill)
    for index in (None, torch.tensor([3, 1, 0], device="cuda")):
        base = stacked if index is not None else stacked[:3]
        c0 = base[:, 0] if mode in ("galois", "relinearize") else None
        c1 = base[:, 2] if mode == "relinearize" else None
        idx = index if c0 is not None else None
        for element in (_elements(degree)[1:] if mode == "galois" else [None]):
            before = trace.counters["launch.ks_intt_finish"]
            got = kc.ks_intt_finish(products, moduli, ctx.ntt_tables, c0, c1, element, idx)
            assert trace.counters["launch.ks_intt_finish"] == before + 1
            assert torch.equal(got, ks.ks_intt_finish_plain(products, ctx, c0, c1, element, idx)), element


@pytest.mark.gpu
def test_fused_widest_served_level():
    """The keyword cell's widest level, [128, 128] parents by queries at
    N = 4096 read from a slot pool through their indices, the Galois
    element N/128 + 1: the fused pair against the plain chain."""
    _card()
    l_t, nodes, queries, degree, _ = SERVED["keyword"]
    moduli = _fused_moduli(l_t)
    ctx = _ctx(moduli, degree)
    slots = 2 * nodes + 1
    pool = _rows(moduli[:-1], (slots, queries, 2), degree, seed=33)
    parents = torch.randperm(slots, generator=torch.Generator().manual_seed(1))[:nodes].cuda()
    element = degree // nodes + 1
    key = _rows(moduli, (l_t, 2), degree, seed=34)
    products = kc.ks_digits_ntt_mac(pool[:, :, 1], key.int(), moduli, ctx.ntt_tables, element, parents)
    digits = ks.ks_digits_plain(pool[:, :, 1], ctx, element, parents)
    want = ks.ks_mac_plain(ntt.forward_ntt_plain(digits, ctx.ntt_tables), key, ctx)
    del digits
    assert torch.equal(products.long(), want)
    got = kc.ks_intt_finish(products, moduli, ctx.ntt_tables, pool[:, :, 0], None, element, parents)
    want = ks.ks_finish_plain(ntt.inverse_ntt_plain(want, ctx.ntt_tables), ctx, pool[:, :, 0], None, element, parents)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_dispatch_takes_the_fused_pair_on_cuda():
    """On CUDA tensors ks_digits_ntt_mac and ks_intt_finish of
    ops/key_switch.py launch their kernels and run no plain pass."""
    _card()
    moduli = _fused_moduli(2)
    ctx = _ctx(moduli, 64)
    before = dict(trace.counters)
    c = _rows(moduli[:-1], (2, 2), 64, seed=43)
    products = ks.ks_digits_ntt_mac(c[:, 1], _rows(moduli, (2, 2), 64, seed=44).int(), ctx, 3)
    ks.ks_intt_finish(products, ctx, c[:, 0], None, 3)
    names = ("ks_digits_ntt_mac", "ks_intt_finish")
    assert {k: trace.counters["launch." + k] - before.get("launch." + k, 0) for k in names} == dict.fromkeys(names, 1)
    plain = names + KS_KERNELS + ("ntt_forward", "ntt_inverse")
    assert not any(trace.counters["plain_on_cuda." + k] - before.get("plain_on_cuda." + k, 0) for k in plain)


@pytest.mark.gpu
def test_keyword_query_tree_by_both_routes():
    """A whole keyword query tree (n_4096_logq_27_28_28_logt_5, 256
    outputs, 8 levels, a batch of 4 queries) expanded on the card by the
    fused route and by the split chain: the same bytes."""
    _card()
    from she_tpu_torch import params as tparams
    from she_tpu_torch.bfv import bfv, keys
    from she_tpu_torch.pir import expansion
    from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr

    context = bfv.get_bfv_context(tparams.from_predefined("n_4096_logq_27_28_28_logt_5", 32), device="cuda")
    degree, outputs = context.degree, 256
    sk = bfv.generate_secret_key(context, nist_aes128_ctr(b"s" * 32))
    elements = tuple((degree >> k) + 1 for k in range(8))
    ek = keys.generate_evaluation_key(context, keys.EvaluationKeyConfig(elements), sk, nist_aes128_ctr(b"k" * 32))
    cts = [bfv.encrypt(bfv.encode(context, [q + 1, 0, 3]), sk, seed=bytes([q + 1]) * 32,
                       err_rng=nist_aes128_ctr(bytes([q + 9]) * 32)) for q in range(4)]
    stacked = torch.stack([ct.stacked() for ct in cts])
    before = dict(trace.counters)
    fused = expansion.expand_stacked(stacked, outputs, ek, context)
    ran = {k: trace.counters[k] - before.get(k, 0) for k in ("key_switch", "key_switch.fused", "key_switch.split")}
    assert ran["key_switch"] == ran["key_switch.fused"] > 0 and ran["key_switch.split"] == 0
    route = ks.fused_route
    try:
        ks.fused_route = lambda ks_ctx: False
        split = expansion.expand_stacked(stacked, outputs, ek, context)
    finally:
        ks.fused_route = route
    assert torch.equal(fused, split)
