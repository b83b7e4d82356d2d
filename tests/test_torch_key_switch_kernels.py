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
index, and the widest shapes the keyword and w64 cells launch.
"""

import numpy as np
import pytest
import torch

from she_tpu_torch.core.context import get_poly_context
from she_tpu_torch.ops import key_switch as ks
from she_tpu_torch.ops import key_switch_cuda as kc
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
        before = kc.launches["ks_digits"]
        got = kc.ks_digits(c1, moduli, element)
        assert kc.launches["ks_digits"] == before + 1
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
    before, plain = dict(kc.launches), dict(ks.plain_calls_on_cuda)
    c = _rows(moduli[:-1], (2, 2), 64, seed=41)
    digits = ks.ks_digits(c[:, 1], ctx, 3)
    mac = ks.ks_mac(digits, _rows(moduli, (2, 2), 64, seed=42), ctx)
    out = ks.ks_finish(mac, ctx, c[:, 0], None, 3)
    pool = torch.cat([c, out])
    idx = torch.tensor([0, 2, 3], device="cuda")
    ks.expand_combine(pool, out[:1], idx[:1], idx[1:2], idx[2:], 4, _ctx(moduli[:-1], 64))
    leaves = torch.zeros((1,) + tuple(pool.shape[1:]), dtype=torch.int64, device="cuda")
    ks.expand_combine(pool, out[:1], idx[:1], idx[1:2], -idx[:1] - 1, 4, _ctx(moduli[:-1], 64), leaves)
    assert {k: kc.launches[k] - before[k] for k in kc.launches} == dict.fromkeys(kc.launches, 1)
    assert ks.plain_calls_on_cuda == plain
