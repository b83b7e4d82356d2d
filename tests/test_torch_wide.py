"""The port's exact wide arithmetic (ops/wide.py) and the width routing of
ops/modarith.py, against Python big ints and she_tpu's W64 limb words.

Every comparison is exact integer equality (tolerance 0).
"""

import numpy as np
import pytest
import torch

from she_tpu.ops import word
from she_tpu.ops.word import W64
from she_tpu_torch.core import rns
from she_tpu_torch.ops import modarith as ma
from she_tpu_torch.ops import wide

GAMMA = (1 << 62) - 40797
CT_55 = (36028797018652673, 36028797017571329)  # n_8192_logq_3x55_logt_24
BSK_61 = rns.bsk_prime_pool(8192, 2, 64)
WIDE_MODULI = [
    (1 << 31) + 11,  # in [2^31, 2^32)
    (1 << 32) - 5,
    *CT_55,
    576460752303436801,  # 59/60-bit (insecure_n_512_logq_4x60_logt_20)
    1152921504606830593,  # 60-bit (insecure_n_16_logq_60_logt_15)
    BSK_61[0],  # a 61-bit B_sk prime
    GAMMA,
]
RNG = np.random.default_rng(2024)


def _residues(q, n=512):
    vals = [int(v) % q for v in RNG.integers(0, 1 << 62, size=n, dtype=np.int64)]
    vals[:4] = [0, 1, q - 1, q - 2]
    return vals


def _t(vals):
    return torch.tensor(vals, dtype=torch.int64)


def _col(values):
    return wide.tag(torch.tensor([[v] for v in values], dtype=torch.int64), values)


def _w64(vals):
    return word.as_word(word.pack(np.array(vals, dtype=object), 2))


def _unword(w):
    return [int(v) for v in word.unpack(np.stack([np.asarray(x) for x in w]))]


def test_bsk_primes_are_61_bits():
    assert [p.bit_length() for p in BSK_61] == [61, 61, 61]


@pytest.mark.parametrize("q", WIDE_MODULI)
def test_mul_mod_matches_big_ints_and_she_tpu(q):
    a, b = _residues(q), _residues(q)[::-1]
    want = [x * y % q for x, y in zip(a, b)]
    assert wide.mul_mod(_t(a), _t(b), q).tolist() == want
    # the routed entry point, with the modulus as a tagged column
    assert ma.mul_mod(_t(a)[None], _t(b)[None], _col([q])).tolist() == [want]
    k, mu = word.barrett_mu(q)
    jw = W64.mulmod(_w64(a), _w64(b), _w64([q] * len(a)), k, _w64([mu] * len(a)))
    assert _unword(jw) == want


@pytest.mark.parametrize("q", WIDE_MODULI)
def test_mul_mod_takes_operands_beyond_q(q):
    """Operands below 2^62 but not below q (e.g. m_sk - alpha reduced mod q)."""
    a = [int(v) for v in RNG.integers(0, 1 << 62, size=256, dtype=np.int64)] + [(1 << 62) - 1]
    b = [int(v) for v in RNG.integers(0, 1 << 62, size=256, dtype=np.int64)] + [(1 << 62) - 1]
    assert wide.mul_mod(_t(a), _t(b), q).tolist() == [x * y % q for x, y in zip(a, b)]


@pytest.mark.parametrize("q", WIDE_MODULI)
def test_reduce_pair_matches_she_tpu_reduce_u128(q):
    hi = [int(v) % q for v in RNG.integers(0, 1 << 62, size=256, dtype=np.int64)] + [q - 1, 0]
    lo = [int(v) for v in RNG.integers(0, 1 << 62, size=256, dtype=np.int64)] + [(1 << 62) - 1, 0]
    values = [(h << 62) + l for h, l in zip(hi, lo)]
    got = wide.reduce_pair(_t(hi), _t(lo), q).tolist()
    assert got == [v % q for v in values]
    c = word.row_consts(q, 64)
    n = len(values)
    p = tuple(np.array([(v >> (32 * i)) & 0xFFFFFFFF for v in values], dtype=np.uint32) for i in range(4))
    consts = {"k": c["k"], "mu": _w64([c["mu"]] * n), "mu32": np.uint32(c["mu32"]),
              "r32": _w64([c["r32"]] * n), "r32_shoup": _w64([c["r32_shoup"]] * n)}
    assert _unword(W64.reduce_u128(p, _w64([q] * n), consts)) == got


@pytest.mark.parametrize("q", [17, 65537, (1 << 30) - 35839, 1 << 32, 1 << 16, 3, 2])
def test_reduce_pair_small_and_even_moduli(q):
    """m~ = 2^32 and plaintext moduli pass through the same reduction."""
    hi = [int(v) % q for v in RNG.integers(0, 1 << 62, size=256, dtype=np.int64)] + [q - 1]
    lo = [int(v) for v in RNG.integers(0, 1 << 62, size=256, dtype=np.int64)] + [(1 << 62) - 1]
    got = wide.reduce_pair(_t(hi), _t(lo), q).tolist()
    assert got == [((h << 62) + l) % q for h, l in zip(hi, lo)]


@pytest.mark.parametrize("q", WIDE_MODULI)
def test_lazy_sum_matches_big_ints(q):
    cap = wide.lazy_product_count([q])
    k = min(3 * cap + 2, 40)
    rows = [_residues(q, 64) for _ in range(2 * k)]
    rows[0] = [q - 1] * 64
    rows[1] = [q - 1] * 64  # the worst product leads
    terms = [(_t(rows[2 * i]), _t(rows[2 * i + 1])) for i in range(k)]
    want = [sum(rows[2 * i][j] * rows[2 * i + 1][j] for i in range(k)) % q for j in range(64)]
    assert wide.sum_products_mod(terms, q, min(cap, k)).tolist() == want
    assert ma.sum_products_mod(iter(terms), q, ma.lazy_product_count([q])).tolist() == want


@pytest.mark.parametrize(
    "q,count",
    [
        ((1 << 31) + 11, 4611686017353646074),
        (CT_55[0], 32640),
        (CT_55[1], 32640),
        (576460752303436801, 119),
        (1152921504606830593, 28),
        (GAMMA, 1),
    ],
)
def test_wide_lazy_bound_pinned(q, count):
    """hi stays below 2^63: it starts below q after a reduction and grows
    by at most ((q-1)^2 >> 62) + 1 a product; one more product could pass."""
    assert wide.lazy_product_count([q]) == count
    step = (((q - 1) ** 2) >> 62) + 1
    assert (q - 1) + count * step <= (1 << 63) - 1 < (q - 1) + (count + 1) * step
    assert ma.lazy_product_count([17, q]) == count


def test_bsk_lazy_bound():
    assert ma.lazy_product_count(BSK_61) == min(wide.lazy_product_count([p]) for p in BSK_61)
    assert ma.lazy_product_count(BSK_61) >= 2


def test_int64_route_unchanged_below_2_31(monkeypatch):
    """Moduli below 2^31 keep the int64 route: the same single multiply and
    remainder, and the w32 lazy bound."""

    def refuse(*args, **kwargs):
        raise AssertionError("the wide route ran for a w32 modulus")

    monkeypatch.setattr(wide, "mul_mod", refuse)
    monkeypatch.setattr(wide, "sum_products_mod", refuse)
    moduli = (134176769, 268369921)
    q = _col(moduli)
    a = torch.stack([_t(_residues(m, 128)) for m in moduli])
    b = torch.stack([_t(_residues(m, 128)[::-1]) for m in moduli])
    assert torch.equal(ma.mul_mod(a, b, q), torch.remainder(a * b, q))
    cap = ma.lazy_product_count(moduli)
    assert cap == ma.signed_lazy_product_count(moduli) == 128
    got = ma.sum_products_mod([(a, b)] * 3, q, cap)
    assert torch.equal(got, torch.remainder(3 * (a * b), q))
    assert not ma.is_wide(max(moduli)) and ma.is_wide(1 << 31)


def test_int64_route_refuses_wide_modulus():
    a = _t([5, 7])
    with pytest.raises(ValueError, match="below 2"):
        ma.mul_mod_int64(a, a, CT_55[0])
    with pytest.raises(ValueError, match="below 2"):
        ma.mul_mod_int64(a[None], a[None], _col([CT_55[0]]))
    assert ma.mul_mod_int64(a, a, 11).tolist() == [3, 5]


def test_untagged_modulus_tensor_raises():
    with pytest.raises(ValueError, match="host values"):
        ma.mul_mod(_t([1]), _t([1]), torch.tensor([[17]]))


@pytest.mark.parametrize("m", [1 << 16, 1 << 32])
def test_power_of_two_product_is_exact(m):
    """rns.small_montgomery_reduce's r * (-Q^-1) mod m~ at m~ = 2^32 reaches
    2^64 as one product; the split keeps it exact without int64 wrap."""
    r = [int(v) % m for v in RNG.integers(0, 1 << 62, size=256, dtype=np.int64)] + [m - 1, 0]
    for c in (m - 1, 1, int(RNG.integers(0, m))):
        assert rns.mul_mod_power_of_two(_t(r), c, m).tolist() == [x * c % m for x in r]


@pytest.mark.parametrize("q", [GAMMA, BSK_61[0], CT_55[0], 131249])
def test_sum_mod_over_an_axis(q):
    x = torch.stack([_t(_residues(q, 32)) for _ in range(11)])
    want = [sum(int(v) for v in x[:, j]) % q for j in range(32)]
    assert ma.sum_mod(x, q, 0).tolist() == want
