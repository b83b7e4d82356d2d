"""The port's NoOp scheme against she_tpu's, bit for bit: identity
encryption, add / sub / neg / add_pt, the negacyclic product mod t through
the NTT (t = 17 = 1 mod 16 at N = 8) and by schoolbook (t = 13, not
NTT-friendly), Galois automorphisms, and the noise budget."""

import numpy as np
import pytest

from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.bfv import noop as jnoop
from she_tpu_torch import convert
from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.bfv import noop as tnoop

MODULI = (131249, 131297, 131441, 131489, 131617)


def _params(pkg, t):
    return pkg.EncryptionParameters(
        poly_degree=8, plaintext_modulus=t, coefficient_moduli=MODULI,
        security_level=pkg.SecurityLevel.UNCHECKED, scalar_bits=32,
    )


@pytest.fixture(scope="module", params=[17, 13], ids=["t17-ntt", "t13-schoolbook"])
def ctxs(request):
    t = request.param
    return jbfv.get_bfv_context(_params(jparams, t)), tbfv.get_bfv_context(_params(tparams, t), device="cpu")


def negacyclic_mul(a, b, t):
    n = len(a)
    out = [0] * n
    for i in range(n):
        for j in range(n):
            k, sign = (i + j, 1) if i + j < n else (i + j - n, -1)
            out[k] = (out[k] + sign * a[i] * b[j]) % t
    return out


def _poly_equal(tpoly, jpoly):
    np.testing.assert_array_equal(tpoly.data.numpy(), convert.limbs_to_int64(np.asarray(jpoly.data)))


def _encrypt_both(ctxs, vals):
    jctx, tctx = ctxs
    return (jnoop.encrypt(jbfv.encode(jctx, vals), jnoop.generate_secret_key(jctx)),
            tnoop.encrypt(tbfv.encode(tctx, vals), tnoop.generate_secret_key(tctx)))


def test_secret_key_is_zero(ctxs):
    jctx, tctx = ctxs
    tsk = tnoop.generate_secret_key(tctx)
    jsk = jnoop.generate_secret_key(jctx)  # held: she_tpu scrubs a freed key
    _poly_equal(tsk.poly, jsk.poly)
    assert not tsk.poly.data.any()


@pytest.mark.parametrize("seed", [0, 1])
def test_noop_ops_match(ctxs, seed):
    jctx, tctx = ctxs
    t = tctx.plaintext_modulus
    rng = np.random.default_rng(seed)
    a, b = ([int(v) for v in rng.integers(0, t, size=8)] for _ in range(2))
    (ja, ta), (jb, tb) = _encrypt_both(ctxs, a), _encrypt_both(ctxs, b)
    assert tbfv.decode(tctx, tnoop.decrypt(ta)) == a
    cases = [
        (tnoop.ct_add(ta, tb), jnoop.ct_add(ja, jb), [(x + y) % t for x, y in zip(a, b)]),
        (tnoop.ct_sub(ta, tb), jnoop.ct_sub(ja, jb), [(x - y) % t for x, y in zip(a, b)]),
        (tnoop.ct_neg(ta), jnoop.ct_neg(ja), [(-x) % t for x in a]),
        (tnoop.ct_add_pt(ta, tbfv.encode(tctx, b)), jnoop.ct_add_pt(ja, jbfv.encode(jctx, b)),
         [(x + y) % t for x, y in zip(a, b)]),
        (tnoop.ct_mul(ta, tb), jnoop.ct_mul(ja, jb), negacyclic_mul(a, b, t)),
    ]
    for got, want, values in cases:
        _poly_equal(got.poly, want.poly)
        assert got.poly.fmt == want.poly.fmt
        assert tbfv.decode(tctx, tnoop.decrypt(got)) == values


@pytest.mark.parametrize("element", [3, 5, 15])
def test_noop_apply_galois_match(ctxs, element):
    jctx, tctx = ctxs
    vals = [1, 2, 3, 4, 5, 6, 7, 8]
    ja, ta = _encrypt_both(ctxs, vals)
    got = tnoop.apply_galois(ta, element)
    _poly_equal(got.poly, jnoop.apply_galois(ja, element).poly)
    t = tctx.plaintext_modulus
    want = [0] * 8
    for i, v in enumerate(vals):  # x^i -> x^(i * element) mod x^8 + 1
        k = i * element % 16
        want[k % 8] = (want[k % 8] + (v if k < 8 else -v)) % t
    assert tbfv.decode(tctx, tnoop.decrypt(got)) == want


def test_noop_noise_budget_and_constants(ctxs):
    _, ta = _encrypt_both(ctxs, [1] * 8)
    assert tnoop.noise_budget(ta) == jnoop.noise_budget(None) == float("inf")
    assert (tnoop.FRESH_CIPHERTEXT_POLY_COUNT, tnoop.MIN_NOISE_BUDGET) == (
        jnoop.FRESH_CIPHERTEXT_POLY_COUNT, jnoop.MIN_NOISE_BUDGET)
