"""The port's modular arithmetic, polynomial ops, Galois maps and BEHZ RNS
tool against she_tpu, bit for bit, on shared numpy inputs."""

import numpy as np
import pytest
import torch

from she_tpu.core import context as jctx
from she_tpu.core import poly as jpoly
from she_tpu.core import rns as jrns
from she_tpu.ops import galois as jgalois
from she_tpu.ops import word as wordmod
from she_tpu_torch import errors as terrors
from she_tpu_torch.core import context as tctx
from she_tpu_torch.core import poly as tpoly
from she_tpu_torch.core import rns as trns
from she_tpu_torch.ops import galois as tgalois
from she_tpu_torch.ops import modarith as ma

CPU = torch.device("cpu")
TINY = ((1 << 17) + 177, (1 << 17) + 225, (1 << 17) + 369, (1 << 17) + 417)
MAIN_CT = ((1 << 27) - 40959, (1 << 28) - 65535)
MAIN_KS = MAIN_CT + ((1 << 28) - 73727,)
MAIN_QBSK = MAIN_CT + (268460033, 268582913, 268640257)


def _rand(moduli, degree, batch=(), seed=0):
    rng = np.random.default_rng(seed)
    out = np.zeros(tuple(batch) + (len(moduli), degree), dtype=np.int64)
    for i, q in enumerate(moduli):
        out[..., i, :] = rng.integers(0, q, size=tuple(batch) + (degree,))
    return out


def _jpoly(values, moduli, fmt=jpoly.COEFF):
    ctx = jctx.get_poly_context(values.shape[-1], tuple(moduli), 32)
    return jpoly.PolyRq.from_values(values.astype(object), ctx, fmt)


def _tpoly(values, moduli, fmt=tpoly.COEFF):
    ctx = tctx.get_poly_context(values.shape[-1], tuple(moduli), 32, CPU)
    return tpoly.PolyRq(torch.from_numpy(values), ctx, fmt)


def _jvalues(word_or_poly):
    data = word_or_poly.data if hasattr(word_or_poly, "data") else np.stack([np.asarray(w) for w in word_or_poly])
    return wordmod.unpack(np.asarray(data)).astype(np.int64)


@pytest.mark.parametrize("moduli", [TINY, MAIN_CT, MAIN_KS, MAIN_QBSK, (17, (1 << 30) - 20405)])
def test_signed_lazy_count_is_half_the_unsigned_count(moduli):
    unsigned = jctx.get_poly_context(8, moduli, 32).max_lazy_product_accumulation_count()
    assert ma.signed_lazy_product_count(moduli) == unsigned // 2
    assert tctx.get_poly_context(8, moduli, 32, CPU).max_signed_lazy_product_count() == unsigned // 2
    # the signed bound really fits: cap products of (q-1)^2 stay below 2^63
    q = max(moduli)
    assert ma.signed_lazy_product_count(moduli) * (q - 1) ** 2 < 1 << 63


def test_sum_products_mod_exact():
    q = MAIN_KS[-1]
    rng = np.random.default_rng(1)
    a = rng.integers(q - 1000, q, size=(300, 16))  # near-worst-case products
    b = rng.integers(q - 1000, q, size=(300, 16))
    cap = ma.signed_lazy_product_count((q,))
    terms = ((torch.from_numpy(a[j]), torch.from_numpy(b[j])) for j in range(300))
    got = ma.sum_products_mod(terms, q, cap)
    want = (a.astype(object) * b.astype(object)).sum(axis=0) % q
    assert got.tolist() == [int(v) for v in want]


@pytest.mark.parametrize("moduli,degree", [(TINY, 8), (MAIN_KS, 256)])
def test_divide_and_round_q_last(moduli, degree):
    vals = _rand(moduli, degree, seed=2)
    want = jpoly.divide_and_round_q_last(_jpoly(vals, moduli))
    got = tpoly.divide_and_round_q_last(_tpoly(vals, moduli))
    assert got.context.moduli == tuple(moduli[:-1])
    np.testing.assert_array_equal(got.data.numpy(), _jvalues(want))


@pytest.mark.parametrize("keep", [1, 3])
def test_drop_context(keep):
    vals = _rand(TINY, 8, seed=keep)
    want = jpoly.drop_context(_jpoly(vals, TINY), jctx.get_poly_context(8, TINY[:keep], 32))
    t_target = tctx.get_poly_context(8, TINY[:keep], 32, CPU)
    got = tpoly.drop_context(_tpoly(vals, TINY), t_target)
    assert got.context is t_target
    np.testing.assert_array_equal(got.data.numpy(), _jvalues(want))
    with pytest.raises(terrors.IncompatibleContexts):
        tpoly.drop_context(_tpoly(vals, TINY), tctx.get_poly_context(8, TINY[1:2], 32, CPU))


@pytest.mark.parametrize("degree", [8, 16, 4096])
def test_galois_element_derivation(degree):
    assert tgalois.swapping_rows_element(degree) == jgalois.swapping_rows_element(degree)
    steps = [s for s in range(-(degree // 2) + 1, degree // 2) if s != 0][:: max(1, degree // 64)]
    for step in steps:
        assert tgalois.rotating_columns_element(step, degree) == jgalois.rotating_columns_element(step, degree)
    multi = tgalois.rotating_columns_multi_step_elements(degree)
    assert multi == jgalois.rotating_columns_multi_step_elements(degree)
    assert tgalois.steps_for(multi, degree) == jgalois.steps_for(multi, degree)
    supported = [1, 2, -1] if degree > 8 else [1, -1]
    for step in steps:
        assert tgalois.plan_multi_step(supported, step, degree) == jgalois.plan_multi_step(supported, step, degree)


@pytest.mark.parametrize("power", [1, 3, 7, 8, 9, 15, -1, -5, -8, -13, 16])
def test_multiply_power_of_x(power):
    vals = _rand(TINY, 8, seed=abs(power))
    want = jpoly.multiply_power_of_x(_jpoly(vals, TINY), power)
    got = tpoly.multiply_power_of_x(_tpoly(vals, TINY), power)
    np.testing.assert_array_equal(got.data.numpy(), _jvalues(want))


@pytest.mark.parametrize("element", [3, 5, 9, 15])
def test_apply_galois(element):
    vals = _rand(TINY, 8, seed=element)
    q_word = wordmod.as_word(np.asarray(jctx.get_poly_context(8, TINY, 32).q_arr))
    word = wordmod.as_word(wordmod.pack(vals.astype(object), 1))
    want = jgalois.apply_galois_coeff(word, q_word, element, wordmod.W32)
    q_col = tctx.get_poly_context(8, TINY, 32, CPU).q_col
    got = tgalois.apply_galois_coeff(torch.from_numpy(vals), q_col, element)
    np.testing.assert_array_equal(got.numpy(), _jvalues(want))
    want_eval = jgalois.apply_galois_eval(word, element)
    got_eval = tgalois.apply_galois_eval(torch.from_numpy(vals), element)
    np.testing.assert_array_equal(got_eval.numpy(), _jvalues(want_eval))


@pytest.fixture(scope="module")
def rns_tools():
    pool = jrns.bsk_prime_pool(8, len(TINY), 32)
    assert trns.bsk_prime_pool(8, len(TINY), 32) == pool
    jt = jrns.RnsTool(jctx.get_poly_context(8, TINY, 32), 17, pool)
    tt = trns.RnsTool(tctx.get_poly_context(8, TINY, 32, CPU), 17, pool)
    return jt, tt


def test_behz_lift_and_floor(rns_tools):
    jt, tt = rns_tools
    vals = _rand(TINY, 8, seed=5)
    word = wordmod.as_word(wordmod.pack(vals.astype(object), 1))
    lifted_j = jt.lift_q_to_qbsk(word)
    lifted = tt.lift_q_to_qbsk(torch.from_numpy(vals))
    np.testing.assert_array_equal(lifted.numpy(), _jvalues(lifted_j))
    ext = _rand(TINY + tt.bsk_context.moduli, 8, seed=6)
    floored_j = jt.floor_qbsk_to_q(wordmod.as_word(wordmod.pack(ext.astype(object), 1)))
    floored = tt.floor_qbsk_to_q(torch.from_numpy(ext))
    np.testing.assert_array_equal(floored.numpy(), _jvalues(floored_j))


def test_scale_and_round(rns_tools):
    jt, tt = rns_tools
    vals = _rand(TINY, 8, seed=8)
    word = wordmod.as_word(wordmod.pack(vals.astype(object), 1))
    for scaling in (1, 5):
        want = jt.scale_and_round(word, scaling)
        got = tt.scale_and_round(torch.from_numpy(vals), scaling)
        np.testing.assert_array_equal(got.numpy(), _jvalues(want))
