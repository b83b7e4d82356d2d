"""The rest of the port's BFV API against she_tpu, bit for bit: SIMD and
signed encoding, plaintext_to_eval with moduli_count, ct_neg, ct +- pt,
ct * pt, rotations and row swaps, ct_mul_relin, the Ciphertext operators,
transparency, EvaluationKeyConfig.contains / key_count and the error types
(the port's side of test_bfv_basic.py, test_bfv_mul.py and
test_he_api_conformance.py).

Ciphertexts come out identical from the same seeds; evaluation keys draw
fresh seeds, so she_tpu's keys are carried across with
she_tpu_torch.convert. This file runs at insecure_n_8_logq_5x18_logt_5
(32-bit scalars, t = 17 = 1 mod 16, so SIMD at N = 8);
test_torch_bfv_api64.py runs the same tests at 64-bit scalars.
"""

import numpy as np
import pytest
import torch

from she_tpu import errors as jerrors
from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.bfv import keys as jkeys
from she_tpu.core.poly import PolyRq as JPolyRq
from she_tpu.ops import galois as jgalois
from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng
from she_tpu_torch import convert, errors
from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.bfv import keys as tkeys
from she_tpu_torch.core.poly import PolyRq
from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr as trng

STEPS = (1, -1, 2)


def _seed(tag):
    return (tag * 32)[:32]


def _limbs(ct):
    return [np.asarray(p.data) for p in ct.polys]


def _assert_ct_equal(port_ct, jax_ct):
    assert len(port_ct.polys) == len(jax_ct.polys)
    assert port_ct.fmt == jax_ct.fmt
    for got, want in zip(convert.ciphertext_to_limbs(port_ct), _limbs(jax_ct)):
        np.testing.assert_array_equal(got, want)


def _assert_pt_equal(port_pt, jax_pt):
    assert port_pt.poly.fmt == jax_pt.poly.fmt
    assert port_pt.poly.context.moduli == jax_pt.poly.context.moduli
    np.testing.assert_array_equal(port_pt.poly.data.numpy(), convert.limbs_to_int64(np.asarray(jax_pt.poly.data)))


def make_env(name: str, bits: int) -> dict:
    """Both packages' contexts, the same secret key, and she_tpu's
    evaluation key (rotations by STEPS, the row swap, relinearization)
    with the port's copy of it."""
    jctx = jbfv.get_bfv_context(jparams.from_predefined(name, bits))
    tctx = tbfv.get_bfv_context(tparams.from_predefined(name, bits), device="cpu")
    jsk = jbfv.generate_secret_key(jctx, jrng(_seed(b"s")))
    tsk = tbfv.generate_secret_key(tctx, trng(_seed(b"s")))
    n = jctx.degree
    elements = tuple(jgalois.rotating_columns_element(s, n) for s in STEPS) + (jgalois.swapping_rows_element(n),)
    jek = jkeys.generate_evaluation_key(jctx, jkeys.EvaluationKeyConfig(elements, True), jsk, jrng(_seed(b"k")))
    galois = {e: [_limbs(ct) for ct in k.ciphertexts] for e, k in jek.galois_key.keys.items()}
    relin = [_limbs(ct) for ct in jek.relinearization_key.key_switch_key.ciphertexts]
    tek = convert.evaluation_key_from_limbs(tctx, galois, relin)
    rng = np.random.default_rng(sum(name.encode()) + bits)
    return dict(jctx=jctx, tctx=tctx, jsk=jsk, tsk=tsk, jek=jek, tek=tek, rng=rng)


@pytest.fixture(scope="module")
def env():
    return make_env("insecure_n_8_logq_5x18_logt_5", 32)


def _values(env, signed=False):
    t = env["tctx"].plaintext_modulus
    if signed:
        return [int(v) for v in env["rng"].integers(-(t >> 1), ((t - 1) >> 1) + 1, size=env["tctx"].degree)]
    return [int(v) for v in env["rng"].integers(0, t, size=env["tctx"].degree)]


def _encrypt_both(env, values, tag, fmt="coefficient"):
    jct = jbfv.encrypt(jbfv.encode(env["jctx"], values, fmt), env["jsk"], seed=_seed(tag),
                       err_rng=jrng(_seed(tag + b"e")))
    tct = tbfv.encrypt(tbfv.encode(env["tctx"], values, fmt), env["tsk"], seed=_seed(tag),
                       err_rng=trng(_seed(tag + b"e")))
    _assert_ct_equal(tct, jct)
    return jct, tct


def test_simd_matrix_and_dimensions(env):
    jctx, tctx = env["jctx"], env["tctx"]
    assert tctx.supports_simd_encoding and jctx.supports_simd_encoding
    np.testing.assert_array_equal(tctx.simd_matrix, jctx.simd_matrix)
    assert tctx.simd_dimensions() == jctx.simd_dimensions() == (2, tctx.degree // 2)


@pytest.mark.parametrize("fmt", ["coefficient", "simd"])
def test_encode_decode_match(env, fmt):
    vals = _values(env)
    jpt, tpt = jbfv.encode(env["jctx"], vals, fmt), tbfv.encode(env["tctx"], vals, fmt)
    _assert_pt_equal(tpt, jpt)
    assert tbfv.decode(env["tctx"], tpt, fmt) == vals == jbfv.decode(env["jctx"], jpt, fmt)
    short = vals[:3]  # fewer values than slots: the rest are zero
    _assert_pt_equal(tbfv.encode(env["tctx"], short, fmt), jbfv.encode(env["jctx"], short, fmt))


@pytest.mark.parametrize("fmt", ["coefficient", "simd"])
def test_encode_decode_signed_match(env, fmt):
    vals = _values(env, signed=True)
    jpt, tpt = jbfv.encode_signed(env["jctx"], vals, fmt), tbfv.encode_signed(env["tctx"], vals, fmt)
    _assert_pt_equal(tpt, jpt)
    assert tbfv.decode_signed(env["tctx"], tpt, fmt) == vals == jbfv.decode_signed(env["jctx"], jpt, fmt)


def test_plaintext_to_eval_moduli_count(env):
    vals = _values(env)
    jpt, tpt = jbfv.encode(env["jctx"], vals, "simd"), tbfv.encode(env["tctx"], vals, "simd")
    for c in range(1, len(env["tctx"].ciphertext_context.moduli) + 1):
        jev = jbfv.plaintext_to_eval(env["jctx"], jpt, moduli_count=c)
        tev = tbfv.plaintext_to_eval(env["tctx"], tpt, moduli_count=c)
        _assert_pt_equal(tev, jev)
        assert tbfv.plaintext_to_eval(env["tctx"], tev) is tev
        assert tbfv.decode(env["tctx"], tbfv.plaintext_to_coeff(tev), "simd") == vals
    # a batch of plaintexts converts in one call, equal to one at a time
    batch = tbfv.Plaintext(env["tctx"], PolyRq(torch.stack([tpt.poly.data] * 3), tpt.poly.context, tpt.poly.fmt))
    one = tbfv.plaintext_to_eval(env["tctx"], tpt).poly.data
    assert all(torch.equal(d, one) for d in tbfv.plaintext_to_eval(env["tctx"], batch).poly.data)


def test_encode_simd_batch_equals_single_encodes(env):
    rows = np.stack([np.array(_values(env)) for _ in range(3)])
    batch = tbfv.encode_simd_batch(env["tctx"], rows)
    assert batch.shape == (3, 1, env["tctx"].degree)
    for b in range(3):
        assert torch.equal(batch[b], tbfv.encode(env["tctx"], rows[b].tolist(), "simd").poly.data)


def test_ct_neg_and_plaintext_add_sub(env):
    t = env["tctx"].plaintext_modulus
    v1, v2 = _values(env), _values(env)
    jct, tct = _encrypt_both(env, v1, b"a")
    jpt, tpt = jbfv.encode(env["jctx"], v2), tbfv.encode(env["tctx"], v2)
    for jop, top, want in (
        (jbfv.ct_neg(jct), tbfv.ct_neg(tct), [(-a) % t for a in v1]),
        (jbfv.ct_add_pt(jct, jpt), tbfv.ct_add_pt(tct, tpt), [(a + b) % t for a, b in zip(v1, v2)]),
        (jbfv.ct_sub_pt(jct, jpt), tbfv.ct_sub_pt(tct, tpt), [(a - b) % t for a, b in zip(v1, v2)]),
        # pt - ct, through the negation (HeScheme.swift:658-729)
        (jbfv.ct_neg(jbfv.ct_sub_pt(jct, jpt)), tbfv.ct_neg(tbfv.ct_sub_pt(tct, tpt)),
         [(b - a) % t for a, b in zip(v1, v2)]),
    ):
        _assert_ct_equal(top, jop)
        assert tbfv.decode(env["tctx"], tbfv.decrypt(top, env["tsk"])) == want


def test_ct_mul_pt_simd(env):
    t = env["tctx"].plaintext_modulus
    v1, v2 = _values(env), _values(env)
    jct, tct = _encrypt_both(env, v1, b"m", "simd")
    jpt = jbfv.plaintext_to_eval(env["jctx"], jbfv.encode(env["jctx"], v2, "simd"))
    tpt = tbfv.plaintext_to_eval(env["tctx"], tbfv.encode(env["tctx"], v2, "simd"))
    jprod = jbfv.ct_mul_pt(jbfv.ct_to_eval(jct), jpt)
    tprod = tbfv.ct_mul_pt(tbfv.ct_to_eval(tct), tpt)
    _assert_ct_equal(tprod, jprod)
    got = tbfv.decode(env["tctx"], tbfv.decrypt(tbfv.ct_to_coeff(tprod), env["tsk"]), "simd")
    assert got == [(a * b) % t for a, b in zip(v1, v2)]


@pytest.mark.parametrize("step", STEPS)
def test_rotate_columns_match(env, step):
    data = _values(env)
    jct, tct = _encrypt_both(env, data, b"r", "simd")
    trot = tbfv.rotate_columns(tct, step, env["tek"])
    _assert_ct_equal(trot, jbfv.rotate_columns(jct, step, env["jek"]))
    half = len(data) // 2
    rows = [data[:half], data[half:]]
    want = [v for row in rows for v in np.roll(row, step).tolist()]  # step > 0 moves slots right
    assert tbfv.decode(env["tctx"], tbfv.decrypt(trot, env["tsk"]), "simd") == want


def test_swap_rows_match(env):
    data = _values(env)
    jct, tct = _encrypt_both(env, data, b"w", "simd")
    tsw = tbfv.swap_rows(tct, env["tek"])
    _assert_ct_equal(tsw, jbfv.swap_rows(jct, env["jek"]))
    half = len(data) // 2
    assert tbfv.decode(env["tctx"], tbfv.decrypt(tsw, env["tsk"]), "simd") == data[half:] + data[:half]


def test_ct_mul_relin_match(env):
    v1, v2 = _values(env), _values(env)
    (ja, ta), (jb, tb) = _encrypt_both(env, v1, b"x"), _encrypt_both(env, v2, b"y")
    tprod = tbfv.ct_mul_relin(ta, tb, env["tek"])
    assert len(tprod.polys) == 2
    _assert_ct_equal(tprod, jbfv.ct_mul_relin(ja, jb, env["jek"]))
    assert tbfv.decode(env["tctx"], tbfv.decrypt(tprod, env["tsk"])) == jbfv.decode(
        env["jctx"], jbfv.decrypt(jbfv.ct_mul_relin(ja, jb, env["jek"]), env["jsk"]))


def test_ciphertext_operators_match(env):
    v1, v2 = _values(env), _values(env)
    (ja, ta), (jb, tb) = _encrypt_both(env, v1, b"o"), _encrypt_both(env, v2, b"p")
    jpt, tpt = jbfv.encode(env["jctx"], v2), tbfv.encode(env["tctx"], v2)
    _assert_ct_equal(ta + tb, ja + jb)
    _assert_ct_equal(ta - tb, ja - jb)
    _assert_ct_equal(ta + tpt, ja + jpt)
    _assert_ct_equal(ta - tpt, ja - jpt)
    _assert_ct_equal(-ta, -ja)
    _assert_ct_equal(ta * tb, ja * jb)
    jev = jbfv.plaintext_to_eval(env["jctx"], jpt)
    tev = tbfv.plaintext_to_eval(env["tctx"], tpt)
    _assert_ct_equal(tbfv.ct_to_eval(ta) * tev, jbfv.ct_to_eval(ja) * jev)
    assert tbfv.decode(env["tctx"], ta.decrypt(env["tsk"])) == v1
    assert ta.noise_budget(env["tsk"]) == ja.noise_budget(env["jsk"])


def test_is_transparent(env):
    tctx, jctx = env["tctx"], env["jctx"]
    zero = tbfv.Ciphertext(tctx, [PolyRq.zero(tctx.ciphertext_context)] * 2)
    jzero = jbfv.Ciphertext(jctx, [JPolyRq.zero(jctx.ciphertext_context)] * 2)
    assert tbfv.is_transparent(zero) and jbfv.is_transparent(jzero)
    jct, tct = _encrypt_both(env, _values(env), b"z")
    assert not tbfv.is_transparent(tct) and not jbfv.is_transparent(jct)
    assert not tbfv.is_transparent(tbfv.encrypt_zero(tctx, env["tsk"], err_rng=trng(_seed(b"0"))))


@pytest.mark.parametrize("a,b", [
    (((3, 5), True), ((3,), False)),
    (((3, 5), False), ((3,), True)),
    (((3,), True), ((3, 5), True)),
    (((), False), ((), False)),
    (((9, 3, 5), True), ((5, 9), True)),
])
def test_evaluation_key_config_contains_and_key_count(a, b):
    ta, tb = tkeys.EvaluationKeyConfig(*a), tkeys.EvaluationKeyConfig(*b)
    ja, jb = jkeys.EvaluationKeyConfig(*a), jkeys.EvaluationKeyConfig(*b)
    assert ta.contains(tb) == ja.contains(jb)
    assert tb.contains(ta) == jb.contains(ja)
    assert ta.contains(ta) and ta.union(tb).contains(tb)
    assert (ta.key_count, tb.key_count) == (ja.key_count, jb.key_count)


def _raises_both(port_call, jax_call, port_error):
    with pytest.raises(port_error):
        port_call()
    with pytest.raises(getattr(jerrors, port_error.__name__)):
        jax_call()


def test_error_types(env):
    tctx, jctx = env["tctx"], env["jctx"]
    t, n = tctx.plaintext_modulus, tctx.degree
    for bad, fmt in (([t], "coefficient"), ([0] * (n + 1), "simd"), ([1], "packed")):
        _raises_both(lambda: tbfv.encode(tctx, bad, fmt), lambda: jbfv.encode(jctx, bad, fmt), errors.EncodingError)
    _raises_both(lambda: tbfv.encode_signed(tctx, [t]), lambda: jbfv.encode_signed(jctx, [t]), errors.EncodingError)
    jct, tct = _encrypt_both(env, _values(env), b"e")
    jpt = jbfv.plaintext_to_eval(jctx, jbfv.encode(jctx, [1]))
    tpt = tbfv.plaintext_to_eval(tctx, tbfv.encode(tctx, [1]))
    _raises_both(lambda: tbfv.ct_mul_pt(tct, tpt), lambda: jbfv.ct_mul_pt(jct, jpt), errors.InvalidFormat)
    jpt1 = jbfv.plaintext_to_eval(jctx, jbfv.encode(jctx, [1]), moduli_count=1)
    tpt1 = tbfv.plaintext_to_eval(tctx, tbfv.encode(tctx, [1]), moduli_count=1)
    _raises_both(lambda: tbfv.ct_mul_pt(tbfv.ct_to_eval(tct), tpt1),
                 lambda: jbfv.ct_mul_pt(jbfv.ct_to_eval(jct), jpt1), errors.IncompatibleContexts)
    _raises_both(lambda: tbfv.rotate_columns(tct, 1, tkeys.EvaluationKey()),
                 lambda: jbfv.rotate_columns(jct, 1, jkeys.EvaluationKey()), errors.MissingGaloisKey)
    _raises_both(lambda: tbfv.ct_add_pt(tbfv.ct_to_eval(tct), tbfv.encode(tctx, [1])),
                 lambda: jbfv.ct_add_pt(jbfv.ct_to_eval(jct), jbfv.encode(jctx, [1])), errors.InvalidFormat)
    _raises_both(lambda: tbfv.rotate_columns(tbfv.ct_to_eval(tct), 1, env["tek"]),
                 lambda: jbfv.rotate_columns(jbfv.ct_to_eval(jct), 1, env["jek"]), errors.InvalidFormat)


def test_simd_not_supported():
    """t = 17 is not 1 mod 2N at N = 4096: no SIMD slots."""
    name = "n_4096_logq_27_28_28_logt_5"
    tctx = tbfv.get_bfv_context(tparams.from_predefined(name, 32), device="cpu")
    jctx = jbfv.get_bfv_context(jparams.from_predefined(name, 32))
    assert not tctx.supports_simd_encoding and not jctx.supports_simd_encoding
    assert tctx.simd_dimensions() is None and jctx.simd_dimensions() is None
    _raises_both(lambda: tbfv.encode(tctx, [1], "simd"), lambda: jbfv.encode(jctx, [1], "simd"),
                 errors.SimdEncodingNotSupported)
    _raises_both(lambda: tbfv.decode(tctx, tbfv.encode(tctx, [1]), "simd"),
                 lambda: jbfv.decode(jctx, jbfv.encode(jctx, [1]), "simd"), errors.SimdEncodingNotSupported)


def test_rotate_columns_multi_step_match(env):
    """A rotation with no key of its own, composed from the keys of steps
    1 and 2 (Extras/HeScheme.swift:62-105), through bfv/extras.py."""
    from she_tpu.bfv import extras as jextras
    from she_tpu_torch.bfv import extras as textras
    from she_tpu_torch.pnns import pnns as tpnns

    n = env["tctx"].degree
    elements = [jgalois.rotating_columns_element(s, n) for s in (1, 2)]
    jek = jkeys.EvaluationKey(jkeys.GaloisKey({e: env["jek"].galois_key.keys[e] for e in elements}))
    tek = tkeys.EvaluationKey(tkeys.GaloisKey({e: env["tek"].galois_key.keys[e] for e in elements}))
    data = _values(env)
    jct, tct = _encrypt_both(env, data, b"3", "simd")
    got = textras.rotate_columns_multi_step(tct, 3, tek)
    _assert_ct_equal(got, jextras.rotate_columns_multi_step(jct, 3, jek))
    half = n // 2
    want = [v for row in (data[:half], data[half:]) for v in np.roll(row, 3).tolist()]
    assert tbfv.decode(env["tctx"], tbfv.decrypt(got, env["tsk"]), "simd") == want
    assert textras.rotate_columns_multi_step is tpnns.rotate_columns_multi_step
    assert textras.rotate_columns_and_sum is tpnns.rotate_columns_and_sum
    assert textras.swap_rows_and_add is tpnns.swap_rows_and_add


def test_extras_remove_last_moduli(env):
    from she_tpu.bfv import extras as jextras
    from she_tpu_torch.bfv import extras as textras

    vals = np.zeros((5, 8), dtype=np.int64)
    vals[:, 0] = [1, 2, 3, 4, 5]
    jctx, tctx = env["jctx"].secret_key_context, env["tctx"].secret_key_context
    got = textras.remove_last_moduli(PolyRq.from_values(vals, tctx, "coeff"), 2)
    want = jextras.remove_last_moduli(JPolyRq.from_values(vals.astype(object), jctx, "coeff"), 2)
    assert got.context.moduli == want.context.moduli == tctx.moduli[:3]
    np.testing.assert_array_equal(got.data.numpy(), convert.limbs_to_int64(np.asarray(want.data)))
