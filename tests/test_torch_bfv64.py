"""The port's BFV scheme at 64-bit scalars against she_tpu, bit for bit.

Three of she_tpu's tiny parameter sets at scalar_bits=64 take every wide
route of the port: insecure_n_8_logq_5x18_logt_5 (18-bit ciphertext
moduli, but 61-bit B_sk primes, gamma = 2^62 - 40797 and m~ = 2^32 make
the BEHZ steps wide), insecure_n_16_logq_60_logt_15 (one 60-bit ciphertext
modulus) and insecure_n_512_logq_4x60_logt_20 (60-bit moduli with key
switching). Secret keys and seeded ciphertexts come out identical from the
same DRBG seeds; evaluation keys are carried across with
she_tpu_torch.convert. Every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.bfv import keys as jkeys
from she_tpu.pir import serving as jserving
from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng
from she_tpu_torch import convert
from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.pir import serving as tserving
from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr as trng

SETS = ["insecure_n_8_logq_5x18_logt_5", "insecure_n_16_logq_60_logt_15", "insecure_n_512_logq_4x60_logt_20"]
WITH_KEYS = [s for s in SETS if s != "insecure_n_16_logq_60_logt_15"]


def _seed(tag):
    return (tag * 32)[:32]


def _limbs(ct):
    return [np.asarray(p.data) for p in ct.polys]


def _assert_ct_equal(port_ct, jax_ct):
    assert len(port_ct.polys) == len(jax_ct.polys)
    for got, want in zip(convert.ciphertext_to_limbs(port_ct), _limbs(jax_ct)):
        np.testing.assert_array_equal(got, want)


_SETUPS = {}


def _setup(name):
    """Contexts, keys and an evaluation key carried across, per set."""
    if name not in _SETUPS:
        jctx = jbfv.get_bfv_context(jparams.from_predefined(name, 64))
        tctx = tbfv.get_bfv_context(tparams.from_predefined(name, 64), device="cpu")
        jsk = jbfv.generate_secret_key(jctx, jrng(_seed(b"s")))
        tsk = tbfv.generate_secret_key(tctx, trng(_seed(b"s")))
        jek = tek = None
        if tctx.supports_evaluation_key:
            n = tctx.degree
            config = jkeys.EvaluationKeyConfig((3, 2 * n - 1), has_relinearization_key=True)
            jek = jkeys.generate_evaluation_key(jctx, config, jsk, jrng(_seed(b"k")))
            galois = {e: [_limbs(ct) for ct in k.ciphertexts] for e, k in jek.galois_key.keys.items()}
            relin = [_limbs(ct) for ct in jek.relinearization_key.key_switch_key.ciphertexts]
            tek = convert.evaluation_key_from_limbs(tctx, galois, relin)
        _SETUPS[name] = dict(jctx=jctx, tctx=tctx, jsk=jsk, tsk=tsk, jek=jek, tek=tek)
    return _SETUPS[name]


def _values(s, tag):
    rng = np.random.default_rng(sum(tag))
    return [int(v) for v in rng.integers(0, s["tctx"].plaintext_modulus, size=s["tctx"].degree)]


def _encrypt_both(s, values, tag):
    jct = jbfv.encrypt(jbfv.encode(s["jctx"], values), s["jsk"], seed=_seed(tag), err_rng=jrng(_seed(tag + b"e")))
    tct = tbfv.encrypt(tbfv.encode(s["tctx"], values), s["tsk"], seed=_seed(tag), err_rng=trng(_seed(tag + b"e")))
    return jct, tct


@pytest.mark.parametrize("name", SETS)
def test_secret_key_and_seeded_encryption_match(name):
    s = _setup(name)
    np.testing.assert_array_equal(convert.secret_key_to_limbs(s["tsk"]), np.asarray(s["jsk"].poly.data))
    values = _values(s, b"c")
    jct, tct = _encrypt_both(s, values, b"c")
    _assert_ct_equal(tct, jct)
    assert tbfv.decode(s["tctx"], tbfv.decrypt(tct, s["tsk"])) == values
    assert tbfv.noise_budget(tct, s["tsk"]) == jbfv.noise_budget(jct, s["jsk"])


@pytest.mark.parametrize("name", SETS)
def test_ct_mul_and_noise_budget_match(name):
    s = _setup(name)
    jct_a, tct_a = _encrypt_both(s, _values(s, b"a"), b"a")
    jct_b, tct_b = _encrypt_both(s, _values(s, b"b"), b"b")
    jprod, tprod = jbfv.ct_mul(jct_a, jct_b), tbfv.ct_mul(tct_a, tct_b)
    _assert_ct_equal(tprod, jprod)
    assert tbfv.noise_budget(tprod, s["tsk"]) == jbfv.noise_budget(jprod, s["jsk"])
    got = tbfv.decode(s["tctx"], tbfv.decrypt(tprod, s["tsk"]))
    assert got == [int(v) for v in jbfv.decode(s["jctx"], jbfv.decrypt(jprod, s["jsk"]))]


@pytest.mark.parametrize("name", WITH_KEYS)
def test_relinearize_matches(name):
    s = _setup(name)
    jct_a, tct_a = _encrypt_both(s, _values(s, b"r"), b"r")
    jrel = jbfv.relinearize(jbfv.ct_mul(jct_a, jct_a), s["jek"])
    trel = tbfv.relinearize(tbfv.ct_mul(tct_a, tct_a), s["tek"])
    _assert_ct_equal(trel, jrel)


@pytest.mark.parametrize("name", WITH_KEYS)
@pytest.mark.parametrize("element_index", [0, 1])
def test_apply_galois_matches(name, element_index):
    s = _setup(name)
    element = (3, 2 * s["tctx"].degree - 1)[element_index]
    jct, tct = _encrypt_both(s, _values(s, b"g"), b"g")
    got = tbfv.apply_galois(tct, element, s["tek"])
    _assert_ct_equal(got, jbfv.apply_galois(jct, element, s["jek"]))
    # batched: two stacked copies give the same ciphertext twice
    stacked = tbfv.Ciphertext.from_stacked(s["tctx"], torch.stack([tct.stacked()] * 2), tct.poly_context())
    batched = tbfv.apply_galois(stacked, element, s["tek"])
    for b in range(2):
        assert torch.equal(batched.stacked()[b], got.stacked())


@pytest.mark.parametrize("name", WITH_KEYS)
def test_mod_switch_down_to_single_matches(name):
    s = _setup(name)
    values = _values(s, b"m")
    jct, tct = _encrypt_both(s, values, b"m")
    got = tbfv.mod_switch_down_to_single(tct)
    _assert_ct_equal(got, jbfv.mod_switch_down_to_single(jct))
    assert tbfv.decode(s["tctx"], tbfv.decrypt(got, s["tsk"])) == values


@pytest.mark.parametrize("name", SETS)
def test_inner_product_ct_pt_matches(name):
    s = _setup(name)
    n = s["tctx"].degree
    rows = np.random.default_rng(3).integers(0, s["tctx"].plaintext_modulus, size=(3, n))
    jpts = jbfv.batch_encode_to_eval(s["jctx"], rows.astype(object))
    data = tbfv.batch_encode_to_eval(s["tctx"], rows)
    ct_ctx = s["tctx"].ciphertext_context
    tpts = [tbfv.Plaintext(s["tctx"], tbfv.PolyRq(data[i], ct_ctx, tbfv.EVAL)) for i in range(3)]
    for jp, tp in zip(jpts, tpts):
        np.testing.assert_array_equal(convert.limbs_from_tensor(tp.poly.data, 2), np.asarray(jp.poly.data))
    pairs = [_encrypt_both(s, _values(s, bytes([70 + i])), bytes([70 + i])) for i in range(3)]
    jcts = [jbfv.ct_to_eval(p[0]) for p in pairs]
    tcts = [tbfv.ct_to_eval(p[1]) for p in pairs]
    got = tbfv.inner_product_ct_pt(tcts, [tpts[0], None, tpts[2]])
    _assert_ct_equal(got, jbfv.inner_product_ct_pt(jcts, [jpts[0], None, jpts[2]]))


def test_dim0_mac_matches_she_tpu_w64():
    """The batched server's dim-0 MAC on the wide route against she_tpu's
    _dim0_inner_products_w64 (lazy 128-bit limbs, reduce_u128)."""
    s = _setup("insecure_n_512_logq_4x60_logt_20")
    ct_ctx_t, ct_ctx_j = s["tctx"].ciphertext_context, s["jctx"].ciphertext_context
    moduli, n = ct_ctx_t.moduli, ct_ctx_t.degree
    rng = np.random.default_rng(9)
    C, d0, P = 2, 5, 4

    def residues(shape):
        out = np.zeros(shape + (len(moduli), n), dtype=np.int64)
        for i, q in enumerate(moduli):
            out[..., i, :] = rng.integers(0, q, size=shape + (n,))
        out.reshape(-1, len(moduli), n)[0] = np.array(moduli)[:, None] - 1
        return out

    db, query = residues((C, d0)), residues((d0, P))
    got = tserving.dim0_inner_products(torch.from_numpy(db), torch.from_numpy(query), ct_ctx_t)
    db_w = np.moveaxis(convert.int64_to_limbs(db, 2), 0, 2)  # [C, d0, W, L, N]
    q_w = np.moveaxis(convert.int64_to_limbs(query, 2), 0, 2)  # [d0, P, W, L, N]
    want = np.asarray(jserving._dim0_inner_products_w64(db_w, q_w, ct_ctx_j))  # [C, P, W, L, N]
    np.testing.assert_array_equal(convert.limbs_from_tensor(got, 2), np.moveaxis(want, 2, 0))


def test_plaintext_translate_refuses_t_beyond_2_31():
    """Beyond t = 2^31, qModT * m overflows int64: encryption no longer
    refuses such a t but rounds on the wide route, and decrypts (the
    name is from when it refused)."""
    ep = tparams.EncryptionParameters(
        poly_degree=16, plaintext_modulus=(1 << 31) + 11, coefficient_moduli=(1152921504606830593,),
        security_level=tparams.SecurityLevel.UNCHECKED, scalar_bits=64,
    )
    ctx = tbfv.get_bfv_context(ep, device="cpu")
    sk = tbfv.generate_secret_key(ctx, trng(_seed(b"t")))
    values = [1, 2, 3, ep.plaintext_modulus - 1] + [0] * 12
    ct = tbfv.encrypt(tbfv.encode(ctx, values), sk, seed=_seed(b"u"))
    assert tbfv.decode(ctx, tbfv.decrypt(ct, sk)) == values
