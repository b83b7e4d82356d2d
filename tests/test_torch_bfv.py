"""The port's BFV scheme and key switching against she_tpu, bit for bit.

Secret keys and seeded ciphertexts come out identical from the same DRBG
seeds. Evaluation keys draw fresh ciphertext seeds from os.urandom, so the
key-switching tests carry she_tpu's keys across with she_tpu_torch.convert.
"""

import os

import numpy as np
import pytest
import torch

from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.bfv import keys as jkeys
from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng
from she_tpu_torch import convert
from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.bfv import keys as tkeys
from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr as trng

PARAMS = "insecure_n_8_logq_5x18_logt_5"


def _seed(tag):
    return (tag * 32)[:32]


def _limbs(ct):
    return [np.asarray(p.data) for p in ct.polys]


def _assert_ct_equal(port_ct, jax_ct):
    assert len(port_ct.polys) == len(jax_ct.polys)
    for got, want in zip(convert.ciphertext_to_limbs(port_ct), _limbs(jax_ct)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def setup():
    jctx = jbfv.get_bfv_context(jparams.from_predefined(PARAMS, 32))
    tctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, 32), device="cpu")
    jsk = jbfv.generate_secret_key(jctx, jrng(_seed(b"s")))
    tsk = tbfv.generate_secret_key(tctx, trng(_seed(b"s")))
    config = jkeys.EvaluationKeyConfig((3, 5, 9), has_relinearization_key=True)
    jek = jkeys.generate_evaluation_key(jctx, config, jsk, jrng(_seed(b"k")))
    galois = {e: [_limbs(ct) for ct in k.ciphertexts] for e, k in jek.galois_key.keys.items()}
    relin = [_limbs(ct) for ct in jek.relinearization_key.key_switch_key.ciphertexts]
    tek = convert.evaluation_key_from_limbs(tctx, galois, relin)
    return jctx, tctx, jsk, tsk, jek, tek


def _encrypt_both(setup, values, tag):
    jctx, tctx, jsk, tsk, _, _ = setup
    jct = jbfv.encrypt(jbfv.encode(jctx, values), jsk, seed=_seed(tag), err_rng=jrng(_seed(tag + b"e")))
    tct = tbfv.encrypt(tbfv.encode(tctx, values), tsk, seed=_seed(tag), err_rng=trng(_seed(tag + b"e")))
    return jct, tct


def test_seeded_secret_key_matches(setup):
    _, _, jsk, tsk, _, _ = setup
    np.testing.assert_array_equal(convert.secret_key_to_limbs(tsk), np.asarray(jsk.poly.data))


def test_seeded_encrypt_and_decrypt_match(setup):
    jctx, tctx, jsk, tsk, _, _ = setup
    values = [1, 16, 0, 5, 9, 3, 2, 11]
    jct, tct = _encrypt_both(setup, values, b"c")
    _assert_ct_equal(tct, jct)
    assert tct.seed == jct.seed
    assert tbfv.decode(tctx, tbfv.decrypt(tct, tsk)) == values
    assert tbfv.decode(tctx, tbfv.decrypt(tct, tsk)) == jbfv.decode(jctx, jbfv.decrypt(jct, jsk))


def test_ct_ops_and_mod_switch_match(setup):
    jct_a, tct_a = _encrypt_both(setup, [3, 1, 4, 1, 5, 9, 2, 6], b"a")
    jct_b, tct_b = _encrypt_both(setup, [2, 7, 1, 8, 2, 8, 1, 8], b"b")
    _assert_ct_equal(tbfv.ct_add(tct_a, tct_b), jbfv.ct_add(jct_a, jct_b))
    _assert_ct_equal(tbfv.ct_sub(tct_a, tct_b), jbfv.ct_sub(jct_a, jct_b))
    _assert_ct_equal(tbfv.ct_to_eval(tct_a), jbfv.ct_to_eval(jct_a))
    _assert_ct_equal(tbfv.mod_switch_down_to_single(tct_a), jbfv.mod_switch_down_to_single(jct_a))
    _assert_ct_equal(tbfv.multiply_power_of_x(tct_a, -3), jbfv.multiply_power_of_x(jct_a, -3))


@pytest.mark.parametrize("element", [3, 5, 9])
def test_apply_galois_with_carried_key(setup, element):
    _, tctx, _, tsk, jek, tek = setup
    jct, tct = _encrypt_both(setup, [1, 2, 3, 4, 5, 6, 7, 8], b"g")
    got = tbfv.apply_galois(tct, element, tek)
    _assert_ct_equal(got, jbfv.apply_galois(jct, element, jek))
    # batched: two stacked copies give the same ciphertext twice
    stacked = tbfv.Ciphertext.from_stacked(tctx, torch.stack([tct.stacked()] * 2), tct.poly_context())
    batched = tbfv.apply_galois(stacked, element, tek)
    for b in range(2):
        assert torch.equal(batched.stacked()[b], got.stacked())


def test_inner_product_ct_ct_and_relinearize(setup):
    _, tctx, _, tsk, jek, tek = setup
    pairs = [_encrypt_both(setup, [i, i + 1, 0, 2, 0, 0, 1, 3], bytes([65 + i])) for i in range(3)]
    jl = [p[0] for p in pairs]
    tl = [p[1] for p in pairs]
    jprod = jbfv.inner_product_ct_ct(jl, jl[::-1])
    tprod = tbfv.inner_product_ct_ct(tl, tl[::-1])
    _assert_ct_equal(tprod, jprod)
    jrel = jbfv.relinearize(jprod, jek)
    trel = tbfv.relinearize(tprod, tek)
    _assert_ct_equal(trel, jrel)
    assert tbfv.decode(tctx, tbfv.decrypt(trel, tsk)) == [
        int(v) for v in np.asarray(jbfv.decode(setup[0], jbfv.decrypt(jrel, setup[2])))
    ]


def test_evaluation_key_generation_matches(setup, monkeypatch):
    """With the same ciphertext seeds (os.urandom replaced by a counter in
    both packages) and the same error stream, key generation is identical."""
    jctx, tctx, jsk, tsk, _, _ = setup

    def counter_urandom():
        state = [0]

        def urandom(n):
            state[0] += 1
            return state[0].to_bytes(4, "little") * (n // 4) + bytes(n % 4)

        return urandom

    config = jkeys.EvaluationKeyConfig((3, 15), has_relinearization_key=True)
    monkeypatch.setattr(os, "urandom", counter_urandom())
    jek = jkeys.generate_evaluation_key(jctx, config, jsk, jrng(_seed(b"q")))
    monkeypatch.setattr(os, "urandom", counter_urandom())
    tek = tkeys.generate_evaluation_key(tctx, tkeys.EvaluationKeyConfig((3, 15), True), tsk, trng(_seed(b"q")))
    galois, relin = convert.evaluation_key_to_limbs(tek)
    assert sorted(galois) == sorted(jek.galois_key.keys)
    for e, cts in galois.items():
        for got, want in zip(cts, jek.galois_key.keys[e].ciphertexts):
            for g, w in zip(got, _limbs(want)):
                np.testing.assert_array_equal(g, w)
    for got, want in zip(relin, jek.relinearization_key.key_switch_key.ciphertexts):
        for g, w in zip(got, _limbs(want)):
            np.testing.assert_array_equal(g, w)


def test_convert_round_trips(setup):
    _, tctx, jsk, tsk, jek, tek = setup
    limbs = np.asarray(jsk.poly.data)
    np.testing.assert_array_equal(convert.secret_key_to_limbs(convert.secret_key_from_limbs(tctx, limbs)), limbs)
    w64 = np.random.default_rng(0).integers(0, 1 << 32, size=(2, 3, 8), dtype=np.uint64).astype(np.uint32)
    w64[1] &= 0x3FFFFFFF
    np.testing.assert_array_equal(convert.int64_to_limbs(convert.limbs_to_int64(w64), 2), w64)
    galois, relin = convert.evaluation_key_to_limbs(tek)
    for e, cts in galois.items():
        for got, want in zip(cts, jek.galois_key.keys[e].ciphertexts):
            for g, w in zip(got, _limbs(want)):
                np.testing.assert_array_equal(g, w)
