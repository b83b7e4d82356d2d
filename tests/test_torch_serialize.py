"""The port's wire format against she_tpu's io/serialize.py, byte for byte.

Polys at several skip-LSB counts, seeded and full ciphertexts in Coeff and
Eval, the decryption-only form of a one-modulus ciphertext, plaintexts, the
secret key, an evaluation key and the processed-database bytes: both
packages write the same bytes from the same values, and each reads the
other's bytes back to the same values. At 32- and 64-bit scalars.
"""

import numpy as np
import pytest
import torch

from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.bfv import keys as jkeys
from she_tpu.core.poly import PolyRq as JPolyRq
from she_tpu.io import serialize as jser
from she_tpu.pir import index_pir as jip
from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng
from she_tpu_torch import convert, errors
from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.core.poly import COEFF, EVAL, PolyRq
from she_tpu_torch.io import serialize as tser
from she_tpu_torch.pir import index_pir as tip
from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr as trng

PARAMS = "insecure_n_8_logq_5x18_logt_5"
BITS = [32, 64]


def _seed(tag):
    return (tag * 32)[:32]


def _limbs(ct):
    return [np.asarray(p.data) for p in ct.polys]


def _assert_ct_equal(port_ct, jax_ct):
    assert len(port_ct.polys) == len(jax_ct.polys)
    for got, want in zip(convert.ciphertext_to_limbs(port_ct), _limbs(jax_ct)):
        np.testing.assert_array_equal(got, want)


def _assert_serialized_equal(got, want):
    assert (got.kind, got.polys, got.seed, tuple(got.skip_lsbs), got.correction_factor) == (
        want.kind, want.polys, want.seed, tuple(want.skip_lsbs), want.correction_factor,
    )


def _as_jax(s):
    return jser.SerializedCiphertext(s.kind, s.polys, s.seed, tuple(s.skip_lsbs), s.correction_factor)


def _as_port(s):
    return tser.SerializedCiphertext(s.kind, s.polys, s.seed, tuple(s.skip_lsbs), s.correction_factor)


@pytest.fixture(scope="module", params=BITS)
def setup(request):
    bits = request.param
    jctx = jbfv.get_bfv_context(jparams.from_predefined(PARAMS, bits))
    tctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, bits), device="cpu")
    jsk = jbfv.generate_secret_key(jctx, jrng(_seed(b"s")))
    tsk = tbfv.generate_secret_key(tctx, trng(_seed(b"s")))
    return dict(bits=bits, jctx=jctx, tctx=tctx, jsk=jsk, tsk=tsk)


def _encrypt_both(setup, values, tag):
    jct = jbfv.encrypt(jbfv.encode(setup["jctx"], values), setup["jsk"], seed=_seed(tag),
                       err_rng=jrng(_seed(tag + b"e")))
    tct = tbfv.encrypt(tbfv.encode(setup["tctx"], values), setup["tsk"], seed=_seed(tag),
                       err_rng=trng(_seed(tag + b"e")))
    _assert_ct_equal(tct, jct)
    return jct, tct


@pytest.mark.parametrize("skip", [0, 1, 5, 17])
def test_poly_bytes_match(setup, skip):
    tctx = setup["tctx"].ciphertext_context
    jctx = setup["jctx"].ciphertext_context
    rng = np.random.default_rng(skip)
    vals = np.stack([rng.integers(0, q, size=tctx.degree) for q in tctx.moduli])
    want = jser.serialize_poly(JPolyRq.from_values(vals.astype(object), jctx, COEFF), skip)
    got = tser.serialize_poly(PolyRq.from_values(vals, tctx, COEFF), skip)
    assert got == want
    assert len(got) == tser.poly_serialization_byte_count(tctx, skip) == jser.poly_serialization_byte_count(jctx, skip)
    back = tser.deserialize_poly(want, tctx, COEFF, skip).to_values()
    np.testing.assert_array_equal(back, jser.deserialize_poly(got, jctx, COEFF, skip).to_values().astype(np.int64))
    mask = (1 << skip) - 1
    np.testing.assert_array_equal(back, vals & ~mask)
    # a poly vector: u16 count, then each poly at its own skip count
    polys_t = [PolyRq.from_values(vals, tctx, COEFF), PolyRq.from_values(vals[:, ::-1].copy(), tctx, COEFF)]
    polys_j = [JPolyRq.from_values(p.to_values().astype(object), jctx, COEFF) for p in polys_t]
    got = tser.serialize_polys(polys_t, [skip, 0])
    assert got == jser.serialize_polys(polys_j, [skip, 0])
    for g, w in zip(tser.deserialize_polys(got, tctx, COEFF, [skip, 0]),
                    jser.deserialize_polys(got, jctx, COEFF, [skip, 0])):
        np.testing.assert_array_equal(g.to_values(), w.to_values().astype(np.int64))


@pytest.mark.parametrize("fmt", [COEFF, EVAL])
@pytest.mark.parametrize("seeded", [True, False])
def test_ciphertext_bytes_match(setup, fmt, seeded):
    jct, tct = _encrypt_both(setup, [1, 16, 0, 5, 9, 3, 2, 11], b"c" + fmt.encode())
    if fmt == EVAL:
        jct, tct = jbfv.ct_to_eval(jct), tbfv.ct_to_eval(tct)
    if not seeded:
        jct.seed = None
        tct.seed = None
    want = jser.serialize_ciphertext(jct)
    got = tser.serialize_ciphertext(tct)
    assert got.kind == ("seeded" if seeded else "full")
    _assert_serialized_equal(got, want)
    # each package reads the other's bytes back to the same ciphertext
    port_back = tser.deserialize_ciphertext(_as_port(want), setup["tctx"], fmt)
    _assert_ct_equal(port_back, jct)
    assert port_back.fmt == fmt and port_back.seed == jct.seed
    _assert_ct_equal(tct, jser.deserialize_ciphertext(_as_jax(got), setup["jctx"], fmt))


def test_many_seeded_ciphertexts_deserialize_like_one(setup):
    cts = [_encrypt_both(setup, [i] * 8, bytes([65 + i]))[1] for i in range(3)]
    serialized = [tser.serialize_ciphertext(ct) for ct in cts]
    serialized.insert(1, tser.serialize_ciphertext(tbfv.Ciphertext(cts[0].context, cts[0].polys, 1, None)))
    together = tser.deserialize_ciphertexts(serialized, setup["tctx"], COEFF)
    for s, ct in zip(serialized, together):
        one = tser.deserialize_ciphertext(s, setup["tctx"], COEFF)
        for a, b in zip(one.polys, ct.polys):
            assert torch.equal(a.data, b.data)


def test_index_masking_matches(setup):
    jct, tct = _encrypt_both(setup, [4, 3, 2, 1, 0, 15, 14, 13], b"m")
    jct.seed = None
    tct.seed = None
    _assert_serialized_equal(tser.serialize_ciphertext(tct, indices=[0, 3]),
                             jser.serialize_ciphertext(jct, indices=[0, 3]))


def test_skip_lsbs_for_decryption_matches(setup):
    values = [7, 0, 3, 16, 2, 2, 9, 1]
    jct, tct = _encrypt_both(setup, values, b"d")
    jsingle, tsingle = jbfv.mod_switch_down_to_single(jct), tbfv.mod_switch_down_to_single(tct)
    _assert_ct_equal(tsingle, jsingle)
    skips = tser.skip_lsbs_for_decryption(tsingle)
    assert skips == jser.skip_lsbs_for_decryption(jsingle)
    assert any(s > 0 for s in skips)
    assert tser.skip_lsbs_for_decryption(tct) == jser.skip_lsbs_for_decryption(jct) == [0, 0]
    want = jser.serialize_ciphertext(jsingle, for_decryption=True)
    got = tser.serialize_ciphertext(tsingle, for_decryption=True)
    _assert_serialized_equal(got, want)
    back = tser.deserialize_ciphertext(_as_port(want), setup["tctx"], COEFF, moduli_count=1)
    assert tbfv.decode(setup["tctx"], tbfv.decrypt(back, setup["tsk"])) == values
    jback = jser.deserialize_ciphertext(_as_jax(got), setup["jctx"], COEFF, moduli_count=1)
    _assert_ct_equal(back, jback)


def test_plaintext_and_secret_key_bytes_match(setup):
    jctx, tctx = setup["jctx"], setup["tctx"]
    values = [int(v) for v in np.random.default_rng(4).integers(0, tctx.plaintext_modulus, size=tctx.degree)]
    got = tser.serialize_plaintext(tbfv.encode(tctx, values))
    assert got == jser.serialize_plaintext(jbfv.encode(jctx, values))
    assert tbfv.decode(tctx, tser.deserialize_plaintext(got, tctx)) == values
    assert jbfv.decode(jctx, jser.deserialize_plaintext(got, jctx)) == values
    got = tser.serialize_secret_key(setup["tsk"])
    assert got == jser.serialize_secret_key(setup["jsk"])
    jsk = jser.deserialize_secret_key(got, jctx)  # held: she_tpu scrubs a freed key's buffer
    np.testing.assert_array_equal(
        convert.secret_key_to_limbs(tser.deserialize_secret_key(got, tctx)), np.asarray(jsk.poly.data)
    )


def test_evaluation_key_bytes_match(setup):
    jctx, tctx = setup["jctx"], setup["tctx"]
    config = jkeys.EvaluationKeyConfig((3, 5), has_relinearization_key=True)
    jek = jkeys.generate_evaluation_key(jctx, config, setup["jsk"], jrng(_seed(b"k")))
    galois = {e: [_limbs(ct) for ct in k.ciphertexts] for e, k in jek.galois_key.keys.items()}
    relin = [_limbs(ct) for ct in jek.relinearization_key.key_switch_key.ciphertexts]
    tek = convert.evaluation_key_from_limbs(tctx, galois, relin)
    want = jser.serialize_evaluation_key(jek)
    got = tser.serialize_evaluation_key(tek)
    assert set(got["galois"]) == set(want["galois"]) == {3, 5}
    for el in (3, 5):
        for g, w in zip(got["galois"][el], want["galois"][el], strict=True):
            _assert_serialized_equal(g, w)
    for g, w in zip(got["relin"], want["relin"], strict=True):
        _assert_serialized_equal(g, w)
    back = tser.deserialize_evaluation_key(
        {"galois": {el: [_as_port(s) for s in v] for el, v in want["galois"].items()},
         "relin": [_as_port(s) for s in want["relin"]]},
        tctx,
    )
    assert back.relinearization_key.key_switch_key.ciphertexts[0].polys[0].context is tctx.secret_key_context
    got_galois, got_relin = convert.evaluation_key_to_limbs(back)
    for el in (3, 5):
        for g, w in zip(got_galois[el], galois[el]):
            for gp, wp in zip(g, w):
                np.testing.assert_array_equal(gp, wp)
    for g, w in zip(got_relin, relin):
        for gp, wp in zip(g, w):
            np.testing.assert_array_equal(gp, wp)


@pytest.mark.parametrize("entry_size", [1, 9])
def test_processed_database_bytes_match(setup, entry_size):
    """Entries of 1 byte share plaintexts; 9-byte entries span three
    4-byte plaintexts each; trailing empty entries leave zero plaintexts."""
    jctx, tctx = setup["jctx"], setup["tctx"]
    rng = np.random.default_rng(entry_size)
    database = [rng.integers(0, 256, size=entry_size, dtype=np.uint8).tobytes() for _ in range(10)]
    database[-2:] = [b"", b""]
    config = dict(entry_count=10, entry_size_in_bytes=entry_size)
    jparam = jip.generate_parameter(jip.IndexPirConfig(**config), jctx)
    tparam = tip.generate_parameter(tip.IndexPirConfig(**config), tctx)
    jdb = jip.MulPirServer.process(database, jctx, jparam)
    tdb = tip.MulPirServer.process(database, tctx, tparam)
    want = jdb.serialize(jctx)
    got = tdb.serialize()
    assert got == want
    assert not tdb.present.all()
    back = tip.ProcessedDatabase.deserialize(want, tctx)
    assert torch.equal(back.data, tdb.data)
    np.testing.assert_array_equal(back.present, tdb.present)
    jback = jip.ProcessedDatabase.deserialize(got, jctx)
    assert jback.serialize(jctx) == want
    with pytest.raises(errors.PirError, match="version"):
        tip.ProcessedDatabase.deserialize(b"\x02" + got[1:], tctx)


@pytest.mark.parametrize("nbytes", [7, 4096, 9000])
def test_lockstep_generators_match_she_tpu_streams(nbytes):
    """The server's lockstep CTR_DRBGs give each seed's own stream."""
    from she_tpu.rng import sampling as jsampling
    from she_tpu_torch.rng import ctr_drbg as tdrbg
    from she_tpu_torch.rng import sampling as tsampling

    seeds = [bytes([i]) * 32 for i in range(4)] + [bytes(range(32))]
    streams = tdrbg.nist_aes128_ctr_streams(seeds, nbytes)
    for seed, got in zip(seeds, streams, strict=True):
        assert got.tobytes() == jrng(seed).random_bytes(nbytes)
    for moduli, degree in (([17, 131249], 8), ([36028797018652673, 36028797017571329], 64)):
        many = tsampling.sample_uniform_many(seeds[:3], moduli, degree)
        for seed, got in zip(seeds[:3], many, strict=True):
            want = jsampling.sample_uniform(jrng(seed), moduli, degree)
            np.testing.assert_array_equal(got, np.asarray(want, dtype=np.int64))
    # FIPS-197 appendix C.1
    block = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"), dtype=np.uint8)[None]
    assert tdrbg.aes_encrypt_blocks(bytes(range(16)), block).tobytes().hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"
