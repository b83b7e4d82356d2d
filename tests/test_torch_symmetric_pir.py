"""Symmetric PIR in the port: the P-384 VOPRF, AES-192-GCM and row sealing.

The port's oprf.py must pass the RFC 9380 and RFC 9497 vectors of
tests/test_symmetric_pir.py and agree with she_tpu's OPRF byte for byte for
fixed blinds and proof nonces; its AES-GCM must agree with the published
AES-192 test cases of the GCM specification (McGrew and Viega, test cases
7-9: 96-bit IV, no associated data) and with the `cryptography` package
where it is installed; symmetric_pir_process and process(...,
symmetric_pir_config=...) must give she_tpu's bytes. The OPRF is pure
Python (tens of milliseconds an evaluation), so the cases keep to a few
evaluations.
"""

import hashlib
import random

import numpy as np
import pytest

from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.pir import keyword_pir as jkp
from she_tpu.pir import oprf as joprf
from she_tpu.pir import process_database as jpd
from she_tpu.pir import symmetric_pir as jspir
from she_tpu_torch import errors
from she_tpu_torch import params as tparams
from she_tpu_torch.pir import keyword_pir as tkp
from she_tpu_torch.pir import oprf
from she_tpu_torch.pir import process_database as tpd
from she_tpu_torch.pir import symmetric_pir as spir
from she_tpu_torch.utils import aes_gcm

OPRF_KEY = bytes(47) + b"\x05"


def test_curve_basics():
    g = oprf.GENERATOR
    g2 = oprf.point_add(g, g)
    assert oprf.point_mul(2, g) == g2
    assert oprf.point_mul(3, g) == oprf.point_add(g2, g)
    assert oprf.point_add(g, oprf.point_neg(g)) is None
    assert oprf.point_mul(oprf.N, g) is None
    p = oprf.point_mul(12345, g)
    assert oprf.deserialize_element(oprf.serialize_element(p)) == p


def test_expand_message_xmd_rfc9380_k1_vectors():
    dst = b"QUUX-V01-CS02-with-expander-SHA256-128"
    assert oprf._expand_message_xmd(b"", dst, 0x20, hashlib.sha256).hex() == (
        "68a985b87eb6b46952128911f2a4412bbc302a9d759667f87f7a21d803f07235")
    assert oprf._expand_message_xmd(b"abc", dst, 0x20, hashlib.sha256).hex() == (
        "d8ccab23b5985ccea865c6c97b6e5b8350e794e603b4b97902f53a8a0d605615")


def test_hash_to_curve_rfc9380_j2_vector():
    x, y = oprf.hash_to_curve(b"", b"QUUX-V01-CS02-with-P384_XMD:SHA-384_SSWU_RO_")
    assert "%096x" % x == ("eb9fe1b4f4e14e7140803c1d99d0a93cd823d2b024040f9c067a8eca1f5a2eea"
                           "c9ad604973527a356f3fa3aeff0e4d83")
    assert "%096x" % y == ("0c21708cff382b7f4643c07b105c2eaec2cead93a917d825601e63c8f21f6abd"
                           "9abc22c93c2bed6f235954b25048bb1a")


def test_derive_key_pair_rfc9497_a4_vector():
    sk = oprf.derive_key_pair(bytes([0xA3] * 32), b"test key", mode=oprf.MODE_VOPRF)
    assert "%096x" % sk == ("051646b9e6e7a71ae27c1e1d0b87b4381db6d3595eeeb1adb41579adbf992f42"
                            "78f9016eafc944edaa2b43183581779d")


def test_oprf_matches_she_tpu_for_fixed_blinds_and_nonces():
    sk, jsk = oprf.OprfPrivateKey(bytes(47) + b"\x07"), joprf.OprfPrivateKey(bytes(47) + b"\x07")
    pk, jpk = sk.public_key, jsk.public_key
    assert pk.oprf_representation == jpk.oprf_representation
    keyword = b"alice"
    blinded = pk.blind(keyword, blind=123456789)
    assert blinded.blinded_element == jpk.blind(keyword, blind=123456789).blinded_element
    response = sk.blind_evaluate(blinded.blinded_element, proof_r=987654321)
    jresponse = jsk.blind_evaluate(blinded.blinded_element, proof_r=987654321)
    assert (response.evaluated_element, response.proof) == (jresponse.evaluated_element, jresponse.proof)
    output = pk.finalize(blinded, response)
    assert output == sk.evaluate(keyword) == jsk.evaluate(keyword)
    assert len(output) == 48


def test_oprf_proof_rejects_wrong_key():
    sk = oprf.OprfPrivateKey(bytes(47) + b"\x07")
    other = oprf.OprfPrivateKey(bytes(47) + b"\x09")
    blinded = sk.public_key.blind(b"keyword")
    with pytest.raises(ValueError):
        sk.public_key.finalize(blinded, other.blind_evaluate(blinded.blinded_element))


# -- AES-GCM -----------------------------------------------------------------------

# The GCM specification's AES-192 test cases with a 96-bit IV and no
# associated data: (key, iv, plaintext, ciphertext, tag).
_K9 = "feffe9928665731c6d6a8f9467308308feffe9928665731c"
_P9 = ("d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
       "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b391aafd255")
_C9 = ("3980ca0b3c00e841eb06fac4872a2757859e1ceaa6efd984628593b40ca1e19c"
       "7d773d00c144c525ac619d18c84a3f4718e2448b2fe324d9ccda2710acade256")
GCM_SPEC_AES192 = [
    ("00" * 24, "00" * 12, "", "", "cd33b28ac773f74ba00ed1f312572435"),
    ("00" * 24, "00" * 12, "00" * 16, "98e7247c07f0fe411c267e4384b0f600", "2ff58d80033927ab8ef4d4587514f0fb"),
    (_K9, "cafebabefacedbaddecaf888", _P9, _C9, "9924a7c8587336bfb118024db8674a14"),
]


@pytest.mark.parametrize("key,iv,plaintext,ciphertext,tag", GCM_SPEC_AES192, ids=["tc7", "tc8", "tc9"])
def test_aes192_gcm_spec_vectors(key, iv, plaintext, ciphertext, tag):
    key, iv, plaintext = bytes.fromhex(key), bytes.fromhex(iv), bytes.fromhex(plaintext)
    sealed = aes_gcm.seal(key, iv, plaintext)
    assert sealed.hex() == ciphertext + tag
    assert aes_gcm.unseal(key, iv, sealed) == plaintext


def test_aes_gcm_matches_cryptography():
    aead = pytest.importorskip("cryptography.hazmat.primitives.ciphers.aead")
    rng = np.random.default_rng(4)
    for key_bytes in (16, 24):
        for length in (0, 1, 15, 16, 17, 61):
            key, iv = rng.bytes(key_bytes), rng.bytes(12)
            plaintext = rng.bytes(length)
            want = aead.AESGCM(key).encrypt(iv, plaintext, None)
            assert aes_gcm.seal(key, iv, plaintext) == want
            assert aes_gcm.unseal(key, iv, want) == plaintext


def test_aes_gcm_refuses_tampering():
    key, iv = bytes(range(24)), bytes(range(12))
    sealed = bytearray(aes_gcm.seal(key, iv, b"the value"))
    for i in (0, len(sealed) - 1):
        bad = bytearray(sealed)
        bad[i] ^= 1
        with pytest.raises(aes_gcm.InvalidTag):
            aes_gcm.unseal(key, iv, bytes(bad))
    with pytest.raises(aes_gcm.InvalidTag):
        aes_gcm.unseal(bytes(24), iv, bytes(sealed))
    with pytest.raises(aes_gcm.InvalidTag):
        aes_gcm.unseal(key, iv, b"short")
    with pytest.raises(ValueError):
        aes_gcm.seal(key, bytes(8), b"x")
    with pytest.raises(ValueError):
        aes_gcm.seal(bytes(32), iv, b"x")


# -- Symmetric PIR -------------------------------------------------------------------


def test_symmetric_pir_process_matches_she_tpu_and_round_trips():
    rows = [(b"keyword-a", b"value-a"), (b"keyword-b", b"another value"), (b"k", b"")]
    config = spir.SymmetricPirConfig(OPRF_KEY)
    processed = spir.symmetric_pir_process(rows, config)
    assert processed == jspir.symmetric_pir_process(rows, jspir.SymmetricPirConfig(OPRF_KEY))
    assert all(len(kw) == 16 for kw, _ in processed)
    server, client = spir.OprfServer(config), spir.OprfClient(config.client_config())
    for (kw, value), (oblivious, sealed) in zip(rows[:2], processed):
        context = client.query_context(kw)
        parsed = client.parse(server.compute_response(context.query), context)
        assert parsed.oblivious_keyword == oblivious
        assert client.decrypt(sealed, parsed) == value
    with pytest.raises(aes_gcm.InvalidTag):
        client.decrypt(processed[0][1], parsed)  # sealed under another row's key
    with pytest.raises(errors.PirError):
        spir.SymmetricPirConfig(bytes(47))


def test_process_with_symmetric_pir_matches_she_tpu():
    """Database processing seals the rows first and shards the oblivious
    keywords: the same cuckoo tables and plaintexts as she_tpu's."""
    rows = {f"kw{i}".encode(): bytes([i, 3 * i]) for i in range(4)}
    name = "insecure_n_8_logq_5x18_logt_5"
    tep, jep = tparams.from_predefined(name, 32), jparams.from_predefined(name, 32)
    bucket = tkp.default_max_serialized_bucket_size(18, tep.bytes_per_plaintext)
    targs = tpd.Arguments(
        tpd.KeywordDatabaseConfig(tkp.Sharding("shardCount", 2),
                                  tkp.KeywordPirConfig(2, tkp.CuckooTableConfig.default_keyword_pir(bucket))),
        tep, trials_per_shard=0, symmetric_pir_config=spir.SymmetricPirConfig(OPRF_KEY))
    jargs = jpd.Arguments(
        jpd.KeywordDatabaseConfig(jkp.Sharding("shardCount", 2),
                                  jkp.KeywordPirConfig(2, jkp.CuckooTableConfig.default_keyword_pir(bucket))),
        jep, trials_per_shard=0, symmetric_pir_config=jspir.SymmetricPirConfig(OPRF_KEY))
    got = tpd.process(rows, targs, rng=random.Random(2), device="cpu")
    want = jpd.process(rows, jargs, rng=random.Random(2))
    assert sorted(got.shards) == sorted(want.shards)
    assert got.evaluation_key_config.galois_elements == want.evaluation_key_config.galois_elements
    jctx = jbfv.get_bfv_context(jep)
    for shard_id, shard in got.shards.items():
        assert shard.pir_parameter.dimensions == want.shards[shard_id].pir_parameter.dimensions
        assert shard.database.serialize() == want.shards[shard_id].database.serialize(jctx)


def test_arguments_check_trials_and_keep_key_compression():
    config = tpd.KeywordDatabaseConfig(
        tkp.Sharding("shardCount", 1), tkp.KeywordPirConfig(2, tkp.CuckooTableConfig.default_keyword_pir(64)))
    ep = tparams.from_predefined("insecure_n_8_logq_5x18_logt_5", 32)
    args = tpd.Arguments(config, ep)
    assert (args.trials_per_shard, args.key_compression, args.symmetric_pir_config) == (
        1, tpd.ip.PirKeyCompression.NO_COMPRESSION, None)
    with pytest.raises(errors.PirError):
        tpd.Arguments(config, ep, trials_per_shard=-1)
    with pytest.raises(errors.PirError):
        tpd.Arguments(config, ep, algorithm="simplePir")
