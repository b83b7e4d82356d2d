"""The port's protobuf conversions against she_tpu's, byte for byte
(mirrors tests/test_proto.py without its PNNS cases).

Each converter of she_tpu_torch.io.proto_conversion must write the bytes
she_tpu.io.proto_conversion writes from the same values, and each package
must read the other's bytes back to the same values. Messages are compared
as serialized bytes (deterministic, so map entries are ordered), never as
objects across the two packages. At 32- and 64-bit scalars.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from she_tpu import params as jparams
from she_tpu.bfv import bfv as jbfv
from she_tpu.bfv import keys as jkeys
from she_tpu.io import pb as jpb
from she_tpu.io import proto_conversion as jpc
from she_tpu.pir import index_pir as jip
from she_tpu.pir import keyword_pir as jkp
from she_tpu.rng.ctr_drbg import nist_aes128_ctr as jrng
from she_tpu_torch import convert
from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv as tbfv
from she_tpu_torch.io import pb as tpb
from she_tpu_torch.io import proto_conversion as tpc
from she_tpu_torch.pir import index_pir as tip
from she_tpu_torch.pir import keyword_pir as tkp
from she_tpu_torch.rng.ctr_drbg import nist_aes128_ctr as trng

PARAMS = "insecure_n_8_logq_5x18_logt_5"


def _seed(tag):
    return (tag * 32)[:32]


def _bytes(msg) -> bytes:
    return msg.SerializeToString(deterministic=True)


def _limbs(ct):
    return [np.asarray(p.data) for p in ct.polys]


@pytest.fixture(scope="module", params=[32, 64])
def setup(request):
    bits = request.param
    jctx = jbfv.get_bfv_context(jparams.from_predefined(PARAMS, bits))
    tctx = tbfv.get_bfv_context(tparams.from_predefined(PARAMS, bits), device="cpu")
    jsk = jbfv.generate_secret_key(jctx, jrng(_seed(b"s")))
    tsk = tbfv.generate_secret_key(tctx, trng(_seed(b"s")))
    return dict(bits=bits, jctx=jctx, tctx=tctx, jsk=jsk, tsk=tsk)


@pytest.mark.parametrize("name,bits", [
    ("n_8192_logq_3x55_logt_24", 64), ("n_4096_logq_27_28_28_logt_5", 32), (PARAMS, 32),
])
def test_encryption_parameters_bytes_match(name, bits):
    tep, jep = tparams.from_predefined(name, bits), jparams.from_predefined(name, bits)
    got = _bytes(tpc.encryption_parameters_to_proto(tep))
    assert got == _bytes(jpc.encryption_parameters_to_proto(jep))
    assert tpc.encryption_parameters_from_proto(tpb.he_pb2.EncryptionParameters.FromString(got), bits) == tep
    assert jpc.encryption_parameters_from_proto(jpb.he_pb2.EncryptionParameters.FromString(got), bits) == jep


def test_ciphertext_messages_match(setup):
    jctx, tctx = setup["jctx"], setup["tctx"]
    values = [int(v) for v in np.random.default_rng(1).integers(0, tctx.plaintext_modulus, size=tctx.degree)]
    jct = jbfv.encrypt(jbfv.encode(jctx, values), setup["jsk"], seed=_seed(b"c"), err_rng=jrng(_seed(b"e")))
    tct = tbfv.encrypt(tbfv.encode(tctx, values), setup["tsk"], seed=_seed(b"c"), err_rng=trng(_seed(b"e")))
    # seeded
    got = _bytes(tpc.ciphertext_to_proto(tct))
    assert got == _bytes(jpc.ciphertext_to_proto(jct))
    msg = tpb.he_pb2.SerializedCiphertext.FromString(got)
    assert msg.WhichOneof("serialized_ciphertext_type") == "seeded"
    assert tbfv.decode(tctx, tbfv.decrypt(tpc.ciphertext_from_proto(msg, tctx), setup["tsk"])) == values
    jback = jpc.ciphertext_from_proto(jpb.he_pb2.SerializedCiphertext.FromString(got), jctx)
    assert jbfv.decode(jctx, jbfv.decrypt(jback, setup["jsk"])) == values
    # full
    jct.seed, tct.seed = None, None
    got = _bytes(tpc.ciphertext_to_proto(tct))
    assert got == _bytes(jpc.ciphertext_to_proto(jct))
    back = tpc.ciphertext_from_proto(tpb.he_pb2.SerializedCiphertext.FromString(got), tctx)
    assert tbfv.decode(tctx, tbfv.decrypt(back, setup["tsk"])) == values
    # the skip-LSB form of a one-modulus ciphertext, for decryption
    jsingle, tsingle = jbfv.mod_switch_down_to_single(jct), tbfv.mod_switch_down_to_single(tct)
    got = _bytes(tpc.ciphertext_to_proto(tsingle, for_decryption=True))
    assert got == _bytes(jpc.ciphertext_to_proto(jsingle, for_decryption=True))
    back = tpc.ciphertext_from_proto(tpb.he_pb2.SerializedCiphertext.FromString(got), tctx, moduli_count=1)
    assert tbfv.decode(tctx, tbfv.decrypt(back, setup["tsk"])) == values
    assert _bytes(tpc.serialized_plaintext_to_proto(b"\x01\x02")) == _bytes(jpc.serialized_plaintext_to_proto(b"\x01\x02"))


def test_key_messages_match(setup):
    jctx, tctx = setup["jctx"], setup["tctx"]
    config = jkeys.EvaluationKeyConfig(galois_elements=(3, 5), has_relinearization_key=True)
    jek = jkeys.generate_evaluation_key(jctx, config, setup["jsk"], jrng(_seed(b"k")))
    galois = {e: [_limbs(ct) for ct in k.ciphertexts] for e, k in jek.galois_key.keys.items()}
    relin = [_limbs(ct) for ct in jek.relinearization_key.key_switch_key.ciphertexts]
    tek = convert.evaluation_key_from_limbs(tctx, galois, relin)
    got = _bytes(tpc.evaluation_key_to_proto(tek))
    assert got == _bytes(jpc.evaluation_key_to_proto(jek))
    back = tpc.evaluation_key_from_proto(tpb.he_pb2.SerializedEvaluationKey.FromString(got), tctx)
    got_galois, got_relin = convert.evaluation_key_to_limbs(back)
    assert set(got_galois) == {3, 5}
    for el in (3, 5):
        for g, w in zip(got_galois[el], galois[el], strict=True):
            for gp, wp in zip(g, w, strict=True):
                np.testing.assert_array_equal(gp, wp)
    for g, w in zip(got_relin, relin, strict=True):
        for gp, wp in zip(g, w, strict=True):
            np.testing.assert_array_equal(gp, wp)
    ksk = tek.relinearization_key.key_switch_key
    got = _bytes(tpc.key_switch_key_to_proto(ksk))
    assert got == _bytes(jpc.key_switch_key_to_proto(jek.relinearization_key.key_switch_key))
    jksk = jpc.key_switch_key_from_proto(jpb.he_pb2.SerializedKeySwitchKey.FromString(got), jctx)
    assert _bytes(jpc.key_switch_key_to_proto(jksk)) == got
    # the secret key
    got = _bytes(tpc.secret_key_to_proto(setup["tsk"]))
    assert got == _bytes(jpc.secret_key_to_proto(setup["jsk"]))
    back = tpc.secret_key_from_proto(tpb.he_pb2.SerializedSecretKey.FromString(got), tctx)
    jsk = jpc.secret_key_from_proto(jpb.he_pb2.SerializedSecretKey.FromString(got), jctx)  # held
    np.testing.assert_array_equal(convert.secret_key_to_limbs(back), np.asarray(jsk.poly.data))


@pytest.mark.parametrize("kind,other", [("sha256", 0), ("doubleMod", 8)])
def test_pir_parameters_and_sharding_messages_match(setup, kind, other):
    jctx, tctx = setup["jctx"], setup["tctx"]
    config = dict(entry_count=10, entry_size_in_bytes=3, dimension_count=2, batch_size=2, uneven_dimensions=True)
    jparam = jip.generate_parameter(
        jip.IndexPirConfig(**config, key_compression=jip.PirKeyCompression.NO_COMPRESSION), jctx)
    tparam = tip.generate_parameter(
        tip.IndexPirConfig(**config, key_compression=tip.PirKeyCompression.NO_COMPRESSION), tctx)
    jfn, tfn = jkp.ShardingFunction(kind, other), tkp.ShardingFunction(kind, other)
    got = _bytes(tpc.sharding_function_to_proto(tfn))
    assert got == _bytes(jpc.sharding_function_to_proto(jfn))
    assert tpc.sharding_function_from_proto(tpb.pir_pb2.PIRShardingFunction.FromString(got)) == tfn
    for tkw, jkw in ((None, None), (tkp.KeywordPirParameter(2, tfn), jkp.KeywordPirParameter(2, jfn))):
        got = _bytes(tpc.pir_parameters_to_proto(tparam, tctx.params, tkw))
        assert got == _bytes(jpc.pir_parameters_to_proto(jparam, jctx.params, jkw))
        ep, param, kw = tpc.pir_parameters_from_proto(tpb.pir_pb2.PirParameters.FromString(got), setup["bits"])
        assert (ep, param, kw) == (tctx.params, tparam, tkw)
        jep, jp, _ = jpc.pir_parameters_from_proto(jpb.pir_pb2.PirParameters.FromString(got), setup["bits"])
        assert jep == jctx.params and jp.dimensions == param.dimensions


def test_keyword_database_message_matches():
    rows = {b"a": b"1", b"bb": b"22", b"": b"\x00\xff"}
    got = _bytes(tpc.keyword_database_to_proto(rows))
    assert got == _bytes(jpc.keyword_database_to_proto(rows))
    assert tpc.keyword_database_from_proto(tpb.pir_pb2.KeywordDatabase.FromString(got)) == rows


def test_pir_query_and_response_messages_match(setup):
    jctx, tctx = setup["jctx"], setup["tctx"]
    config = dict(entry_count=6, entry_size_in_bytes=2, dimension_count=2, batch_size=1, uneven_dimensions=True)
    jparam = jip.generate_parameter(
        jip.IndexPirConfig(**config, key_compression=jip.PirKeyCompression.NO_COMPRESSION), jctx)
    tparam = tip.generate_parameter(
        tip.IndexPirConfig(**config, key_compression=tip.PirKeyCompression.NO_COMPRESSION), tctx)
    jclient = jip.MulPirClient(jparam, jctx)
    jquery = jclient.generate_query([3], setup["jsk"])
    want = _bytes(jpc.pir_query_to_proto(jquery))
    tquery = tpc.pir_query_from_proto(tpb.pir_pb2.EncryptedIndices.FromString(want), tctx)
    assert tquery.indices_count == 1 and len(tquery.ciphertexts) == len(jquery.ciphertexts)
    assert _bytes(tpc.pir_query_to_proto(tquery)) == want  # the seeds come through
    # the port answers she_tpu's query; she_tpu reads and decrypts the answer
    database = [bytes([i, 2 * i]) for i in range(6)]
    jek = jclient.generate_evaluation_key(setup["jsk"], jrng(_seed(b"k")))
    galois = {e: [_limbs(ct) for ct in k.ciphertexts] for e, k in jek.galois_key.keys.items()}
    relin = [_limbs(ct) for ct in jek.relinearization_key.key_switch_key.ciphertexts]
    tek = convert.evaluation_key_from_limbs(tctx, galois, relin)
    server = tip.MulPirServer(tparam, tctx, [tip.MulPirServer.process(database, tctx, tparam)])
    response = server.compute_response(tquery, tek)
    got = [_bytes(v) for v in tpc.pir_response_to_proto(response)]
    single = jctx.ciphertext_context.get_context(1)
    jresponse = jip.Response([
        [jbfv.Ciphertext(jctx, [jbfv.PolyRq(jnp.asarray(p), single, jbfv.COEFF)
                                for p in convert.ciphertext_to_limbs(ct)]) for ct in reply]
        for reply in response.ciphertexts
    ])
    assert got == [_bytes(v) for v in jpc.pir_response_to_proto(jresponse)]
    jback = jpc.pir_response_from_proto([jpb.he_pb2.SerializedCiphertextVec.FromString(d) for d in got], jctx)
    assert jclient.decrypt(jback, [3], setup["jsk"])[0][:2] == database[3]
    tback = tpc.pir_response_from_proto([tpb.he_pb2.SerializedCiphertextVec.FromString(d) for d in got], tctx)
    assert tip.MulPirClient(tparam, tctx).decrypt(tback, [3], setup["tsk"])[0][:2] == database[3]


def test_the_generated_modules_share_descriptors():
    """Both packages' generated modules describe the same messages, so a
    message of one parses the other's bytes."""
    for name in ("he_pb2", "pir_pb2", "pnns_pb2", "api_pb2", "api_shared_pb2", "api_pir_pb2", "api_pnns_pb2"):
        tmod, jmod = getattr(tpb, name), getattr(jpb, name)
        assert tmod.DESCRIPTOR.serialized_pb == jmod.DESCRIPTOR.serialized_pb
        assert tmod.__name__ == f"she_tpu_torch.io.pb.{name}"
