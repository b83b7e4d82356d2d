"""Native <-> protobuf bridges (reference ConversionHe.swift:24-347 and the
ApplicationProtobuf conversions).

The HE and PIR half of she_tpu/io/proto_conversion.py:18-287: encryption
parameters, ciphertexts (seeded, full, and the skip-LSB form for
decryption), key-switch, evaluation and secret keys, sharding functions,
PIR parameters, the keyword database, and PIR queries and responses. The
bytes inside the messages are io/serialize.py's, so both packages write
the same messages. The PNNS half waits for PNNS.
"""

from __future__ import annotations

from .. import errors
from .. import params as paramsmod
from ..bfv import keys as keysmod
from ..core.poly import COEFF
from ..pir import index_pir as ip
from ..pir import keyword_pir as kp
from . import pb
from . import serialize as ser

# -- EncryptionParameters -----------------------------------------------------


def encryption_parameters_to_proto(ep: paramsmod.EncryptionParameters):
    msg = pb.he_pb2.EncryptionParameters()
    msg.polynomial_degree = ep.poly_degree
    msg.plaintext_modulus = ep.plaintext_modulus
    msg.coefficient_moduli.extend(ep.coefficient_moduli)
    msg.error_std_dev = (
        pb.he_pb2.ERROR_STD_DEV_STDDEV32
        if ep.error_std_dev == paramsmod.ErrorStdDev.STDDEV_32
        else pb.he_pb2.ERROR_STD_DEV_STDDEV64
    )
    msg.security_level = (
        pb.he_pb2.SECURITY_LEVEL_QUANTUM128
        if ep.security_level == paramsmod.SecurityLevel.QUANTUM128
        else pb.he_pb2.SECURITY_LEVEL_UNSPECIFIED
    )
    msg.he_scheme = pb.he_pb2.HE_SCHEME_BFV
    return msg


def encryption_parameters_from_proto(msg, scalar_bits: int = 64) -> paramsmod.EncryptionParameters:
    return paramsmod.EncryptionParameters(
        poly_degree=int(msg.polynomial_degree),
        plaintext_modulus=int(msg.plaintext_modulus),
        coefficient_moduli=tuple(int(q) for q in msg.coefficient_moduli),
        error_std_dev=(
            paramsmod.ErrorStdDev.STDDEV_32
            if msg.error_std_dev == pb.he_pb2.ERROR_STD_DEV_STDDEV32
            else paramsmod.ErrorStdDev.STDDEV_64
        ),
        security_level=(
            paramsmod.SecurityLevel.QUANTUM128
            if msg.security_level == pb.he_pb2.SECURITY_LEVEL_QUANTUM128
            else paramsmod.SecurityLevel.UNCHECKED
        ),
        scalar_bits=scalar_bits,
    )


# -- ciphertexts ----------------------------------------------------------------


def serialized_ciphertext_to_proto(s: ser.SerializedCiphertext):
    msg = pb.he_pb2.SerializedCiphertext()
    if s.kind == "seeded":
        msg.seeded.poly0 = s.polys
        msg.seeded.seed = s.seed
    else:
        msg.full.polys = s.polys
        msg.full.skip_lsbs.extend(s.skip_lsbs)
        msg.full.correction_factor = s.correction_factor
    return msg


def serialized_ciphertext_from_proto(msg) -> ser.SerializedCiphertext:
    which = msg.WhichOneof("serialized_ciphertext_type")
    if which == "seeded":
        return ser.SerializedCiphertext(kind="seeded", polys=bytes(msg.seeded.poly0), seed=bytes(msg.seeded.seed))
    if which == "full":
        return ser.SerializedCiphertext(
            kind="full",
            polys=bytes(msg.full.polys),
            skip_lsbs=tuple(msg.full.skip_lsbs),
            correction_factor=int(msg.full.correction_factor),
        )
    raise errors.SerializationError("empty SerializedCiphertext")


def serialized_plaintext_to_proto(data: bytes):
    msg = pb.he_pb2.SerializedPlaintext()
    msg.poly = data
    return msg


def ciphertext_to_proto(ct, for_decryption: bool = False):
    return serialized_ciphertext_to_proto(ser.serialize_ciphertext(ct, for_decryption))


def ciphertexts_from_proto(msgs, context, fmt=COEFF, moduli_count=None) -> list:
    """Many ciphertext messages at once: the seeded ones expand their seeds
    together (io/serialize.deserialize_ciphertexts)."""
    return ser.deserialize_ciphertexts([serialized_ciphertext_from_proto(m) for m in msgs], context, fmt, moduli_count)


def ciphertext_from_proto(msg, context, fmt=COEFF, moduli_count=None):
    return ciphertexts_from_proto([msg], context, fmt, moduli_count)[0]


# -- keys -------------------------------------------------------------------------


def key_switch_key_to_proto(ksk):
    msg = pb.he_pb2.SerializedKeySwitchKey()
    for s in ser.serialize_key_switch_key(ksk):
        msg.key_switch_key.ciphertexts.append(serialized_ciphertext_to_proto(s))
    return msg


def key_switch_key_from_proto(msg, context):
    return ser.deserialize_key_switch_key(
        [serialized_ciphertext_from_proto(c) for c in msg.key_switch_key.ciphertexts], context
    )


def evaluation_key_to_proto(ek):
    msg = pb.he_pb2.SerializedEvaluationKey()
    if ek.galois_key is not None:
        for element, ksk in ek.galois_key.keys.items():
            msg.galois_key.key_switch_keys[element].CopyFrom(key_switch_key_to_proto(ksk))
    if ek.relinearization_key is not None:
        msg.relin_key.relin_key.CopyFrom(key_switch_key_to_proto(ek.relinearization_key.key_switch_key))
    return msg


def evaluation_key_from_proto(msg, context):
    galois = None
    if msg.HasField("galois_key") and msg.galois_key.key_switch_keys:
        galois = keysmod.GaloisKey(
            {int(el): key_switch_key_from_proto(k, context) for el, k in msg.galois_key.key_switch_keys.items()}
        )
    relin = None
    if msg.HasField("relin_key"):
        relin = keysmod.RelinearizationKey(key_switch_key_from_proto(msg.relin_key.relin_key, context))
    return keysmod.EvaluationKey(galois, relin)


def secret_key_to_proto(sk):
    msg = pb.he_pb2.SerializedSecretKey()
    msg.polys = ser.serialize_secret_key(sk)
    return msg


def secret_key_from_proto(msg, context):
    return ser.deserialize_secret_key(bytes(msg.polys), context)


# -- PIR ----------------------------------------------------------------------------


def sharding_function_to_proto(fn: kp.ShardingFunction):
    msg = pb.pir_pb2.PIRShardingFunction()
    if fn.kind == "sha256":
        msg.sha256.SetInParent()
    else:
        msg.double_mod.other_shard_count = fn.other_shard_count
    return msg


def sharding_function_from_proto(msg) -> kp.ShardingFunction:
    if msg.WhichOneof("function") == "double_mod":
        return kp.ShardingFunction("doubleMod", int(msg.double_mod.other_shard_count))
    return kp.ShardingFunction("sha256")


def evaluation_key_config_to_proto(config: keysmod.EvaluationKeyConfig):
    msg = pb.he_pb2.EvaluationKeyConfig()
    msg.galois_elements.extend(config.galois_elements)
    msg.has_relin_key = config.has_relinearization_key
    return msg


def pir_parameters_to_proto(parameter: ip.IndexPirParameter, ep: paramsmod.EncryptionParameters,
                            keyword_parameter: kp.KeywordPirParameter | None = None):
    """IndexPirParameter (and a KeywordPirParameter) -> PirParameters."""
    msg = pb.pir_pb2.PirParameters()
    msg.encryption_parameters.CopyFrom(encryption_parameters_to_proto(ep))
    msg.num_entries = parameter.entry_count
    msg.entry_size = parameter.entry_size_in_bytes
    msg.dimensions.extend(parameter.dimensions)
    msg.algorithm = pb.pir_pb2.PIR_ALGORITHM_MUL_PIR
    msg.batch_size = parameter.batch_size
    msg.evaluation_key_config.CopyFrom(evaluation_key_config_to_proto(parameter.evaluation_key_config))
    msg.encoding_entry_size = parameter.encoding_entry_size
    if keyword_parameter is not None:
        msg.keyword_pir_params.num_hash_functions = keyword_parameter.hash_function_count
        msg.keyword_pir_params.sharding_function.CopyFrom(sharding_function_to_proto(keyword_parameter.sharding_function))
    return msg


def pir_parameters_from_proto(msg, scalar_bits: int = 64):
    """PirParameters -> (EncryptionParameters, IndexPirParameter,
    KeywordPirParameter or None)."""
    ep = encryption_parameters_from_proto(msg.encryption_parameters, scalar_bits)
    parameter = ip.IndexPirParameter(
        entry_count=int(msg.num_entries),
        entry_size_in_bytes=int(msg.entry_size),
        dimensions=tuple(int(d) for d in msg.dimensions),
        batch_size=int(msg.batch_size),
        evaluation_key_config=keysmod.EvaluationKeyConfig(
            tuple(int(e) for e in msg.evaluation_key_config.galois_elements),
            bool(msg.evaluation_key_config.has_relin_key),
        ),
        encoding_entry_size=bool(msg.encoding_entry_size),
    )
    keyword_parameter = None
    if msg.HasField("keyword_pir_params"):
        keyword_parameter = kp.KeywordPirParameter(
            int(msg.keyword_pir_params.num_hash_functions),
            sharding_function_from_proto(msg.keyword_pir_params.sharding_function),
        )
    return ep, parameter, keyword_parameter


def keyword_database_to_proto(rows: dict[bytes, bytes]):
    msg = pb.pir_pb2.KeywordDatabase()
    for kw, val in rows.items():
        row = msg.rows.add()
        row.keyword = kw
        row.value = val
    return msg


def keyword_database_from_proto(msg) -> dict[bytes, bytes]:
    return {bytes(r.keyword): bytes(r.value) for r in msg.rows}


def pir_query_to_proto(query: ip.Query):
    msg = pb.pir_pb2.EncryptedIndices()
    for ct in query.ciphertexts:
        msg.ciphertexts.append(ciphertext_to_proto(ct))
    msg.num_pir_calls = query.indices_count
    return msg


def pir_query_from_proto(msg, context) -> ip.Query:
    return ip.Query(ciphertexts_from_proto(msg.ciphertexts, context), int(msg.num_pir_calls))


def pir_response_to_proto(response: ip.Response) -> list:
    """The reference's response wire form: one SerializedCiphertextVec per
    reply, each ciphertext in its skip-LSB form for decryption."""
    out = []
    for reply in response.ciphertexts:
        vec = pb.he_pb2.SerializedCiphertextVec()
        for ct in reply:
            vec.ciphertexts.append(ciphertext_to_proto(ct, for_decryption=True))
        out.append(vec)
    return out


def pir_response_from_proto(vecs, context) -> ip.Response:
    return ip.Response([ciphertexts_from_proto(vec.ciphertexts, context, moduli_count=1) for vec in vecs])
