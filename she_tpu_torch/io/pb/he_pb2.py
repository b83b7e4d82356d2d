# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: apple/swift_homomorphic_encryption/v1/he.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n.apple/swift_homomorphic_encryption/v1/he.proto\x12%apple.swift_homomorphic_encryption.v1\"#\n\x13SerializedPlaintext\x12\x0c\n\x04poly\x18\x01 \x01(\x0c\"k\n\x17SerializedCiphertextVec\x12P\n\x0b\x63iphertexts\x18\x01 \x03(\x0b\x32;.apple.swift_homomorphic_encryption.v1.SerializedCiphertext\"\xda\x01\n\x14SerializedCiphertext\x12S\n\x06seeded\x18\x01 \x01(\x0b\x32\x41.apple.swift_homomorphic_encryption.v1.SerializedSeededCiphertextH\x00\x12O\n\x04\x66ull\x18\x02 \x01(\x0b\x32?.apple.swift_homomorphic_encryption.v1.SerializedFullCiphertextH\x00\x42\x1c\n\x1aserialized_ciphertext_type\"9\n\x1aSerializedSeededCiphertext\x12\r\n\x05poly0\x18\x01 \x01(\x0c\x12\x0c\n\x04seed\x18\x02 \x01(\x0c\"W\n\x18SerializedFullCiphertext\x12\r\n\x05polys\x18\x01 \x01(\x0c\x12\x11\n\tskip_lsbs\x18\x02 \x03(\r\x12\x19\n\x11\x63orrection_factor\x18\x03 \x01(\x04\"p\n\x16SerializedKeySwitchKey\x12V\n\x0ekey_switch_key\x18\x01 \x01(\x0b\x32>.apple.swift_homomorphic_encryption.v1.SerializedCiphertextVec\"\xf2\x01\n\x13SerializedGaloisKey\x12\x66\n\x0fkey_switch_keys\x18\x01 \x03(\x0b\x32M.apple.swift_homomorphic_encryption.v1.SerializedGaloisKey.KeySwitchKeysEntry\x1as\n\x12KeySwitchKeysEntry\x12\x0b\n\x03key\x18\x01 \x01(\x04\x12L\n\x05value\x18\x02 \x01(\x0b\x32=.apple.swift_homomorphic_encryption.v1.SerializedKeySwitchKey:\x02\x38\x01\"f\n\x12SerializedRelinKey\x12P\n\trelin_key\x18\x01 \x01(\x0b\x32=.apple.swift_homomorphic_encryption.v1.SerializedKeySwitchKey\"$\n\x13SerializedSecretKey\x12\r\n\x05polys\x18\x01 \x01(\x0c\"\xb7\x01\n\x17SerializedEvaluationKey\x12N\n\ngalois_key\x18\x01 \x01(\x0b\x32:.apple.swift_homomorphic_encryption.v1.SerializedGaloisKey\x12L\n\trelin_key\x18\x02 \x01(\x0b\x32\x39.apple.swift_homomorphic_encryption.v1.SerializedRelinKey\"\xa1\x01\n\x13\x45valuationKeyConfig\x12Z\n\x15\x65ncryption_parameters\x18\x01 \x01(\x0b\x32;.apple.swift_homomorphic_encryption.v1.EncryptionParameters\x12\x17\n\x0fgalois_elements\x18\x02 \x03(\r\x12\x15\n\rhas_relin_key\x18\x03 \x01(\x08\"\xc5\x02\n\x14\x45ncryptionParameters\x12\x19\n\x11polynomial_degree\x18\x01 \x01(\x04\x12\x19\n\x11plaintext_modulus\x18\x02 \x01(\x04\x12\x1a\n\x12\x63oefficient_moduli\x18\x03 \x03(\x04\x12I\n\rerror_std_dev\x18\x04 \x01(\x0e\x32\x32.apple.swift_homomorphic_encryption.v1.ErrorStdDev\x12L\n\x0esecurity_level\x18\x05 \x01(\x0e\x32\x34.apple.swift_homomorphic_encryption.v1.SecurityLevel\x12\x42\n\the_scheme\x18\x06 \x01(\x0e\x32/.apple.swift_homomorphic_encryption.v1.HeScheme*E\n\x0b\x45rrorStdDev\x12\x1a\n\x16\x45RROR_STD_DEV_STDDEV32\x10\x00\x12\x1a\n\x16\x45RROR_STD_DEV_STDDEV64\x10\x01*N\n\rSecurityLevel\x12\x1e\n\x1aSECURITY_LEVEL_UNSPECIFIED\x10\x00\x12\x1d\n\x19SECURITY_LEVEL_QUANTUM128\x10\x01*K\n\x08HeScheme\x12\x19\n\x15HE_SCHEME_UNSPECIFIED\x10\x00\x12\x11\n\rHE_SCHEME_BFV\x10\x01\x12\x11\n\rHE_SCHEME_BGV\x10\x02\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'she_tpu_torch.io.pb.he_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SERIALIZEDGALOISKEY_KEYSWITCHKEYSENTRY._options = None
  _SERIALIZEDGALOISKEY_KEYSWITCHKEYSENTRY._serialized_options = b'8\001'
  _ERRORSTDDEV._serialized_start=1783
  _ERRORSTDDEV._serialized_end=1852
  _SECURITYLEVEL._serialized_start=1854
  _SECURITYLEVEL._serialized_end=1932
  _HESCHEME._serialized_start=1934
  _HESCHEME._serialized_end=2009
  _SERIALIZEDPLAINTEXT._serialized_start=89
  _SERIALIZEDPLAINTEXT._serialized_end=124
  _SERIALIZEDCIPHERTEXTVEC._serialized_start=126
  _SERIALIZEDCIPHERTEXTVEC._serialized_end=233
  _SERIALIZEDCIPHERTEXT._serialized_start=236
  _SERIALIZEDCIPHERTEXT._serialized_end=454
  _SERIALIZEDSEEDEDCIPHERTEXT._serialized_start=456
  _SERIALIZEDSEEDEDCIPHERTEXT._serialized_end=513
  _SERIALIZEDFULLCIPHERTEXT._serialized_start=515
  _SERIALIZEDFULLCIPHERTEXT._serialized_end=602
  _SERIALIZEDKEYSWITCHKEY._serialized_start=604
  _SERIALIZEDKEYSWITCHKEY._serialized_end=716
  _SERIALIZEDGALOISKEY._serialized_start=719
  _SERIALIZEDGALOISKEY._serialized_end=961
  _SERIALIZEDGALOISKEY_KEYSWITCHKEYSENTRY._serialized_start=846
  _SERIALIZEDGALOISKEY_KEYSWITCHKEYSENTRY._serialized_end=961
  _SERIALIZEDRELINKEY._serialized_start=963
  _SERIALIZEDRELINKEY._serialized_end=1065
  _SERIALIZEDSECRETKEY._serialized_start=1067
  _SERIALIZEDSECRETKEY._serialized_end=1103
  _SERIALIZEDEVALUATIONKEY._serialized_start=1106
  _SERIALIZEDEVALUATIONKEY._serialized_end=1289
  _EVALUATIONKEYCONFIG._serialized_start=1292
  _EVALUATIONKEYCONFIG._serialized_end=1453
  _ENCRYPTIONPARAMETERS._serialized_start=1456
  _ENCRYPTIONPARAMETERS._serialized_end=1781
# @@protoc_insertion_point(module_scope)
