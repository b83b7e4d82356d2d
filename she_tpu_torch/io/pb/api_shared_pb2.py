# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: apple/swift_homomorphic_encryption/api/shared/v1/api_shared.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import he_pb2 as apple_dot_swift__homomorphic__encryption_dot_v1_dot_he__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\nAapple/swift_homomorphic_encryption/api/shared/v1/api_shared.proto\x12\x30\x61pple.swift_homomorphic_encryption.api.shared.v1\x1a.apple/swift_homomorphic_encryption/v1/he.proto\">\n\x15\x45valuationKeyMetadata\x12\x11\n\ttimestamp\x18\x01 \x01(\x04\x12\x12\n\nidentifier\x18\x02 \x01(\x0c\"n\n\tKeyStatus\x12\x11\n\ttimestamp\x18\x01 \x01(\x04\x12N\n\nkey_config\x18\x02 \x01(\x0b\x32:.apple.swift_homomorphic_encryption.v1.EvaluationKeyConfig\"_\n\x0e\x45valuationKeys\x12M\n\x04keys\x18\x01 \x03(\x0b\x32?.apple.swift_homomorphic_encryption.api.shared.v1.EvaluationKey\"\xc2\x01\n\rEvaluationKey\x12Y\n\x08metadata\x18\x01 \x01(\x0b\x32G.apple.swift_homomorphic_encryption.api.shared.v1.EvaluationKeyMetadata\x12V\n\x0e\x65valuation_key\x18\x02 \x01(\x0b\x32>.apple.swift_homomorphic_encryption.v1.SerializedEvaluationKeyb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'she_tpu_torch.io.pb.api_shared_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EVALUATIONKEYMETADATA._serialized_start=167
  _EVALUATIONKEYMETADATA._serialized_end=229
  _KEYSTATUS._serialized_start=231
  _KEYSTATUS._serialized_end=341
  _EVALUATIONKEYS._serialized_start=343
  _EVALUATIONKEYS._serialized_end=438
  _EVALUATIONKEY._serialized_start=441
  _EVALUATIONKEY._serialized_end=635
# @@protoc_insertion_point(module_scope)
