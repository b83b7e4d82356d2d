# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: apple/swift_homomorphic_encryption/api/pnns/v1/api_pnns.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import api_shared_pb2 as apple_dot_swift__homomorphic__encryption_dot_api_dot_shared_dot_v1_dot_api__shared__pb2
from . import pnns_pb2 as apple_dot_swift__homomorphic__encryption_dot_pnns_dot_v1_dot_pnns__pb2
from . import he_pb2 as apple_dot_swift__homomorphic__encryption_dot_v1_dot_he__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n=apple/swift_homomorphic_encryption/api/pnns/v1/api_pnns.proto\x12.apple.swift_homomorphic_encryption.api.pnns.v1\x1a\x41\x61pple/swift_homomorphic_encryption/api/shared/v1/api_shared.proto\x1a\x35\x61pple/swift_homomorphic_encryption/pnns/v1/pnns.proto\x1a.apple/swift_homomorphic_encryption/v1/he.proto\"\x85\x03\n\nPNNSConfig\x12Z\n\x15\x65ncryption_parameters\x18\x01 \x01(\x0b\x32;.apple.swift_homomorphic_encryption.v1.EncryptionParameters\x12\x16\n\x0escaling_factor\x18\x02 \x01(\x04\x12P\n\rquery_packing\x18\x03 \x01(\x0b\x32\x39.apple.swift_homomorphic_encryption.pnns.v1.MatrixPacking\x12\x18\n\x10vector_dimension\x18\x04 \x01(\r\x12S\n\x0f\x64istance_metric\x18\x05 \x01(\x0e\x32:.apple.swift_homomorphic_encryption.pnns.v1.DistanceMetric\x12\"\n\x1a\x65valuation_key_config_hash\x18\x06 \x01(\x0c\x12\x1e\n\x16\x65xtra_plaintext_moduli\x18\x07 \x03(\x04\"\xe4\x02\n\x0bPNNSRequest\x12\x15\n\rshard_indices\x18\x01 \x03(\r\x12U\n\x05query\x18\x02 \x03(\x0b\x32\x46.apple.swift_homomorphic_encryption.pnns.v1.SerializedCiphertextMatrix\x12h\n\x17\x65valuation_key_metadata\x18\x03 \x01(\x0b\x32G.apple.swift_homomorphic_encryption.api.shared.v1.EvaluationKeyMetadata\x12\x11\n\tconfig_id\x18\x04 \x01(\x0c\x12W\n\x0e\x65valuation_key\x18\x05 \x01(\x0b\x32?.apple.swift_homomorphic_encryption.api.shared.v1.EvaluationKey\x12\x11\n\tshard_ids\x18\x06 \x03(\t\"\x96\x01\n\x11PNNSShardResponse\x12U\n\x05reply\x18\x01 \x03(\x0b\x32\x46.apple.swift_homomorphic_encryption.pnns.v1.SerializedCiphertextMatrix\x12\x11\n\tentry_ids\x18\x02 \x03(\x04\x12\x17\n\x0f\x65ntry_metadatas\x18\x03 \x03(\x0c\"j\n\x0cPNNSResponse\x12Z\n\x0fshard_responses\x18\x01 \x03(\x0b\x32\x41.apple.swift_homomorphic_encryption.api.pnns.v1.PNNSShardResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'she_tpu_torch.io.pb.api_pnns_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PNNSCONFIG._serialized_start=284
  _PNNSCONFIG._serialized_end=673
  _PNNSREQUEST._serialized_start=676
  _PNNSREQUEST._serialized_end=1032
  _PNNSSHARDRESPONSE._serialized_start=1035
  _PNNSSHARDRESPONSE._serialized_end=1185
  _PNNSRESPONSE._serialized_start=1187
  _PNNSRESPONSE._serialized_end=1293
# @@protoc_insertion_point(module_scope)
