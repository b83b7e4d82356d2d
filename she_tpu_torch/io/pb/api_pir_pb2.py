# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: apple/swift_homomorphic_encryption/api/pir/v1/api_pir.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import api_shared_pb2 as apple_dot_swift__homomorphic__encryption_dot_api_dot_shared_dot_v1_dot_api__shared__pb2
from . import pir_pb2 as apple_dot_swift__homomorphic__encryption_dot_pir_dot_v1_dot_pir__pb2
from . import he_pb2 as apple_dot_swift__homomorphic__encryption_dot_v1_dot_he__pb2
from google.protobuf import any_pb2 as google_dot_protobuf_dot_any__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n;apple/swift_homomorphic_encryption/api/pir/v1/api_pir.proto\x12-apple.swift_homomorphic_encryption.api.pir.v1\x1a\x41\x61pple/swift_homomorphic_encryption/api/shared/v1/api_shared.proto\x1a\x33\x61pple/swift_homomorphic_encryption/pir/v1/pir.proto\x1a.apple/swift_homomorphic_encryption/v1/he.proto\x1a\x19google/protobuf/any.proto\"\xb8\x01\n\x0ePIRShardConfig\x12\x13\n\x0bnum_entries\x18\x01 \x01(\x04\x12\x12\n\nentry_size\x18\x02 \x01(\x04\x12\x12\n\ndimensions\x18\x03 \x03(\x04\x12\x10\n\x08shard_id\x18\x04 \x01(\t\x12(\n compress_vectorized_pir_response\x18\x05 \x01(\x08\x12-\n%vectorized_pir_internal_batching_size\x18\x06 \x01(\x04\"\xb7\x04\n\tPIRConfig\x12Z\n\x15\x65ncryption_parameters\x18\x01 \x01(\x0b\x32;.apple.swift_homomorphic_encryption.v1.EncryptionParameters\x12T\n\rshard_configs\x18\x02 \x03(\x0b\x32=.apple.swift_homomorphic_encryption.api.pir.v1.PIRShardConfig\x12[\n\x12keyword_pir_params\x18\x03 \x01(\x0b\x32?.apple.swift_homomorphic_encryption.pir.v1.KeywordPirParameters\x12J\n\talgorithm\x18\x04 \x01(\x0e\x32\x37.apple.swift_homomorphic_encryption.pir.v1.PirAlgorithm\x12\x12\n\nbatch_size\x18\x05 \x01(\x04\x12\"\n\x1a\x65valuation_key_config_hash\x18\x06 \x01(\x0c\x12Y\n\x11pir_shard_configs\x18\n \x01(\x0b\x32>.apple.swift_homomorphic_encryption.api.pir.v1.PIRShardConfigs\x12\x1b\n\x13\x65ncoding_entry_size\x18\x0b \x01(\x08\x12\x1f\n\x01Y\x18\x64 \x01(\x0b\x32\x14.google.protobuf.Any\"\x87\x01\n\x0fPIRShardConfigs\x12\x63\n\x15repeated_shard_config\x18\x01 \x01(\x0b\x32\x42.apple.swift_homomorphic_encryption.api.pir.v1.PIRFixedShardConfigH\x00\x42\x0f\n\rshard_configs\"\x7f\n\x13PIRFixedShardConfig\x12S\n\x0cshard_config\x18\x01 \x01(\x0b\x32=.apple.swift_homomorphic_encryption.api.pir.v1.PIRShardConfig\x12\x13\n\x0bshard_count\x18\x02 \x01(\r\"\xde\x02\n\nPIRRequest\x12\x13\n\x0bshard_index\x18\x01 \x01(\r\x12J\n\x05query\x18\x02 \x01(\x0b\x32;.apple.swift_homomorphic_encryption.pir.v1.EncryptedIndices\x12h\n\x17\x65valuation_key_metadata\x18\x03 \x01(\x0b\x32G.apple.swift_homomorphic_encryption.api.shared.v1.EvaluationKeyMetadata\x12\x1a\n\x12\x63onfiguration_hash\x18\x04 \x01(\x0c\x12\x10\n\x08shard_id\x18\x05 \x01(\t\x12W\n\x0e\x65valuation_key\x18\x06 \x01(\x0b\x32?.apple.swift_homomorphic_encryption.api.shared.v1.EvaluationKey\"\xac\x01\n\x0bPIRResponse\x12O\n\x07replies\x18\x01 \x03(\x0b\x32>.apple.swift_homomorphic_encryption.v1.SerializedCiphertextVec\x12L\n\x05stash\x18\x02 \x01(\x0b\x32=.apple.swift_homomorphic_encryption.api.pir.v1.StashOfEntries\"7\n\x0bOPRFRequest\x12\x15\n\rquery_element\x18\x01 \x01(\x0c\x12\x11\n\tconfig_id\x18\x02 \x01(\x0c\"8\n\x0cOPRFResponse\x12\x19\n\x11\x65valuated_element\x18\x01 \x01(\x0c\x12\r\n\x05proof\x18\x02 \x01(\x0c\"\xd1\x01\n\x0fSimplePIRConfig\x12T\n\x10\x64\x61tabase_mapping\x18\x01 \x01(\x0b\x32:.apple.swift_homomorphic_encryption.pir.v1.DatabaseMapping\x12N\n\x06params\x18\x02 \x03(\x0b\x32>.apple.swift_homomorphic_encryption.pir.v1.SimplePIRParameters\x12\x18\n\x10hint_identifiers\x18\x03 \x03(\x0c\"\x90\x01\n\x10SimplePIRRequest\x12K\n\x07request\x18\x01 \x01(\x0b\x32:.apple.swift_homomorphic_encryption.pir.v1.SimplePIRMatrix\x12\x13\n\x0bshard_index\x18\x02 \x01(\r\x12\x1a\n\x12\x63onfiguration_hash\x18\x03 \x01(\x0c\"a\n\x11SimplePIRResponse\x12L\n\x08response\x18\x01 \x01(\x0b\x32:.apple.swift_homomorphic_encryption.pir.v1.SimplePIRMatrix\"Z\n\x0eStashOfEntries\x12\x17\n\x0fhashed_keywords\x18\x01 \x03(\x04\x12\x0e\n\x06values\x18\x02 \x03(\x0c\x12\x1f\n\x17removed_hashed_keywords\x18\x03 \x03(\x04\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'she_tpu_torch.io.pb.api_pir_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PIRSHARDCONFIG._serialized_start=306
  _PIRSHARDCONFIG._serialized_end=490
  _PIRCONFIG._serialized_start=493
  _PIRCONFIG._serialized_end=1060
  _PIRSHARDCONFIGS._serialized_start=1063
  _PIRSHARDCONFIGS._serialized_end=1198
  _PIRFIXEDSHARDCONFIG._serialized_start=1200
  _PIRFIXEDSHARDCONFIG._serialized_end=1327
  _PIRREQUEST._serialized_start=1330
  _PIRREQUEST._serialized_end=1680
  _PIRRESPONSE._serialized_start=1683
  _PIRRESPONSE._serialized_end=1855
  _OPRFREQUEST._serialized_start=1857
  _OPRFREQUEST._serialized_end=1912
  _OPRFRESPONSE._serialized_start=1914
  _OPRFRESPONSE._serialized_end=1970
  _SIMPLEPIRCONFIG._serialized_start=1973
  _SIMPLEPIRCONFIG._serialized_end=2182
  _SIMPLEPIRREQUEST._serialized_start=2185
  _SIMPLEPIRREQUEST._serialized_end=2329
  _SIMPLEPIRRESPONSE._serialized_start=2331
  _SIMPLEPIRRESPONSE._serialized_end=2428
  _STASHOFENTRIES._serialized_start=2430
  _STASHOFENTRIES._serialized_end=2520
# @@protoc_insertion_point(module_scope)
