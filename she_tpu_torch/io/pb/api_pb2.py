# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: apple/swift_homomorphic_encryption/api/v1/api.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import api_pir_pb2 as apple_dot_swift__homomorphic__encryption_dot_api_dot_pir_dot_v1_dot_api__pir__pb2
from . import api_pnns_pb2 as apple_dot_swift__homomorphic__encryption_dot_api_dot_pnns_dot_v1_dot_api__pnns__pb2
from . import api_shared_pb2 as apple_dot_swift__homomorphic__encryption_dot_api_dot_shared_dot_v1_dot_api__shared__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n3apple/swift_homomorphic_encryption/api/v1/api.proto\x12)apple.swift_homomorphic_encryption.api.v1\x1a;apple/swift_homomorphic_encryption/api/pir/v1/api_pir.proto\x1a=apple/swift_homomorphic_encryption/api/pnns/v1/api_pnns.proto\x1a\x41\x61pple/swift_homomorphic_encryption/api/shared/v1/api_shared.proto\">\n\rConfigRequest\x12\x10\n\x08usecases\x18\x01 \x03(\t\x12\x1b\n\x13\x65xisting_config_ids\x18\x02 \x03(\x0c\"\xc4\x02\n\x06\x43onfig\x12\x11\n\tconfig_id\x18\x03 \x01(\x0c\x12\x1d\n\x15reuse_existing_config\x18\x04 \x01(\x08\x12N\n\npir_config\x18\x01 \x01(\x0b\x32\x38.apple.swift_homomorphic_encryption.api.pir.v1.PIRConfigH\x00\x12Q\n\x0bpnns_config\x18\x02 \x01(\x0b\x32:.apple.swift_homomorphic_encryption.api.pnns.v1.PNNSConfigH\x00\x12[\n\x11simple_pir_config\x18\x05 \x01(\x0b\x32>.apple.swift_homomorphic_encryption.api.pir.v1.SimplePIRConfigH\x00\x42\x08\n\x06\x63onfig\"\x9b\x02\n\x0e\x43onfigResponse\x12W\n\x07\x63onfigs\x18\x01 \x03(\x0b\x32\x46.apple.swift_homomorphic_encryption.api.v1.ConfigResponse.ConfigsEntry\x12M\n\x08key_info\x18\x02 \x03(\x0b\x32;.apple.swift_homomorphic_encryption.api.shared.v1.KeyStatus\x1a\x61\n\x0c\x43onfigsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12@\n\x05value\x18\x02 \x01(\x0b\x32\x31.apple.swift_homomorphic_encryption.api.v1.Config:\x02\x38\x01\"P\n\x08Requests\x12\x44\n\x08requests\x18\x01 \x03(\x0b\x32\x32.apple.swift_homomorphic_encryption.api.v1.Request\"S\n\tResponses\x12\x46\n\tresponses\x18\x01 \x03(\x0b\x32\x33.apple.swift_homomorphic_encryption.api.v1.Response\"\xff\x02\n\x07Request\x12\x0f\n\x07usecase\x18\x01 \x01(\t\x12P\n\x0bpir_request\x18\x02 \x01(\x0b\x32\x39.apple.swift_homomorphic_encryption.api.pir.v1.PIRRequestH\x00\x12S\n\x0cpnns_request\x18\x03 \x01(\x0b\x32;.apple.swift_homomorphic_encryption.api.pnns.v1.PNNSRequestH\x00\x12R\n\x0coprf_request\x18\x04 \x01(\x0b\x32:.apple.swift_homomorphic_encryption.api.pir.v1.OPRFRequestH\x00\x12]\n\x12simple_pir_request\x18\x05 \x01(\x0b\x32?.apple.swift_homomorphic_encryption.api.pir.v1.SimplePIRRequestH\x00\x42\t\n\x07request\"\xf8\x02\n\x08Response\x12R\n\x0cpir_response\x18\x01 \x01(\x0b\x32:.apple.swift_homomorphic_encryption.api.pir.v1.PIRResponseH\x00\x12U\n\rpnns_response\x18\x02 \x01(\x0b\x32<.apple.swift_homomorphic_encryption.api.pnns.v1.PNNSResponseH\x00\x12T\n\roprf_response\x18\x03 \x01(\x0b\x32;.apple.swift_homomorphic_encryption.api.pir.v1.OPRFResponseH\x00\x12_\n\x13simple_pir_response\x18\x04 \x01(\x0b\x32@.apple.swift_homomorphic_encryption.api.pir.v1.SimplePIRResponseH\x00\x42\n\n\x08response\"\xcc\x04\n\x05\x45rror\x12j\n\x18\x63onfig_version_not_found\x18\x01 \x01(\x0b\x32\x46.apple.swift_homomorphic_encryption.api.v1.Error.ConfigVersionNotFoundH\x00\x12j\n\x18\x65valuation_key_not_found\x18\x02 \x01(\x0b\x32\x46.apple.swift_homomorphic_encryption.api.v1.Error.EvaluationKeyNotFoundH\x00\x12Z\n\x0finvalid_request\x18\x03 \x01(\x0b\x32?.apple.swift_homomorphic_encryption.api.v1.Error.InvalidRequestH\x00\x12X\n\x0einternal_error\x18\x04 \x01(\x0b\x32>.apple.swift_homomorphic_encryption.api.v1.Error.InternalErrorH\x00\x1ak\n\x15\x43onfigVersionNotFound\x12R\n\x0f\x63onfig_response\x18\x01 \x01(\x0b\x32\x39.apple.swift_homomorphic_encryption.api.v1.ConfigResponse\x1a\x17\n\x15\x45valuationKeyNotFound\x1a\x10\n\x0eInvalidRequest\x1a\x0f\n\rInternalErrorB\x0c\n\nerror_typeb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'she_tpu_torch.io.pb.api_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _CONFIGRESPONSE_CONFIGSENTRY._options = None
  _CONFIGRESPONSE_CONFIGSENTRY._serialized_options = b'8\001'
  _CONFIGREQUEST._serialized_start=289
  _CONFIGREQUEST._serialized_end=351
  _CONFIG._serialized_start=354
  _CONFIG._serialized_end=678
  _CONFIGRESPONSE._serialized_start=681
  _CONFIGRESPONSE._serialized_end=964
  _CONFIGRESPONSE_CONFIGSENTRY._serialized_start=867
  _CONFIGRESPONSE_CONFIGSENTRY._serialized_end=964
  _REQUESTS._serialized_start=966
  _REQUESTS._serialized_end=1046
  _RESPONSES._serialized_start=1048
  _RESPONSES._serialized_end=1131
  _REQUEST._serialized_start=1134
  _REQUEST._serialized_end=1517
  _RESPONSE._serialized_start=1520
  _RESPONSE._serialized_end=1896
  _ERROR._serialized_start=1899
  _ERROR._serialized_end=2487
  _ERROR_CONFIGVERSIONNOTFOUND._serialized_start=2306
  _ERROR_CONFIGVERSIONNOTFOUND._serialized_end=2413
  _ERROR_EVALUATIONKEYNOTFOUND._serialized_start=2415
  _ERROR_EVALUATIONKEYNOTFOUND._serialized_end=2438
  _ERROR_INVALIDREQUEST._serialized_start=2440
  _ERROR_INVALIDREQUEST._serialized_end=2456
  _ERROR_INTERNALERROR._serialized_start=2458
  _ERROR_INTERNALERROR._serialized_end=2473
# @@protoc_insertion_point(module_scope)
