# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: apple/swift_homomorphic_encryption/pnns/v1/pnns.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import he_pb2 as apple_dot_swift__homomorphic__encryption_dot_v1_dot_he__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n5apple/swift_homomorphic_encryption/pnns/v1/pnns.proto\x12*apple.swift_homomorphic_encryption.pnns.v1\x1a.apple/swift_homomorphic_encryption/v1/he.proto\"\xe1\x01\n\x1aSerializedCiphertextMatrix\x12\x10\n\x08num_rows\x18\x01 \x01(\r\x12\x13\n\x0bnum_columns\x18\x02 \x01(\r\x12P\n\x0b\x63iphertexts\x18\x03 \x03(\x0b\x32;.apple.swift_homomorphic_encryption.v1.SerializedCiphertext\x12J\n\x07packing\x18\x04 \x01(\x0b\x32\x39.apple.swift_homomorphic_encryption.pnns.v1.MatrixPacking\"\xde\x01\n\x19SerializedPlaintextMatrix\x12\x10\n\x08num_rows\x18\x01 \x01(\r\x12\x13\n\x0bnum_columns\x18\x02 \x01(\r\x12N\n\nplaintexts\x18\x03 \x03(\x0b\x32:.apple.swift_homomorphic_encryption.v1.SerializedPlaintext\x12J\n\x07packing\x18\x04 \x01(\x0b\x32\x39.apple.swift_homomorphic_encryption.pnns.v1.MatrixPacking\"\xfc\x02\n\x0c\x43lientConfig\x12Z\n\x15\x65ncryption_parameters\x18\x01 \x01(\x0b\x32;.apple.swift_homomorphic_encryption.v1.EncryptionParameters\x12\x16\n\x0escaling_factor\x18\x02 \x01(\x04\x12P\n\rquery_packing\x18\x03 \x01(\x0b\x32\x39.apple.swift_homomorphic_encryption.pnns.v1.MatrixPacking\x12\x18\n\x10vector_dimension\x18\x04 \x01(\r\x12\x17\n\x0fgalois_elements\x18\x05 \x03(\r\x12S\n\x0f\x64istance_metric\x18\x06 \x01(\x0e\x32:.apple.swift_homomorphic_encryption.pnns.v1.DistanceMetric\x12\x1e\n\x16\x65xtra_plaintext_moduli\x18\x07 \x03(\x04\"G\n\x0b\x44\x61tabaseRow\x12\x10\n\x08\x65ntry_id\x18\x01 \x01(\x04\x12\x16\n\x0e\x65ntry_metadata\x18\x02 \x01(\x0c\x12\x0e\n\x06vector\x18\x03 \x03(\x02\"Q\n\x08\x44\x61tabase\x12\x45\n\x04rows\x18\x01 \x03(\x0b\x32\x37.apple.swift_homomorphic_encryption.pnns.v1.DatabaseRow\"T\n\x11\x42\x61\x62yStepGiantStep\x12\x18\n\x10vector_dimension\x18\x01 \x01(\r\x12\x11\n\tbaby_step\x18\x02 \x01(\r\x12\x12\n\ngiant_step\x18\x03 \x01(\r\"\xb3\x02\n\rMatrixPacking\x12V\n\tdense_row\x18\x01 \x01(\x0b\x32\x41.apple.swift_homomorphic_encryption.pnns.v1.MatrixPackingDenseRowH\x00\x12U\n\x08\x64iagonal\x18\x02 \x01(\x0b\x32\x41.apple.swift_homomorphic_encryption.pnns.v1.MatrixPackingDiagonalH\x00\x12\\\n\x0c\x64\x65nse_column\x18\x03 \x01(\x0b\x32\x44.apple.swift_homomorphic_encryption.pnns.v1.MatrixPackingDenseColumnH\x00\x42\x15\n\x13matrix_packing_type\"\x17\n\x15MatrixPackingDenseRow\"t\n\x15MatrixPackingDiagonal\x12[\n\x14\x62\x61\x62y_step_giant_step\x18\x02 \x01(\x0b\x32=.apple.swift_homomorphic_encryption.pnns.v1.BabyStepGiantStep\"\x1a\n\x18MatrixPackingDenseColumn\"\xfd\x01\n\x1bSerializedProcessedDatabase\x12\x61\n\x12plaintext_matrices\x18\x01 \x03(\x0b\x32\x45.apple.swift_homomorphic_encryption.pnns.v1.SerializedPlaintextMatrix\x12\x11\n\tentry_ids\x18\x02 \x03(\x04\x12\x17\n\x0f\x65ntry_metadatas\x18\x03 \x03(\x0c\x12O\n\rserver_config\x18\x04 \x01(\x0b\x32\x38.apple.swift_homomorphic_encryption.pnns.v1.ServerConfig\"\xb4\x01\n\x0cServerConfig\x12O\n\rclient_config\x18\x01 \x01(\x0b\x32\x38.apple.swift_homomorphic_encryption.pnns.v1.ClientConfig\x12S\n\x10\x64\x61tabase_packing\x18\x02 \x01(\x0b\x32\x39.apple.swift_homomorphic_encryption.pnns.v1.MatrixPacking*7\n\x0e\x44istanceMetric\x12%\n!DISTANCE_METRIC_COSINE_SIMILARITY\x10\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'she_tpu_torch.io.pb.pnns_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _DISTANCEMETRIC._serialized_start=2147
  _DISTANCEMETRIC._serialized_end=2202
  _SERIALIZEDCIPHERTEXTMATRIX._serialized_start=150
  _SERIALIZEDCIPHERTEXTMATRIX._serialized_end=375
  _SERIALIZEDPLAINTEXTMATRIX._serialized_start=378
  _SERIALIZEDPLAINTEXTMATRIX._serialized_end=600
  _CLIENTCONFIG._serialized_start=603
  _CLIENTCONFIG._serialized_end=983
  _DATABASEROW._serialized_start=985
  _DATABASEROW._serialized_end=1056
  _DATABASE._serialized_start=1058
  _DATABASE._serialized_end=1139
  _BABYSTEPGIANTSTEP._serialized_start=1141
  _BABYSTEPGIANTSTEP._serialized_end=1225
  _MATRIXPACKING._serialized_start=1228
  _MATRIXPACKING._serialized_end=1535
  _MATRIXPACKINGDENSEROW._serialized_start=1537
  _MATRIXPACKINGDENSEROW._serialized_end=1560
  _MATRIXPACKINGDIAGONAL._serialized_start=1562
  _MATRIXPACKINGDIAGONAL._serialized_end=1678
  _MATRIXPACKINGDENSECOLUMN._serialized_start=1680
  _MATRIXPACKINGDENSECOLUMN._serialized_end=1706
  _SERIALIZEDPROCESSEDDATABASE._serialized_start=1709
  _SERIALIZEDPROCESSEDDATABASE._serialized_end=1962
  _SERVERCONFIG._serialized_start=1965
  _SERVERCONFIG._serialized_end=2145
# @@protoc_insertion_point(module_scope)
