# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: apple/swift_homomorphic_encryption/pir/v1/pir.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import he_pb2 as apple_dot_swift__homomorphic__encryption_dot_v1_dot_he__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n3apple/swift_homomorphic_encryption/pir/v1/pir.proto\x12)apple.swift_homomorphic_encryption.pir.v1\x1a.apple/swift_homomorphic_encryption/v1/he.proto\"p\n\x11\x45mbeddingCodebook\x12\x1b\n\x13\x65mbedding_dimension\x18\x01 \x01(\r\x12\x1f\n\x17\x63\x65ntroid_embedding_fp16\x18\x02 \x01(\x0c\x12\x1d\n\x15num_clusters_to_probe\x18\x03 \x01(\r\"\xc2\x04\n\rPirParameters\x12Z\n\x15\x65ncryption_parameters\x18\x01 \x01(\x0b\x32;.apple.swift_homomorphic_encryption.v1.EncryptionParameters\x12\x13\n\x0bnum_entries\x18\x02 \x01(\x04\x12\x12\n\nentry_size\x18\x03 \x01(\x04\x12\x12\n\ndimensions\x18\x04 \x03(\x04\x12[\n\x12keyword_pir_params\x18\x05 \x01(\x0b\x32?.apple.swift_homomorphic_encryption.pir.v1.KeywordPirParameters\x12J\n\talgorithm\x18\x06 \x01(\x0e\x32\x37.apple.swift_homomorphic_encryption.pir.v1.PirAlgorithm\x12\x12\n\nbatch_size\x18\x07 \x01(\x04\x12Y\n\x15\x65valuation_key_config\x18\x08 \x01(\x0b\x32:.apple.swift_homomorphic_encryption.v1.EvaluationKeyConfig\x12\x63\n\x18key_compression_strategy\x18\t \x01(\x0e\x32\x41.apple.swift_homomorphic_encryption.pir.v1.KeyCompressionStrategy\x12\x1b\n\x13\x65ncoding_entry_size\x18\r \x01(\x08\"\xf7\x01\n\x14KeywordPirParameters\x12\x1a\n\x12num_hash_functions\x18\x01 \x01(\x04\x12h\n\x1bsymmetric_pir_client_config\x18\x03 \x01(\x0b\x32\x43.apple.swift_homomorphic_encryption.pir.v1.SymmetricPirClientConfig\x12Y\n\x11sharding_function\x18\x04 \x01(\x0b\x32>.apple.swift_homomorphic_encryption.pir.v1.PIRShardingFunction\"\xd8\x01\n\x13PIRShardingFunction\x12V\n\x06sha256\x18\x01 \x01(\x0b\x32\x44.apple.swift_homomorphic_encryption.pir.v1.PIRShardingFunctionSHA256H\x00\x12]\n\ndouble_mod\x18\x02 \x01(\x0b\x32G.apple.swift_homomorphic_encryption.pir.v1.PIRShardingFunctionDoubleModH\x00\x42\n\n\x08\x66unction\"\x1b\n\x19PIRShardingFunctionSHA256\"9\n\x1cPIRShardingFunctionDoubleMod\x12\x19\n\x11other_shard_count\x18\x01 \x01(\r\"{\n\x10\x45ncryptedIndices\x12P\n\x0b\x63iphertexts\x18\x01 \x03(\x0b\x32;.apple.swift_homomorphic_encryption.v1.SerializedCiphertext\x12\x15\n\rnum_pir_calls\x18\x02 \x01(\x04\"\x8d\x01\n\x18SymmetricPirClientConfig\x12\x19\n\x11server_public_key\x18\x01 \x01(\x0c\x12V\n\x0b\x63onfig_type\x18\x02 \x01(\x0e\x32\x41.apple.swift_homomorphic_encryption.pir.v1.SymmetricPirConfigType\"4\n\x12KeywordDatabaseRow\x12\x0f\n\x07keyword\x18\x01 \x01(\x0c\x12\r\n\x05value\x18\x02 \x01(\x0c\"^\n\x0fKeywordDatabase\x12K\n\x04rows\x18\x01 \x03(\x0b\x32=.apple.swift_homomorphic_encryption.pir.v1.KeywordDatabaseRow\"$\n\x13IndexPirDatabaseRow\x12\r\n\x05value\x18\x01 \x01(\x0c\"`\n\x10IndexPirDatabase\x12L\n\x04rows\x18\x01 \x03(\x0b\x32>.apple.swift_homomorphic_encryption.pir.v1.IndexPirDatabaseRow\"E\n\x0fSimplePIRMatrix\x12\x11\n\trow_count\x18\x01 \x01(\r\x12\x11\n\tcol_count\x18\x02 \x01(\r\x12\x0c\n\x04\x64\x61ta\x18\x03 \x03(\x04\"~\n\x19SimplePIREncryptionParams\x12\x19\n\x11lattice_dimension\x18\x01 \x01(\r\x12\x15\n\rerror_std_dev\x18\x02 \x01(\x01\x12\x16\n\x0eplaintext_bits\x18\x03 \x01(\r\x12\x17\n\x0f\x63iphertext_bits\x18\x04 \x01(\r\"\xf3\x01\n\x13SimplePIRParameters\x12_\n\x11\x65ncryption_params\x18\x01 \x01(\x0b\x32\x44.apple.swift_homomorphic_encryption.pir.v1.SimplePIREncryptionParams\x12\x0e\n\x06\x61_seed\x18\x02 \x01(\x0c\x12\x1b\n\x13\x65ntry_size_in_bytes\x18\x03 \x01(\r\x12\x1a\n\x12\x65ntries_per_column\x18\x04 \x01(\r\x12\x18\n\x10\x63hunks_per_entry\x18\x05 \x01(\r\x12\x18\n\x10\x64\x61tabase_columns\x18\x06 \x01(\r\"\xb7\x02\n\x0f\x44\x61tabaseMapping\x12Q\n\x07\x65ntries\x18\x01 \x03(\x0b\x32@.apple.swift_homomorphic_encryption.pir.v1.DatabaseMapping.Entry\x12\x12\n\nchunk_size\x18\x02 \x01(\r\x1a\x33\n\rChunkLocation\x12\x13\n\x0bshard_index\x18\x01 \x01(\r\x12\r\n\x05index\x18\x02 \x01(\r\x1a\x87\x01\n\x05\x45ntry\x12\x16\n\x0eoriginal_index\x18\x01 \x01(\x04\x12\x0c\n\x04size\x18\x02 \x01(\r\x12X\n\x06\x63hunks\x18\x03 \x03(\x0b\x32H.apple.swift_homomorphic_encryption.pir.v1.DatabaseMapping.ChunkLocation*\xa5\x01\n\x16KeyCompressionStrategy\x12(\n$KEY_COMPRESSION_STRATEGY_UNSPECIFIED\x10\x00\x12\x30\n,KEY_COMPRESSION_STRATEGY_MAXIMUM_COMPRESSION\x10\x01\x12/\n+KEY_COMPRESSION_STRATEGY_HYBRID_COMPRESSION\x10\x02*\x89\x01\n\x16SymmetricPirConfigType\x12)\n%SYMMETRIC_PIR_CONFIG_TYPE_UNSPECIFIED\x10\x00\x12\x44\n@SYMMETRIC_PIR_CONFIG_TYPE_OPRF_P384_AES_GCM_192_NONCE_96_TAG_128\x10\x01*E\n\x0cPirAlgorithm\x12\x1a\n\x16PIR_ALGORITHM_ACLS_PIR\x10\x00\x12\x19\n\x15PIR_ALGORITHM_MUL_PIR\x10\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'she_tpu_torch.io.pb.pir_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _KEYCOMPRESSIONSTRATEGY._serialized_start=2713
  _KEYCOMPRESSIONSTRATEGY._serialized_end=2878
  _SYMMETRICPIRCONFIGTYPE._serialized_start=2881
  _SYMMETRICPIRCONFIGTYPE._serialized_end=3018
  _PIRALGORITHM._serialized_start=3020
  _PIRALGORITHM._serialized_end=3089
  _EMBEDDINGCODEBOOK._serialized_start=146
  _EMBEDDINGCODEBOOK._serialized_end=258
  _PIRPARAMETERS._serialized_start=261
  _PIRPARAMETERS._serialized_end=839
  _KEYWORDPIRPARAMETERS._serialized_start=842
  _KEYWORDPIRPARAMETERS._serialized_end=1089
  _PIRSHARDINGFUNCTION._serialized_start=1092
  _PIRSHARDINGFUNCTION._serialized_end=1308
  _PIRSHARDINGFUNCTIONSHA256._serialized_start=1310
  _PIRSHARDINGFUNCTIONSHA256._serialized_end=1337
  _PIRSHARDINGFUNCTIONDOUBLEMOD._serialized_start=1339
  _PIRSHARDINGFUNCTIONDOUBLEMOD._serialized_end=1396
  _ENCRYPTEDINDICES._serialized_start=1398
  _ENCRYPTEDINDICES._serialized_end=1521
  _SYMMETRICPIRCLIENTCONFIG._serialized_start=1524
  _SYMMETRICPIRCLIENTCONFIG._serialized_end=1665
  _KEYWORDDATABASEROW._serialized_start=1667
  _KEYWORDDATABASEROW._serialized_end=1719
  _KEYWORDDATABASE._serialized_start=1721
  _KEYWORDDATABASE._serialized_end=1815
  _INDEXPIRDATABASEROW._serialized_start=1817
  _INDEXPIRDATABASEROW._serialized_end=1853
  _INDEXPIRDATABASE._serialized_start=1855
  _INDEXPIRDATABASE._serialized_end=1951
  _SIMPLEPIRMATRIX._serialized_start=1953
  _SIMPLEPIRMATRIX._serialized_end=2022
  _SIMPLEPIRENCRYPTIONPARAMS._serialized_start=2024
  _SIMPLEPIRENCRYPTIONPARAMS._serialized_end=2150
  _SIMPLEPIRPARAMETERS._serialized_start=2153
  _SIMPLEPIRPARAMETERS._serialized_end=2396
  _DATABASEMAPPING._serialized_start=2399
  _DATABASEMAPPING._serialized_end=2710
  _DATABASEMAPPING_CHUNKLOCATION._serialized_start=2521
  _DATABASEMAPPING_CHUNKLOCATION._serialized_end=2572
  _DATABASEMAPPING_ENTRY._serialized_start=2575
  _DATABASEMAPPING_ENTRY._serialized_end=2710
# @@protoc_insertion_point(module_scope)
