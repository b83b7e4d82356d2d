"""PIR service API: the wire protocol consumed by live services
(reference ApplicationProtobuf Api_* messages; the protocol used by
apple's pir-service-example).

The port of she_tpu/pir/service.py:26-150, the server side of the
envelope: per-usecase PIRConfig with shard configs and config hash,
evaluation-key storage keyed by metadata identifier, PIRRequest ->
PIRResponse dispatch onto the per-query KeywordPirServer of the request's
shard, and OPRF blind evaluation for Symmetric PIR.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from .. import errors
from ..io import pb
from ..io import proto_conversion as pc
from . import keyword_pir as kp
from . import process_database as pdb
from . import symmetric_pir as spir


def _config_hash(config_msg) -> bytes:
    return hashlib.sha256(config_msg.SerializeToString()).digest()


@dataclass
class PirUsecase:
    context: object
    processed: pdb.Processed
    servers: dict = field(default_factory=dict)  # shard_id -> KeywordPirServer
    config_msg: object = None
    config_hash: bytes = b""


class PirService:
    """In-process PIR service speaking the protobuf envelope."""

    def __init__(self):
        self.usecases: dict[str, PirUsecase] = {}
        self.evaluation_keys: dict[bytes, object] = {}
        self.oprf_servers: dict[bytes, spir.OprfServer] = {}

    # -- setup -------------------------------------------------------------

    def add_keyword_pir_usecase(self, name: str, context, processed: pdb.Processed):
        uc = PirUsecase(context, processed)
        config = pb.api_pir_pb2.PIRConfig()
        first = next(iter(processed.shards.values()))
        config.encryption_parameters.CopyFrom(
            pc.encryption_parameters_to_proto(context.params)
        )
        for shard_id, shard in sorted(processed.shards.items()):
            sc = config.shard_configs.add()
            sc.num_entries = shard.pir_parameter.entry_count
            sc.entry_size = shard.pir_parameter.entry_size_in_bytes
            sc.dimensions.extend(shard.pir_parameter.dimensions)
            sc.shard_id = shard_id
        kwp = first.keyword_pir_parameter
        if kwp is not None:
            config.keyword_pir_params.num_hash_functions = kwp.hash_function_count
            config.keyword_pir_params.sharding_function.CopyFrom(
                pc.sharding_function_to_proto(kwp.sharding_function)
            )
        config.algorithm = pb.pir_pb2.PIR_ALGORITHM_MUL_PIR
        config.batch_size = first.pir_parameter.batch_size
        ekc = pc.evaluation_key_config_to_proto(processed.evaluation_key_config)
        config.evaluation_key_config_hash = hashlib.sha256(ekc.SerializeToString()).digest()
        uc.config_msg = config
        uc.config_hash = _config_hash(config)
        for shard_id, shard in processed.shards.items():
            uc.servers[shard_id] = kp.KeywordPirServer(context, shard)
        self.usecases[name] = uc

    def add_oprf_usecase(self, config_id: bytes, config: spir.SymmetricPirConfig):
        self.oprf_servers[config_id] = spir.OprfServer(config)

    # -- config ------------------------------------------------------------

    def handle_config_request(self, request_msg):
        response = pb.api_pb2.ConfigResponse()
        for usecase in request_msg.usecases or self.usecases.keys():
            uc = self.usecases.get(usecase)
            if uc is None:
                continue
            cfg = response.configs[usecase]
            cfg.pir_config.CopyFrom(uc.config_msg)
            cfg.config_id = uc.config_hash
        for metadata, _ in self.evaluation_keys.values():
            status = response.key_info.add()
            status.timestamp = metadata["timestamp"]
        return response

    # -- evaluation keys ---------------------------------------------------

    def store_evaluation_keys(self, keys_msg, context):
        """EvaluationKeys message -> stored native keys by identifier."""
        for key in keys_msg.keys:
            ek = pc.evaluation_key_from_proto(key.evaluation_key, context)
            self.evaluation_keys[bytes(key.metadata.identifier)] = (
                {"timestamp": int(key.metadata.timestamp)},
                ek,
            )

    # -- requests ----------------------------------------------------------

    def handle_pir_request(self, usecase: str, request_msg):
        uc = self.usecases.get(usecase)
        if uc is None:
            raise errors.PirError(f"unknown usecase {usecase}")
        if bytes(request_msg.configuration_hash) != uc.config_hash:
            raise errors.PirError("configuration hash mismatch")
        stored = self.evaluation_keys.get(
            bytes(request_msg.evaluation_key_metadata.identifier)
        )
        if stored is None and request_msg.HasField("evaluation_key"):
            ek = pc.evaluation_key_from_proto(
                request_msg.evaluation_key.evaluation_key, uc.context
            )
        elif stored is not None:
            ek = stored[1]
        else:
            raise errors.PirError("no evaluation key available")
        shard_id = request_msg.shard_id or str(int(request_msg.shard_index))
        server = uc.servers.get(shard_id)
        if server is None:
            raise errors.PirError(f"unknown shard {shard_id}")
        query = pc.pir_query_from_proto(request_msg.query, uc.context)
        response = server.compute_response(query, ek)
        out = pb.api_pir_pb2.PIRResponse()
        for vec in pc.pir_response_to_proto(response):
            out.replies.append(vec)
        return out

    def handle_oprf_request(self, request_msg):
        server = self.oprf_servers.get(bytes(request_msg.config_id))
        if server is None:
            raise errors.PirError("unknown OPRF config")
        evaluation = server.compute_response(bytes(request_msg.query_element))
        out = pb.api_pir_pb2.OPRFResponse()
        out.evaluated_element = evaluation.evaluated_element
        out.proof = evaluation.proof
        return out
