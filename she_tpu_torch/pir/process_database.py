"""ProcessKeywordDatabase: shard, process and validate a keyword database.

The port of she_tpu/pir/process_database.py (reference
Sources/PrivateInformationRetrieval/KeywordPir/KeywordDatabase.swift:441-671
and Util/ShardValidation.swift:19-56): with a Symmetric PIR config, seal
every row first (OPRF-derived keyword and AES-GCM value); shard the rows,
cuckoo-process each shard into a keyword-PIR database on the context's
device, and union the shards' evaluation-key configs. `validate_shard`
runs end-to-end trials on one shard and measures the evaluation key,
query and response in their protobuf sizes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from .. import errors
from .. import params as paramsmod
from ..bfv import bfv, keys
from ..io import proto_conversion as pc
from . import index_pir as ip
from . import keyword_pir as kp
from . import symmetric_pir as spir


@dataclass(frozen=True)
class KeywordDatabaseConfig:
    sharding: kp.Sharding
    keyword_pir_config: kp.KeywordPirConfig


@dataclass(frozen=True)
class Arguments:
    database_config: KeywordDatabaseConfig
    encryption_parameters: paramsmod.EncryptionParameters
    algorithm: str = "mulPir"
    key_compression: ip.PirKeyCompression = ip.PirKeyCompression.NO_COMPRESSION
    trials_per_shard: int = 1
    symmetric_pir_config: spir.SymmetricPirConfig | None = None

    def __post_init__(self):
        if self.algorithm != "mulPir":
            raise errors.PirError(f"unsupported algorithm {self.algorithm}")
        if self.trials_per_shard < 0:
            raise errors.PirError("trialsPerShard must be >= 0")


@dataclass
class Processed:
    evaluation_key_config: keys.EvaluationKeyConfig
    shards: dict  # shard ID -> kp.ProcessedDatabaseWithParameters


@dataclass
class ShardValidationResult:
    """Reference ShardValidation.swift:19-56: serialized sizes in bytes,
    the smallest noise budget in bits, and the server's seconds a trial."""

    evaluation_key_size: int
    query_size: int
    response_size: int
    noise_budget: float
    compute_times: list


def process_shard(shard_rows, arguments: Arguments, rng=None, on_event=None, device=None):
    """Process one shard (KeywordDatabase.swift:516-545) on `device` (the
    CUDA card by default)."""
    context = bfv.get_bfv_context(arguments.encryption_parameters, device)
    rows = list(shard_rows.items()) if isinstance(shard_rows, dict) else list(shard_rows)
    return kp.KeywordPirServer.process(
        rows, arguments.database_config.keyword_pir_config, context, rng=rng, on_event=on_event
    )


def process(rows: dict, arguments: Arguments, rng=None, on_event=None, device=None) -> Processed:
    """Shard and process the whole database; the evaluation-key config is
    the union over the shards (KeywordDatabase.swift:640-671). With a
    Symmetric PIR config the rows are sealed first
    (spir.symmetric_pir_process), and sharding sees the oblivious keywords."""
    config = arguments.database_config
    if arguments.symmetric_pir_config is not None:
        rows = dict(spir.symmetric_pir_process(list(rows.items()), arguments.symmetric_pir_config))
    shards = kp.shard_database(rows, config.sharding, config.keyword_pir_config.sharding_function)
    processed = {}
    ek_config = keys.EvaluationKeyConfig()
    for shard_id, shard_rows in sorted(shards.items()):
        p = process_shard(shard_rows, arguments, rng=rng, on_event=on_event, device=device)
        processed[shard_id] = p
        ek_config = ek_config.union(p.pir_parameter.evaluation_key_config)
    return Processed(ek_config, processed)


def validate_shard(shard, row: tuple[bytes, bytes], trials: int, context, rng=None) -> ShardValidationResult:
    """Fresh keys, one query for `row`'s keyword, the response, its
    decryption checked against the row's value, and the noise budget, in
    `trials` trials (KeywordDatabase.swift:557-630). `rng` draws the secret
    keys and the evaluation keys' errors (the system's when None)."""
    if trials <= 0:
        raise errors.PirError("trials must be > 0")
    keyword, value = row
    server = kp.KeywordPirServer(context, shard)
    client = kp.KeywordPirClient(shard.keyword_pir_parameter, shard.pir_parameter, context)
    compute_times = []
    min_noise = float("inf")
    ek_size = query_size = response_size = 0
    for trial in range(trials):
        sk = bfv.generate_secret_key(context, rng)
        ek = client.generate_evaluation_key(sk, rng)
        query = client.generate_query(keyword, sk)
        t0 = time.perf_counter()
        response = server.compute_response(query, ek)
        compute_times.append(time.perf_counter() - t0)
        got = client.decrypt(response, keyword, sk)
        if bytes(got or b"") != bytes(value):
            raise errors.PirError(f"validation failed: got {got!r}, expected {value!r}")
        min_noise = min(min_noise, min(bfv.noise_budget(ct, sk) for reply in response.ciphertexts for ct in reply))
        if trial == 0:
            ek_size = pc.evaluation_key_to_proto(ek).ByteSize()
            query_size = sum(pc.ciphertext_to_proto(ct).ByteSize() for ct in query.ciphertexts)
            response_size = sum(
                pc.ciphertext_to_proto(ct, for_decryption=True).ByteSize()
                for reply in response.ciphertexts
                for ct in reply
            )
        sk.zeroize()
    return ShardValidationResult(ek_size, query_size, response_size, min_noise, compute_times)
