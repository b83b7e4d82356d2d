"""ProcessKeywordDatabase: shard a keyword database and process each shard.

The port of she_tpu/pir/process_database.py:24-92 (reference
Sources/PrivateInformationRetrieval/KeywordPir/KeywordDatabase.swift:441-671):
shard the rows, cuckoo-process each shard into a keyword-PIR database on
the context's device, and union the shards' evaluation-key configs.
Symmetric PIR (OPRF-encrypted rows) and shard validation, which measures
sizes through protobuf messages, are not ported yet; nor are the
arguments only validation reads (its key compression and trials per
shard).
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import errors
from .. import params as paramsmod
from ..bfv import bfv, keys
from . import keyword_pir as kp


@dataclass(frozen=True)
class KeywordDatabaseConfig:
    sharding: kp.Sharding
    keyword_pir_config: kp.KeywordPirConfig


@dataclass(frozen=True)
class Arguments:
    database_config: KeywordDatabaseConfig
    encryption_parameters: paramsmod.EncryptionParameters
    algorithm: str = "mulPir"
    symmetric_pir_config: object = None

    def __post_init__(self):
        if self.algorithm != "mulPir":
            raise errors.PirError(f"unsupported algorithm {self.algorithm}")
        if self.symmetric_pir_config is not None:
            raise errors.PirError(
                "Symmetric PIR is not ported yet: it comes with the Symmetric PIR slice (ROADMAP queue 1)"
            )


@dataclass
class Processed:
    evaluation_key_config: keys.EvaluationKeyConfig
    shards: dict  # shard ID -> kp.ProcessedDatabaseWithParameters


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
    the union over the shards (KeywordDatabase.swift:640-671)."""
    config = arguments.database_config
    shards = kp.shard_database(rows, config.sharding, config.keyword_pir_config.sharding_function)
    processed = {}
    ek_config = keys.EvaluationKeyConfig()
    for shard_id, shard_rows in sorted(shards.items()):
        p = process_shard(shard_rows, arguments, rng=rng, on_event=on_event, device=device)
        processed[shard_id] = p
        ek_config = ek_config.union(p.pir_parameter.evaluation_key_config)
    return Processed(ek_config, processed)
