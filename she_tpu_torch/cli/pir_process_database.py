"""PIRProcessDatabase: JSON-config-driven keyword PIR database processing
(reference Sources/PIRProcessDatabase/main.swift:188-650), on --device.

Config JSON keys (subset of the reference's):
  inputDatabase, outputDatabase (with SHARD_ID placeholder),
  outputPirParameters (with SHARD_ID), rlweParameters (predefined name),
  outputEvaluationKeyConfig, sharding {shardCount|entryCountPerShard},
  trialsPerShard, keyCompression, cuckooTableArguments
  {hashFunctionCount, maxEvictionCount, bucketCount, maxSerializedBucketSize},
  symmetricPirArguments {oprfKeyFilePath}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .. import params as paramsmod
from ..bfv import bfv
from ..io import pb, proto_conversion as pc
from ..pir import index_pir as ip
from ..pir import keyword_pir as kp
from ..pir import process_database as pdb
from ..pir import symmetric_pir as spir
from . import util

SHARD_ID = "SHARD_ID"


def build_arguments(config: dict, max_value_size: int = 0) -> pdb.Arguments:
    ep = paramsmod.from_predefined(config["rlweParameters"])
    sharding_cfg = config.get("sharding", {"shardCount": 1})
    if "shardCount" in sharding_cfg:
        sharding = kp.Sharding("shardCount", int(sharding_cfg["shardCount"]))
    else:
        sharding = kp.Sharding("entryCountPerShard", int(sharding_cfg["entryCountPerShard"]))
    cuckoo_args = config.get("cuckooTableArguments", {})
    max_bucket = cuckoo_args.get(
        "maxSerializedBucketSize",
        kp.default_max_serialized_bucket_size(max_value_size, ep.bytes_per_plaintext),
    )
    bucket_count_cfg = cuckoo_args.get("bucketCount")
    if isinstance(bucket_count_cfg, dict) and "fixedSize" in bucket_count_cfg:
        bucket_count = kp.CuckooBucketConfig(
            "fixedSize", bucket_count=int(bucket_count_cfg["fixedSize"]["bucketCount"])
        )
    else:
        bucket_count = kp.CuckooBucketConfig("allowExpansion", 1.1, 0.9)
    cuckoo = kp.CuckooTableConfig(
        hash_function_count=cuckoo_args.get("hashFunctionCount", 2),
        max_eviction_count=cuckoo_args.get("maxEvictionCount", 100),
        max_serialized_bucket_size=max_bucket,
        bucket_count=bucket_count,
    )
    key_compression = {
        "noCompression": ip.PirKeyCompression.NO_COMPRESSION,
        "hybridCompression": ip.PirKeyCompression.HYBRID,
        "maxCompression": ip.PirKeyCompression.MAX,
    }[config.get("keyCompression", "noCompression")]
    keyword_config = kp.KeywordPirConfig(
        dimension_count=config.get("outputDatabaseDimensionCount", 2),
        cuckoo_table_config=cuckoo,
        uneven_dimensions=config.get("unevenDimensions", True),
        key_compression=key_compression,
        use_max_serialized_bucket_size=config.get("useMaxSerializedBucketSize", False),
    )
    sym_config = None
    sym_args = config.get("symmetricPirArguments")
    if sym_args:
        with open(sym_args["oprfKeyFilePath"], "rb") as f:
            key = f.read()
        if len(key) != 48:
            key = bytes.fromhex(key.decode().strip())
        sym_config = spir.SymmetricPirConfig(key)
    return pdb.Arguments(
        database_config=pdb.KeywordDatabaseConfig(sharding, keyword_config),
        encryption_parameters=ep,
        key_compression=key_compression,
        trials_per_shard=config.get("trialsPerShard", 1),
        symmetric_pir_config=sym_config,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description="Process a keyword PIR database")
    parser.add_argument("config", help="JSON configuration file")
    util.add_device_argument(parser)
    args = parser.parse_args(argv)
    with open(args.config) as f:
        config = json.load(f)

    db_msg = util.load_proto(config["inputDatabase"], pb.pir_pb2.KeywordDatabase)
    rows = pc.keyword_database_from_proto(db_msg)
    max_value_size = max((len(v) for v in rows.values()), default=0)
    arguments = build_arguments(config, max_value_size)
    context = bfv.get_bfv_context(arguments.encryption_parameters, args.device)
    print(f"Loaded {len(rows)} rows from {config['inputDatabase']} (device {context.device})")

    t0 = time.perf_counter()
    on_event = (lambda kind, detail: print(f"cuckoo: {kind} {detail}")) if config.get("verbose") else None
    processed = pdb.process(rows, arguments, on_event=on_event, device=context.device)
    print(f"Processed {len(processed.shards)} shard(s) in {time.perf_counter() - t0:.2f}s")

    for shard_id, shard in processed.shards.items():
        out_db = config["outputDatabase"].replace(SHARD_ID, shard_id)
        with open(out_db, "wb") as f:
            f.write(shard.database.serialize())
        out_params = config["outputPirParameters"].replace(SHARD_ID, shard_id)
        params_msg = pc.pir_parameters_to_proto(
            shard.pir_parameter, arguments.encryption_parameters, shard.keyword_pir_parameter
        )
        util.save_proto(out_params, params_msg)
        if arguments.trials_per_shard > 0 and arguments.symmetric_pir_config is None:
            # validate with a row from this shard
            n_shards = arguments.database_config.sharding.shard_count(len(rows))
            sharding_function = arguments.database_config.keyword_pir_config.sharding_function
            row = next(
                ((kw, v) for kw, v in rows.items() if str(sharding_function.shard_index(kw, n_shards)) == shard_id),
                None,
            )
            if row is not None:
                result = pdb.validate_shard(shard, row, arguments.trials_per_shard, context)
                print(
                    f"shard {shard_id}: evalKey {result.evaluation_key_size}B, "
                    f"query {result.query_size}B, response {result.response_size}B, "
                    f"noiseBudget {result.noise_budget:.2f}, "
                    f"compute {min(result.compute_times) * 1e3:.1f}ms"
                )
        print(f"Wrote shard {shard_id}: {out_db}, {out_params}")

    ek_out = config.get("outputEvaluationKeyConfig")
    if ek_out:
        msg = pb.he_pb2.EvaluationKeyConfig()
        msg.galois_elements.extend(processed.evaluation_key_config.galois_elements)
        msg.has_relin_key = processed.evaluation_key_config.has_relinearization_key
        util.save_proto(ek_out, msg)
        print(f"Wrote evaluation key config to {ek_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
