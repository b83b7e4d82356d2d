"""PIRShardDatabase: re-shard a keyword database protobuf
(reference Sources/PIRShardDatabase/ShardDatabase.swift:26-120). Host code:
it takes no --device."""

from __future__ import annotations

import argparse
import sys

from ..io import pb, proto_conversion as pc
from ..pir import keyword_pir as kp
from . import util

SHARD_ID = "SHARD_ID"


def main(argv=None):
    parser = argparse.ArgumentParser(description="Shard a keyword PIR database")
    parser.add_argument("--input-database", required=True)
    parser.add_argument("--output-database", required=True, help="path with SHARD_ID placeholder")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--shard-count", type=int)
    group.add_argument("--entry-count-per-shard", type=int)
    parser.add_argument("--sharding-function", choices=["sha256", "doubleMod"], default="sha256")
    parser.add_argument("--other-shard-count", type=int, default=0)
    args = parser.parse_args(argv)

    db = util.load_proto(args.input_database, pb.pir_pb2.KeywordDatabase)
    rows = pc.keyword_database_from_proto(db)
    if args.shard_count:
        sharding = kp.Sharding("shardCount", args.shard_count)
    else:
        sharding = kp.Sharding("entryCountPerShard", args.entry_count_per_shard)
    fn = (
        kp.ShardingFunction("sha256")
        if args.sharding_function == "sha256"
        else kp.ShardingFunction("doubleMod", args.other_shard_count)
    )
    shards = kp.shard_database(rows, sharding, fn)
    for shard_id, shard_rows in sorted(shards.items()):
        path = args.output_database.replace(SHARD_ID, shard_id)
        util.save_proto(path, pc.keyword_database_to_proto(shard_rows))
        print(f"Wrote shard {shard_id} ({len(shard_rows)} rows) to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
