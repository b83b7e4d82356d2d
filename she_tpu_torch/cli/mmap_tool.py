"""MMapTool: build/inspect MMapDictionary files from keyword databases
(reference Sources/MMapTool/main.swift, DictCommand.swift). Host code: the
dictionary is bytes on disk, so this tool takes no --device."""

from __future__ import annotations

import argparse
import sys

from ..io import mmap_dict, pb
from . import util


def main(argv=None):
    parser = argparse.ArgumentParser(description="MMapDictionary tool")
    sub = parser.add_subparsers(dest="command", required=True)

    build = sub.add_parser("dict", help="build an mmap dictionary from a keyword database")
    build.add_argument("--input-database", required=True, help="KeywordDatabase .binpb/.txtpb")
    build.add_argument("--output", required=True)
    build.add_argument("--load-factor", type=float, default=mmap_dict.DEFAULT_LOAD_FACTOR)

    info = sub.add_parser("info", help="inspect an mmap dictionary")
    info.add_argument("path")

    lookup = sub.add_parser("get", help="look up a keyword")
    lookup.add_argument("path")
    lookup.add_argument("keyword")

    args = parser.parse_args(argv)

    if args.command == "dict":
        db = util.load_proto(args.input_database, pb.pir_pb2.KeywordDatabase)
        builder = mmap_dict.MMapDictionaryBuilder()
        for row in db.rows:
            builder.insert(bytes(row.keyword), bytes(row.value))
        builder.write(args.output, args.load_factor)
        print(f"Wrote {len(db.rows)} entries to {args.output}")
    elif args.command == "info":
        d = mmap_dict.MMapDictionary(args.path)
        print(
            f"buckets: {d.bucket_count}, entries: {d.count()}, "
            f"offset width: {d.offset_size * 8} bits, "
            f"longest probe run: {d.longest_probe_run()}"
        )
        d.close()
    else:
        d = mmap_dict.MMapDictionary(args.path)
        value = d.get(args.keyword.encode())
        d.close()
        if value is None:
            print("not found")
            return 1
        print(value.hex())
    return 0


if __name__ == "__main__":
    sys.exit(main())
