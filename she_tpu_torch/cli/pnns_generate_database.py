"""PNNSGenerateDatabase: synthesize a vector database
(reference Sources/PNNSGenerateDatabase/GenerateDatabase.swift:23-60).
Host code: it takes no --device."""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io import pb
from . import util


def main(argv=None):
    parser = argparse.ArgumentParser(description="Generate a PNNS test database")
    parser.add_argument("--output-database", required=True)
    parser.add_argument("--row-count", type=int, required=True)
    parser.add_argument("--vector-dimension", type=int, required=True)
    parser.add_argument("--vector-type", choices=["random", "unit"], default="random")
    parser.add_argument("--metadata-size", type=int, default=0)
    args = parser.parse_args(argv)

    rng = np.random.default_rng(0)
    db = pb.pnns_pb2.Database()
    for i in range(args.row_count):
        row = db.rows.add()
        row.entry_id = i
        row.entry_metadata = rng.integers(0, 256, size=args.metadata_size).astype(np.uint8).tobytes()
        if args.vector_type == "unit":
            v = np.zeros(args.vector_dimension, dtype=np.float32)
            v[i % args.vector_dimension] = 1.0
        else:
            v = rng.standard_normal(args.vector_dimension).astype(np.float32)
        row.vector.extend(v.tolist())
    util.save_proto(args.output_database, db)
    print(f"Wrote {args.row_count} rows to {args.output_database}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
