"""PNNSProcessDatabase: config-driven PNNS database processing
(reference Sources/PNNSProcessDatabase, 322 LoC), on --device.

Config JSON keys: inputDatabase, outputDatabase, rlweParameters,
scalingFactor (optional; defaults to max), extraPlaintextModuli,
maxQueryCount, trialsPerShard.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .. import params as paramsmod
from ..bfv import bfv
from ..device import resolve_device
from ..io import pb, proto_conversion as pc
from ..pnns import pnns
from . import util


def main(argv=None):
    parser = argparse.ArgumentParser(description="Process a PNNS database")
    parser.add_argument("config")
    util.add_device_argument(parser)
    args = parser.parse_args(argv)
    with open(args.config) as f:
        config = json.load(f)
    device = resolve_device(args.device)

    ep = paramsmod.from_predefined(config["rlweParameters"])
    db_msg = util.load_proto(config["inputDatabase"], pb.pnns_pb2.Database)
    database = pc.pnns_database_from_proto(db_msg)
    dim = len(database.rows[0].vector)
    extra = tuple(config.get("extraPlaintextModuli", []))
    moduli = [ep.plaintext_modulus, *extra]
    scaling = config.get("scalingFactor") or pnns.max_scaling_factor(dim, moduli)

    ctx = bfv.get_bfv_context(ep, device)
    pt_dims = pnns.MatrixDimensions(len(database.rows), dim)
    ek_config = pnns.matmul_evaluation_key_config(ctx, pt_dims, config.get("maxQueryCount", 1))
    client_config = pnns.ClientConfig.create(
        ep, scaling, pnns.MatrixPacking.dense_row(), dim, ek_config, extra_plaintext_moduli=extra
    )
    server_config = pnns.ServerConfig(
        client_config, pnns.MatrixPacking.diagonal(pnns.BabyStepGiantStep.create(dim))
    )
    t0 = time.perf_counter()
    processed = pnns.process_database(database, server_config, device)
    print(f"Processed {len(database.rows)} rows in {time.perf_counter() - t0:.2f}s (device {device})")

    out = pb.pnns_pb2.SerializedProcessedDatabase()
    for m in processed.plaintext_matrices:
        out.plaintext_matrices.append(pc.plaintext_matrix_to_proto(m))
    out.entry_ids.extend(processed.entry_ids)
    for md in processed.entry_metadatas:
        out.entry_metadatas.append(bytes(md))
    out.server_config.CopyFrom(pc.pnns_server_config_to_proto(server_config))
    util.save_proto(config["outputDatabase"], out)
    print(f"Wrote processed database to {config['outputDatabase']}")

    trials = config.get("trialsPerShard", 1)
    if trials > 0:
        result = pnns.validate_database(processed, trials=trials)
        print(
            f"validation ({trials} trial(s)): "
            f"query {result.query_time_s * 1e3:.1f} ms, "
            f"response {result.response_time_s * 1e3:.1f} ms, "
            f"decrypt {result.decrypt_time_s * 1e3:.1f} ms, "
            f"noise budget {result.noise_budget:.2f}, "
            f"max |error| {result.max_abs_error:.2e}"
        )
        if result.noise_budget <= 0:
            print("validation FAILED: noise budget exhausted", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
