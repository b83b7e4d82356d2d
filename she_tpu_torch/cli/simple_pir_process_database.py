"""SimplePIRProcessDatabase: process a database for SimplePIR serving
(reference Sources/SimplePIRProcessDatabase, 386 LoC), on --device.

Config JSON keys: inputDatabase (KeywordDatabase; its values are the
entries), outputDatabase and outputHint (.npy, uint64), outputParameters
(SimplePIRParameters), plaintextModulusBits (9), ciphertextModulusBits
(21), latticeDimension (1024), securityLevel, seed (hex). The files are
she_tpu's, byte for byte.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .. import params as paramsmod
from ..io import pb
from ..pir import simple_pir as sp
from . import util


def main(argv=None):
    parser = argparse.ArgumentParser(description="Process a database for SimplePIR")
    parser.add_argument("config")
    util.add_device_argument(parser)
    args = parser.parse_args(argv)
    with open(args.config) as f:
        config = json.load(f)

    ep = sp.SimplePirEncryptionParams(
        plaintext_modulus_bits=config.get("plaintextModulusBits", 9),
        ciphertext_modulus_bits=config.get("ciphertextModulusBits", 21),
        lattice_dimension=config.get("latticeDimension", 1024),
        security_level=(
            paramsmod.SecurityLevel.UNCHECKED
            if config.get("securityLevel") == "unchecked"
            else paramsmod.SecurityLevel.QUANTUM128
        ),
    )
    db_msg = util.load_proto(config["inputDatabase"], pb.pir_pb2.KeywordDatabase)
    entries = [bytes(r.value) for r in db_msg.rows]
    seed = bytes.fromhex(config["seed"]) if "seed" in config else None
    t0 = time.perf_counter()
    results = sp.process_database(entries, ep, seed=seed, device=args.device)
    database = results.database.cpu().numpy()
    hint = results.hint.cpu().numpy()
    print(
        f"Processed {len(entries)} entries in {time.perf_counter() - t0:.2f}s on "
        f"{results.database.device}: {results.params.database_columns} columns x "
        f"{database.shape[0]} rows, hint {hint.shape}"
    )

    np.save(config["outputDatabase"], database.astype(np.uint64))
    np.save(config["outputHint"], hint.astype(np.uint64))
    params_msg = pb.pir_pb2.SimplePIRParameters()
    params_msg.encryption_params.lattice_dimension = ep.lattice_dimension
    params_msg.encryption_params.error_std_dev = ep.error_std_dev
    params_msg.encryption_params.plaintext_bits = ep.plaintext_modulus_bits
    params_msg.encryption_params.ciphertext_bits = ep.ciphertext_modulus_bits
    params_msg.a_seed = results.params.seed
    params_msg.entry_size_in_bytes = results.params.entry_size_in_bytes
    params_msg.entries_per_column = results.params.entries_per_column
    params_msg.chunks_per_entry = results.params.chunks_per_entry
    params_msg.database_columns = results.params.database_columns
    util.save_proto(config["outputParameters"], params_msg)
    print(f"Wrote {config['outputDatabase']}, {config['outputHint']}, {config['outputParameters']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
