"""warm: build the CUDA kernels and drive one batch of a serving config.

she_tpu's tool of this name fills the XLA compile cache before traffic
arrives (she_tpu/cli/warm.py). The port compiles no programs; what a cold
start pays is the nvcc build of its kernels (ops/kernel_build), which this
tool runs on a CUDA device, into the build directory that later processes
load. It then builds the serving path for a (parameter set, database
shape, batch) configuration against a synthetic database, serves one batch
through BatchedMulPirServer or BatchedPnnsServer and checks that every
answer of the batch decrypts (PIR: to its entry; PNNS: to the integer dot
products of the rounded vectors).

Usage (the subcommands and flags of she_tpu's tool, and --device):
  python -m she_tpu_torch.cli.warm pir  --params n_4096_logq_27_28_28_logt_5 \
      --scalar-bits 32 --entries 100000 --entry-size 1 --batch 16
  python -m she_tpu_torch.cli.warm pnns --params n_4096_logq_27_28_28_logt_17 \
      --scalar-bits 32 --rows 4096 --dim 128 --batch 16
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from . import util


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _det(tag: bytes):
    from ..rng.ctr_drbg import nist_aes128_ctr

    return nist_aes128_ctr((tag * 32)[:32])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_pir(args, device: torch.device) -> None:
    from .. import params as paramsmod
    from ..bfv import bfv
    from ..pir import index_pir as ip, serving

    ep = paramsmod.from_predefined(args.params, scalar_bits=args.scalar_bits)
    ctx = bfv.get_bfv_context(ep, device)
    sk = bfv.generate_secret_key(ctx, _det(b"warm-sk"))
    config = ip.IndexPirConfig(
        entry_count=args.entries,
        entry_size_in_bytes=args.entry_size,
        dimension_count=args.dims,
        batch_size=1,
        uneven_dimensions=True,
        key_compression=ip.PirKeyCompression[args.key_compression],
    )
    parameter = ip.generate_parameter(config, ctx)
    _log(f"warming PIR dims={parameter.dimensions} expanded={parameter.expanded_query_count} "
         f"batch={args.batch} on {device}")
    values = np.random.default_rng(0).integers(0, 256, size=args.entries, dtype=np.uint8)
    database = [bytes([v]) * args.entry_size for v in values]
    t0 = time.perf_counter()
    processed = ip.MulPirServer.process(database, ctx, parameter)
    _sync(device)
    _log(f"db processed in {time.perf_counter() - t0:.1f}s")
    client = ip.MulPirClient(parameter, ctx)
    ek = client.generate_evaluation_key(sk, _det(b"warm-ek"))
    server = serving.BatchedMulPirServer(parameter, ctx, [processed])
    indices = [i % args.entries for i in range(args.batch)]
    queries = [client.generate_query([i], sk) for i in indices]
    t0 = time.perf_counter()
    responses = server.compute_response_batch(queries, ek)
    _sync(device)
    dt = time.perf_counter() - t0
    for i, response in zip(indices, responses):
        got = client.decrypt(response, [i], sk)[0][: args.entry_size]
        if got != database[i]:
            raise RuntimeError(f"warm-run decrypt mismatch at entry {i}")
    _log(f"first batch of {args.batch} in {dt:.3f}s; every answer decrypts")


def warm_pnns(args, device: torch.device) -> None:
    from .. import params as paramsmod
    from ..bfv import bfv
    from ..pnns import pnns, serving as pnns_serving

    ep = paramsmod.from_predefined(args.params, scalar_bits=args.scalar_bits)
    ctx = bfv.get_bfv_context(ep, device)
    sf = pnns.max_scaling_factor(args.dim, [ctx.plaintext_modulus])
    pt_dims = pnns.MatrixDimensions(args.rows, args.dim)
    ek_config = pnns.matmul_evaluation_key_config(ctx, pt_dims, 1)
    client_config = pnns.ClientConfig.create(ep, sf, pnns.MatrixPacking.dense_row(), args.dim, ek_config)
    server_config = pnns.ServerConfig(
        client_config, pnns.MatrixPacking.diagonal(pnns.BabyStepGiantStep.create(args.dim))
    )
    _log(f"warming PNNS {args.rows}x{args.dim} batch={args.batch} on {device}")
    rng = np.random.default_rng(0)
    vectors = rng.standard_normal((args.rows, args.dim)).astype(np.float32)
    db = pnns.Database([pnns.DatabaseRow(i, b"", vectors[i]) for i in range(args.rows)])
    t0 = time.perf_counter()
    processed = pnns.process_database(db, server_config, device)
    _sync(device)
    _log(f"db processed in {time.perf_counter() - t0:.1f}s")
    client = pnns.Client(client_config, device)
    sk = client.generate_secret_key(_det(b"warm-sk"))
    ek = client.generate_evaluation_key(sk, _det(b"warm-ek"))
    server = pnns_serving.BatchedPnnsServer(processed)
    query_vectors = rng.standard_normal((args.batch, 1, args.dim)).astype(np.float32)
    queries = [client.generate_query(v, sk, err_rng=_det(bytes([i % 256]))) for i, v in enumerate(query_vectors)]
    t0 = time.perf_counter()
    responses = server.compute_response_batch(queries, ek)
    _sync(device)
    dt = time.perf_counter() - t0
    db_rounded = pnns.normalized_scaled_and_rounded(vectors, sf)
    for v, response in zip(query_vectors, responses):
        want = db_rounded @ pnns.normalized_scaled_and_rounded(v, sf).T
        if not np.array_equal(client.scores(response, sk), want):
            raise RuntimeError("warm-run scores differ from the integer dot products")
    _log(f"first batch of {args.batch} in {dt:.3f}s; every score decrypts to its dot product")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="warm", description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="mode", required=True)
    pir = sub.add_parser("pir", help="warm a MulPIR serving config")
    pir.add_argument("--params", default="n_4096_logq_27_28_28_logt_5")
    pir.add_argument("--scalar-bits", type=int, default=32)
    pir.add_argument("--entries", type=int, default=1_000_000)
    pir.add_argument("--entry-size", type=int, default=1)
    pir.add_argument("--dims", type=int, default=2)
    pir.add_argument("--batch", type=int, default=128)
    pir.add_argument("--key-compression", default="NO_COMPRESSION", choices=["NO_COMPRESSION", "HYBRID", "MAX"])
    util.add_device_argument(pir)
    pnns_p = sub.add_parser("pnns", help="warm a PNNS serving config")
    pnns_p.add_argument("--params", default="n_4096_logq_27_28_28_logt_17")
    pnns_p.add_argument("--scalar-bits", type=int, default=32)
    pnns_p.add_argument("--rows", type=int, default=4096)
    pnns_p.add_argument("--dim", type=int, default=128)
    pnns_p.add_argument("--batch", type=int, default=16)
    util.add_device_argument(pnns_p)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    if device.type == "cuda":
        from ..ops import kernel_build

        _log(f"kernels built (seconds each, 0 if already built): {kernel_build.build()}")
    if args.mode == "pir":
        warm_pir(args, device)
    else:
        warm_pnns(args, device)
    _log(f"total warm time {time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
