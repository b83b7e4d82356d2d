"""What each rank runs for tests/test_torch_parallel.py and
tests/test_torch_sharded.py.

parallel.mesh.run_ranks starts the ranks with `spawn`, so the functions
they run must import from a module: this one. It imports the port, torch
and numpy only (a rank has no use for jax). Every input comes from the
test as numpy arrays (she_tpu's keys, queries and inputs, carried across
with she_tpu_torch.convert), every rank returns the whole result as
int64 numpy arrays, and the test compares them with she_tpu's.
"""

from __future__ import annotations

import numpy as np
import torch

from she_tpu_torch import convert
from she_tpu_torch import params as tparams
from she_tpu_torch.bfv import bfv
from she_tpu_torch.core.context import get_poly_context
from she_tpu_torch.ops import ntt
from she_tpu_torch.parallel import mesh as meshmod
from she_tpu_torch.parallel import sharded
from she_tpu_torch.pir import index_pir as ip
from she_tpu_torch.pir import serving
from she_tpu_torch.pnns import pnns
from she_tpu_torch.pnns import serving as pnns_serving

CPU = torch.device("cpu")


def pir_server(spec: dict, use_dim0_int8: bool = False):
    """The port's context, server, evaluation key and queries from a PIR
    spec (she_tpu's database, key and query limbs)."""
    ctx = bfv.get_bfv_context(tparams.from_predefined(spec["params"], spec["bits"]), device=CPU)
    parameter = ip.generate_parameter(ip.IndexPirConfig(**spec["config"]), ctx)
    processed = ip.MulPirServer.process(spec["database"], ctx, parameter)
    server = serving.BatchedMulPirServer(parameter, ctx, [processed], use_dim0_int8=use_dim0_int8)
    ek = convert.evaluation_key_from_limbs(ctx, *spec["ek"])
    queries = [convert.query_from_limbs(ctx, q, 1) for q in spec["queries"]]
    return ctx, server, ek, queries


def response_values(responses: list) -> np.ndarray:
    """ip.Response list -> int64 [B, 2, 1, N] (one index, one chunk)."""
    return np.stack([r.ciphertexts[0][0].stacked().numpy() for r in responses])


def pnns_server(spec: dict):
    ep = tparams.from_predefined(spec["params"], spec["bits"])
    ctx = bfv.get_bfv_context(ep, device=CPU)
    dim, rows = spec["dim"], len(spec["vectors"])
    sf = pnns.max_scaling_factor(dim, [ep.plaintext_modulus])
    ek_config = pnns.matmul_evaluation_key_config(ctx, pnns.MatrixDimensions(rows, dim), 1)
    client_config = pnns.ClientConfig.create(ep, sf, pnns.MatrixPacking.dense_row(), dim, ek_config)
    server_config = pnns.ServerConfig(client_config, pnns.MatrixPacking.diagonal(pnns.BabyStepGiantStep.create(dim)))
    db = pnns.process_database(
        pnns.Database([pnns.DatabaseRow(i, b"", v) for i, v in enumerate(spec["vectors"])]), server_config, device=CPU)
    ek = convert.evaluation_key_from_limbs(ctx, spec["ek"], None)
    queries = [convert.pnns_query_from_limbs(db.contexts, (1, dim), pnns.MatrixPacking.dense_row(), q)
               for q in spec["queries"]]
    return pnns_serving.BatchedPnnsServer(db), ek, queries


def pnns_values(responses: list) -> np.ndarray:
    """pnns.Response list -> int64 [B, R, 2, 1, N] (one plaintext modulus)."""
    return np.stack([np.stack([c.stacked().numpy() for c in r.ciphertext_matrices[0].ciphertexts])
                     for r in responses])


def dim0_case(mesh, case: dict) -> np.ndarray:
    """dim0_partial_psum over the "db" axis; with case["int8"], on the
    digits of this rank's slice, packed here as a server packs them."""
    ct_ctx = get_poly_context(case["degree"], case["moduli"], case["bits"], CPU)
    db, query = torch.from_numpy(case["db"]), torch.from_numpy(case["query"])
    digits = None
    if case["int8"]:
        rows = meshmod.shard(db.shape[1], mesh, "db", "d0")
        digits = serving.pack_database_chunk_digits(db[:, rows].contiguous(), ct_ctx)
    return meshmod.dim0_partial_psum(db, query, ct_ctx, mesh, "db", digits).numpy()


def parallel_ranks(mesh, spec: dict) -> dict:
    """Every case of test_torch_parallel.py on a world of len(spec) ranks:
    `mesh` is that world on one axis, "batch"."""
    S = mesh.size("batch")
    out = {}
    db_mesh = meshmod.make_mesh((S,), ("db",), mesh.backend, mesh.device)
    for name, pir in spec["pir"].items():
        _, server, ek, queries = pir_server(pir)
        out[f"batch_parallel/{name}"] = response_values(meshmod.batch_parallel_response(server, queries, ek, mesh))
    for name, case in spec["dim0"].items():
        if case["S"] == S:
            out[f"dim0/{name}"] = dim0_case(db_mesh, case)
    if S == 4:
        two = meshmod.make_mesh((2, 2), ("batch", "db"), mesh.backend, mesh.device)
        for name, pir in spec["pir"].items():
            for int8 in (False, True) if pir["bits"] == 32 else (False,):
                _, server, ek, queries = pir_server(pir, use_dim0_int8=int8)
                raw = meshmod.two_axis_response(server, queries, ek, two)
                out[f"two_axis/{name}{'-int8' if int8 else ''}"] = raw[0][0].numpy()
        server, ek, queries = pnns_server(spec["pnns"])
        out["pnns"] = pnns_values(meshmod.batch_parallel_pnns_response(server, queries, ek, mesh))
    return out


def ntt_case(mesh, case: dict) -> dict:
    tables = ntt.build_ntt_tables(case["moduli"], case["degree"], CPU)
    x = torch.from_numpy(case["x"])
    sn = sharded.ShardedNtt(mesh, tables, "n")
    fwd = sn.forward(x)
    return dict(forward=fwd.numpy(), inverse=sn.inverse(fwd).numpy(), inverse_of_x=sn.inverse(x).numpy())


def limb_case(mesh, case: dict) -> dict:
    tables = ntt.build_ntt_tables(case["moduli"], case["degree"], CPU)
    fwd, inv = sharded.limb_parallel_ntt_fns(mesh, tables, "limb")
    got = fwd(torch.from_numpy(case["x"]))
    return dict(forward=got.numpy(), inverse=inv(got).numpy())


def ct_mul_case(mesh, case: dict) -> np.ndarray:
    ctx = bfv.get_bfv_context(tparams.from_predefined(case["params"], case["bits"]), device=CPU)
    a, b = (convert.ciphertext_from_limbs(ctx, c) for c in case["cts"])
    return sharded.sharded_ct_mul(a, b, mesh, "n").stacked().numpy()


def sharded_ranks(mesh, spec: dict) -> dict:
    """Every case of test_torch_sharded.py on a world of S ranks: `mesh`
    is that world on one axis, "n"."""
    S = mesh.size("n")
    limb = meshmod.make_mesh((S,), ("limb",), mesh.backend, mesh.device)
    out = {f"ntt/{k}": ntt_case(mesh, c) for k, c in spec["ntt"].items() if c["S"] == S}
    out |= {f"limb/{k}": limb_case(limb, c) for k, c in spec["limb"].items() if c["S"] == S}
    out |= {f"ct_mul/{k}": ct_mul_case(mesh, c) for k, c in spec["ct_mul"].items() if c["S"] == S}
    return out
