"""Multi-device PIR and PNNS serving over a torch.distributed device mesh.

The port of she_tpu/parallel/mesh.py. she_tpu runs one controller over a
jax.sharding.Mesh and writes each sharded step as a jax.shard_map body;
here every rank is one process that holds one shard and runs that body on
it (SPMD): jax.lax.axis_index is `Mesh.index`, ppermute a pairwise
exchange and psum an all-reduce (parallel/collectives.py). A mesh across
processes of one host and a mesh across hosts are the same program, so
this one port covers she_tpu's single-controller mesh and its multi-process
(DCN) analogue alike.

Every function below is called by every rank of the mesh with the same
arguments (the queries and the database replicated), takes its own shard,
and returns the whole result on every rank:

* `batch_parallel_response` / `batch_parallel_pnns_response`: the query
  batch split over one axis; each rank serves B/S queries through its own
  batched server, and the raw response tensors are gathered along the
  batch.
* `dim0_partial_psum`: the d0 hyper-rows of one database chunk split over
  an axis; each rank computes its d0/S slice's partial inner products (the
  int8 digit form when it is given its slice's digits, which the owner of
  the database packs once and keeps, else the MAC) and the fully reduced
  partials are summed: one all-reduce and a reduction mod q where she_tpu takes its
  one-shot psum (32-bit scalars, S * max(q) within the port's int64 words
  rather than she_tpu's uint32), else a recursive-doubling butterfly of
  exact modular adds. Either way the same bits as one device.
* `two_axis_response`: a (batch, db) mesh; the batch split over `batch`,
  expansion replicated over `db`, the dim-0 hyper-rows and the higher
  dimensions' BEHZ terms partitioned over `db`, combined by butterflies
  before the single scaling, relinearization and mod switch.

`make_mesh` makes the mesh on a rank of an initialized process group, and
`run_ranks` starts such ranks on this host. Axis sizes must be powers of
two: the butterflies pair rank s with s ^ step, which is what she_tpu does
too, but there a size such as 3 fails inside its trace; here it raises
InvalidArgument.
"""

from __future__ import annotations

import math
import os
import pickle
import tempfile
import time
from dataclasses import dataclass

import torch
import torch.distributed as tdist
import torch.multiprocessing as torch_mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import errors
from ..bfv import bfv
from ..core.poly import EVAL, PolyRq
from ..ops import modarith as ma
from ..pir import serving
from . import collectives

BACKENDS = ("gloo", "nccl")
# how long run_ranks waits for its ranks before it stops them and raises
RANK_TIMEOUT_S = 600.0


@dataclass(frozen=True)
class Mesh:
    """A named device mesh on one rank: the torch DeviceMesh, the backend
    the caller named for its process groups, and this rank's device."""

    device_mesh: DeviceMesh
    backend: str
    device: torch.device

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.device_mesh.mesh_dim_names

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.device_mesh.mesh.shape))

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's place along `axis` (jax.lax.axis_index)."""
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)


def check_mesh_shape(mesh_shape, axis_names) -> None:
    if len(mesh_shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
        raise errors.InvalidArgument(f"mesh shape {tuple(mesh_shape)} with axes {tuple(axis_names)}")
    for size, name in zip(mesh_shape, axis_names):
        if size < 1 or size & (size - 1):
            raise errors.InvalidArgument(f"mesh axis {name!r} of size {size} is not a power of two")


def make_mesh(mesh_shape, axis_names, backend: str, device) -> Mesh:
    """The mesh of this rank's process group (initialized with `backend`),
    the ranks laid out row-major over `mesh_shape` (she_tpu mesh.py:37)."""
    check_mesh_shape(mesh_shape, axis_names)
    if backend not in BACKENDS:
        raise errors.InvalidArgument(f"backend {backend!r} is none of {BACKENDS}")
    if not tdist.is_initialized() or tdist.get_backend() != backend:
        raise errors.InvalidArgument(f"make_mesh needs a process group initialized with {backend!r}")
    device = torch.device(device)
    dm = init_device_mesh(device.type, tuple(mesh_shape), mesh_dim_names=tuple(axis_names))
    return Mesh(dm, backend, device)


def _rank_main(rank, world, store_dir, mesh_shape, axis_names, backend, device_type):
    torch.set_num_threads(1)
    with open(os.path.join(store_dir, "call"), "rb") as f:
        fn, args = pickle.load(f)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank} finds no CUDA device")
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(device_type)
    # the ranks of one launch share this host: gloo talks over loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    store = tdist.FileStore(os.path.join(store_dir, "store"), world)
    tdist.init_process_group(backend, store=store, rank=rank, world_size=world)
    try:
        result = fn(make_mesh(mesh_shape, axis_names, backend, device), *args)
        path = os.path.join(store_dir, f"result_{rank}")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(path + ".tmp", path)
    finally:
        tdist.destroy_process_group()


def run_ranks(fn, mesh_shape, axis_names, backend: str, device, *args) -> list:
    """Runs fn(mesh, *args) on prod(mesh_shape) ranks of this host, each a
    process started with `spawn` (CUDA cannot be forked), and returns
    their results in rank order. fn and args must pickle (fn a module
    function); so must fn's result, which should hold host objects. The
    ranks meet through a FileStore in a temporary directory, so launches
    in parallel never share a port. Rank r runs on cuda:(r % device count)
    when `device` is a CUDA device, else on the host; a rank that finds no
    card raises. A rank that raises, or a launch past RANK_TIMEOUT_S, stops
    every rank and raises here."""
    check_mesh_shape(mesh_shape, axis_names)
    if backend not in BACKENDS:
        raise errors.InvalidArgument(f"backend {backend!r} is none of {BACKENDS}")
    device_type = torch.device(device).type
    if device_type not in ("cpu", "cuda") or (backend == "nccl" and device_type != "cuda"):
        raise errors.InvalidArgument(f"backend {backend!r} on device {device!r}")
    world = math.prod(mesh_shape)
    with tempfile.TemporaryDirectory(prefix="she_ranks_") as store_dir:
        # the call goes through a file: a process start blocks until its
        # child has read what it was given, after the child's imports
        with open(os.path.join(store_dir, "call"), "wb") as f:
            pickle.dump((fn, args), f)
        ctx = torch_mp.start_processes(
            _rank_main, args=(world, store_dir, tuple(mesh_shape), tuple(axis_names), backend, device_type),
            nprocs=world, join=False, start_method="spawn",
        )
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish within {RANK_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        results = []
        for rank in range(world):
            with open(os.path.join(store_dir, f"result_{rank}"), "rb") as f:
                results.append(pickle.load(f))
    return results


def shard(total: int, mesh: Mesh, axis: str, what: str) -> slice:
    """This rank's contiguous share of `total` items along `axis`."""
    S = mesh.size(axis)
    if total % S:
        raise errors.InvalidArgument(f"mesh axis {axis!r} of size {S} must divide {what}={total}")
    k = total // S
    i = mesh.index(axis)
    return slice(i * k, (i + 1) * k)


def butterfly_add(x: torch.Tensor, q, mesh: Mesh, axis: str) -> torch.Tensor:
    """The exact modular sum over `axis` of residues x in [0, q): a
    recursive-doubling butterfly of add_mod, each rank ending with the sum."""
    step = 1
    while step < mesh.size(axis):
        x = ma.add_mod(x, collectives.exchange(x, mesh, axis, step), q)
        step <<= 1
    return x


def sum_partials(partial: torch.Tensor, ct_ctx, mesh: Mesh, axis: str) -> torch.Tensor:
    """Fully reduced partials [..., L, N] over ct_ctx summed over `axis`:
    she_tpu's one-shot psum and fold where it takes them (32-bit scalars)
    and the int64 sum cannot overflow, else the butterfly."""
    if ct_ctx.scalar_bits == 32 and mesh.size(axis) * max(ct_ctx.moduli) < ma.INT63:
        return torch.remainder(collectives.all_reduce_sum(partial, mesh, axis), ct_ctx.q_col)
    return butterfly_add(partial, ct_ctx.q_col, mesh, axis)


def batch_parallel_response(server: "serving.BatchedMulPirServer", queries: list, evaluation_key, mesh: Mesh) -> list:
    """One ip.Response per query, each rank serving its B/S queries of the
    mesh's first axis (she_tpu mesh.py:50)."""
    axis = mesh.axis_names[0]
    B = len(queries)
    local = queries[shard(B, mesh, axis, "the query batch")]
    stacked, _, indices_count = server.stack_queries_device(local)
    out = server.respond_stacked(stacked, evaluation_key, indices_count)
    out = [[collectives.all_gather_batch(a, mesh, axis) for a in reply] for reply in out]
    return server._assemble_responses(out, B)


def dim0_partial_psum(db_chunk: torch.Tensor, query_eval: torch.Tensor, ct_ctx, mesh: Mesh, axis: str = "db",
                      db_digits: torch.Tensor | None = None) -> torch.Tensor:
    """db_chunk [C, d0, L, N], query_eval [d0, P, L, N] (Eval) -> the
    [C, P, L, N] of serving.dim0_inner_products, bit for bit, with d0
    split over `axis` (she_tpu mesh.py:67). db_digits, the int8 digits of
    this rank's slice db_chunk[:, shard(d0, mesh, axis, ...)] as the
    database's owner keeps them (BatchedMulPirServer.slice_digits), takes
    the int8 digit form; None takes the MAC."""
    rows = shard(db_chunk.shape[1], mesh, axis, "d0")
    if db_digits is None:
        partial = serving.dim0_inner_products(db_chunk[:, rows], query_eval[rows], ct_ctx)
    else:
        partial = serving.dim0_int8(db_digits, query_eval[rows], ct_ctx)
    return sum_partials(partial, ct_ctx, mesh, axis)


def _fold_dimensions_partitioned(server, columns: torch.Tensor, rest: torch.Tensor, evaluation_key, mesh: Mesh,
                                 axis: str) -> torch.Tensor:
    """server.fold_dimensions with each dimension's ct-ct terms split over
    `axis`: a rank lifts and multiplies its dim_size/S pairs, the
    extended-base sums are combined by the butterfly, then one
    drop_extended_base and relinearization (she_tpu mesh.py:229-286)."""
    ctx, ct_ctx = server.context, server.ct_ctx
    query_start = 0
    for dim_size in server.parameter.dimensions[1:]:
        terms = shard(dim_size, mesh, axis, "a higher dimension")
        v0 = rest[query_start + terms.start : query_start + terms.stop].transpose(0, 1)  # [B, k, 2, L, N]
        groups = []
        for start in range(0, columns.shape[1], dim_size):
            v1 = columns[:, start + terms.start : start + terms.stop]
            prod = bfv.multiply_without_scaling(
                bfv.Ciphertext.from_stacked(ctx, v0, ct_ctx), bfv.Ciphertext.from_stacked(ctx, v1, ct_ctx)
            )
            ext_ctx = prod.polys[0].context
            partial = torch.stack([ma.sum_mod(p.data, ext_ctx.q_col, -3) for p in prod.polys])
            summed = butterfly_add(partial, ext_ctx.q_col, mesh, axis)
            acc = bfv.Ciphertext(prod.context, [PolyRq(p, ext_ctx, EVAL) for p in summed], prod.correction_factor)
            groups.append(bfv.relinearize(bfv.drop_extended_base(acc), evaluation_key).stacked())
        columns = torch.stack(groups, dim=1)  # [B, groups, 2, L, N]
        query_start += dim_size
    if columns.shape[1] != 1:
        raise errors.PirError("dimensions do not reduce to one ciphertext")
    return columns


def two_axis_response(server: "serving.BatchedMulPirServer", queries: list, evaluation_key, mesh: Mesh) -> list:
    """The whole MulPIR batch on a (batch, db) mesh (she_tpu mesh.py:119):
    raw responses as server.respond_stacked gives them, per query index
    (one) and chunk, [B, 2, 1, N], equal to the single server's bits."""
    baxis, daxis = mesh.axis_names
    parameter = server.parameter
    B = len(queries)
    local = queries[shard(B, mesh, baxis, "the query batch")]
    rows = shard(parameter.dimensions[0], mesh, daxis, "d0")
    for dim_size in parameter.dimensions[1:]:
        shard(dim_size, mesh, daxis, "a higher dimension")
    stacked, _, indices_count = server.stack_queries_device(local)
    if indices_count != 1 or len(server.chunks) != 1:
        raise errors.InvalidArgument("two_axis_response serves one index a query from one database")
    expanded = server.expand(stacked, evaluation_key)
    query_eval, rest = server.dim0_query(expanded)
    reply = []
    for chunk_index in range(len(server.chunks[0])):
        partial = server.dim0_partial(0, chunk_index, rows, query_eval)
        columns = server.dim0_columns(butterfly_add(partial, server.ct_ctx.q_col, mesh, daxis))
        columns = _fold_dimensions_partitioned(server, columns, rest, evaluation_key, mesh, daxis)
        reply.append(server.mod_switch(columns))
    return [[collectives.all_gather_batch(a, mesh, baxis) for a in reply]]


def batch_parallel_pnns_response(server, queries: list, evaluation_key, mesh: Mesh) -> list:
    """One pnns.Response per query of a pnns.serving.BatchedPnnsServer,
    each rank serving its B/S queries of the mesh's first axis (she_tpu
    mesh.py:341)."""
    axis = mesh.axis_names[0]
    B = len(queries)
    local = queries[shard(B, mesh, axis, "the query batch")]
    out = server.respond_stacked(server.stack_queries_device(local), evaluation_key)
    out = [collectives.all_gather_batch(a, mesh, axis, dim=1) for a in out]  # [R, B, 2, 1, N] each
    return server._assemble_responses(out, B)
