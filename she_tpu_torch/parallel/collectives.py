"""The collectives of the port's mesh, over torch.distributed.

The counterparts of the three jax.lax collectives she_tpu/parallel uses,
run by every rank of one mesh axis's process group (mesh.Mesh.group):

* `exchange(x, mesh, axis, dist)`: rank s of the axis swaps x with rank
  s ^ dist (jax.lax.ppermute with perm [(s, s ^ dist)]), one send and one
  receive through dist.batch_isend_irecv;
* `all_reduce_sum(x, mesh, axis)`: the sum over the axis (jax.lax.psum);
* `all_gather_batch(x, mesh, axis, dim=0)`: the axis's shards concatenated
  along `dim` in rank order, what a NamedSharding output gathers to.

Transport follows the backend the caller made the mesh with (mesh.backend),
never a guess:
* nccl: the tensors lie on the card and stay there; a host tensor raises.
* gloo: host tensors go as they are. A CUDA tensor is copied to the host,
  sent, and the result copied back to its device, explicitly: the
  tracer's registry counts the bytes of those copies
  (collective.staged_bytes) and their seconds on the host clock
  (collective.staged_s; each copy waits for the device), so a run can
  report what staging cost.
No branch turns one backend into the other, and any other backend or
device raises.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as tdist

from .. import trace


def _wire(x: torch.Tensor, backend: str) -> torch.Tensor:
    """x in the form the backend sends: contiguous, on the card for nccl,
    on the host for gloo (a CUDA tensor copied there and counted)."""
    if backend == "nccl":
        if x.device.type != "cuda":
            raise ValueError(f"nccl sends CUDA tensors, got one on {x.device}")
        return x.contiguous()
    if backend != "gloo":
        raise ValueError(f"no transport for backend {backend!r}")
    if x.device.type == "cpu":
        return x.contiguous()
    if x.device.type != "cuda":
        raise ValueError(f"gloo stages CUDA or host tensors, got one on {x.device}")
    t0 = time.perf_counter()
    host = x.to("cpu").contiguous()
    trace.count("collective.staged_s", time.perf_counter() - t0)
    trace.count("collective.staged_bytes", host.numel() * host.element_size())
    return host


def _home(y: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A received tensor back on the device its input came from."""
    if y.device == device:
        return y
    t0 = time.perf_counter()
    out = y.to(device)
    torch.cuda.synchronize(device)
    trace.count("collective.staged_s", time.perf_counter() - t0)
    trace.count("collective.staged_bytes", y.numel() * y.element_size())
    return out


def exchange(x: torch.Tensor, mesh, axis: str, dist: int) -> torch.Tensor:
    """The x of rank s ^ dist of `axis`, for every rank s of the axis
    (dist a power of two below the axis size)."""
    S, s = mesh.size(axis), mesh.index(axis)
    if not 0 < dist < S or dist & (dist - 1):
        raise ValueError(f"exchange distance {dist} on an axis of {S} ranks")
    group = mesh.group(axis)
    peer = tdist.get_global_rank(group, s ^ dist)
    send = _wire(x, mesh.backend)
    recv = torch.empty_like(send)
    ops = [tdist.P2POp(tdist.isend, send, peer, group), tdist.P2POp(tdist.irecv, recv, peer, group)]
    for req in tdist.batch_isend_irecv(ops):
        req.wait()
    return _home(recv, x.device)


def all_reduce_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise sum of x over the ranks of `axis` (x is left as it
    was); the caller keeps the sum from overflowing."""
    buf = _wire(x, mesh.backend)
    buf = buf.clone() if buf is x else buf
    tdist.all_reduce(buf, op=tdist.ReduceOp.SUM, group=mesh.group(axis))
    return _home(buf, x.device)


def all_gather_batch(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The x of every rank of `axis`, concatenated along `dim` in rank
    order (every rank's x has the same shape)."""
    send = _wire(x, mesh.backend)
    parts = [torch.empty_like(send) for _ in range(mesh.size(axis))]
    tdist.all_gather(parts, send, group=mesh.group(axis))
    return _home(torch.cat(parts, dim=dim), x.device)
