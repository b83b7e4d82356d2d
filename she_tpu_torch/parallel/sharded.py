"""Polynomials sharded on N and on the RNS limbs over a mesh axis.

The port of she_tpu/parallel/sharded.py, one rank a shard (SPMD, as in
parallel/mesh.py):

* `ShardedNtt`: a [..., L, N] polynomial split into S contiguous blocks of
  N/S coefficients, block d on rank d of the axis. Stage log2 m of the
  forward transform pairs coefficients N/(2m) apart, so its first log2 S
  stages pair block d with block d ^ (S >> (log2 m + 1)): one exchange of
  the whole shard and one exact butterfly a stage. After them, block d
  undergoes exactly a negacyclic NTT of length N/S whose twiddle
  m' + i is the full table's (S + d) m' + i (she_tpu's index m + d m_local,
  sharded.py:130, with m = S m'): ops/ntt.build_block_tables makes those
  tables with their 64- and 32-bit Shoup constants, and the local stages
  run in ops/ntt.forward_ntt, the CUDA NTT kernel on the card. The inverse
  runs the local transform first with tables that leave n^-1 out of its
  last stage, then the cross-rank stages with n^-1 (and n^-1 w^-1) in the
  last. Every stage's output is fully reduced, so the result has the bits
  of the unsharded transform.
* `limb_parallel_ntt_fns`: the L rows split over the axis; each rank
  transforms its rows with their rows' tables, no collective.
* `sharded_ct_mul`: the BEHZ ct x ct multiply (bfv.ct_mul) with every
  polynomial sharded on N: the lift (read in place from the rank's block
  of N/S columns), the sharded forward NTT, the tensor product scaled by
  t, the sharded inverse and the floor, all on the shard, through the
  BEHZ kernels of ops/behz.py on a CUDA card; only the NTTs exchange.
"""

from __future__ import annotations

import torch

from .. import errors, trace
from ..bfv import bfv
from ..core.poly import COEFF
from ..ops import behz
from ..ops import modarith as ma
from ..ops import ntt as nttmod
from ..ops import wide
from . import collectives


class ShardedNtt:
    """Forward and inverse negacyclic NTT of polynomials sharded on N over
    `axis`. forward_local / inverse_local take this rank's block
    [..., L, N/S] in [0, q); forward / inverse take the whole [..., L, N]
    on every rank and return it whole."""

    def __init__(self, mesh, tables: "nttmod.NttTables", axis: str):
        self.mesh, self.axis, self.tables = mesh, axis, tables
        S, n = mesh.size(axis), tables.degree
        if n % S or S & (S - 1) or S >= n:
            raise errors.InvalidArgument(f"mesh axis size {S} must be a power of two below and dividing N={n}")
        self.S, self.block, self.n_local = S, mesh.index(axis), n // S
        self.log2S = S.bit_length() - 1
        L = len(tables.moduli)
        self.q = wide.tag(tables.q.view(L, 1), tables.moduli)
        self.local_tables = tables if S == 1 else nttmod.build_block_tables(tables.moduli, n, S, self.block, tables.q.device)
        # stage log2 m < log2 S: the twiddle of this block's butterfly group
        groups = [(1 << k) + self.block // (2 * (S >> (k + 1))) for k in range(self.log2S)]
        self.roots = [tables.roots[:, g : g + 1] for g in groups]
        self.inv_roots = [tables.inv_roots[:, g : g + 1] for g in groups]

    def _partner(self, x: torch.Tensor, log2m: int) -> tuple[torch.Tensor, bool]:
        dist = self.S >> (log2m + 1)
        return collectives.exchange(x, self.mesh, self.axis, dist), (self.block & dist) == 0

    def forward_local(self, x: torch.Tensor) -> torch.Tensor:
        q = self.q
        for log2m in range(self.log2S):
            partner, lower = self._partner(x, log2m)
            if lower:
                x = ma.add_mod(x, ma.mul_mod(partner, self.roots[log2m], q), q)
            else:
                x = ma.sub_mod(partner, ma.mul_mod(x, self.roots[log2m], q), q)
        return nttmod.forward_ntt(x, self.local_tables)

    def inverse_local(self, x: torch.Tensor) -> torch.Tensor:
        q, t = self.q, self.tables
        x = nttmod.inverse_ntt(x, self.local_tables)
        for log2m in reversed(range(self.log2S)):
            partner, lower = self._partner(x, log2m)
            if lower:
                x = ma.add_mod(x, partner, q)
                if log2m == 0:
                    x = ma.mul_mod(x, t.n_inv, q)
            else:
                w = t.n_inv_w if log2m == 0 else self.inv_roots[log2m]
                x = ma.mul_mod(ma.sub_mod(partner, x, q), w, q)
        return x

    def _block(self, data: torch.Tensor) -> torch.Tensor:
        return data[..., self.block * self.n_local : (self.block + 1) * self.n_local].contiguous()

    def forward(self, data: torch.Tensor) -> torch.Tensor:
        return collectives.all_gather_batch(self.forward_local(self._block(data)), self.mesh, self.axis, dim=-1)

    def inverse(self, data: torch.Tensor) -> torch.Tensor:
        return collectives.all_gather_batch(self.inverse_local(self._block(data)), self.mesh, self.axis, dim=-1)


def limb_parallel_ntt_fns(mesh, tables: "nttmod.NttTables", axis: str = "limb"):
    """(forward, inverse) on whole [..., L, N] polynomials, each rank
    transforming its L/S rows with their tables (she_tpu sharded.py:204)."""
    S, L = mesh.size(axis), len(tables.moduli)
    if L % S:
        raise errors.InvalidArgument(f"mesh axis size {S} must divide L={L}")
    k = L // S
    rows = slice(mesh.index(axis) * k, (mesh.index(axis) + 1) * k)
    local = nttmod.build_ntt_tables(tables.moduli[rows], tables.degree, tables.q.device)

    def run(transform, data):
        out = transform(data[..., rows, :].contiguous(), local)
        return collectives.all_gather_batch(out, mesh, axis, dim=-2)

    return (lambda data: run(nttmod.forward_ntt, data)), (lambda data: run(nttmod.inverse_ntt, data))


def sharded_ct_mul(a: "bfv.Ciphertext", b: "bfv.Ciphertext", mesh, axis: str = "n") -> "bfv.Ciphertext":
    """bfv.ct_mul with every polynomial sharded on N over `axis`; a and b
    whole on every rank, the 3-polynomial product whole on every rank, bit
    for bit bfv.ct_mul's (she_tpu sharded.py:291)."""
    if a.context is not b.context:
        raise errors.IncompatibleContexts("different contexts")
    if len(a.polys) != 2 or len(b.polys) != 2:
        raise errors.InvalidCiphertext("multiply requires 2-poly ciphertexts")
    if a.correction_factor != 1 or b.correction_factor != 1:
        raise errors.InvalidCorrectionFactor("multiply requires correction factor 1")
    if a.fmt != COEFF or b.fmt != COEFF:
        raise errors.InvalidFormat("multiply requires canonical (Coeff) ciphertexts")
    ctx = a.context
    tool = ctx.get_rns_tool(a.moduli_count)
    qbsk = tool.q_bsk_context
    sn = ShardedNtt(mesh, qbsk.ntt_tables, axis)
    columns = slice(sn.block * sn.n_local, (sn.block + 1) * sn.n_local)

    def lifted_eval(ct):  # [2, L + L_bsk, N/S] Eval
        return sn.forward_local(tool.lift_q_to_qbsk(bfv.stacked_view(ct)[..., columns]))

    scaled = behz.behz_tensor_mac(lifted_eval(a), lifted_eval(b), qbsk, ctx.plaintext_modulus)  # [3, M, N/S]
    floored = tool.floor_qbsk_to_q(sn.inverse_local(scaled))  # [3, L, N/S]
    trace.count("behz.tensor_product")  # one tensor product and one floor, as bfv.ct_mul counts them
    trace.count("behz.floor")
    whole = collectives.all_gather_batch(floored, mesh, axis, dim=-1)
    return bfv.Ciphertext.from_stacked(ctx, whole, tool.input_context, COEFF, a.correction_factor)
