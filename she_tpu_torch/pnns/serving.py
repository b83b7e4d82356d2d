"""Batched PNNS serving: stacked BSGS matrix-vector products on one device.

The port of she_tpu/pnns/serving.py. The reference evaluates the
Halevi-Shoup baby-step/giant-step product with per-plaintext multiplies
(MatrixMultiplication.swift:131-299); here a whole query batch goes through
tensors with a leading batch axis, as she_tpu vmaps it (serving.py:374-397):

* the diagonal plaintext matrix is packed on the device once, as an int64
  [G, J, R, L, N] tensor (G giant steps, J baby steps, R result
  ciphertexts; missing baby steps of the last giant step are zeros);
* baby steps: J - 1 rotations by -1 of the [B, 2, L, N] query batch, in
  she_tpu's order (state <- rotate(state, -1)), each one batched Galois
  gather and key switch; the J states go to Eval in one forward NTT;
* the BSGS MAC: out[g, r, b] = sum_j db[g, j, r] * rotated[j, b], one
  ops/dim0_mac (she_tpu's bsgs_inner_products and _bsgs_inner_products_w64
  in one function): on the card the kernel of csrc/dim0_mac.cu, on the
  CPU a lazy multiply-add streamed over j on the route ops/modarith picks
  (int64 when every modulus is below 2^31, the exact wide route
  otherwise);
* one inverse NTT of all [G, R, B, 2, L, N] products, then the giant-step
  rotate-and-sum by -J over [R, B, 2, L, N] and the mod switch down to one
  modulus.

Every step is the same exact arithmetic as pnns.Server, so responses are
bit-identical to it. she_tpu's _StagedPnnsResponder (serving.py:108-211, a
pipeline of cached jits that keeps XLA's w64 compile times linear) has no
counterpart, like pir/serving.py's _StagedResponder: eager PyTorch runs one
program per stage already, and the contract the stager keeps, the same
bits, is this module's.
"""

from __future__ import annotations

import torch

from .. import errors
from ..bfv import bfv
from ..core import poly as polymod
from ..core.poly import COEFF, EVAL, PolyRq
from ..ops import dim0_mac
from . import pnns


def _mark(on_stage, stage: str) -> None:
    if on_stage is not None:
        on_stage(stage)


def pack_diagonal_matrix(matrix: "pnns.PlaintextMatrix", ct_ctx) -> torch.Tensor:
    """Diagonal-packed Eval PlaintextMatrix -> int64 [G, J, R, L, N] on the
    plaintexts' device: entry (g, j, r) is plaintext R * (j + J * g) + r,
    zeros where the last giant step has fewer than J baby steps."""
    bsgs = matrix.packing.bsgs
    G, J = bsgs.giant_step, bsgs.baby_step
    n = ct_ctx.degree
    R = -(-matrix.row_count // n)
    data = torch.stack([pt.poly.data for pt in matrix.plaintexts])  # [P, L, N]
    out = torch.zeros((G, J, R) + tuple(data.shape[1:]), dtype=torch.int64, device=data.device)
    for g in range(G):
        pt_count = min(J, bsgs.vector_dimension - J * g)
        start = R * J * g
        out[g, :pt_count] = data[start : start + R * pt_count].reshape((pt_count, R) + tuple(data.shape[1:]))
    return out


def bsgs_inner_products(db: torch.Tensor, rotated_eval: torch.Tensor, ct_ctx) -> torch.Tensor:
    """db [G, J, R, L, N]; rotated_eval [J, B, P, L, N] (the Eval baby-step
    rotations of B queries, P = 2 polys) -> [G, R, B, P, L, N] fully reduced
    sum over j of db[g, j, r] * rotated_eval[j, b, p].

    ops/dim0_mac over the diagonals as a [G, R, J, L, N] view (she_tpu
    serving.py:52-97, both scalar widths): on the card the kernel of
    csrc/dim0_mac.cu, on the CPU a lazy multiply-add streamed over J,
    reduced every max_signed_lazy_product_count products of the context's
    route."""
    return dim0_mac.dim0_mac(db.permute(0, 2, 1, 3, 4), rotated_eval, ct_ctx)


class BatchedPnnsServer:
    """Serves whole PNNS query batches (one 1-row denseRow query matrix per
    plaintext modulus) with batched tensor ops, at 32- or 64-bit scalars.

    A batch runs per plaintext modulus the stages `baby_steps`, `to_eval`,
    `bsgs_mac`, `inverse_ntt`, `rotate_and_sum` and `mod_switch`, after
    `stack`. A caller may pass `on_stage`, called with each stage's name
    once its work is issued, to mark the stages on the device's queue."""

    def __init__(self, database: "pnns.ProcessedDatabase"):
        self.database = database
        self.config = database.server_config
        self.contexts = database.contexts
        for m in database.plaintext_matrices:
            if m.packing.kind != "diagonal":
                raise errors.PnnsError("the batched server needs a diagonal-packed database")
        self.packed = [
            pack_diagonal_matrix(m, ctx.ciphertext_context)
            for m, ctx in zip(database.plaintext_matrices, self.contexts)
        ]

    @staticmethod
    def stack_queries(queries: list) -> list:
        """Stack pnns.Query objects into per-plaintext-modulus [B, 2, L, N]
        tensors."""
        n_matrices = len(queries[0].ciphertext_matrices)
        return [
            torch.stack([q.ciphertext_matrices[mi].ciphertexts[0].stacked() for q in queries])
            for mi in range(n_matrices)
        ]

    def stack_queries_device(self, queries: list) -> list:
        """stack_queries on the server's device. she_tpu stacks a batch in
        one cached jitted dispatch; here that is one torch.stack per
        plaintext modulus."""
        return [s.to(ctx.device) for s, ctx in zip(self.stack_queries(queries), self.contexts)]

    def compute_response_batch(self, queries: list, evaluation_key, on_stage=None) -> list:
        """queries: list of pnns.Query (single-row query matrices); returns
        one pnns.Response per query."""
        stacked = self.stack_queries_device(queries)
        _mark(on_stage, "stack")
        return self.compute_response_batch_from_stacked(stacked, evaluation_key, len(queries), on_stage)

    def compute_response_batch_from_stacked(self, stacked: list, evaluation_key, B: int, on_stage=None) -> list:
        """stacked: per plaintext modulus [B, 2, L, N] on the server's
        device (as stack_queries_device makes them) -> one pnns.Response
        per query (she_tpu pnns/serving.py:339)."""
        if len(stacked) != len(self.packed) or any(s.shape[0] != B for s in stacked):
            raise errors.InvalidArgument(
                f"expected {len(self.packed)} stacked query matrices of {B} queries, "
                f"got {[tuple(s.shape) for s in stacked]}"
            )
        return self._assemble_responses(self.respond_stacked(stacked, evaluation_key, on_stage), B)

    def compute_response_stream(self, batches: list, evaluation_key) -> list:
        """Serves a sequence of query batches; returns the flat list of
        pnns.Response. Nothing in compute_response_batch waits for the
        device (the responses are views), so batch i+1's work is queued
        while batch i's still runs."""
        return [r for queries in batches for r in self.compute_response_batch(queries, evaluation_key)]

    def respond_stacked(self, stacked: list, evaluation_key, on_stage=None) -> list:
        """stacked: per plaintext modulus [B, 2, L, N] Coeff -> per plaintext
        modulus [R, B, 2, 1, N] Coeff, one modulus."""
        return [self._respond_matrix(mi, arr, evaluation_key, on_stage) for mi, arr in enumerate(stacked)]

    def _respond_matrix(self, mi: int, arr: torch.Tensor, ek, on_stage) -> torch.Tensor:
        ctx = self.contexts[mi]
        ct_ctx = ctx.ciphertext_context
        bsgs = self.database.plaintext_matrices[mi].packing.bsgs
        J = bsgs.baby_step
        states = [arr]
        state = bfv.Ciphertext.from_stacked(ctx, arr, ct_ctx)
        for _ in range(J - 1):
            state = bfv.rotate_columns(state, -1, ek)
            states.append(state.stacked())
        _mark(on_stage, "baby_steps")
        rotated = polymod.forward_ntt(PolyRq(torch.stack(states), ct_ctx, COEFF))  # [J, B, 2, L, N]
        _mark(on_stage, "to_eval")
        prods = bsgs_inner_products(self.packed[mi], rotated.data, ct_ctx)  # [G, R, B, 2, L, N]
        _mark(on_stage, "bsgs_mac")
        giants = polymod.inverse_ntt(PolyRq(prods, ct_ctx, EVAL)).data
        _mark(on_stage, "inverse_ntt")
        acc = bfv.Ciphertext.from_stacked(ctx, giants[-1], ct_ctx)
        for g in reversed(range(giants.shape[0] - 1)):
            rotated_acc = pnns.rotate_columns_multi_step(acc, -J, ek)
            acc = bfv.ct_add(rotated_acc, bfv.Ciphertext.from_stacked(ctx, giants[g], ct_ctx))
        _mark(on_stage, "rotate_and_sum")
        out = bfv.mod_switch_down_to_single(acc).stacked()  # [R, B, 2, 1, N]
        _mark(on_stage, "mod_switch")
        return out

    def _assemble_responses(self, out: list, B: int) -> list:
        """out: per plaintext modulus [R, B, 2, 1, N] -> pnns.Response each,
        the ciphertexts views of `out` (torch.unbind launches nothing)."""
        matrices = []  # per plaintext modulus, per query: CiphertextMatrix
        for mi, arr in enumerate(out):
            ctx = self.contexts[mi]
            single_ctx = ctx.ciphertext_context.get_context(1)
            dims = pnns.MatrixDimensions(self.database.plaintext_matrices[mi].row_count, 1)
            per_result = [torch.unbind(a, 0) for a in torch.unbind(arr, 0)]  # [R][B]
            matrices.append([
                pnns.CiphertextMatrix(
                    dims, pnns.MatrixPacking.dense_column(),
                    [bfv.Ciphertext.from_stacked(ctx, parts[b], single_ctx) for parts in per_result], ctx,
                )
                for b in range(B)
            ])
        return [
            pnns.Response([m[b] for m in matrices], self.database.entry_ids, self.database.entry_metadatas)
            for b in range(B)
        ]
