"""Batched MulPIR serving on one torch device (w32 path).

The port of she_tpu/pir/serving.py's w32 path: throughput comes from
batching whole query batches through tensors with leading batch axes, not
from one program per query.

* Level-batched oblivious expansion: every node at one level of the
  expansion tree applies the same Galois element, so each level is ONE
  batched Galois + key switch over a [nodes * queries, 2, L, N] tensor
  held in a slot pool [slots, queries, 2, L, N].
* Dim-0 ct-pt inner products for all columns at once against the database
  chunk packed on the device as [C, d0, L, N], a lazy int64 MAC streamed
  over d0 (the [C, d0, 2B, L, N] product is never materialized).
* Higher dimensions: BEHZ ct-ct inner products and relinearization over
  [queries, d, ...] tensors, then the mod switch down to one modulus.

Every step is the same exact arithmetic as ip.MulPirServer, so responses
are bit-identical to it.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import torch

from .. import errors
from ..bfv import bfv
from ..core.poly import COEFF, EVAL
from ..io import coeffs as coeffio
from ..ops import modarith as ma
from . import index_pir as ip


@dataclass
class ExpansionPlan:
    """Per level: which node slots expand into two children; leaves record
    (slot, doubled?) in final output order."""

    output_count: int
    levels: list  # level -> list of (parent_slot, child0_slot, child1_slot)
    leaves: list  # output order -> (slot, doubled: bool)
    slot_count: int


def build_expansion_plan(output_count: int) -> ExpansionPlan:
    """The recursive expansion (PirUtil.swift:249-304) flattened into
    per-level batched steps."""
    levels: dict[int, list] = {}
    leaves_by_id: dict[int, tuple] = {}
    counter = [1]  # slot 0 = root

    def recurse(slot: int, count: int, log_step: int, expected_height: int):
        if count == 1:
            leaves_by_id[slot] = (slot, log_step <= expected_height)
            return [slot]
        second = count >> 1
        first = count - second
        c0, c1 = counter[0], counter[0] + 1
        counter[0] += 2
        levels.setdefault(log_step, []).append((slot, c0, c1))
        left = recurse(c0, first, log_step + 1, expected_height)
        right = recurse(c1, second, log_step + 1, expected_height)
        out = []
        for a, b in zip(left[:second], right):
            out.extend([a, b])
        out.extend(left[second:])
        return out

    height = coeffio.ceil_log2(output_count)
    order = recurse(0, output_count, 1, height)
    max_level = max(levels) if levels else 0
    return ExpansionPlan(
        output_count=output_count,
        levels=[levels.get(l, []) for l in range(1, max_level + 1)],
        leaves=[leaves_by_id[slot] for slot in order],
        slot_count=counter[0],
    )


@lru_cache(maxsize=None)
def _plan_on_device(output_count: int, device: torch.device):
    """The plan's slot indices as device tensors, made once: per non-empty
    level (log_step, parents, first children, second children), then the
    leaf slots in output order and their doubling mask."""
    plan = build_expansion_plan(output_count)

    def idx(values):
        return torch.tensor(values, dtype=torch.int64, device=device)

    levels = [
        (i + 1, idx([p for p, _, _ in lv]), idx([c for _, c, _ in lv]), idx([c for _, _, c in lv]))
        for i, lv in enumerate(plan.levels)
        if lv
    ]
    leaves = idx([s for s, _ in plan.leaves])
    doubled = torch.tensor([d for _, d in plan.leaves], device=device).view(-1, 1, 1, 1, 1)
    return plan.slot_count, levels, leaves, doubled


def _ct(context, data: torch.Tensor, poly_ctx, fmt=COEFF) -> bfv.Ciphertext:
    return bfv.Ciphertext.from_stacked(context, data, poly_ctx, fmt)


def expand_stacked(stacked: torch.Tensor, output_count: int, evaluation_key, context) -> torch.Tensor:
    """Level-batched expansion of one query ciphertext per batch entry.

    stacked: [B, 2, L, N] Coeff -> [output_count, B, 2, L, N] in final
    output order; the same tree and math as ip.expand_ciphertext."""
    ct_ctx = context.ciphertext_context.get_context(stacked.shape[-2])
    if output_count == 1:
        # height 0: a single output, no doubling (logStep 1 > height 0)
        return stacked.unsqueeze(0)
    slot_count, levels, leaves, doubled = _plan_on_device(output_count, stacked.device)
    pool = torch.empty((slot_count,) + tuple(stacked.shape), dtype=stacked.dtype, device=stacked.device)
    pool[0] = stacked
    for log_step, parent_idx, child0_idx, child1_idx in levels:
        element, apply_count = ip.expansion_step_element(evaluation_key, context.degree, log_step)
        parents = _ct(context, pool.index_select(0, parent_idx), ct_ctx)  # [n, B, 2, L, N]
        c1 = parents
        for _ in range(apply_count):
            c1 = bfv.apply_galois(c1, element, evaluation_key)
        p0 = bfv.ct_add(c1, parents)
        p1 = bfv.multiply_power_of_x(bfv.ct_sub(parents, c1), -(1 << (log_step - 1)))
        pool[child0_idx] = p0.stacked()
        pool[child1_idx] = p1.stacked()
    out = pool.index_select(0, leaves)
    twice = ma.add_mod(out, out, ct_ctx.q_col)
    return torch.where(doubled, twice, out)


def expand_batched(stacked_cts: list, output_count: int, evaluation_key, context) -> torch.Tensor:
    """stacked_cts: per query ciphertext, [B, 2, L, N] -> expanded
    [output_count, B, 2, L, N], bit-identical to ip.expand per query."""
    degree = context.degree
    outs = []
    remaining = output_count
    for stacked in stacked_cts:
        n = min(remaining, degree)
        outs.append(expand_stacked(stacked, n, evaluation_key, context))
        remaining -= n
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def dim0_inner_products(db_chunk: torch.Tensor, query_eval: torch.Tensor, ct_ctx) -> torch.Tensor:
    """db_chunk [C, d0, L, N]; query_eval [d0, P, L, N] (P = 2 polys per
    query) -> [C, P, L, N] fully reduced out[c, p] = sum_j db[c, j] * q[j, p].

    Streams a lazy int64 MAC over d0, reducing every
    max_signed_lazy_product_count products (she_tpu serving.py:318-341)."""
    d0 = db_chunk.shape[1]
    terms = ((db_chunk[:, j, None], query_eval[j]) for j in range(d0))
    return ma.sum_products_mod(terms, ct_ctx.q_col, ct_ctx.max_signed_lazy_product_count())


class BatchedMulPirServer:
    """Serves whole query batches with batched tensor ops (w32 parameters).

    The database is packed on the context's device once, as one
    [C, d0, L, N] tensor per chunk."""

    def __init__(self, parameter: ip.IndexPirParameter, context, databases: list):
        if context.params.scalar_bits != 32:
            raise errors.PirError("the batched server serves scalar_bits=32 parameters")
        self.parameter = parameter
        self.context = context
        self.ct_ctx = context.ciphertext_context
        d0 = parameter.dimensions[0]
        n_chunks = ip.chunk_count(parameter, context)
        self.chunks = []  # per database, per chunk: [C, d0, L, N] on the device
        for db in databases:
            per_chunk = db.count // n_chunks
            data = db.data.to(context.device)
            self.chunks.append(
                [
                    data[s : s + per_chunk].reshape((per_chunk // d0, d0) + tuple(data.shape[1:]))
                    for s in range(0, db.count, per_chunk)
                ]
            )

    @staticmethod
    def stack_queries(queries: list) -> tuple[list, int, int]:
        """Stack ip.Query objects into per-ciphertext [B, 2, L, N] tensors;
        returns (stacked, n_ct, indices_count)."""
        n_ct = len(queries[0].ciphertexts)
        stacked = [torch.stack([q.ciphertexts[i].stacked() for q in queries]) for i in range(n_ct)]
        return stacked, n_ct, queries[0].indices_count

    def compute_response_batch(self, queries: list, evaluation_key) -> list:
        """queries: list of ip.Query; returns one ip.Response per query."""
        stacked, _, indices_count = self.stack_queries(queries)
        out = self.respond_stacked(stacked, evaluation_key, indices_count)
        return self._assemble_responses(out, len(queries))

    def respond_stacked(self, stacked: list, evaluation_key, indices_count: int = 1) -> list:
        """Raw responses: per query index, per chunk, [B, 2, 1, N] Coeff."""
        parameter = self.parameter
        expanded_all = expand_batched(
            stacked, parameter.expanded_query_count * indices_count, evaluation_key, self.context
        )
        per_query = parameter.expanded_query_count
        out = []
        for qi in range(indices_count):
            expanded = expanded_all[qi * per_query : (qi + 1) * per_query]
            db_index = qi if len(self.chunks) > 1 else 0
            out.append(self._respond_expanded(expanded, evaluation_key, db_index))
        return out

    def _respond_expanded(self, expanded: torch.Tensor, evaluation_key, db_index: int) -> list:
        """expanded: [per_query, B, 2, L, N] Coeff."""
        parameter = self.parameter
        ctx, ct_ctx = self.context, self.ct_ctx
        d0 = parameter.dimensions[0]
        B = expanded.shape[1]
        dim0 = bfv.ct_to_eval(_ct(ctx, expanded[:d0], ct_ctx))
        query_eval = dim0.stacked().reshape((d0, B * 2) + tuple(expanded.shape[-2:]))
        rest = expanded[d0:]  # [sum(dims[1:]), B, 2, L, N]
        reply = []
        for chunk in self.chunks[db_index]:
            results = dim0_inner_products(chunk, query_eval, ct_ctx)  # [C, 2B, L, N]
            C = results.shape[0]
            results = results.reshape((C, B, 2) + tuple(results.shape[-2:]))
            # columns as [B, C, 2, L, N] Coeff ciphertexts
            columns = bfv.ct_to_coeff(_ct(ctx, results.transpose(0, 1), ct_ctx, EVAL)).stacked()
            query_start = 0
            for dim_size in parameter.dimensions[1:]:
                v0 = rest[query_start : query_start + dim_size].transpose(0, 1)  # [B, d, 2, L, N]
                groups = []
                for start in range(0, columns.shape[1], dim_size):
                    v1 = columns[:, start : start + dim_size]
                    prod = bfv.inner_product_ct_ct_stacked(
                        _ct(ctx, v0, ct_ctx), _ct(ctx, v1, ct_ctx), axis=-3
                    )
                    groups.append(bfv.relinearize(prod, evaluation_key).stacked())
                columns = torch.stack(groups, dim=1)  # [B, groups, 2, L, N]
                query_start += dim_size
            if columns.shape[1] != 1:
                raise errors.PirError("dimensions do not reduce to one ciphertext")
            single = bfv.mod_switch_down_to_single(_ct(ctx, columns[:, 0], ct_ctx))
            reply.append(single.stacked())  # [B, 2, 1, N]
        return reply

    def _assemble_responses(self, out: list, B: int) -> list:
        """out: per query index, per chunk, [B, 2, 1, N] -> ip.Response each."""
        single_ctx = self.ct_ctx.get_context(1)
        return [
            ip.Response(
                [
                    [bfv.Ciphertext.from_stacked(self.context, arr[b], single_ctx) for arr in reply]
                    for reply in out
                ]
            )
            for b in range(B)
        ]
