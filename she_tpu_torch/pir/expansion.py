"""The oblivious expansion, level by level (PirUtil.swift:190-355).

Every node at one level of the expansion tree applies the same Galois
element, so a level is ONE batched Galois + key switch over the level's
[nodes, queries, 2, L, N] parents, read in place from a pool of the
tree's inner nodes [inner, queries, 2, L, N] (bfv/keys.key_switch with
the parents' slot indices), then ONE expand_combine that writes both
children: an inner node into its pool slot, a leaf (doubled where the
plan says) straight into the output at its position (ops/key_switch.py;
on a CUDA card, kernels of csrc/key_switch.cu), so no pass follows the
last level. The tree, the doubling and the bits are those of
index_pir.expand_ciphertext, she_tpu's node-by-node structure. The batched
server (pir/serving.py) expands a batch of queries here, and the per-query
server (index_pir.expand) each query as a batch of one.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import torch

from .. import errors, trace
from ..bfv import keys as keysmod
from ..io import coeffs as coeffio
from ..ops import key_switch as ks
from ..utils import nt


def expansion_step_element(evaluation_key, degree: int, log_step: int) -> tuple[int, int]:
    """(Galois element, times to apply it) for one expansion level: the
    substitution x -> x^(N/2^(logStep-1) + 1), built from the largest
    available key element."""
    log2n = nt.log2_exact(degree)
    target_element = (1 << (log2n - log_step + 1)) + 1
    available = (
        [e for e in evaluation_key.galois_key.keys if e <= target_element]
        if evaluation_key.galois_key
        else []
    )
    if not available:
        raise errors.MissingGaloisKey(str(target_element))
    element = max(available)
    apply_count = 1 << (
        coeffio.floor_log2(target_element - 1) - coeffio.floor_log2(element - 1)
    )
    return element, apply_count


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
    """The plan as the level kernels take it, made once: the count of
    inner nodes (the slot pool holds only those, the root in slot 0), and
    per non-empty level (log_step, parents, first children, second
    children, whether it writes leaves, the leaves' doubling mask). A
    parent is a pool slot; a child is its pool slot, or -(position + 1)
    for a leaf, which the level writes straight into the output at its
    position. The mask is a bool [2, n] tensor (a level's first children,
    then its second), None where the level doubles no leaf. Each level's
    destinations are checked here, on the host, as expand_combine needs
    them."""
    plan = build_expansion_plan(output_count)
    inner = sorted({0} | {node[0] for lv in plan.levels for node in lv})
    pool_slot = {slot: i for i, slot in enumerate(inner)}
    leaf = {slot: (-(pos + 1), doubled) for pos, (slot, doubled) in enumerate(plan.leaves)}

    def idx(values):
        return torch.tensor(values, dtype=torch.int64, device=device)

    levels = []
    for i, lv in enumerate(plan.levels):
        if not lv:
            continue
        parents = [pool_slot[node[0]] for node in lv]
        child0, child1 = ([pool_slot[node[k]] if node[k] in pool_slot else leaf[node[k]][0] for node in lv]
                          for k in (1, 2))
        ks.check_level_slots(parents, child0, child1)
        mask = [[node[k] in leaf and leaf[node[k]][1] for node in lv] for k in (1, 2)]
        doubled = torch.tensor(mask, device=device) if any(map(any, mask)) else None
        writes_leaves = min(child0 + child1) < 0
        levels.append((i + 1, idx(parents), idx(child0), idx(child1), writes_leaves, doubled))
    return len(inner), levels


def expand_stacked(stacked: torch.Tensor, output_count: int, evaluation_key, context,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Level-batched expansion of one query ciphertext per batch entry.

    stacked: [B, 2, L, N] Coeff -> [output_count, B, 2, L, N] in final
    output order (written into `out` where given); the same tree and math
    as index_pir.expand_ciphertext. Each level's key switch reads its parents
    from the pool of inner nodes in place, and its expand_combine writes
    the children: inner nodes into the pool, leaves (doubled where the
    plan says, she_tpu serving.py:168-171) straight into the output, so
    nothing passes over the output after the last level. The tracer's
    registry counts each level as expansion_level and, where it writes
    leaves, as leaf_level: on a CUDA card each launches expand_combine's
    kernel once, its leaf instance (expand_leaves) where the level writes
    leaves. The expansion is span `expand`, each level `expand.level`."""
    ct_ctx = context.ciphertext_context.get_context(stacked.shape[-2])
    if output_count == 1:
        # height 0: a single output, no doubling (logStep 1 > height 0)
        if out is None:
            return stacked.unsqueeze(0)
        out[0] = stacked
        return out
    inner_count, levels = _plan_on_device(output_count, stacked.device)
    shape = tuple(stacked.shape)
    with trace.span("expand"):
        if out is None:
            out = torch.empty((output_count,) + shape, dtype=stacked.dtype, device=stacked.device)
        pool = torch.empty((inner_count,) + shape, dtype=stacked.dtype, device=stacked.device)
        pool[0] = stacked
        for log_step, parent_idx, child0_idx, child1_idx, writes_leaves, doubled in levels:
            element, apply_count = expansion_step_element(evaluation_key, context.degree, log_step)
            key = evaluation_key.galois_key.keys[element]
            with trace.span("expand.level", level=log_step, parents=parent_idx.shape[0], applies=apply_count):
                # the parents' Galois image, key-switched, read from the pool in place: [n, B, 2, L, N]
                image = keysmod.key_switch(context, pool[:, :, 1], key, element, parent_idx, c0=pool[:, :, 0])
                for _ in range(apply_count - 1):
                    image = keysmod.key_switch(context, image[:, :, 1], key, element, c0=image[:, :, 0])
                ks.expand_combine(pool, image, parent_idx, child0_idx, child1_idx, 1 << (log_step - 1), ct_ctx,
                                  out=out if writes_leaves else None, doubled=doubled)
            trace.count("expansion_level")
            if writes_leaves:
                trace.count("leaf_level")
    return out


def expand_batched(stacked_cts: list, output_count: int, evaluation_key, context) -> torch.Tensor:
    """stacked_cts: per query ciphertext, [B, 2, L, N] -> expanded
    [output_count, B, 2, L, N], bit-identical to index_pir.expand per query;
    each ciphertext's outputs are written into their block of one output
    tensor."""
    degree = context.degree
    if len(stacked_cts) == 1:
        return expand_stacked(stacked_cts[0], min(output_count, degree), evaluation_key, context)
    first = stacked_cts[0]
    out = torch.empty((output_count,) + tuple(first.shape), dtype=first.dtype, device=first.device)
    start = 0
    for stacked in stacked_cts:
        n = min(output_count - start, degree)
        expand_stacked(stacked, n, evaluation_key, context, out=out[start:start + n])
        start += n
    return out
