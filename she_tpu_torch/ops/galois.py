"""Galois automorphisms f(x) -> f(x^p) as precomputed gather permutations.

The host maps and the element derivation are she_tpu/ops/galois.py's; the
device ops gather along the last axis of int64 [..., L, N] tensors
(reference: Sources/HomomorphicEncryption/PolyRq/Galois.swift:18-165).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils import nt
from .modarith import neg_mod


def is_valid_galois_element(element: int, degree: int) -> bool:
    return (
        nt.is_power_of_two(degree)
        and element % 2 == 1
        and 1 < element < 2 * degree
    )


@lru_cache(maxsize=None)
def coeff_maps(degree: int, element: int) -> tuple[np.ndarray, np.ndarray]:
    """(source_index, negate) arrays such that out[j] = +-in[src[j]].

    The reference iterates input index i -> output index (i*p mod N) with
    negation when floor(i*p / N) is odd (GaloisCoeffIterator); this inverts
    that into a gather map.
    """
    if not is_valid_galois_element(element, degree):
        raise ValueError(f"invalid Galois element {element} for degree {degree}")
    src = np.zeros(degree, dtype=np.int64)
    neg = np.zeros(degree, dtype=bool)
    raw = 0
    for i in range(degree):
        out = raw & (degree - 1)
        src[out] = i
        neg[out] = (raw >> nt.log2_exact(degree)) & 1 != 0
        raw += element
    return src, neg


@lru_cache(maxsize=None)
def eval_map(degree: int, element: int) -> np.ndarray:
    """Permutation `perm` with out[j] = in[perm[j]] in Eval order
    (GaloisEvalIterator, Galois.swift:65-99)."""
    if not is_valid_galois_element(element, degree):
        raise ValueError(f"invalid Galois element {element} for degree {degree}")
    log2n = nt.log2_exact(degree)
    perm = np.zeros(degree, dtype=np.int64)
    for i in range(degree):
        reversed_idx = nt.reverse_bits(i + degree, log2n + 1)
        index_raw = ((element * reversed_idx) >> 1) & (degree - 1)
        perm[i] = nt.reverse_bits(index_raw, log2n)
    return perm


@lru_cache(maxsize=None)
def _device_coeff_maps(degree: int, element: int, device: torch.device):
    src, neg = coeff_maps(degree, element)
    return torch.from_numpy(src).to(device), torch.from_numpy(neg).to(device)


def apply_galois_coeff(data: torch.Tensor, q: torch.Tensor, element: int) -> torch.Tensor:
    """data: int64 [..., L, N] in Coeff, q: [L, 1]; permuted and negated."""
    src, neg = _device_coeff_maps(data.shape[-1], element, data.device)
    gathered = data.index_select(-1, src)
    return torch.where(neg, neg_mod(gathered, q), gathered)


def apply_galois_eval(data: torch.Tensor, element: int) -> torch.Tensor:
    """data: int64 [..., L, N] in Eval; pure permutation."""
    perm = torch.from_numpy(eval_map(data.shape[-1], element)).to(data.device)
    return data.index_select(-1, perm)


# -- element derivation (Galois.swift:169-319) ------------------------------


def swapping_rows_element(degree: int) -> int:
    return 2 * degree - 1


def rotating_columns_element(step: int, degree: int) -> int:
    """Galois element rotating SIMD columns by `step` (negative = left)."""
    if not nt.is_power_of_two(degree):
        raise ValueError(f"degree {degree} is not a power of two")
    positive = abs(step)
    if not 0 < positive < degree // 2:
        raise ValueError(f"invalid rotation step {step} for degree {degree}")
    if step > 0:
        positive = degree // 2 - positive
    return pow(3, positive, 2 * degree)


def rotating_columns_multi_step_elements(degree: int) -> list[int]:
    out = []
    log_max = nt.log2_exact(degree // 2)
    for log_step in range(log_max):
        step = 1 << log_step
        out.append(rotating_columns_element(step, degree))
        out.append(rotating_columns_element(-step, degree))
    return out


def steps_for(elements: list[int], degree: int) -> dict[int, int | None]:
    """Map Galois elements back to rotation steps (Galois.swift:239-258)."""
    result: dict[int, int | None] = {e: None for e in elements}
    found = 0
    g_pow = 1
    for step in range(degree // 2 + 1):
        if g_pow in result and result[g_pow] is None:
            result[g_pow] = degree // 2 - step
            found += 1
            if found == len(set(elements)):
                return result
        g_pow = (g_pow * 3) % (2 * degree)
    return result


def plan_multi_step(supported_steps: list[int], step: int, degree: int):
    """Greedy decomposition of a rotation into supported steps
    (Galois.swift:272-319); returns {step: count} or None."""
    if abs(step) >= degree:
        raise ValueError(f"invalid step {step}")
    if step in supported_steps:
        return {step: 1}

    def trunc_div(a, b):
        """Swift-style truncating division/remainder."""
        q = abs(a) // abs(b)
        if (a < 0) != (b < 0):
            q = -q
        return q, a - q * b

    def greedy(sorted_steps, transform):
        result: dict[int, int] = {}
        remaining = transform(step)
        for s in sorted_steps:
            ts = transform(s)
            if ts == 0:
                continue
            cnt, remaining = trunc_div(remaining, ts)
            if cnt > 0:
                result[s] = result.get(s, 0) + cnt
        return result if remaining == 0 else None

    sorted_desc = sorted(supported_steps, reverse=True)
    columns = degree >> 1
    pos = greedy(sorted_desc, lambda s: s)
    negt = greedy(list(reversed(sorted_desc)), lambda s: columns - s)
    if pos is None:
        return negt
    if negt is None:
        return pos
    return pos if sum(pos.values()) <= sum(negt.values()) else negt
