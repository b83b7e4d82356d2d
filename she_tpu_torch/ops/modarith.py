"""Modular arithmetic over int64 tensors.

The port keeps one int64 word per coefficient, fully reduced into [0, q),
in place of she_tpu's uint32 limb words (ops/word.py, ops/limb.py): torch
has no unsigned add, subtract, shift or compare on the CPU, and every
modulus of the w32 path is below 2^31, so a product of two residues
(< 2^62) fits a signed word. Moduli broadcast as int64 columns [L, 1]
against [..., L, N] data.

Lazy sums of products stay below 2^63 (not the 2^64 of the unsigned
accumulators she_tpu uses): `signed_lazy_product_count` says how many
products of (q-1)^2 fit, and `sum_products_mod` reduces that often.
"""

from __future__ import annotations

import torch

INT63 = 1 << 63


def signed_lazy_product_count(moduli) -> int:
    """How many products of (q-1)^2 fit in a signed 64-bit accumulator, for
    the largest q of `moduli`. Equals half of she_tpu's unsigned
    PolyContext.max_lazy_product_accumulation_count, rounded down."""
    return min(INT63 // ((q - 1) ** 2 + 1) for q in moduli)


def add_mod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    """(a + b) mod q for a, b in [0, q)."""
    s = a + b
    return torch.where(s >= q, s - q, s)


def sub_mod(a: torch.Tensor, b: torch.Tensor, q) -> torch.Tensor:
    """(a - b) mod q for a, b in [0, q)."""
    d = a - b
    return torch.where(d < 0, d + q, d)


def neg_mod(a: torch.Tensor, q) -> torch.Tensor:
    """-a mod q for a in [0, q)."""
    return torch.where(a == 0, a, q - a)


def mul_mod(a: torch.Tensor, b, q) -> torch.Tensor:
    """a * b mod q for a, b in [0, q), q < 2^31."""
    return torch.remainder(a * b, q)


def reduce(x: torch.Tensor, q) -> torch.Tensor:
    """Exact reduction of a non-negative int64 value into [0, q)."""
    return torch.remainder(x, q)


def sum_products_mod(terms, q, cap: int) -> torch.Tensor:
    """sum(a * b for a, b in terms) mod q, with residues below 2^31.

    Accumulates lazily in int64 and reduces after every `cap` products
    (cap from signed_lazy_product_count), so the accumulator never exceeds
    2^63 - 1. Returns a fully reduced tensor."""
    if cap < 1:
        raise ValueError(f"lazy product count {cap} < 1")
    total = None
    acc = None
    count = 0
    for a, b in terms:
        p = a * b
        if acc is None:
            acc = p
        else:
            acc += p
        count += 1
        if count == cap:
            red = torch.remainder(acc, q)
            total = red if total is None else add_mod(total, red, q)
            acc, count = None, 0
    if acc is not None:
        red = torch.remainder(acc, q)
        total = red if total is None else add_mod(total, red, q)
    if total is None:
        raise ValueError("empty sum of products")
    return total
