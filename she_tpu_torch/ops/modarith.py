"""Modular arithmetic over int64 tensors, routed by modulus width.

The port keeps one int64 word per coefficient, fully reduced into [0, q),
in place of she_tpu's uint32 limb words (ops/word.py, ops/limb.py): torch
has no unsigned add, subtract, shift or compare on the CPU. Moduli
broadcast as int64 columns [L, 1] against [..., L, N] data; a modulus
argument is a Python int or a column tagged with its host values
(wide.tag, PolyContext.q_col), so the route is chosen on the host.

* The int64 route: when every modulus (and every operand bound) is below
  2^31, a product of two residues (< 2^62) fits a signed word, so a
  product is one multiply and one torch.remainder. This is the w32 path.
* The wide route (ops/wide.py): otherwise, exact 124-bit products and
  reductions for moduli up to 2^62.

add_mod, sub_mod and neg_mod need no route: a sum of two residues below
2^62 fits int64. Lazy sums of products stay below 2^63 (not the 2^64 of
the unsigned accumulators she_tpu uses): `lazy_product_count` says how many
products the route's accumulator takes between reductions.
"""

from __future__ import annotations

import torch

from . import wide
from .wide import moduli_of

INT63 = 1 << 63
INT64_ROUTE_MAX = 1 << 31  # the int64 route takes moduli and operands below this


def signed_lazy_product_count(moduli) -> int:
    """How many products of (q-1)^2 fit in a signed 64-bit accumulator, for
    the largest q of `moduli`: the int64 route's bound. Equals half of
    she_tpu's unsigned PolyContext.max_lazy_product_accumulation_count,
    rounded down."""
    return min(INT63 // ((q - 1) ** 2 + 1) for q in moduli)


def is_wide(bound: int) -> bool:
    """Whether operands below `bound` take the wide route."""
    return bound >= INT64_ROUTE_MAX


def lazy_product_count(moduli) -> int:
    """Products between two reductions for operands below max(moduli):
    the int64 route's signed_lazy_product_count, or the wide accumulator's
    wide.lazy_product_count."""
    bound = max(moduli)
    return wide.lazy_product_count((bound,)) if is_wide(bound) else signed_lazy_product_count(moduli)


def _bound(q, bound) -> int:
    return max(moduli_of(q)) if bound is None else max(bound, max(moduli_of(q)))


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


def mul_mod(a: torch.Tensor, b, q, bound: int | None = None) -> torch.Tensor:
    """a * b mod q for operands below `bound` (default: the largest modulus
    of q), fully reduced."""
    if is_wide(_bound(q, bound)):
        return wide.mul_mod(a, b, q)
    return mul_mod_int64(a, b, q)


def mul_mod_int64(a: torch.Tensor, b, q) -> torch.Tensor:
    """The int64 route of mul_mod: a * b mod q for a, b in [0, q), q < 2^31.
    A wider modulus would overflow the product, so it raises."""
    if is_wide(max(moduli_of(q))):
        raise ValueError(f"the int64 route takes moduli below 2^31, got {max(moduli_of(q))}")
    return torch.remainder(a * b, q)


def reduce(x: torch.Tensor, q) -> torch.Tensor:
    """Exact reduction of a non-negative int64 value into [0, q)."""
    return torch.remainder(x, q)


def sum_mod(x: torch.Tensor, q, dim: int) -> torch.Tensor:
    """x.sum(dim) mod q for residues x in [0, q): one sum while the plain
    int64 sum cannot overflow, else sums of as many slices as can't, each
    reduced, then added mod q."""
    step = (INT63 - 1) // max(max(moduli_of(q)) - 1, 1)
    k = x.shape[dim]
    if k <= step:
        return torch.remainder(x.sum(dim=dim), q)
    total = None
    for start in range(0, k, step):
        part = torch.remainder(x.narrow(dim, start, min(step, k - start)).sum(dim=dim), q)
        total = part if total is None else add_mod(total, part, q)
    return total


def sum_products_mod(terms, q, cap: int, bound: int | None = None) -> torch.Tensor:
    """sum(a * b for a, b in terms) mod q, fully reduced, for operands
    below `bound` (default: the largest modulus of q).

    Accumulates lazily and reduces after every `cap` products (cap from
    lazy_product_count of the same bound): in int64 on the int64 route, in
    (hi, lo) pairs on the wide route."""
    bound = _bound(q, bound)
    if is_wide(bound):
        return wide.sum_products_mod(terms, q, cap, bound)
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
