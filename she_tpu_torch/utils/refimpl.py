"""Slow exact host reference implementations (Python big ints).

Used as ground truth in tests and for tiny host-side transforms (e.g.
SIMD encoding matrices). Loop structure mirrors the reference NTT
(Sources/HomomorphicEncryption/PolyRq/PolyRq+Ntt.swift:209-544) without
lazy-reduction tricks — final values are identical because all arithmetic
is exact mod q.
"""

from __future__ import annotations

from functools import lru_cache

from . import nt


@lru_cache(maxsize=None)
def ntt_root_tables(q: int, n: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(roots, inv_roots) tables in bit-reversed order:
    roots[bitrev(i)] = w^i where w = minimal primitive 2n-th root mod q."""
    w = nt.min_primitive_root_of_unity(q, 2 * n)
    if w is None:
        raise ValueError(f"{q} is not an NTT modulus for degree {n}")
    w_inv = nt.inverse_mod(w, q)
    log2n = nt.log2_exact(n)
    roots = [1] * n
    inv_roots = [1] * n
    prev = 0
    for i in range(1, n):
        rev = nt.reverse_bits(i, log2n)
        roots[rev] = (roots[prev] * w) % q
        inv_roots[rev] = (inv_roots[prev] * w_inv) % q
        prev = rev
    return tuple(roots), tuple(inv_roots)


def forward_ntt(coeffs: list[int], q: int) -> list[int]:
    """Negacyclic forward NTT, natural-order input -> reference eval order."""
    n = len(coeffs)
    roots, _ = ntt_root_tables(q, n)
    x = [c % q for c in coeffs]
    log2n = nt.log2_exact(n)
    for log2m in range(log2n):
        m = 1 << log2m
        t = n >> (log2m + 1)
        for i in range(m):
            w = roots[m + i]
            j1 = 2 * i * t
            for j in range(j1, j1 + t):
                u, v = x[j], (x[j + t] * w) % q
                x[j] = (u + v) % q
                x[j + t] = (u - v) % q
    return x


def inverse_ntt(evals: list[int], q: int) -> list[int]:
    """Inverse of forward_ntt, including the n^-1 scaling."""
    n = len(evals)
    _, inv_roots = ntt_root_tables(q, n)
    x = [c % q for c in evals]
    log2n = nt.log2_exact(n)
    for log2m in reversed(range(log2n)):
        m = 1 << log2m
        t = n >> (log2m + 1)
        for i in range(m):
            w = inv_roots[m + i]
            j1 = 2 * i * t
            for j in range(j1, j1 + t):
                u, v = x[j], x[j + t]
                x[j] = (u + v) % q
                x[j + t] = ((u - v) * w) % q
    n_inv = nt.inverse_mod(n, q)
    return [(c * n_inv) % q for c in x]
