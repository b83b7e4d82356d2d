"""Exact modular arithmetic for moduli up to 2^62 on int64 tensors.

The counterpart of she_tpu's 128-bit limb arithmetic (ops/limb.py mul64,
add128, shr128; ops/word.py W64.mulmod, div_floor, reduce_u128,
reduce_u64_any) for the port's one-int64-word layout. A product of two
residues below 2^62 needs 124 bits, so it is kept as a pair (hi, lo) of
int64 words, value = hi * 2^62 + lo with 0 <= lo < 2^62.

The rule of this module: every intermediate is an exact integer of at most
63 bits (int64 without overflow; nothing relies on the wrap of an
overflowing multiply), so CPU and CUDA tensors run the same code and give
the same bits.

* `mul_wide` splits each operand at 31 bits: four partial products, each
  below 2^62, and a middle sum below 2^63.
* `reduce_pair` reduces hi * 2^62 + lo (hi < q) exactly, and
  `divmod_pair` also gives its quotient. Two float64
  quotient estimates only choose how many q to subtract; the subtraction
  itself is integer arithmetic on 31-bit pieces, and its result is
  corrected into [0, q). Estimate 1 is within 2^12 of floor(T / q)
  (relative error below 5 * 2^-53 of a value below 2^62), which leaves a
  remainder below 2^75 in magnitude; written as g * 2^31 + g0 with
  |g| < 2^45, its float quotient is within 2^-17 of exact, so estimate 2
  leaves a remainder in [-q, 2q).
* `sum_products_mod` accumulates products lazily in (hi, lo): lo is
  renormalized after every product, hi grows by less than
  ((q - 1)^2 >> 62) + 1 per product and is reduced mod q every
  `lazy_product_count` products, so it stays below 2^63.

Moduli need not be odd or prime (the BEHZ base has m~ = 2^32). A modulus
argument `q` is a Python int or an int64 tensor tagged with its host
values (`tag`, done by PolyContext.q_col): the per-modulus constants are
made on the host from those values, never read back from the device.
"""

from __future__ import annotations

from functools import lru_cache

import torch

MAX_MODULUS = 1 << 62
INT63 = 1 << 63
M31 = (1 << 31) - 1
M62 = (1 << 62) - 1
_TWO31 = 1 << 31
_TAG = "she_moduli"


def tag(col: torch.Tensor, moduli) -> torch.Tensor:
    """Attach the host values of a modulus tensor (one per element, in
    order) so that the wide and routed ops can read them without a copy
    from the device. Returns `col`."""
    values = tuple(int(v) for v in moduli)
    if len(values) != col.numel():
        raise ValueError(f"{len(values)} moduli for a tensor of {col.numel()} elements")
    setattr(col, _TAG, values)
    return col


def moduli_of(q) -> tuple[int, ...]:
    """The host values of a modulus argument: a Python int, or a tensor
    tagged by `tag`. An untagged tensor raises, on every device, so that a
    missing tag shows in the CPU tests too."""
    if isinstance(q, int):
        return (q,)
    values = getattr(q, _TAG, None)
    if values is None:
        raise ValueError("a modulus tensor needs its host values (wide.tag / PolyContext.q_col)")
    return values


def lazy_product_count(moduli) -> int:
    """How many products of operands below max(moduli) the wide
    accumulator takes between two reductions of its high word: after a
    reduction hi < q, and each product adds at most ((q-1)^2 >> 62) + 1."""
    q = max(moduli)
    if not 1 < q <= MAX_MODULUS:
        raise ValueError(f"modulus {q} outside (1, 2^62]")
    return (INT63 - q) // ((((q - 1) ** 2) >> 62) + 1)


@lru_cache(maxsize=None)
def _columns(moduli: tuple[int, ...], shape: tuple[int, ...], device: torch.device) -> dict:
    """Per-modulus constants as tensors of the modulus tensor's shape."""

    def col(values, dtype):
        return torch.tensor(values, dtype=dtype, device=device).view(shape)

    return dict(
        q_lo=col([q & M31 for q in moduli], torch.int64),
        q_hi=col([q >> 31 for q in moduli], torch.int64),
        inv=col([1.0 / q for q in moduli], torch.float64),
        inv31=col([float(_TWO31) / q for q in moduli], torch.float64),
        inv62=col([float(1 << 62) / q for q in moduli], torch.float64),
    )


def _consts(q) -> dict:
    moduli = moduli_of(q)
    if max(moduli) > MAX_MODULUS:
        raise ValueError("wide arithmetic takes moduli up to 2^62")
    if isinstance(q, int):
        return dict(q_lo=q & M31, q_hi=q >> 31, inv=1.0 / q, inv31=float(_TWO31) / q,
                    inv62=float(1 << 62) / q)
    return _columns(moduli, tuple(q.shape), q.device)


def _split(x):
    """x in [0, 2^62] -> (x mod 2^31, x >> 31), each at most 2^31."""
    return x & M31, x >> 31


def mul_wide(a, b):
    """Exact a * b for 0 <= a, b <= 2^62 (one may be a Python int) as
    (hi, lo): a * b = hi * 2^62 + lo, 0 <= lo < 2^62, hi < 2^62 + 2^32."""
    return _mul_split(a, *_split(b))


def _mul_split(a, b0, b1):
    """mul_wide with b given as its pieces (b mod 2^31, b >> 31)."""
    a0, a1 = _split(a)
    mid = a0 * b1
    mid = mid + a1 * b0  # < 2^63: each partial product is below 2^62
    lo = a0 * b0 + ((mid & M31) << 31)  # < 2^63
    hi = a1 * b1 + (mid >> 31) + (lo >> 62)
    return hi, lo & M62


def _divide(hi: torch.Tensor, lo: torch.Tensor, q):
    """The two quotient estimates of (hi * 2^62 + lo) / q and the remainder
    they leave, in [-q, 2q): reduce_pair's and divmod_pair's common part."""
    c = _consts(q)
    f64 = torch.float64
    # estimate 1: within 2^12 of floor(T / q) < 2^62
    est = hi.to(f64) * c["inv62"] + lo.to(f64) * c["inv"]
    quot = est.floor_().clamp_(0.0, float(MAX_MODULUS)).to(torch.int64)
    qh, ql = _mul_split(quot, c["q_lo"], c["q_hi"])
    dh = hi - qh  # |dh| < 2^13
    dl = lo - ql  # |dl| < 2^62
    # remainder 1 = g * 2^31 + g0, |g| < 2^45, 0 <= g0 < 2^31
    g = dh * _TWO31 + (dl >> 31)
    g0 = dl & M31
    # estimate 2: within one of floor(remainder 1 / q)
    est2 = g.to(f64) * c["inv31"] + g0.to(f64) * c["inv"]
    quot2 = est2.floor_().to(torch.int64)
    e = g - quot2 * c["q_hi"]
    f = g0 - quot2 * c["q_lo"]
    e = e + (f >> 31)
    return quot, quot2, e * _TWO31 + (f & M31)


def reduce_pair(hi: torch.Tensor, lo: torch.Tensor, q) -> torch.Tensor:
    """(hi * 2^62 + lo) mod q for 0 <= hi < q, 0 <= lo < 2^62, q <= 2^62:
    exact, fully reduced into [0, q)."""
    r = _divide(hi, lo, q)[2]
    r = torch.where(r < 0, r + q, r)
    return torch.where(r >= q, r - q, r)


def divmod_pair(hi: torch.Tensor, lo: torch.Tensor, q) -> tuple[torch.Tensor, torch.Tensor]:
    """(floor(T / q), T mod q) for T = hi * 2^62 + lo, 0 <= hi < q,
    0 <= lo < 2^62, q <= 2^62: exact; the quotient is below 2^62."""
    quot, quot2, r = _divide(hi, lo, q)
    below, above = r < 0, r >= q
    quot = quot + quot2 - below.to(torch.int64) + above.to(torch.int64)
    r = torch.where(below, r + q, r)
    return quot, torch.where(above, r - q, r)


def mul_mod(a: torch.Tensor, b, q) -> torch.Tensor:
    """a * b mod q, fully reduced, for 0 <= a, b < 2^62 (neither need be
    below q) and q <= 2^62."""
    hi, lo = mul_wide(a, b)
    return reduce_pair(torch.remainder(hi, q), lo, q)


def sum_products_mod(terms, q, cap: int, bound: int | None = None) -> torch.Tensor:
    """sum(a * b for a, b in terms) mod q, fully reduced, for operands
    below `bound` (default: the largest modulus of q), bound <= 2^62.

    The 124-bit products accumulate in (hi, lo); hi is reduced mod q after
    every `cap` products, and cap may not exceed lazy_product_count(bound)."""
    bound = max(moduli_of(q)) if bound is None else bound
    limit = lazy_product_count((bound,))
    if not 1 <= cap <= limit:
        raise ValueError(f"lazy product count {cap} outside [1, {limit}] for operands below {bound}")
    hi = lo = None
    count = 0
    for a, b in terms:
        h, l = mul_wide(a, b)
        if hi is None:
            hi, lo = h, l
        else:
            lo = lo + l
            hi = hi + h + (lo >> 62)
            lo = lo & M62
        count += 1
        if count == cap:
            hi = torch.remainder(hi, q)
            count = 0
    if hi is None:
        raise ValueError("empty sum of products")
    return reduce_pair(torch.remainder(hi, q), lo, q)
