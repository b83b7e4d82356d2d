"""Base-2^7 digits of residues, for exact int8 x int8 -> int32 dot products.

The digit helpers of she_tpu/ops/ntt_mxu.py, shared by the int8 form of
dim-0 (pir/serving.py) and the matrix NTT (ops/ntt_mxu.py): every residue
is written as D unsigned 7-bit digits (each in [0, 127], so it is a
non-negative int8), a product of two residues becomes D^2 digit products,
and the partial sums of equal digit weight are recombined and reduced
mod q.
"""

from __future__ import annotations

import torch

from . import modarith as ma

DIGIT_BITS = 7
DIGIT_MASK = (1 << DIGIT_BITS) - 1
INT32_LIMIT = 1 << 31


def digit_count(moduli) -> int:
    """Digits a residue below max(moduli) needs: ceil(bits / 7)."""
    return -(-max(int(q).bit_length() for q in moduli) // DIGIT_BITS)


def assert_int32_partial_bound(contract: int, digits: int) -> None:
    """The digit dots accumulate up to `digits` partial products of
    `contract` int8 x int8 terms (each <= 127^2) in one int32; raise
    instead of wrapping past the exact bound (she_tpu ntt_mxu.py:174)."""
    if contract * 127 * 127 * digits >= INT32_LIMIT:
        raise OverflowError(
            f"int32 digit-dot bound exceeded: contraction length {contract} x "
            f"127^2 x {digits} digits >= 2^31; use the int64 MAC for this shape"
        )


def value_digits(x: torch.Tensor, digits: int) -> list[torch.Tensor]:
    """int64 residues [...] in [0, 2^62) -> `digits` int8 tensors [...],
    digit d = (x >> 7d) & 127 (she_tpu ntt_mxu.py:238 _value_digits, on one
    int64 word instead of uint32 limbs)."""
    return [((x >> (DIGIT_BITS * d)) & DIGIT_MASK).to(torch.int8) for d in range(digits)]


def recombine_partials(partials: list, q) -> torch.Tensor:
    """sum_k partials[k] * 2^(7k) mod q, fully reduced, for non-negative
    int32 or int64 partial sums below 2^31 and moduli below 2^62 (a Python
    int or a tagged column broadcast against the partials).

    she_tpu recombines into exact uint32 limbs (ntt_mxu.py:253
    _accumulate_partials) and then folds the limbs mod q
    (serving.py:271 _reduce_acc_limbs_w32_rows, :292
    _reduce_acc_limbs_w64_row). On one int64 word the exact sum may need
    more than 64 bits, so this folds by Horner's rule instead, reducing
    after every digit: r <- (r * 2^7 + p_k) mod q. The result is the same
    residue."""
    out = None
    for p in reversed(partials):
        p = ma.reduce(p.to(torch.int64), q)
        out = p if out is None else ma.add_mod(ma.mul_mod(out, 1 << DIGIT_BITS, q), p, q)
    if out is None:
        raise ValueError("no partial sums")
    return out
