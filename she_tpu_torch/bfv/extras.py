"""SPI extras (reference _HomomorphicEncryptionExtras, Sources/
_HomomorphicEncryptionExtras/{HeScheme,Ciphertext,PolyRq}.swift), the port
of she_tpu/bfv/extras.py: multi-step rotations composed from the available
Galois keys, rotate-and-sum / swap-rows-and-add accumulation, and
modulus-dropping on polynomials. Used by PNNS; exposed here as the stable
extras surface."""

from __future__ import annotations

from ..core import poly as polymod
from ..core.context import get_poly_context
from ..core.poly import PolyRq
from ..pnns.pnns import (  # noqa: F401  (canonical implementations)
    rotate_columns_and_sum,
    rotate_columns_multi_step,
    swap_rows_and_add,
)


def remove_last_moduli(p: PolyRq, count: int) -> PolyRq:
    """Drop the trailing `count` RNS rows (reference Extras/PolyRq.swift:230)."""
    ctx = p.context
    target = get_poly_context(ctx.degree, ctx.moduli[: len(ctx.moduli) - count], ctx.scalar_bits, ctx.device)
    return polymod.drop_context(p, target)
