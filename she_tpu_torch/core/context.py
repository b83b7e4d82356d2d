"""PolyContext: per-(degree, moduli, device) precomputation chain.

Mirrors she_tpu/core/context.py (and the reference's PolyContext linked
list dropping the last modulus, PolyContext.swift:19-267): each level holds
its moduli as an int64 column on its device, its NTT tables, and
q_last^{-1} mod q_i for modulus switching. Host precomputation uses Python
big ints.
"""

from __future__ import annotations

from functools import cached_property, lru_cache

import torch

from .. import errors
from ..ops import modarith
from ..ops import ntt as nttmod
from ..utils import nt


@lru_cache(maxsize=None)
def get_poly_context(
    degree: int, moduli: tuple[int, ...], scalar_bits: int, device: torch.device
) -> "PolyContext":
    return PolyContext(degree, moduli, scalar_bits, device)


class PolyContext:
    """Immutable; use get_poly_context for interning (identity-based eq)."""

    def __init__(self, degree: int, moduli: tuple[int, ...], scalar_bits: int, device: torch.device):
        if not nt.is_power_of_two(degree):
            raise errors.InvalidDegree(str(degree))
        if not moduli:
            raise errors.InvalidModulus("empty moduli")
        limit = (1 << (scalar_bits - 2)) - 1
        for q in moduli:
            if not (1 < q <= limit):
                raise errors.InvalidModulus(str(q))
        self.degree = degree
        self.moduli = tuple(moduli)
        self.scalar_bits = scalar_bits
        self.device = device
        self.q_product = 1
        for q in self.moduli:
            self.q_product *= q
        self._columns: dict[tuple, torch.Tensor] = {}

    # -- chain ------------------------------------------------------------

    @property
    def next(self) -> "PolyContext | None":
        if len(self.moduli) == 1:
            return None
        return get_poly_context(self.degree, self.moduli[:-1], self.scalar_bits, self.device)

    def get_context(self, moduli_count: int) -> "PolyContext":
        """Context keeping the first `moduli_count` moduli
        (reference PolyContext.getContext, PolyContext.swift:229-239)."""
        if not 1 <= moduli_count <= len(self.moduli):
            raise errors.IncompatibleContexts(f"moduli_count {moduli_count}")
        if moduli_count == len(self.moduli):
            return self
        return get_poly_context(
            self.degree, self.moduli[:moduli_count], self.scalar_bits, self.device
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"PolyContext(N={self.degree}, L={len(self.moduli)}, device={self.device})"

    # -- tables -----------------------------------------------------------

    @cached_property
    def ntt_tables(self) -> nttmod.NttTables:
        for q in self.moduli:
            if not nt.is_ntt_modulus(q, self.degree):
                raise errors.InvalidModulus(f"{q} is not NTT-friendly for N={self.degree}")
        return nttmod.build_ntt_tables(self.moduli, self.degree, self.device)

    def max_signed_lazy_product_count(self) -> int:
        """How many q_i^2-sized products fit in a signed int64 accumulator
        (half of the reference's maxLazyProductAccumulationCount,
        PolyContext.swift:246-253, which counts an unsigned double word)."""
        return modarith.signed_lazy_product_count(self.moduli)

    # -- device constants --------------------------------------------------

    @cached_property
    def q_col(self) -> torch.Tensor:
        """[L, 1] int64 moduli on the device."""
        return self.column(self.moduli)

    def column(self, values) -> torch.Tensor:
        """Per-row host ints [L] -> [L, 1] int64 tensor on the device, made
        once per distinct values: a host-to-device copy waits for the device
        to drain its queue, so the serving path must not make one per call."""
        key = tuple(int(v) for v in values)
        col = self._columns.get(key)
        if col is None:
            col = torch.tensor([[v] for v in key], dtype=torch.int64, device=self.device)
            self._columns[key] = col
        return col

    @cached_property
    def inverse_q_last(self) -> torch.Tensor:
        """[L-1, 1]: q_last^{-1} mod q_i
        (reference PolyContext.inverseQLast, PolyContext.swift:96-111)."""
        q_last = self.moduli[-1]
        return self.column(nt.inverse_mod(q_last % q, q) for q in self.moduli[:-1])
