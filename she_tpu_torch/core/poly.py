"""PolyRq: RNS polynomial residue tensors and their ops.

A polynomial in R_q is an int64 tensor [..., L, N] (L = RNS moduli,
N = degree) of residues fully reduced into [0, q_i), RNS-major like
she_tpu/core/poly.py and the reference's Array2d layout
(PolyRq.swift:21-52). Leading axes are batch axes: every op below works on
a whole batch of polynomials at once, which is how the port replaces
she_tpu's vmap.

Formats: COEFF (coefficient domain) and EVAL (NTT domain), enforced at the
op level like the reference's phantom types.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .. import errors
from ..ops import modarith as ma
from ..ops import ntt as nttmod
from .context import PolyContext

COEFF = "coeff"
EVAL = "eval"


@dataclass
class PolyRq:
    data: torch.Tensor  # [..., L, N] int64
    context: PolyContext
    fmt: str

    @property
    def degree(self) -> int:
        return self.context.degree

    @property
    def moduli(self):
        return self.context.moduli

    @classmethod
    def zero(cls, context: PolyContext, fmt: str = COEFF, batch: tuple = ()) -> "PolyRq":
        shape = tuple(batch) + (len(context.moduli), context.degree)
        return cls(torch.zeros(shape, dtype=torch.int64, device=context.device), context, fmt)

    @classmethod
    def from_values(cls, values, context: PolyContext, fmt: str = COEFF) -> "PolyRq":
        """values: integer array [..., L, N] of residues in [0, q_i)."""
        arr = np.asarray(values).astype(np.int64)
        return cls(torch.from_numpy(arr).to(context.device), context, fmt)

    def to_values(self) -> np.ndarray:
        """-> int64 numpy array [..., L, N]."""
        return self.data.cpu().numpy()


def check_same(a: PolyRq, b: PolyRq):
    if a.context is not b.context:
        raise errors.IncompatibleContexts(f"{a.context} vs {b.context}")
    if a.fmt != b.fmt:
        raise errors.InvalidFormat(f"{a.fmt} vs {b.fmt}")


def add(a: PolyRq, b: PolyRq) -> PolyRq:
    check_same(a, b)
    return PolyRq(ma.add_mod(a.data, b.data, a.context.q_col), a.context, a.fmt)


def sub(a: PolyRq, b: PolyRq) -> PolyRq:
    check_same(a, b)
    return PolyRq(ma.sub_mod(a.data, b.data, a.context.q_col), a.context, a.fmt)


def neg(a: PolyRq) -> PolyRq:
    return PolyRq(ma.neg_mod(a.data, a.context.q_col), a.context, a.fmt)


def mul_eval(a: PolyRq, b: PolyRq) -> PolyRq:
    """Pointwise product in Eval format (reference PolyRq *=,
    PolyRq.swift:184-204)."""
    check_same(a, b)
    if a.fmt != EVAL:
        raise errors.InvalidFormat("multiplication requires Eval format")
    return PolyRq(ma.mul_mod(a.data, b.data, a.context.q_col), a.context, EVAL)


def mul_poly_rows(a: PolyRq, other: torch.Tensor) -> PolyRq:
    """Pointwise product with the matching leading rows of another poly's
    data (e.g. a secret key over a larger context). Used by encrypt/decrypt
    (reference PolyRq.mulAssign(secretPoly:))."""
    L = len(a.context.moduli)
    rows = other[..., :L, :]
    return PolyRq(ma.mul_mod(a.data, rows, a.context.q_col), a.context, a.fmt)


def mul_scalar_rows(a: PolyRq, constants) -> PolyRq:
    """Multiply row i by host constant constants[i] (reference
    PolyRq *= [T], PolyRq.swift:232-245)."""
    ctx = a.context
    c = ctx.column(k % q for k, q in zip(constants, ctx.moduli))
    return PolyRq(ma.mul_mod(a.data, c, ctx.q_col), ctx, a.fmt)


def forward_ntt(a: PolyRq) -> PolyRq:
    if a.fmt != COEFF:
        raise errors.InvalidFormat("forward NTT requires Coeff")
    return PolyRq(nttmod.forward_ntt(a.data, a.context.ntt_tables), a.context, EVAL)


def inverse_ntt(a: PolyRq) -> PolyRq:
    if a.fmt != EVAL:
        raise errors.InvalidFormat("inverse NTT requires Eval")
    return PolyRq(nttmod.inverse_ntt(a.data, a.context.ntt_tables), a.context, COEFF)


def drop_context(a: PolyRq, target: PolyContext) -> PolyRq:
    """Keep only the first len(target.moduli) RNS rows (reference
    PolyRq.dropContext, PolyRq.swift:318-329)."""
    if target.moduli != a.context.moduli[: len(target.moduli)]:
        raise errors.IncompatibleContexts("dropContext target is not a prefix")
    return PolyRq(a.data[..., : len(target.moduli), :], target, a.fmt)


def divide_and_round_q_last_data(data: torch.Tensor, ctx: PolyContext) -> torch.Tensor:
    """divide_and_round_q_last on raw int64 [..., L, N] Coeff data over ctx."""
    q_last = ctx.moduli[-1]
    half = q_last >> 1
    L = len(ctx.moduli)
    last = data[..., L - 1 :, :]
    last_plus = torch.remainder(last + half, q_last)  # [..., 1, N] in [0, q_last)
    qs = ctx.column(ctx.moduli[:-1])
    tmp = torch.remainder(last_plus, qs)  # [..., L-1, N]
    half_mod = ctx.column(half % q for q in ctx.moduli[:-1])
    coeff = ma.add_mod(data[..., : L - 1, :], half_mod, qs)
    coeff = ma.sub_mod(coeff, tmp, qs)
    return ma.mul_mod(coeff, ctx.inverse_q_last, qs)


def divide_and_round_q_last(a: PolyRq) -> PolyRq:
    """Divide+round by the last modulus, dropping it — BFV mod switch
    (reference PolyRq.divideAndRoundQLast, PolyRq.swift:365-393;
    Alg 8 of HPS / Alg 2 of eprint 2018/931)."""
    if a.fmt != COEFF:
        raise errors.InvalidFormat("divideAndRoundQLast requires Coeff")
    nxt = a.context.next
    if nxt is None:
        raise errors.IncompatibleContexts("no next context")
    return PolyRq(divide_and_round_q_last_data(a.data, a.context), nxt, COEFF)


def power_of_x_maps(n: int, power: int) -> tuple[int, np.ndarray] | None:
    """(roll, negate mask) for a negacyclic multiply by x^power, or None
    when x^power is 1 (reference PolyRq.multiplyPowerOfX)."""
    abs_step = abs(power) % (2 * n)
    if abs_step == 0:
        return None
    rot = -(abs_step % n) if power < 0 else (abs_step % n)
    neg_mask = np.zeros(n, dtype=bool)
    if power < 0 and abs_step < n:
        neg_mask[n - abs_step : n] = True
    elif power < 0:
        neg_mask[0 : 2 * n - abs_step] = True
    elif abs_step < n:
        neg_mask[0:abs_step] = True
    else:
        neg_mask[abs_step - n : n] = True
    return rot, neg_mask


@lru_cache(maxsize=None)
def _device_power_of_x_maps(n: int, power: int, device: torch.device):
    maps = power_of_x_maps(n, power)
    return None if maps is None else (maps[0], torch.from_numpy(maps[1]).to(device))


def multiply_power_of_x_data(data: torch.Tensor, power: int, ctx: PolyContext) -> torch.Tensor:
    """multiply_power_of_x on raw int64 [..., L, N] Coeff data over ctx."""
    maps = _device_power_of_x_maps(ctx.degree, power, data.device)
    if maps is None:
        return data
    rot, mask = maps
    rolled = torch.roll(data, rot, dims=-1)
    return torch.where(mask, ma.neg_mod(rolled, ctx.q_col), rolled)


def multiply_power_of_x(a: PolyRq, power: int) -> PolyRq:
    """Negacyclic multiply by x^power (reference PolyRq.multiplyPowerOfX,
    PolyRq.swift:398-422)."""
    if a.fmt != COEFF:
        raise errors.InvalidFormat("multiplyPowerOfX requires Coeff")
    out = multiply_power_of_x_data(a.data, power, a.context)
    return a if out is a.data else PolyRq(out, a.context, COEFF)
