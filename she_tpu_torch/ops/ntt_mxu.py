"""The negacyclic NTT as two modular matrix products of int8 digits.

The port of she_tpu/ops/ntt_mxu.py, she_tpu's opt-in NTT
(SHE_TPU_NTT_MXU=1). For N = A * 64 a polynomial is viewed as
X[a, b] = x[64a + b] (A rows of 64):

* the first log2(A) forward stages have a butterfly span of at least 64,
  so they act along the row axis with twiddles that depend on the row
  alone: one [A, A] matrix Lf mod q, shared by every column b;
* the last 6 stages act within each row of 64: one [64, 64] matrix Rf[a]
  per row.

    forward:  X -> Rf[a] @ (Lf @ X)        (the row phase, then the block phase)
    inverse:  X -> Li @ (Ri[a] @ X)        (n^-1 folded into Li)

The matrices are made on the host by running the stage butterflies on
identity matrices, so the composition is bit-identical to the butterfly
NTT (ops/ntt.py): same values, same element order. Each product is D^2
products of base-2^7 digits (D = ceil(bits(max q) / 7), so each digit is a
non-negative int8), summed in int32 (each weight's sum stays below 2^31,
checked when the tables are made), recombined by weight and reduced mod q:
exact integer arithmetic throughout.

The block matrices of a modulus are one shared matrix times a twist:
row a of the [A, 64] view is the sub-ring Z_q[Y]/(Y^64 - c_a), whose
transform is a fixed 64-point transform after scaling coefficient j by
zeta_a^j, so

    Rf[a] = R_f diag(s_f[a]),   Ri[a] = diag(s_i[a]) R_i

with R_f = Rf[0], R_i = Ri[0] and twists s_f, s_i [A, 64] (asserted exactly
when the tables are built). A direction is then two products by matrices
that every polynomial of a modulus shares, with one pointwise product
between them (`forward_factored_plain`, `inverse_factored_plain`): the form
the fused kernel computes.

`forward_ntt` / `inverse_ntt` dispatch on the tensor's device: a CUDA
tensor takes the hand-written kernel (ops/ntt_mxu_cuda.py, one launch a
direction), a CPU tensor the factored plain version, and anything else
raises. `phase_plain` keeps she_tpu's per-phase form, which the tests hold
against the factored one; its per-row block matrices are rebuilt from the
shared ones and the twists when it asks for them (`phase_matrix`), not
kept. `use_mxu` is she_tpu's policy, read at every call, under the same
variable, so one setting routes both packages alike.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache

import torch

from .. import trace
from ..device import resolve_device
from ..utils import nt
from ..utils.refimpl import ntt_root_tables
from . import digits as dg
from . import modarith as ma
from . import ntt_mxu_cuda
from . import wide
from .ntt_mxu_cuda import MAX_MODULUS, shoup_constants

BLOCK = 64  # width of the block phase: the last 6 forward stages
MATRICES = ("Lf", "Rf", "Ri", "Li")  # she_tpu's phases: forward Lf then Rf, inverse Ri then Li
ROW_MATRICES = ("Lf", "Li")  # the row phase, along the rows; "Rf" and "Ri" are the block phase
ENV = "SHE_TPU_NTT_MXU"


# ---------------------------------------------------------------------------
# Host construction: the stage butterflies run on identity matrices
# (she_tpu ntt_mxu.py:53-135), in int64 with the port's modular arithmetic
# ---------------------------------------------------------------------------


def _forward_row_matrix(roots, q: int, A: int) -> torch.Tensor:
    """[A, A]: the first log2(A) forward stages along the row axis of the
    [A, 64] view (twiddle m + i, as in the full transform)."""
    X = torch.eye(A, dtype=torch.int64)
    for log2m in range(nt.log2_exact(A)):
        m, t = 1 << log2m, A >> (log2m + 1)
        v = X.reshape(m, 2, t, A)
        w = torch.tensor(roots[m : 2 * m], dtype=torch.int64).view(m, 1, 1)
        u, wv = v[:, 0], ma.mul_mod(v[:, 1], w, q)
        X = torch.stack((ma.add_mod(u, wv, q), ma.sub_mod(u, wv, q)), dim=1).reshape(A, A)
    return X


def _block_twiddles(roots, m: int, A: int, bpr: int) -> torch.Tensor:
    """[A, bpr, 1, 1]: twiddle m + a * bpr + ib of block ib of row a."""
    return torch.tensor(roots[m : m + A * bpr], dtype=torch.int64).view(A, bpr, 1, 1)


def _forward_block_matrices(roots, q: int, A: int, n: int) -> torch.Tensor:
    """[A, 64, 64]: the last 6 forward stages within each row of 64."""
    X = torch.eye(BLOCK, dtype=torch.int64).expand(A, BLOCK, BLOCK)
    for log2m in range(nt.log2_exact(A), nt.log2_exact(n)):
        m, t = 1 << log2m, n >> (log2m + 1)
        bpr = BLOCK // (2 * t)
        v = X.reshape(A, bpr, 2, t, BLOCK)
        u, wv = v[:, :, 0], ma.mul_mod(v[:, :, 1], _block_twiddles(roots, m, A, bpr), q)
        X = torch.stack((ma.add_mod(u, wv, q), ma.sub_mod(u, wv, q)), dim=2).reshape(A, BLOCK, BLOCK)
    return X


def _inverse_block_matrices(inv_roots, q: int, A: int, n: int) -> torch.Tensor:
    """[A, 64, 64]: the first inverse stages (span at most 32) within each
    row of 64, butterfly (u + v, (u - v) * w)."""
    X = torch.eye(BLOCK, dtype=torch.int64).expand(A, BLOCK, BLOCK)
    for log2m in reversed(range(nt.log2_exact(A), nt.log2_exact(n))):
        m, t = 1 << log2m, n >> (log2m + 1)
        bpr = BLOCK // (2 * t)
        v = X.reshape(A, bpr, 2, t, BLOCK)
        u, b = v[:, :, 0], v[:, :, 1]
        d = ma.mul_mod(ma.sub_mod(u, b, q), _block_twiddles(inv_roots, m, A, bpr), q)
        X = torch.stack((ma.add_mod(u, b, q), d), dim=2).reshape(A, BLOCK, BLOCK)
    return X


def _inverse_row_matrix(inv_roots, q: int, A: int, n: int) -> torch.Tensor:
    """[A, A]: the last inverse stages (span at least 64) along the rows,
    with n^-1 folded in (the butterfly NTT folds it into its m = 1 stage:
    the same composed values)."""
    X = torch.eye(A, dtype=torch.int64)
    for log2m in reversed(range(nt.log2_exact(A))):
        m, t = 1 << log2m, A >> (log2m + 1)
        v = X.reshape(m, 2, t, A)
        u, b = v[:, 0], v[:, 1]
        w = torch.tensor(inv_roots[m : 2 * m], dtype=torch.int64).view(m, 1, 1)
        X = torch.stack((ma.add_mod(u, b, q), ma.mul_mod(ma.sub_mod(u, b, q), w, q)), dim=1).reshape(A, A)
    return ma.mul_mod(X, nt.inverse_mod(n, q), q)


def _matrix_digits(M: torch.Tensor, D: int) -> torch.Tensor:
    """int64 [...] in [0, 2^(7D)) -> int8 [D, ...], digit d = (M >> 7d) & 127."""
    return torch.stack(dg.value_digits(M, D))


def factor_block_matrices(blocks: torch.Tensor, q: int, forward: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 [A, 64, 64] block matrices -> (the shared [64, 64] matrix,
    the twist [A, 64]): forward Rf[a] = Rf[0] diag(s[a]) (a ratio a
    column), inverse Ri[a] = diag(s[a]) Ri[0] (a ratio a row). Every entry
    of row 0 (forward) or column 0 (inverse) of the shared matrix is a
    product of roots of unity, so invertible mod q. Raises unless the
    product equals every block matrix exactly."""
    shared = blocks[0]
    pivot = shared[0] if forward else shared[:, 0]  # [64]
    inv = torch.tensor([nt.inverse_mod(int(v), q) for v in pivot], dtype=torch.int64)
    twist = ma.mul_mod(blocks[:, 0] if forward else blocks[:, :, 0], inv, q)  # [A, 64]
    rebuilt = ma.mul_mod(shared, twist[:, None, :] if forward else twist[:, :, None], q)
    if not torch.equal(rebuilt, blocks):
        raise AssertionError(f"the block matrices mod {q} are not the shared matrix times a twist")
    return shared, twist


@dataclass(frozen=True)
class MxuNttTables:
    """Per-(moduli, degree, device) digit matrices: Lf / Li int8
    [L, D, A, A], R_f / R_i int8 [L, D, 64, 64] (the shared block
    matrices), the twists s_f / s_i int64 [L, A, 64] with their Shoup
    constants floor(s 2^64 / q) as unsigned bits (s_f_shoup, s_i_shoup),
    the moduli as a tagged int64 column [L, 1, 1], and the fused kernel's
    operands made from them (ntt_mxu_cuda.kernel_operands)."""

    degree: int
    moduli: tuple[int, ...]
    A: int
    D: int
    Lf: torch.Tensor
    Li: torch.Tensor
    R_f: torch.Tensor
    R_i: torch.Tensor
    s_f: torch.Tensor
    s_i: torch.Tensor
    s_f_shoup: torch.Tensor
    s_i_shoup: torch.Tensor
    q: torch.Tensor
    operands: dict


def supports(moduli, degree: int) -> bool:
    """she_tpu's rule (ntt_mxu.py:165): a power-of-two degree with at
    least two rows of 64."""
    return nt.is_power_of_two(degree) and degree % BLOCK == 0 and degree // BLOCK >= 2


@lru_cache(maxsize=None)
def build_mxu_tables(moduli: tuple[int, ...], degree: int, device: torch.device) -> MxuNttTables:
    if not supports(moduli, degree):
        raise ValueError(f"the matrix NTT takes a power-of-two N >= 128, got {degree}")
    if max(moduli) >= MAX_MODULUS:
        raise ValueError("the matrix NTT takes moduli below 2^62")
    A = degree // BLOCK
    D = dg.digit_count(moduli)
    dg.assert_int32_partial_bound(max(A, BLOCK), D)
    mats = {name: [] for name in ROW_MATRICES + ("R_f", "R_i")}
    twists = {"s_f": [], "s_i": []}
    for q in moduli:
        roots, inv_roots = ntt_root_tables(q, degree)
        mats["Lf"].append(_forward_row_matrix(roots, q, A))
        mats["Li"].append(_inverse_row_matrix(inv_roots, q, A, degree))
        for side, blocks, forward in (("f", _forward_block_matrices(roots, q, A, degree), True),
                                      ("i", _inverse_block_matrices(inv_roots, q, A, degree), False)):
            shared, twist = factor_block_matrices(blocks, q, forward)
            mats[f"R_{side}"].append(shared)
            twists[f"s_{side}"].append(twist)
    # [L, D, ...]: digit planes of each modulus's matrix
    parts = {k: torch.stack([_matrix_digits(M, D) for M in v]) for k, v in mats.items()}
    for name in list(twists):
        parts[name] = torch.stack(twists[name])  # [L, A, 64]
        parts[f"{name}_shoup"] = shoup_constants(parts[name], moduli)
    parts = {k: v.to(device) for k, v in parts.items()}
    operands = ntt_mxu_cuda.kernel_operands(moduli, D, **parts)
    q = wide.tag(torch.tensor(moduli, dtype=torch.int64, device=device).view(-1, 1, 1), moduli)
    return MxuNttTables(degree=degree, moduli=tuple(moduli), A=A, D=D, q=q, operands=operands, **parts)


def tables_for(moduli: tuple[int, ...], degree: int, device) -> MxuNttTables:
    """The cached tables, keyed by a device with its index ("cuda" and
    "cuda:0" share one entry on card 0)."""
    return build_mxu_tables(tuple(moduli), degree, resolve_device(device))


def use_mxu(tables) -> bool:
    """Dispatch policy for ops/ntt.py (she_tpu ntt_mxu.py:404): the matrix
    NTT only on request, SHE_TPU_NTT_MXU=1, and only at a degree
    `supports` takes. A sharded NTT's block tables (NttTables.block) never
    take it: their twiddles are a sub-transform's, and she_tpu's sharded
    stages call the stage functions directly."""
    flag = os.environ.get(ENV)
    if flag == "0":
        return False
    if getattr(tables, "block", None) is not None:
        return False
    if not supports(tables.moduli, tables.degree):
        return False
    return flag == "1"


# ---------------------------------------------------------------------------
# The plain version: one phase in the digit form
# ---------------------------------------------------------------------------


def _check_phase(x: torch.Tensor, t: MxuNttTables, matrix: str) -> None:
    L, n = len(t.moduli), t.degree
    if matrix not in MATRICES:
        raise ValueError(f"no matrix {matrix!r}; the phases multiply by one of {MATRICES}")
    if x.dim() < 2 or tuple(x.shape[-2:]) != (L, n):
        raise ValueError(f"the matrix NTT expects [..., {L}, {n}], got {tuple(x.shape)}")


def _pair_products(m: torch.Tensor, xd: torch.Tensor, row: bool) -> torch.Tensor:
    """One digit plane of the matrix times one of x, as int64: the row
    phase out[..., l, u, b] = sum_a m[l, u, a] xd[..., l, a, b]; the block
    phase out[..., l, a, u] = sum_b m[l, a, u, b] xd[..., l, a, b]. Every
    sum is below 2^31: int64 matmuls on the CPU, float64 ones elsewhere
    (exact below 2^53; CUDA has no integer matmul)."""
    dtype = torch.int64 if xd.device.type == "cpu" else torch.float64
    shape = xd.shape
    L, A = shape[-3], shape[-2]
    xb = xd.reshape(-1, L, A, BLOCK).to(dtype)  # [B, L, A, 64]
    if row:  # [L, A, A] @ [L, A, B 64], the batch moved next to b
        out = torch.matmul(m.to(dtype), xb.permute(1, 2, 0, 3).reshape(L, A, -1))
        out = out.reshape(L, A, -1, BLOCK).permute(2, 0, 1, 3)
    else:  # [L, A, 64, 64] @ [L, A, 64, B], the batch as the columns
        out = torch.matmul(m.to(dtype), xb.permute(1, 2, 3, 0)).permute(3, 0, 1, 2)
    return out.reshape(shape).to(torch.int64)


def _planes_values(planes: torch.Tensor) -> torch.Tensor:
    """int8 digit planes [L, D, ...] -> int64 values [L, ...]."""
    return sum(planes[:, i].to(torch.int64) << (7 * i) for i in range(planes.shape[1]))


def phase_matrix(t: MxuNttTables, matrix: str) -> torch.Tensor:
    """The digit planes of one of she_tpu's phase matrices: Lf / Li int8
    [L, D, A, A] as kept; Rf / Ri int8 [L, D, A, 64, 64], the per-row block
    matrices, rebuilt from the shared one and the twist (Rf[a] = R_f
    diag(s_f[a]), Ri[a] = diag(s_i[a]) R_i)."""
    if matrix in ROW_MATRICES:
        return getattr(t, matrix)
    forward = matrix == "Rf"
    shared = _planes_values(t.R_f if forward else t.R_i)  # [L, 64, 64]
    twist = t.s_f if forward else t.s_i  # [L, A, 64]
    blocks = [ma.mul_mod(shared[l], twist[l][:, None, :] if forward else twist[l][:, :, None], q)
              for l, q in enumerate(t.moduli)]
    return torch.stack([_matrix_digits(M, t.D) for M in blocks])


def phase_plain(x: torch.Tensor, t: MxuNttTables, matrix: str) -> torch.Tensor:
    """Plain PyTorch version of one phase: int64 [..., L, N] in [0, q) ->
    the product by `matrix` ("Lf", "Rf", "Ri" or "Li"), [..., L, N] in
    [0, q). The digits of x (digits.value_digits) times those of the
    matrix give 2D - 1 partial sums by weight (she_tpu ntt_mxu.py:310
    _phase_row, :330 _phase_block), recombined by
    digits.recombine_partials."""
    _check_phase(x, t, matrix)
    if x.device.type == "cuda":
        trace.count("plain_on_cuda.ntt_mxu_forward" if matrix.endswith("f") else "plain_on_cuda.ntt_mxu_inverse")
    shape = x.shape
    xv = x.reshape(shape[:-1] + (t.A, BLOCK))
    xd = dg.value_digits(xv, t.D)
    M = phase_matrix(t, matrix)
    row = matrix in ROW_MATRICES
    partials: list = [None] * (2 * t.D - 1)
    for i in range(t.D):
        for j in range(t.D):
            p = _pair_products(M[:, i], xd[j], row)
            partials[i + j] = p if partials[i + j] is None else partials[i + j] + p
    return dg.recombine_partials(partials, t.q).reshape(shape)


def forward_ntt_plain(x: torch.Tensor, t: MxuNttTables) -> torch.Tensor:
    """x: int64 [..., L, N] in [0, q) -> Eval form, bit-identical to
    ops/ntt.forward_ntt_plain: she_tpu's two phases (Lf, then Rf)."""
    return phase_plain(phase_plain(x, t, "Lf"), t, "Rf")


def inverse_ntt_plain(x: torch.Tensor, t: MxuNttTables) -> torch.Tensor:
    """x: int64 [..., L, N] Eval form in [0, q) -> Coeff form."""
    return phase_plain(phase_plain(x, t, "Ri"), t, "Li")


# ---------------------------------------------------------------------------
# The plain version of the fused kernel: a direction in the factored form
# ---------------------------------------------------------------------------


def _digit_product(m: torch.Tensor, xv: torch.Tensor, t: MxuNttTables, row: bool) -> torch.Tensor:
    """[..., L, A, 64] residues times a shared matrix of every modulus, in
    base-2^7 digits: the row product out[..., l, u, b] = sum_a m[l, u, a]
    x[..., l, a, b] (m = Lf or Li digits [L, D, A, A]) or the block product
    out[..., l, a, u] = sum_b m[l, u, b] x[..., l, a, b] (m = R_f or R_i
    digits [L, D, 64, 64]); the D^2 digit-plane products summed by weight
    (each below 2^31) and recombined by digits.recombine_partials."""
    dtype = torch.int64 if xv.device.type == "cpu" else torch.float64  # exact: every sum is below 2^31
    shape = xv.shape
    L, A = shape[-3], shape[-2]
    xd = [d.reshape(-1, L, A, BLOCK).to(dtype) for d in dg.value_digits(xv, t.D)]
    partials: list = [None] * (2 * t.D - 1)
    for i in range(t.D):
        mi = m[:, i].to(dtype)
        for j in range(t.D):
            if row:  # [L, A, A] @ [L, A, B 64], the batch moved next to b
                xb = xd[j].permute(1, 2, 0, 3).reshape(L, A, -1)
                p = torch.matmul(mi, xb).reshape(L, A, -1, BLOCK).permute(2, 0, 1, 3)
            else:  # [B, L, A, 64] @ [L, 64, 64]^T, broadcast over the batch
                p = torch.matmul(xd[j], mi.transpose(-1, -2))
            p = p.reshape(shape).to(torch.int64)
            partials[i + j] = p if partials[i + j] is None else partials[i + j] + p
    return dg.recombine_partials(partials, t.q)


def _check_direction(x: torch.Tensor, t: MxuNttTables) -> None:
    L, n = len(t.moduli), t.degree
    if x.dim() < 2 or tuple(x.shape[-2:]) != (L, n):
        raise ValueError(f"the matrix NTT expects [..., {L}, {n}], got {tuple(x.shape)}")


def forward_factored_plain(x: torch.Tensor, t: MxuNttTables) -> torch.Tensor:
    """The fused kernel's plain version: x int64 [..., L, N] in [0, q) ->
    Eval form in [0, q): the row product by Lf, the twist s_f, the block
    product by the shared R_f. Bit-identical to forward_ntt_plain."""
    _check_direction(x, t)
    if x.device.type == "cuda":
        trace.count("plain_on_cuda.ntt_mxu_forward")
    xv = x.reshape(x.shape[:-1] + (t.A, BLOCK))
    y = ma.mul_mod(_digit_product(t.Lf, xv, t, row=True), t.s_f, t.q)
    return _digit_product(t.R_f, y, t, row=False).reshape(x.shape)


def inverse_factored_plain(x: torch.Tensor, t: MxuNttTables) -> torch.Tensor:
    """x int64 [..., L, N] Eval form in [0, q) -> Coeff form in [0, q): the
    block product by the shared R_i, the twist s_i, the row product by Li.
    Bit-identical to inverse_ntt_plain."""
    _check_direction(x, t)
    if x.device.type == "cuda":
        trace.count("plain_on_cuda.ntt_mxu_inverse")
    xv = x.reshape(x.shape[:-1] + (t.A, BLOCK))
    w = ma.mul_mod(_digit_product(t.R_i, xv, t, row=False), t.s_i, t.q)
    return _digit_product(t.Li, w, t, row=True).reshape(x.shape)


def forward_ntt(x: torch.Tensor, t: MxuNttTables) -> torch.Tensor:
    """x: int64 [..., L, N] in [0, q) -> Eval form in [0, q): the fused
    kernel on a CUDA tensor, the factored plain version on a CPU tensor;
    anything else raises."""
    if x.device.type == "cuda":
        return ntt_mxu_cuda.ntt_mxu_forward(x.contiguous(), t)
    if x.device.type == "cpu":
        return forward_factored_plain(x, t)
    raise ValueError(f"no matrix NTT for device {x.device}")


def inverse_ntt(x: torch.Tensor, t: MxuNttTables) -> torch.Tensor:
    """x: int64 [..., L, N] Eval form in [0, q) -> Coeff form in [0, q)."""
    if x.device.type == "cuda":
        return ntt_mxu_cuda.ntt_mxu_inverse(x.contiguous(), t)
    if x.device.type == "cpu":
        return inverse_factored_plain(x, t)
    raise ValueError(f"no matrix NTT for device {x.device}")
