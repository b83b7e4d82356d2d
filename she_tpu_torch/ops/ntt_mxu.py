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

`forward_ntt` / `inverse_ntt` dispatch on the tensor's device: a CUDA
tensor takes the hand-written phase kernel (ops/ntt_mxu_cuda.py, one
launch a phase), a CPU tensor the plain PyTorch version below, and
anything else raises. `use_mxu` is she_tpu's policy, read at every call,
under the same variable, so one setting routes both packages alike.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache

import torch

from ..device import resolve_device
from ..utils import nt
from ..utils.refimpl import ntt_root_tables
from . import digits as dg
from . import modarith as ma
from . import ntt_mxu_cuda
from . import wide
from .ntt_mxu_cuda import MATRICES, MAX_MODULUS, ROW_MATRICES

BLOCK = 64  # width of the block phase: the last 6 forward stages
ENV = "SHE_TPU_NTT_MXU"

plain_calls_on_cuda = {"forward": 0, "inverse": 0}


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


@dataclass(frozen=True)
class MxuNttTables:
    """Per-(moduli, degree, device) digit matrices: Lf / Li int8
    [L, D, A, A], Rf / Ri int8 [L, D, A, 64, 64], and the moduli as a
    tagged int64 column [L, 1, 1]."""

    degree: int
    moduli: tuple[int, ...]
    A: int
    D: int
    Lf: torch.Tensor
    Rf: torch.Tensor
    Ri: torch.Tensor
    Li: torch.Tensor
    q: torch.Tensor


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
    mats = {name: [] for name in MATRICES}
    for q in moduli:
        roots, inv_roots = ntt_root_tables(q, degree)
        mats["Lf"].append(_forward_row_matrix(roots, q, A))
        mats["Rf"].append(_forward_block_matrices(roots, q, A, degree))
        mats["Ri"].append(_inverse_block_matrices(inv_roots, q, A, degree))
        mats["Li"].append(_inverse_row_matrix(inv_roots, q, A, degree))
    # [L, D, ...]: digit planes of each modulus's matrix
    digit_planes = {k: torch.stack([_matrix_digits(M, D) for M in v]).to(device) for k, v in mats.items()}
    q = wide.tag(torch.tensor(moduli, dtype=torch.int64, device=device).view(-1, 1, 1), moduli)
    return MxuNttTables(degree=degree, moduli=tuple(moduli), A=A, D=D, q=q, **digit_planes)


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


def phase_plain(x: torch.Tensor, t: MxuNttTables, matrix: str) -> torch.Tensor:
    """Plain PyTorch version of one phase: int64 [..., L, N] in [0, q) ->
    the product by `matrix` ("Lf", "Rf", "Ri" or "Li"), [..., L, N] in
    [0, q). The digits of x (digits.value_digits) times those of the
    matrix give 2D - 1 partial sums by weight (she_tpu ntt_mxu.py:310
    _phase_row, :330 _phase_block), recombined by
    digits.recombine_partials."""
    _check_phase(x, t, matrix)
    if x.device.type == "cuda":
        plain_calls_on_cuda["forward" if matrix.endswith("f") else "inverse"] += 1
    shape = x.shape
    xv = x.reshape(shape[:-1] + (t.A, BLOCK))
    xd = dg.value_digits(xv, t.D)
    M = getattr(t, matrix)
    row = matrix in ROW_MATRICES
    partials: list = [None] * (2 * t.D - 1)
    for i in range(t.D):
        for j in range(t.D):
            p = _pair_products(M[:, i], xd[j], row)
            partials[i + j] = p if partials[i + j] is None else partials[i + j] + p
    return dg.recombine_partials(partials, t.q).reshape(shape)


def forward_ntt_plain(x: torch.Tensor, t: MxuNttTables) -> torch.Tensor:
    """x: int64 [..., L, N] in [0, q) -> Eval form, bit-identical to
    ops/ntt.forward_ntt_plain."""
    return phase_plain(phase_plain(x, t, "Lf"), t, "Rf")


def inverse_ntt_plain(x: torch.Tensor, t: MxuNttTables) -> torch.Tensor:
    """x: int64 [..., L, N] Eval form in [0, q) -> Coeff form."""
    return phase_plain(phase_plain(x, t, "Ri"), t, "Li")


def phase(x: torch.Tensor, t: MxuNttTables, matrix: str) -> torch.Tensor:
    """One phase: the kernel on a CUDA tensor, the plain version on a CPU
    tensor; anything else raises."""
    if x.device.type == "cuda":
        return ntt_mxu_cuda.ntt_mxu_phase(x.contiguous(), t, matrix)
    if x.device.type == "cpu":
        return phase_plain(x, t, matrix)
    raise ValueError(f"no matrix NTT for device {x.device}")


def forward_ntt(x: torch.Tensor, t: MxuNttTables) -> torch.Tensor:
    """x: int64 [..., L, N] in [0, q) -> Eval form in [0, q)."""
    return phase(phase(x, t, "Lf"), t, "Rf")


def inverse_ntt(x: torch.Tensor, t: MxuNttTables) -> torch.Tensor:
    """x: int64 [..., L, N] Eval form in [0, q) -> Coeff form in [0, q)."""
    return phase(phase(x, t, "Ri"), t, "Li")
