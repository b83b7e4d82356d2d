"""Launch wrapper for the matrix NTT's phase kernel (csrc/ntt_mxu.cu).

The kernel replaces she_tpu/ops/ntt_mxu.py:310 _phase_row and :330
_phase_block: one phase of the matrix NTT (ops/ntt_mxu.py) as int8 x int8
-> int32 digit products on the tensor cores (mma.sync), recombined and
reduced mod q in its epilogue. The wrapper checks its inputs, allocates
the output with torch.empty, launches on torch.cuda.current_stream() and
raises if the launch reports a CUDA error. There is no fallback: a tensor
the kernel does not take raises. `launches` counts each launch;
`launch_shapes` counts the same launches by PhaseKey (matrix, input shape,
moduli), so a run can check and time each shape it used.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from functools import lru_cache
from typing import NamedTuple

import torch

from . import kernel_build


class PhaseKey(NamedTuple):
    """What a launch is counted by in `launch_shapes`."""

    matrix: str  # "Lf", "Rf" (forward) or "Ri", "Li" (inverse)
    shape: tuple
    moduli: tuple


launches = {"ntt_mxu_phase": 0}
launch_shapes: Counter = Counter()

MATRICES = ("Lf", "Rf", "Ri", "Li")
ROW_MATRICES = ("Lf", "Li")  # the row phase, along the rows; "Rf" and "Ri" are the block phase
MAX_DIGITS = 9
MAX_MODULUS = 1 << 62
MAX_ROWS = 128  # A = N / 64: N up to 8192
MAX_GROUPS = 65535  # the grid's second dimension: L (row phase) or L * A (block phase)

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_ARGS = [_VP] * 4 + [_INT] * 5 + [ctypes.c_longlong, _VP]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    launch_shapes.clear()


def _library():
    lib = kernel_build.load("ntt_mxu")
    if lib.she_ntt_mxu_phase.argtypes is None:
        lib.she_ntt_mxu_phase.argtypes = _ARGS
        lib.she_ntt_mxu_phase.restype = ctypes.c_int
    return lib


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


@lru_cache(maxsize=None)
def constants(moduli: tuple, device: torch.device) -> torch.Tensor:
    """int64 [4, L] on the device (unsigned bits reinterpreted): q_l,
    floor(2^64 / q_l), w = 2^28 mod q_l and floor(w 2^64 / q_l)."""
    w28 = [(1 << 28) % q for q in moduli]
    rows = [list(moduli), [(1 << 64) // q for q in moduli], w28, [(w << 64) // q for w, q in zip(w28, moduli)]]
    return torch.tensor([[_signed(v) for v in r] for r in rows], dtype=torch.int64, device=device)


def exact64(moduli, contract: int) -> bool:
    """Whether the exact dot product of `contract` residues below max(q)
    fits 64 bits, so the epilogue sums the weights and reduces once."""
    return contract * (max(moduli) - 1) ** 2 < 1 << 64


def _check(x: torch.Tensor, tables, matrix: str) -> tuple[torch.Tensor, int, int]:
    """Validate the operands; returns (digit planes, L, batch)."""
    if x.dtype != torch.int64:
        raise TypeError(f"the matrix NTT kernel needs int64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the matrix NTT kernel needs a contiguous tensor")
    L, n, A, D = len(tables.moduli), tables.degree, tables.A, tables.D
    if x.dim() < 2 or tuple(x.shape[-2:]) != (L, n):
        raise ValueError(f"the matrix NTT kernel expects [..., {L}, {n}], got {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"the matrix NTT kernel needs a CUDA tensor, got {x.device}")
    if matrix not in MATRICES:
        raise ValueError(f"no matrix {matrix!r}")
    m = getattr(tables, matrix)
    want = (L, D, A, A) if matrix in ROW_MATRICES else (L, D, A, 64, 64)
    if m.dtype != torch.int8 or tuple(m.shape) != want or not m.is_contiguous():
        raise ValueError(f"{matrix} must be contiguous int8 {want}, got {m.dtype} {tuple(m.shape)}")
    if m.device != x.device:
        raise ValueError(f"tables on {m.device}, data on {x.device}")
    if not 2 <= A <= MAX_ROWS or A & (A - 1) or n != 64 * A:
        raise ValueError(f"the matrix NTT kernel takes N = 128 .. 8192, got {n}")
    if not 1 <= D <= MAX_DIGITS or max(tables.moduli) >= MAX_MODULUS:
        raise ValueError("the matrix NTT kernel takes moduli below 2^62 (at most 9 digits)")
    if (L if matrix in ROW_MATRICES else L * A) > MAX_GROUPS:
        raise ValueError(f"the matrix NTT kernel takes at most {MAX_GROUPS} groups, got L = {L}, A = {A}")
    return m, L, x.numel() // (L * n)


def ntt_mxu_phase(x: torch.Tensor, tables, matrix: str) -> torch.Tensor:
    """One phase of the matrix NTT: x int64 [..., L, N] in [0, q) times
    the digit planes of `matrix` (tables: ntt_mxu.MxuNttTables) -> int64
    [..., L, N] in [0, q), bit-identical to ntt_mxu.phase_plain."""
    m, L, batch = _check(x, tables, matrix)
    out = torch.empty_like(x)
    if batch == 0:
        return out
    row = matrix in ROW_MATRICES
    moduli = tuple(tables.moduli)
    err = _library().she_ntt_mxu_phase(
        m.data_ptr(), x.data_ptr(), out.data_ptr(), constants(moduli, x.device).data_ptr(),
        tables.D, tables.A, L, int(row), int(exact64(moduli, tables.A if row else 64)), batch,
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"she_ntt_mxu_phase launch failed with CUDA error {err}")
    launches["ntt_mxu_phase"] += 1
    launch_shapes[PhaseKey(matrix, tuple(x.shape), moduli)] += 1
    return out
