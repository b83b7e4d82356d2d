"""Launch wrapper for the int8 digit dim-0 kernel (csrc/dim0_int8.cu).

The kernel replaces she_tpu/pir/serving.py:222 dim0_inner_products_mxu:
the dim-0 ct-pt inner products as int8 x int8 -> int32 digit products on
the tensor cores (mma.sync), recombined and reduced mod q in its epilogue.
The wrapper checks its inputs, allocates the output with torch.empty,
launches on torch.cuda.current_stream() and raises if the launch reports a
CUDA error. There is no fallback: a tensor the kernel does not take raises.
`launches` counts each launch; `launch_shapes` counts the same launches by
(digits shape, query shape, moduli), so a run can time each shape it used.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from functools import lru_cache

import torch

from . import digits as dg
from . import kernel_build

launches = {"dim0_int8": 0}
launch_shapes: Counter = Counter()

MMA_DEPTH = 32  # k of mma.sync m16n8k32 for int8
MAX_MODULUS = 1 << 56  # r * 2^7 + partial must fit 64 bits: at most 8 digits
N_TILE = 8  # n positions a block

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_ARGS = [_VP] * 5 + [_INT] * 7 + [_VP]


def padded_depth(d0: int) -> int:
    """d0 rounded up to the MMA depth: the K of the digit layout."""
    return -(-d0 // MMA_DEPTH) * MMA_DEPTH


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    launch_shapes.clear()


def _library():
    lib = kernel_build.load("dim0_int8")
    if lib.she_dim0_int8.argtypes is None:
        lib.she_dim0_int8.argtypes = _ARGS
        lib.she_dim0_int8.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def _constants(moduli: tuple, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """q_l and floor(2^64 / q_l) as int64 [L] on the device (the Barrett
    constant's bits reinterpreted), made once per moduli and device."""
    barrett = [(1 << 64) // q for q in moduli]
    barrett = [b - (1 << 64) if b >= 1 << 63 else b for b in barrett]
    q = torch.tensor(moduli, dtype=torch.int64, device=device)
    return q, torch.tensor(barrett, dtype=torch.int64, device=device)


def _check(db_digits: torch.Tensor, query_eval: torch.Tensor, moduli: tuple) -> tuple[int, int]:
    """Validate the operands; returns (C, D)."""
    for name, x, dtype in (("digits", db_digits, torch.int8), ("query", query_eval, torch.int64)):
        if x.dtype != dtype:
            raise TypeError(f"int8 dim-0 needs {dtype} {name}, got {x.dtype}")
        if x.device.type != "cuda":
            raise ValueError(f"int8 dim-0 needs CUDA tensors, got {name} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"int8 dim-0 needs a contiguous {name} tensor")
    if db_digits.device != query_eval.device:
        raise ValueError(f"digits on {db_digits.device}, query on {query_eval.device}")
    if max(moduli) >= MAX_MODULUS:
        raise ValueError("int8 dim-0 kernel takes moduli below 2^56")
    D = dg.digit_count(moduli)
    if query_eval.dim() != 4 or db_digits.dim() != 4:
        raise ValueError(f"expected digits [L, N, D*C, K] and query [d0, P, L, N], got "
                         f"{tuple(db_digits.shape)} and {tuple(query_eval.shape)}")
    d0, P, L, N = query_eval.shape
    rows, K = db_digits.shape[2:]
    if tuple(db_digits.shape[:2]) != (L, N) or rows % D or K != padded_depth(d0) or L != len(moduli):
        raise ValueError(f"digits {tuple(db_digits.shape)} do not fit query {tuple(query_eval.shape)} "
                         f"with {len(moduli)} moduli of {D} digits")
    if N % N_TILE:
        raise ValueError(f"int8 dim-0 kernel takes N a multiple of {N_TILE}, got {N}")
    dg.assert_int32_partial_bound(d0, D)
    return rows // D, D


def dim0_int8(db_digits: torch.Tensor, query_eval: torch.Tensor, ct_ctx) -> torch.Tensor:
    """db_digits [L, N, D * C, K] int8 (serving.pack_database_chunk_digits),
    query_eval [d0, P, L, N] int64 in [0, q) -> [C, P, L, N] int64 in
    [0, q), bit-identical to serving.dim0_inner_products."""
    moduli = tuple(ct_ctx.moduli)
    C, D = _check(db_digits, query_eval, moduli)
    d0, P, L, N = query_eval.shape
    out = torch.empty((C, P, L, N), dtype=torch.int64, device=query_eval.device)
    q, barrett = _constants(moduli, query_eval.device)
    err = _library().she_dim0_int8(
        db_digits.data_ptr(), query_eval.data_ptr(), out.data_ptr(), q.data_ptr(), barrett.data_ptr(),
        C, D, d0, db_digits.shape[3], P, L, N, torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"she_dim0_int8 launch failed with CUDA error {err}")
    launches["dim0_int8"] += 1
    launch_shapes[(tuple(db_digits.shape), tuple(query_eval.shape), moduli)] += 1
    return out
