"""Launch wrappers for the CUDA NTT kernels (csrc/ntt.cu).

The kernels replace she_tpu/ops/ntt_pallas.py:_fwd_kernel / _inv_kernel.
Each wrapper checks its input, allocates the output with torch.empty,
launches on torch.cuda.current_stream() and raises if the launch reports a
CUDA error. There is no fallback: a tensor the kernel does not take raises.
`launches` counts each launch per direction, so a run can show that its
NTTs went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernel_build

launches = {"ntt_forward": 0, "ntt_inverse": 0}

MAX_LOG2N = 13  # one row in shared memory: 8192 u64 = 64 KB
MAX_MODULUS = 1 << 62  # Harvey lazy range [0, 4q) must fit 64 bits

_VP = ctypes.c_void_p
_FWD_ARGS = [_VP, _VP, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _VP, _VP, _VP, _VP]
_INV_ARGS = [_VP, _VP, ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [_VP] * 8


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _library():
    lib = kernel_build.load("ntt")
    if lib.she_ntt_forward.argtypes is None:
        lib.she_ntt_forward.argtypes = _FWD_ARGS
        lib.she_ntt_forward.restype = ctypes.c_int
        lib.she_ntt_inverse.argtypes = _INV_ARGS
        lib.she_ntt_inverse.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, tables) -> int:
    """Validate x against the tables; returns log2(N)."""
    if x.device.type != "cuda":
        raise ValueError(f"CUDA NTT needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"CUDA NTT needs int64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("CUDA NTT needs a contiguous tensor")
    L, n = len(tables.moduli), tables.degree
    if x.dim() < 2 or tuple(x.shape[-2:]) != (L, n):
        raise ValueError(f"CUDA NTT expects [..., {L}, {n}], got {tuple(x.shape)}")
    if tables.q.device != x.device:
        raise ValueError(f"tables on {tables.q.device}, data on {x.device}")
    log2n = n.bit_length() - 1
    if n != 1 << log2n or not 1 <= log2n <= MAX_LOG2N:
        raise ValueError(f"CUDA NTT takes power-of-two N in [2, 8192], got {n}")
    if max(tables.moduli) >= MAX_MODULUS:
        raise ValueError("CUDA NTT takes moduli below 2^62")
    return log2n


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def forward(x: torch.Tensor, tables) -> torch.Tensor:
    """Forward NTT of int64 [..., L, N] in [0, q) -> Eval form in [0, q)."""
    log2n = _check(x, tables)
    y = torch.empty_like(x)
    rows = x.numel() >> log2n
    if rows == 0:
        return y
    err = _library().she_ntt_forward(
        x.data_ptr(), y.data_ptr(), rows, len(tables.moduli), log2n,
        tables.roots.data_ptr(), tables.roots_shoup.data_ptr(),
        tables.q.data_ptr(), _stream(),
    )
    if err != 0:
        raise RuntimeError(f"she_ntt_forward launch failed with CUDA error {err}")
    launches["ntt_forward"] += 1
    return y


def inverse(x: torch.Tensor, tables) -> torch.Tensor:
    """Inverse NTT of int64 [..., L, N] in [0, q) -> Coeff form in [0, q)."""
    log2n = _check(x, tables)
    y = torch.empty_like(x)
    rows = x.numel() >> log2n
    if rows == 0:
        return y
    err = _library().she_ntt_inverse(
        x.data_ptr(), y.data_ptr(), rows, len(tables.moduli), log2n,
        tables.inv_roots.data_ptr(), tables.inv_roots_shoup.data_ptr(),
        tables.q.data_ptr(), tables.n_inv.data_ptr(), tables.n_inv_shoup.data_ptr(),
        tables.n_inv_w.data_ptr(), tables.n_inv_w_shoup.data_ptr(), _stream(),
    )
    if err != 0:
        raise RuntimeError(f"she_ntt_inverse launch failed with CUDA error {err}")
    launches["ntt_inverse"] += 1
    return y
