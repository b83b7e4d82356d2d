"""Launch wrappers for the CUDA NTT kernels (csrc/ntt.cu).

The kernels replace she_tpu/ops/ntt_pallas.py:_fwd_kernel / _inv_kernel.
Each wrapper checks its input, allocates the output with torch.empty,
launches on torch.cuda.current_stream() and raises if the launch reports a
CUDA error. There is no fallback: a tensor the kernel does not take raises.
The kernel's word is `tables.word_bits` (ops/ntt.ntt_word_bits): 32-bit
words with the tables of `tables.w32` when every modulus is below 2^30,
64-bit words with the int64 tables otherwise; both are kernels. The
largest modulus' bit length goes along: on 64-bit words at N = 8192 the
kernel runs lazily below 2^58 (csrc/ntt.cu, kLazyBits).
Each launch is counted in the tracer's registry as launch.ntt_forward or
launch.ntt_inverse, so a run can show that its NTTs went through the
kernels; while tracing is on also by LaunchKey (direction, input shape,
moduli, tables.block), so a run can time each shape and each kind of table
(a sharded NTT's block tables) it used.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import trace
from . import kernel_build


class LaunchKey(NamedTuple):
    """What a launch is counted by in the tracer's shape table."""

    name: str  # "ntt_forward" or "ntt_inverse"
    shape: tuple
    moduli: tuple
    block: tuple | None  # (degree, blocks, block) of block tables, else None


MAX_LOG2N = 13  # one row in shared memory: 8192 u64 = 64 KB
MAX_MODULUS = 1 << 62  # Harvey lazy range [0, 4q) must fit 64 bits

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_FWD_ARGS = [_VP, _VP, ctypes.c_longlong, _INT, _INT, _INT, _INT] + [_VP] * 4
_INV_ARGS = [_VP, _VP, ctypes.c_longlong, _INT, _INT, _INT, _INT] + [_VP] * 8


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
    if x.dtype != torch.int64:
        raise TypeError(f"CUDA NTT needs int64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("CUDA NTT needs a contiguous tensor")
    if x.device.type != "cuda":
        raise ValueError(f"CUDA NTT needs a CUDA tensor, got {x.device}")
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


def _words(tables):
    """The tables of the kernel's word: the 32-bit ones or the int64 ones."""
    return tables.w32 if tables.word_bits == 32 else tables


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy of it where its data is not 16-byte aligned: the 64-bit
    kernel at N = 8192 reads each row with one bulk copy, which takes
    16-byte aligned addresses (a contiguous view at an odd offset is not)."""
    return x.clone() if x.data_ptr() % 16 else x


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def forward(x: torch.Tensor, tables) -> torch.Tensor:
    """Forward NTT of int64 [..., L, N] in [0, q) -> Eval form in [0, q)."""
    log2n = _check(x, tables)
    y = torch.empty_like(x)
    rows = x.numel() >> log2n
    if rows == 0:
        return y
    x = _aligned(x)
    w = _words(tables)
    err = _library().she_ntt_forward(
        x.data_ptr(), y.data_ptr(), rows, len(tables.moduli), log2n, tables.word_bits,
        max(tables.moduli).bit_length(), w.roots.data_ptr(), w.roots_shoup.data_ptr(), w.q.data_ptr(), _stream(),
    )
    if err != 0:
        raise RuntimeError(f"she_ntt_forward launch failed with CUDA error {err}")
    if trace.launch("ntt_forward"):
        trace.count_shape("ntt_forward", LaunchKey("ntt_forward", tuple(x.shape), tables.moduli, tables.block))
    return y


def inverse(x: torch.Tensor, tables) -> torch.Tensor:
    """Inverse NTT of int64 [..., L, N] in [0, q) -> Coeff form in [0, q)."""
    log2n = _check(x, tables)
    y = torch.empty_like(x)
    rows = x.numel() >> log2n
    if rows == 0:
        return y
    x = _aligned(x)
    w = _words(tables)
    err = _library().she_ntt_inverse(
        x.data_ptr(), y.data_ptr(), rows, len(tables.moduli), log2n, tables.word_bits,
        max(tables.moduli).bit_length(), w.inv_roots.data_ptr(), w.inv_roots_shoup.data_ptr(), w.q.data_ptr(),
        w.n_inv.data_ptr(), w.n_inv_shoup.data_ptr(), w.n_inv_w.data_ptr(),
        w.n_inv_w_shoup.data_ptr(), _stream(),
    )
    if err != 0:
        raise RuntimeError(f"she_ntt_inverse launch failed with CUDA error {err}")
    if trace.launch("ntt_inverse"):
        trace.count_shape("ntt_inverse", LaunchKey("ntt_inverse", tuple(x.shape), tables.moduli, tables.block))
    return y
