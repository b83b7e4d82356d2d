"""Launch wrapper for the dim-0 MAC kernel (csrc/dim0_mac.cu).

The kernel replaces the lazy multiply-add streams that she_tpu leaves to
XLA to fuse in the dim-0 inner products (she_tpu/pir/serving.py:318,344),
the PNNS BSGS products (she_tpu/pnns/serving.py:52,75) and
bfv.inner_product_ct_pt (she_tpu/bfv/bfv.py:876); ops/dim0_mac.py holds
its plain version and the dispatch. The wrapper checks its operands,
allocates the output with torch.empty, launches on
torch.cuda.current_stream() and raises if the launch reports a CUDA error;
there is no fallback. `launches` counts the launches (an empty output
launches nothing) and `launch_shapes` counts them by MacKey, so a run can
show that its MACs went through the kernel and time each shape it used.

Both operands are read in place: a [*M1, J, L, N] and b [J, *M2, L, N],
each passed as its base pointer with the sizes and strides of its batch
axes (at most key_switch_cuda.MAX_BATCH_AXES), the stride of its j axis
and of its RNS axis; the last axis must be contiguous (the kernel loads
one coefficient a thread, so no alignment beyond the word's). The moduli's
Barrett words floor(2^128 / q) are key_switch_cuda.constants' rows, made on
the host once per moduli and device; the lazy count `cap` is made there too.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple

import torch

from . import kernel_build
from .key_switch_cuda import MAX_BATCH_AXES, MAX_MODULUS, Operand, constants

MAX_CAP = (1 << 31) - 1
TILES = ((1, 1), (1, 2), (1, 4), (2, 1), (2, 2))  # (mt, m2t): the instances csrc/dim0_mac.cu builds


class MacKey(NamedTuple):
    """What a launch is counted by in `launch_shapes`: the shapes and
    strides of both operands as read, and the moduli."""

    a_shape: tuple
    a_strides: tuple
    b_shape: tuple
    b_strides: tuple
    moduli: tuple


launches = {"dim0_mac": 0}
launch_shapes: Counter = Counter()

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong
_OP = ctypes.POINTER(Operand)
_ARGTYPES = [_OP, _LL, _OP, _LL, _VP, _LL, _LL, _INT, _INT, _INT, _VP, _INT, _INT, _INT, _VP]


def reset_launches() -> None:
    launches["dim0_mac"] = 0
    launch_shapes.clear()


def _library():
    lib = kernel_build.load("dim0_mac")
    fn = lib.she_dim0_mac
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def lazy_cap(moduli) -> int:
    """Products a 128-bit accumulator takes after a reduction: the largest
    c with (q - 1) + c (q - 1)^2 < 2^128 for every modulus (16 near
    2^62), at most MAX_CAP."""
    return min(MAX_CAP, *(((1 << 128) - q) // max((q - 1) ** 2, 1) for q in moduli))


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def tile(m1: int, m2: int) -> tuple[int, int]:
    """The kernel's tile (mt, m2t), one of TILES: rows of A and of B a
    thread accumulates. 2 x 2 was the fastest at the w64 and PNNS shapes
    on an H100 (tools/dim0_mac_tiles.py; wider tiles hold too many
    registers for the SM to keep enough threads in flight, PERF.md).
    Smaller operands take the smaller tile that covers them."""
    mt = min(2, _pow2_at_least(m1))
    return mt, min(4 // mt, _pow2_at_least(m2))


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _operand(x: torch.Tensor, batch: list, strides: list, what: str) -> Operand:
    if len(batch) > MAX_BATCH_AXES:
        raise ValueError(f"{what} has {len(batch)} batch axes, the kernel takes {MAX_BATCH_AXES}")
    op = Operand()
    op.base = x.data_ptr()
    op.nd = len(batch)
    for d, (n, s) in enumerate(zip(batch, strides)):
        op.size[d], op.stride[d] = n, s
    op.index = None
    op.lstride = x.stride(-2)
    return op


def _check(x: torch.Tensor, what: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what} must be a tensor")
    if x.dtype != torch.int64:
        raise TypeError(f"{what} must be int64, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {x.device}")
    if x.dim() < 3:
        raise ValueError(f"{what} must have a j axis, an RNS axis and a coefficient axis, got {tuple(x.shape)}")
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        raise ValueError(f"{what} needs a contiguous last axis")


def dim0_mac(a: torch.Tensor, b: torch.Tensor, moduli: tuple, tile_shape: tuple | None = None) -> torch.Tensor:
    """a [*M1, J, L, N], b [J, *M2, L, N] (each read in place) ->
    [*M1, *M2, L, N] contiguous: sum over j of a[m1, j] * b[j, m2] mod
    q_l, fully reduced. tile_shape: one of TILES, by default tile(m1, m2)."""
    if tile_shape is not None and tuple(tile_shape) not in TILES:
        raise ValueError(f"tile {tile_shape} is not built; the kernel has {TILES}")
    _check(a, "a")
    _check(b, "b")
    if b.device != a.device:
        raise ValueError(f"b on {b.device}, a on {a.device}")
    L, degree, J = len(moduli), a.shape[-1], a.shape[-3]
    if tuple(a.shape[-2:]) != (L, degree) or tuple(b.shape[-2:]) != (L, degree) or b.shape[0] != J:
        raise ValueError(f"a [..., J, {L}, N] and b [J, ..., {L}, N] must agree, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if J < 1:
        raise ValueError("an empty sum of products")
    if max(moduli) >= MAX_MODULUS or min(moduli) < 2:
        raise ValueError(f"the dim-0 MAC takes moduli in [2, 2^62), got {moduli}")
    m1_shape, m2_shape = tuple(a.shape[:-3]), tuple(b.shape[1:-2])
    op_a = _operand(a, list(m1_shape), list(a.stride()[:-3]), "a")
    op_b = _operand(b, list(m2_shape), list(b.stride()[1:-2]), "b")
    out = torch.empty(m1_shape + m2_shape + (L, degree), dtype=torch.int64, device=a.device)
    m1, m2 = out.shape[:len(m1_shape)].numel(), out.shape[len(m1_shape):-2].numel()
    if out.numel():
        mt, m2t = tile_shape or tile(m1, m2)
        err = _library().she_dim0_mac(ctypes.byref(op_a), a.stride(-3), ctypes.byref(op_b), b.stride(0),
                                      out.data_ptr(), m1, m2, J, L, degree, constants(moduli, a.device).data_ptr(),
                                      lazy_cap(moduli), mt, m2t, _stream())
        if err != 0:
            raise RuntimeError(f"she_dim0_mac launch failed with CUDA error {err}")
        launches["dim0_mac"] += 1
        launch_shapes[MacKey(tuple(a.shape), tuple(a.stride()), tuple(b.shape), tuple(b.stride()), moduli)] += 1
    return out
