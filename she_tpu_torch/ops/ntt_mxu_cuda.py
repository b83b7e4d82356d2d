"""Launch wrapper for the fused matrix NTT kernel (csrc/ntt_mxu.cu).

The kernel replaces she_tpu/ops/ntt_mxu.py:310 _phase_row and :330
_phase_block: a whole direction of the matrix NTT (ops/ntt_mxu.py) in one
launch, the row product by Lf (Li), the twist and the block product by the
shared R_f (R_i) as int8 x int8 -> int32 digit products on the tensor cores
(wgmma), recombined and reduced mod q on the way. The wrapper checks its
inputs, takes the kernel's operand images from the tables (made with them,
by `kernel_operands`), allocates the output with torch.empty, launches
on torch.cuda.current_stream() and raises if the launch reports a CUDA
error. There is no fallback: a tensor the kernel does not take raises.
Each launch (one a direction) is counted in the tracer's registry as
launch.ntt_mxu and, while tracing is on, by DirectionKey (direction, input
shape, moduli), so a run can check and time each shape it used.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple

import torch

from .. import trace
from . import kernel_build


class DirectionKey(NamedTuple):
    """What a launch is counted by in the tracer's shape table."""

    direction: str  # "forward" or "inverse"
    shape: tuple
    moduli: tuple


DIRECTIONS = ("forward", "inverse")
BLOCK = 64
MAX_DIGITS = 9
MAX_MODULUS = 1 << 62
MAX_ROWS = 128  # A = N / 64: N up to 8192
MAX_GROUPS = 65535  # L * A
CHUNK_BITS = 42  # the kernel joins 64-bit chunks of six digit weights: r <- r 2^42 + chunk mod q
OUTPUTS_PER_THREAD = 16  # a warpgroup's 64 x 32 tile of a unit over its 128 threads

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_ARGS = [_VP] * 6 + [_INT] * 5 + [ctypes.c_longlong, _VP]


def _library():
    lib = kernel_build.load("ntt_mxu")
    if lib.she_ntt_mxu.argtypes is None:
        lib.she_ntt_mxu.argtypes = _ARGS
        lib.she_ntt_mxu.restype = ctypes.c_int
    return lib


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def shoup_constants(w: torch.Tensor, moduli) -> torch.Tensor:
    """floor(w 2^64 / q_l) of int64 w [L, ...] in [0, q_l), as unsigned bits
    in int64 (computed on the host, exactly)."""
    rows = []
    for l, q in enumerate(moduli):
        rows.append([_signed((int(v) << 64) // q) for v in w[l].reshape(-1).tolist()])
    return torch.tensor(rows, dtype=torch.int64).view(w.shape)


def constants(moduli: tuple, device: torch.device) -> torch.Tensor:
    """int64 [5, L] on the device (unsigned bits reinterpreted): q_l,
    floor(2^64 / q_l), w = 2^42 mod q_l, floor(w 2^64 / q_l) and the bits of
    1 / q_l in float64 (the D <= 4 reductions' quotient estimate)."""
    w42 = [(1 << CHUNK_BITS) % q for q in moduli]
    inv = [struct.unpack("<Q", struct.pack("<d", 1.0 / q))[0] for q in moduli]
    rows = [list(moduli), [(1 << 64) // q for q in moduli], w42, [(w << 64) // q for w, q in zip(w42, moduli)], inv]
    return torch.tensor([[_signed(v) for v in r] for r in rows], dtype=torch.int64, device=device)


def lazy(moduli, digits: int) -> bool:
    """Whether values in [0, 2 max(q)) still split into `digits` digits, so
    the intermediate between the two products may stay unreduced."""
    return 2 * max(moduli) <= 1 << 7 * digits


def operand_image(planes: torch.Tensor, rows: int, kbytes: int) -> torch.Tensor:
    """int8 digit planes [..., R, K] (R, K <= rows, kbytes) -> the image
    [..., rows * kbytes] of wgmma's K-major layout without swizzling, zero
    past R and K: element (r, k) at (r / 8) 8 kbytes + (k / 16) 128 + (r % 8)
    16 + k % 16 (8-row x 16-byte core matrices, K-adjacent ones 128 bytes
    apart)."""
    lead, (R, K) = planes.shape[:-2], planes.shape[-2:]
    padded = torch.zeros(lead + (rows, kbytes), dtype=torch.int8, device=planes.device)
    padded[..., :R, :K] = planes
    tiles = padded.reshape(lead + (rows // 8, 8, kbytes // 16, 16)).transpose(-3, -2)
    return tiles.reshape(lead + (rows * kbytes,)).contiguous()


def twist_table(twist: torch.Tensor, shoup: torch.Tensor, moduli, digits: int) -> torch.Tensor:
    """A direction's twist as the kernel reads it: int64 [L, A, 64, 2], s
    and floor(s 2^64 / q); at D <= 4 (moduli below 2^28) int64 [L, A, 64],
    s | floor(s 2^32 / q) << 32."""
    if digits > 4:
        return torch.stack((twist, shoup), dim=-1).contiguous()
    q = torch.tensor(moduli, dtype=torch.int64, device=twist.device).view(-1, 1, 1)
    return twist | ((twist << 32) // q) << 32


def kernel_operands(moduli, digits: int, Lf, Li, R_f, R_i, s_f, s_i, s_f_shoup, s_i_shoup) -> dict:
    """The kernel's operands, made once with the tables
    (ntt_mxu.build_mxu_tables, from its fields of the same names): each
    direction's row matrix planes [L, D, max(A, 64) * max(A, 32)], block
    matrix planes [L, D, 64 * 64] (operand_image) and twist (twist_table),
    and the constants."""
    A = Lf.shape[-1]
    rows, kbytes = max(A, BLOCK), max(A, 32)
    ops = dict(constants=constants(tuple(moduli), Lf.device))
    for direction, row, block, twist, shoup in (("forward", Lf, R_f, s_f, s_f_shoup),
                                                ("inverse", Li, R_i, s_i, s_i_shoup)):
        ops[direction] = (operand_image(row, rows, kbytes), operand_image(block, BLOCK, BLOCK),
                          twist_table(twist, shoup, moduli, digits))
    return ops


def _check(x: torch.Tensor, tables) -> int:
    """Validate the operands; returns the batch."""
    if x.dtype != torch.int64:
        raise TypeError(f"the matrix NTT kernel needs int64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the matrix NTT kernel needs a contiguous tensor")
    L, n, A, D = len(tables.moduli), tables.degree, tables.A, tables.D
    if x.dim() < 2 or tuple(x.shape[-2:]) != (L, n):
        raise ValueError(f"the matrix NTT kernel expects [..., {L}, {n}], got {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"the matrix NTT kernel needs a CUDA tensor, got {x.device}")
    for name, want in (("Lf", (L, D, A, A)), ("Li", (L, D, A, A)), ("R_f", (L, D, BLOCK, BLOCK)),
                       ("R_i", (L, D, BLOCK, BLOCK))):
        m = getattr(tables, name)
        if m.dtype != torch.int8 or tuple(m.shape) != want:
            raise ValueError(f"{name} must be int8 {want}, got {m.dtype} {tuple(m.shape)}")
        if m.device != x.device or tables.operands["constants"].device != x.device:
            raise ValueError(f"tables on {m.device}, data on {x.device}")
    if not 2 <= A <= MAX_ROWS or A & (A - 1) or n != BLOCK * A:
        raise ValueError(f"the matrix NTT kernel takes N = 128 .. 8192, got {n}")
    if not 1 <= D <= MAX_DIGITS or max(tables.moduli) >= MAX_MODULUS:
        raise ValueError("the matrix NTT kernel takes moduli below 2^62 (at most 9 digits)")
    if L * A > MAX_GROUPS:
        raise ValueError(f"the matrix NTT kernel takes L * A <= {MAX_GROUPS}, got L = {L}, A = {A}")
    return x.numel() // (L * n)


def _launch(x: torch.Tensor, tables, direction: str) -> torch.Tensor:
    batch = _check(x, tables)
    out = torch.empty_like(x)
    if batch == 0:
        return out
    if x.data_ptr() % 16:  # the kernel reads 16 bytes at a time
        x = x.clone()
    ops = tables.operands
    row, block, twist = ops[direction]
    moduli, D, A = tuple(tables.moduli), tables.D, tables.A
    err = _library().she_ntt_mxu(
        row.data_ptr(), block.data_ptr(), twist.data_ptr(), ops["constants"].data_ptr(), x.data_ptr(),
        out.data_ptr(), D, A, len(moduli), int(direction == "forward"), int(lazy(moduli, D)), batch,
        torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"she_ntt_mxu launch failed with CUDA error {err}")
    if trace.launch("ntt_mxu"):
        trace.count_shape("ntt_mxu", DirectionKey(direction, tuple(x.shape), moduli))
    return out


def ntt_mxu_forward(x: torch.Tensor, tables) -> torch.Tensor:
    """The forward matrix NTT in one launch: x int64 [..., L, N] in [0, q)
    -> Eval form [..., L, N] in [0, q), bit-identical to
    ntt_mxu.forward_factored_plain (tables: ntt_mxu.MxuNttTables)."""
    return _launch(x, tables, "forward")


def ntt_mxu_inverse(x: torch.Tensor, tables) -> torch.Tensor:
    """The inverse matrix NTT in one launch: Eval form -> Coeff form,
    bit-identical to ntt_mxu.inverse_factored_plain."""
    return _launch(x, tables, "inverse")
