"""Launch wrapper for the dim-0 MAC kernel (csrc/dim0_mac.cu).

The kernel replaces the lazy multiply-add streams that she_tpu leaves to
XLA to fuse in the dim-0 inner products (she_tpu/pir/serving.py:318,344),
the PNNS BSGS products (she_tpu/pnns/serving.py:52,75) and
bfv.inner_product_ct_pt (she_tpu/bfv/bfv.py:876); ops/dim0_mac.py holds
its plain version and the dispatch. The wrapper checks its operands,
allocates the output with torch.empty, launches on
torch.cuda.current_stream() and raises if the launch reports a CUDA error;
there is no fallback. Each launch is counted in the tracer's registry as
launch.dim0_mac (an empty output launches nothing) and, while tracing is
on, by MacKey, so a run can
show that its MACs went through the kernel and time each shape it used.

Both operands are read in place: a [*M1, J, L, N] and b [J, *M2, L, N],
each passed as its base pointer with the sizes and strides of its batch
axes (at most key_switch_cuda.MAX_BATCH_AXES), the stride of its j axis
and of its RNS axis; the last axis must be contiguous (the kernel loads
one coefficient a thread, so no alignment beyond the word's). The moduli's
Barrett words floor(2^128 / q) are key_switch_cuda.constants' rows, made on
the host once per moduli and device. `plan` picks the launch on the host:
the instance by the moduli (`word_bits`: 32-bit words below 2^32, else two
limbs of `limb_shift` bits, three products a product below 2^60 and four
above), the rows of A a thread accumulates, the lanes of a block, the rows
of B a block walks and the depth of each thread's ring of B; `lazy_cap`
the products between reductions.
Everything but the operands' base pointers is made once per launch shape
(`_launch`), so a call costs the host little beside the launch.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from math import prod
from typing import NamedTuple

import torch

from .. import trace
from . import kernel_build
from .key_switch_cuda import MAX_BATCH_AXES, MAX_MODULUS, Operand, constants

MAX_CAP = (1 << 31) - 1
GROUPS = (1, 2, 4, 8, 12, 16)  # accumulators a thread keeps: the instances csrc/dim0_mac.cu builds
DEPTHS = (0, 1, 2)  # m2-steps of B in a thread's ring (0: the direct instance): the instances csrc/dim0_mac.cu builds
COLUMNS = 32  # coefficients a block (csrc/dim0_mac.cu kColumns)
MAX_THREADS = 256  # threads a block: COLUMNS x lanes
MAX_LANES = 8  # m2 a block works on at once, sharing its words of A
STEPS = 16  # m2 each lane walks
MAX_SHARED_BYTES = 227 * 1024  # the most shared memory an H100 block can have


class MacKey(NamedTuple):
    """What a launch is counted by in the tracer's shape table: the shapes and
    strides of both operands as read, and the moduli."""

    a_shape: tuple
    a_strides: tuple
    b_shape: tuple
    b_strides: tuple
    moduli: tuple


class MacPlan(NamedTuple):
    """How the kernel is launched: `word_bits` its instance (word_bits());
    `group` the rows of A (m1) a thread accumulates at once (M1 is split
    into ceil(M1 / group) groups); `lanes` the rows of COLUMNS threads of a
    block, which share its words of A; `run` the rows of B (m2) a block
    walks, lane y taking y, y + lanes, ...; `depth` the m2-steps of B a
    thread's ring holds (one of DEPTHS: the loads run depth - 1 steps
    ahead), 0 for the direct instance, which stages nothing and loads
    every word where it lies (for a J too deep for A and a ring)."""

    word_bits: int
    group: int
    lanes: int
    run: int
    depth: int



_VP = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong
_OP = ctypes.POINTER(Operand)
_ARGTYPES = [_OP, _LL, _OP, _LL, _VP, _LL, _LL, _INT, _INT, _INT, _VP, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _VP]


def _library():
    lib = kernel_build.load("dim0_mac")
    fn = lib.she_dim0_mac
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def limb_shift(moduli) -> int:
    """The 60- and 64-bit instances' limb width: a residue splits into a
    low limb of this many bits and a high limb below 2^shift (ceil(bits of
    the largest modulus / 2), at most 31)."""
    return max(1, -(-max(moduli).bit_length() // 2))


def word_bits(moduli) -> int:
    """The kernel's instance for these moduli: 32 where every modulus is
    below 2^32 (a product is one 32 x 32 -> 64-bit multiply-add); 60 where
    every modulus is below 2^60 (two limbs, three multiply-adds a product,
    Karatsuba); else 64 (two limbs, four)."""
    if max(moduli) < 1 << 32:
        return 32
    return 60 if limb_shift(moduli) <= 30 else 64


def lazy_cap(moduli, bits: int) -> int:
    """Products the `bits`-bit instance's sums take after a reduction, at
    most MAX_CAP. 32: the largest c with (q - 1) + c (q - 1)^2 < 2^64 for
    every modulus (1 near 2^32). 60 and 64, with limbs below 2^s (s =
    limb_shift) and a residue below 2^(2s) left in the sums by a reduction:
    the Karatsuba sum takes c products of limb sums below 2^(s + 1), so c =
    2^(62 - 2s) - 1 (63 at 55 bits); the four-product middle sum takes two
    products below 2^(2s) a product, so c = 2^(63 - 2s) - 1 (1 near
    2^62)."""
    if bits == 32:
        return min(MAX_CAP, *((((1 << 64) - q) // max((q - 1) ** 2, 1)) for q in moduli))
    return min(MAX_CAP, (1 << ((62 if bits == 60 else 63) - 2 * limb_shift(moduli))) - 1)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _instance(group: int) -> int:
    return next(g for g in GROUPS if g >= group)


def _shared_bytes(p: MacPlan, j: int) -> int:
    """The block's dynamic shared memory, as csrc/dim0_mac.cu's
    shared_bytes counts it: the offsets, the group's words of A (padded to
    its instance) and each lane's ring of B."""
    mg = _instance(p.group)
    staged = (4 if p.word_bits == 32 else 8) * COLUMNS * j * (mg + p.lanes * p.depth) if p.depth else 0
    return 8 * (mg + p.run) + staged


def plan(m1: int, m2: int, j: int, moduli) -> MacPlan:
    """The launch for a [m1, j] x [j, m2] MAC (blocks of COLUMNS
    coefficients of one RNS row): all of M1 in one group where it fits 16
    accumulators, else as few groups as cover it; up to MAX_LANES m2 at
    once, each lane walking up to STEPS m2 through a ring of two steps (the
    fastest of tools/mac_floor_turns.py's sweep at the w64 and PNNS shapes
    on an H100); fewer lanes where the group's words of A and the rings
    would pass a block's shared memory, and the direct instance where even
    one lane's would."""
    bits = word_bits(moduli)
    group, lanes = _ceil(m1, _ceil(m1, GROUPS[-1])), min(MAX_LANES, m2)

    def with_lanes(lanes: int, staged: bool = True) -> MacPlan:
        run = min(m2, lanes * STEPS)
        return MacPlan(bits, group, lanes, run, (2 if run > lanes else 1) if staged else 0)

    p = with_lanes(lanes)
    while _shared_bytes(p, j) > MAX_SHARED_BYTES:
        p = with_lanes(p.lanes // 2) if p.lanes > 1 else with_lanes(lanes, staged=False)
    return p


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _operand(batch: list, strides: list, lstride: int, what: str) -> Operand:
    """An Operand of these batch axes and RNS stride; its base is set at
    each call."""
    if len(batch) > MAX_BATCH_AXES:
        raise ValueError(f"{what} has {len(batch)} batch axes, the kernel takes {MAX_BATCH_AXES}")
    op = Operand()
    op.nd = len(batch)
    for d, (n, s) in enumerate(zip(batch, strides)):
        op.size[d], op.stride[d] = n, s
    op.index = None
    op.lstride = lstride
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


def _check_plan(p: MacPlan, moduli, j: int) -> None:
    if p.word_bits not in (32, 60, 64) or p.word_bits < word_bits(moduli):
        raise ValueError(f"the {p.word_bits}-bit instance does not take moduli {moduli}")
    if (not 1 <= p.group <= GROUPS[-1] or p.run < 1 or p.depth not in DEPTHS or p.lanes < 1
            or COLUMNS * p.lanes > MAX_THREADS):
        raise ValueError(f"plan {p} is not one the kernel takes")
    if _shared_bytes(p, j) > MAX_SHARED_BYTES:
        raise ValueError(f"plan {p} needs more shared memory than a block has")


class _Launch(NamedTuple):
    """What a launch shape needs beside its operands' base pointers, made
    once per shape (the host's cost of a call is most of a small MAC's
    time): the output's shape, the Operand structs (bases filled in at
    each call) and the rest of the C call's arguments."""

    out_shape: tuple
    ops: tuple
    args: list
    consts: torch.Tensor


@lru_cache(maxsize=1024)
def _launch(key: MacKey, device: torch.device, launch_plan: MacPlan | None) -> _Launch:
    a_shape, a_strides, b_shape, b_strides, moduli = key
    L, degree, J = len(moduli), a_shape[-1], a_shape[-3]
    if tuple(a_shape[-2:]) != (L, degree) or tuple(b_shape[-2:]) != (L, degree) or b_shape[0] != J:
        raise ValueError(f"a [..., J, {L}, N] and b [J, ..., {L}, N] must agree, got {a_shape} and {b_shape}")
    if J < 1:
        raise ValueError("an empty sum of products")
    if max(moduli) >= MAX_MODULUS or min(moduli) < 2:
        raise ValueError(f"the dim-0 MAC takes moduli in [2, 2^62), got {moduli}")
    m1_shape, m2_shape = a_shape[:-3], b_shape[1:-2]
    op_a = _operand(list(m1_shape), list(a_strides[:-3]), a_strides[-2], "a")
    op_b = _operand(list(m2_shape), list(b_strides[1:-2]), b_strides[-2], "b")
    m1, m2 = prod(m1_shape), prod(m2_shape)
    p = launch_plan or plan(m1, m2, J, moduli)
    _check_plan(p, moduli, J)
    consts = constants(moduli, device)
    args = [ctypes.byref(op_a), a_strides[-3], ctypes.byref(op_b), b_strides[0], None, m1, m2, J, L, degree,
            consts.data_ptr(), lazy_cap(moduli, p.word_bits), limb_shift(moduli), p.word_bits, p.group, p.lanes,
            p.run, p.depth, None]
    return _Launch(m1_shape + m2_shape + (L, degree), (op_a, op_b), args, consts)


def dim0_mac(a: torch.Tensor, b: torch.Tensor, moduli: tuple, launch_plan: MacPlan | None = None) -> torch.Tensor:
    """a [*M1, J, L, N], b [J, *M2, L, N] (each read in place) ->
    [*M1, *M2, L, N] contiguous: sum over j of a[m1, j] * b[j, m2] mod
    q_l, fully reduced. launch_plan: by default plan(M1, M2, J,
    moduli)."""
    _check(a, "a")
    _check(b, "b")
    if b.device != a.device:
        raise ValueError(f"b on {b.device}, a on {a.device}")
    key = MacKey(tuple(a.shape), a.stride(), tuple(b.shape), b.stride(), tuple(moduli))
    launch = _launch(key, a.device, launch_plan)
    out = torch.empty(launch.out_shape, dtype=torch.int64, device=a.device)
    if out.numel():
        op_a, op_b = launch.ops
        op_a.base, op_b.base = a.data_ptr(), b.data_ptr()
        args = launch.args
        args[4], args[-1] = out.data_ptr(), _stream()
        err = _library().she_dim0_mac(*args)
        if err != 0:
            raise RuntimeError(f"she_dim0_mac launch failed with CUDA error {err}")
        if trace.launch("dim0_mac"):
            trace.count_shape("dim0_mac", key)
    return out
