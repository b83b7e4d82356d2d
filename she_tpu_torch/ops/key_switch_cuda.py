"""Launch wrappers for the key-switch kernels (csrc/key_switch.cu).

The kernels replace the passes that she_tpu leaves to XLA to fuse in a key
switch (she_tpu/bfv/keys.py:270-363, ops/galois.py:61, core/poly.py:207,
bfv/bfv.py:796-840): on the fused route (fused_shape: every key-switching
modulus below 2^30, 8 <= N <= 4096, at most FUSED_MAX_MODULI moduli) two
kernels, ks_digits_ntt_mac and ks_intt_finish, whose products cross
between them as 32-bit words; on the split route ks_digits, ks_mac and
ks_finish around the NTT kernels (ops/ntt_cuda.py). They also replace
the passes in an expansion level (pir/serving.py:160-171:
the combine, and the leaves written by its leaf instance) and in the mod
switch (bfv/bfv.py:694,707 over core/poly.py:207);
ops/key_switch.py holds their plain versions and the dispatch. Each
wrapper checks its operands, allocates its output with torch.empty,
launches on torch.cuda.current_stream() and raises if the launch reports a
CUDA error; there is no fallback. Each launch is counted in the tracer's
registry (launch.<kernel>) and, while tracing is on, by KsKey, so a run can
show that its key switches went through the kernels and time each shape it
used.

An operand the kernels read in place (c1, c0 and the source's c1, which
may be views of a stacked ciphertext or of the expansion's slot pool) is
passed as its base pointer with the sizes and strides of its batch axes
(at most MAX_BATCH_AXES), the stride of its RNS axis and, for the slot
pool, an index array that maps axis 0; its last axis must be contiguous,
its strides even and its base 16-byte aligned (the kernels load two
coefficients at a time). The moduli's constants (q, floor(2^128 / q),
and for the divide-and-round floor(q_ks / 2) mod q_i and q_ks^-1 mod q_i
with its Shoup constant) are made on the host once per moduli and device;
the mod switch's, one such table a dropped modulus, once per moduli,
target and device, and its launch once per shape (_mod_switch_launch).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from math import prod
from typing import NamedTuple

import torch

from .. import trace
from ..utils import nt
from . import kernel_build

MAX_LOG2N = 13
MAX_MODULUS = 1 << 62
MAX_BATCH_AXES = 6
CONST_WORDS = 8  # per modulus: q, r_lo, r_hi, half mod q, q_ks^-1 mod q, its Shoup constant, fold, 0
COMPS = 2  # the components of every key-switching key (bfv/keys.KeySwitchKey)
MAX_MOD_SWITCH_MODULI = 8  # the moduli a mod_switch input may have (csrc/key_switch.cu kMaxModSwitchRows)
# the fused pair (ks_digits_ntt_mac, ks_intt_finish): the NTT's 32-bit route
# (every modulus below 2^30), 8 <= N <= 2^12 (a row in one CTA's registers)
# and at most 8 key-switching moduli (csrc/key_switch.cu kMaxFusedModuli,
# kMinFusedLog2n, kMaxFusedLog2n)
FUSED_MAX_MODULUS = 1 << 30
FUSED_MIN_LOG2N = 3
FUSED_MAX_LOG2N = 12
FUSED_MAX_MODULI = 8


class KsKey(NamedTuple):
    """What a launch is counted by in the tracer's shape table: the kernel, the
    shape of its main input (c1 as read, fwd, inv, the products, the update), the
    key-switching moduli (the ciphertext moduli for expand_combine) and
    the kernel's variant: (element, slots) for ks_digits and
    ks_digits_ntt_mac, () for ks_mac, (element, c0 given, c1 given, slots)
    for ks_finish and ks_intt_finish, (shift, slots) for
    expand_combine, (shift, slots, outputs, a doubling mask given) for
    its leaf instance, expand_leaves, (target moduli count, the input's
    strides) for mod_switch; slots is the size of an indexed operand's
    axis 0, else None."""

    name: str
    shape: tuple
    moduli: tuple
    variant: tuple



class Operand(ctypes.Structure):
    _fields_ = [
        ("base", ctypes.c_void_p),
        ("nd", ctypes.c_int),
        ("size", ctypes.c_longlong * MAX_BATCH_AXES),
        ("stride", ctypes.c_longlong * MAX_BATCH_AXES),
        ("index", ctypes.c_void_p),
        ("lstride", ctypes.c_longlong),
    ]


_VP = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong
_U64 = ctypes.c_ulonglong
_OP = ctypes.POINTER(Operand)
_ARGTYPES = {
    "she_ks_digits": [_OP, _VP, _LL, _INT, _INT, _INT, _VP, _U64, _INT, _VP],
    "she_ks_mac": [_VP, _VP, _VP, _LL, _INT, _INT, _INT, _VP, _VP],
    "she_ks_finish": [_VP, _OP, _OP, _VP, _LL, _INT, _INT, _VP, _U64, _INT, _VP],
    "she_expand_combine": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _LL, _LL, _INT, _INT, _INT, _VP, _VP],
    "she_mod_switch": [_OP, _VP, _LL, _INT, _INT, _INT, _VP, _VP],
    "she_ks_digits_ntt_mac": [_OP, _VP, _VP, _LL, _INT, _INT, _VP, _U64, _INT, _VP, _VP, _VP, _VP],
    "she_ks_intt_finish": [_VP, _OP, _OP, _VP, _LL, _INT, _INT, _VP, _U64, _INT] + [_VP] * 8,
}


def _library():
    lib = kernel_build.load("key_switch")
    for name, args in _ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


@lru_cache(maxsize=None)
def constants(moduli: tuple, device: torch.device) -> torch.Tensor:
    """[L, CONST_WORDS] int64 (the bit patterns of unsigned words) on the
    device: per modulus q_i, floor(2^128 / q_i) as (lo, hi), and for every
    modulus but the last floor(q_last / 2) mod q_i, q_last^-1 mod q_i and
    its Shoup constant floor(q_last^-1 * 2^64 / q_i); and for q_i below
    2^32 the 32-bit Shoup constant floor((2^32 mod q_i) * 2^32 / q_i) that
    folds the high word of a 64-bit sum (the fused route's MAC)."""
    q_last = moduli[-1]
    rows = []
    for i, q in enumerate(moduli):
        ratio = (1 << 128) // q
        fold = ((1 << 32) % q << 32) // q if q < 1 << 32 else 0
        row = [q, ratio & ((1 << 64) - 1), ratio >> 64, 0, 0, 0, fold, 0]
        if i < len(moduli) - 1:
            inv = nt.inverse_mod(q_last % q, q)
            row[3:6] = [(q_last >> 1) % q, inv, (inv << 64) // q]
        rows.append([_signed(v) for v in row])
    return torch.tensor(rows, dtype=torch.int64, device=device)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_tensor(x: torch.Tensor, what: str, dtype=torch.int64) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what} must be a tensor")
    if x.dtype != dtype:
        raise TypeError(f"{what} must be {str(dtype).removeprefix('torch.')}, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {x.device}")


def _check_contiguous(x: torch.Tensor, what: str, dtype=torch.int64) -> None:
    _check_tensor(x, what, dtype)
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check_moduli(moduli: tuple, degree: int) -> int:
    """Returns log2(N)."""
    log2n = degree.bit_length() - 1
    if degree != 1 << log2n or not 1 <= log2n <= MAX_LOG2N:
        raise ValueError(f"the key-switch kernels take power-of-two N in [2, 8192], got {degree}")
    if max(moduli) >= MAX_MODULUS or min(moduli) < 2:
        raise ValueError(f"the key-switch kernels take moduli in [2, 2^62), got {moduli}")
    return log2n


def fused_shape(moduli: tuple, degree: int) -> bool:
    """Whether the fused pair takes a key switch over these key-switching
    moduli at this degree: every modulus below 2^30 (the NTT's 32-bit
    route, ops/ntt.ntt_word_bits), N a power of two from 8 to 4096 and at
    most FUSED_MAX_MODULI moduli."""
    return (max(moduli) < FUSED_MAX_MODULUS and 2 <= len(moduli) <= FUSED_MAX_MODULI
            and degree & (degree - 1) == 0 and 1 << FUSED_MIN_LOG2N <= degree <= 1 << FUSED_MAX_LOG2N)


def _check_fused(moduli: tuple, degree: int, tables, device) -> int:
    """The fused pair's moduli, degree and 32-bit NTT tables; returns log2(N)."""
    log2n = _check_moduli(moduli, degree)
    if not fused_shape(moduli, degree):
        raise ValueError(f"the fused key switch takes 2 to {FUSED_MAX_MODULI} moduli below 2^30 and N from "
                         f"{1 << FUSED_MIN_LOG2N} up to {1 << FUSED_MAX_LOG2N}, got moduli {moduli} at N = {degree}")
    if tuple(tables.moduli) != tuple(moduli) or tables.degree != degree or tables.word_bits != 32:
        raise ValueError(f"the fused key switch needs the 32-bit NTT tables of moduli {moduli} at N = {degree}")
    if tables.q.device != device:
        raise ValueError(f"tables on {tables.q.device}, data on {device}")
    return log2n


def _check_index(index, slots: int, device) -> None:
    if index.dtype != torch.int64 or index.dim() != 1 or not index.is_contiguous():
        raise ValueError("an index must be a contiguous 1-D int64 tensor")
    if index.device != device:
        raise ValueError(f"index on {index.device}, data on {device}")


def layout(shape: tuple, strides: tuple, L: int, degree: int, what: str = "operand", index_len: int | None = None):
    """The Operand of a [batch..., L, N] tensor of this shape and these
    strides, its base and index left to the caller, and the shape of the
    batch as the kernel sees it (axis 0 replaced by index_len where an
    index is given)."""
    if len(shape) < 2 or tuple(shape[-2:]) != (L, degree):
        raise ValueError(f"{what} must be [..., {L}, {degree}], got {tuple(shape)}")
    batch, batch_strides = list(shape[:-2]), list(strides[:-2])
    if strides[-1] != 1:
        raise ValueError(f"{what} needs a contiguous last axis")
    if any(s % 2 for n, s in zip(batch, batch_strides) if n != 1) or strides[-2] % 2:
        raise ValueError(f"{what} needs even strides and a 16-byte aligned base")
    if index_len is not None:
        if not batch:
            raise ValueError(f"an indexed {what} needs a batch axis")
        batch[0] = index_len
    if len(batch) > MAX_BATCH_AXES:
        raise ValueError(f"{what} has {len(batch)} batch axes, the kernels take {MAX_BATCH_AXES}")
    op = Operand()
    op.nd = len(batch)
    for d, (n, s) in enumerate(zip(batch, batch_strides)):
        op.size[d], op.stride[d] = n, s
    op.index = None
    op.lstride = strides[-2]
    return op, tuple(batch)


def operand(x: torch.Tensor, L: int, degree: int, index=None, what: str = "operand") -> tuple:
    """The Operand of x [batch..., L, N] read in place, and the shape of
    the batch as the kernel sees it (axis 0 replaced by the index's
    length where an index is given)."""
    _check_tensor(x, what)
    op, batch = layout(tuple(x.shape), x.stride(), L, degree, what, None if index is None else index.numel())
    if x.data_ptr() % 16:
        raise ValueError(f"{what} needs even strides and a 16-byte aligned base")
    if index is not None:
        _check_index(index, x.shape[0], x.device)
    op.base = x.data_ptr()
    op.index = None if index is None else index.data_ptr()
    return op, batch


def _pinv(element: int | None, degree: int) -> int:
    """element^-1 mod 2N: output k of the Galois gather reads
    t = k * element^-1 mod 2N, at t mod N, negated where t >= N."""
    if element is None:
        return 0
    if element % 2 == 0 or not 1 < element < 2 * degree:
        raise ValueError(f"invalid Galois element {element} for degree {degree}")
    return pow(element, -1, 2 * degree)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"she_{name} launch failed with CUDA error {err}")


def ks_digits(c1: torch.Tensor, moduli: tuple, element: int | None = None, index=None) -> torch.Tensor:
    """c1 [..., L_t, N] (read in place; index: its axis 0 gathered) ->
    [..., L_t, L_ks, N], L_ks = len(moduli) = L_t + 1."""
    L_ks, degree = len(moduli), c1.shape[-1]
    log2n = _check_moduli(moduli, degree)
    op, batch = operand(c1, L_ks - 1, degree, index, "c1")
    out = torch.empty(batch + (L_ks - 1, L_ks, degree), dtype=torch.int64, device=c1.device)
    m = out.numel() // ((L_ks - 1) * L_ks * degree)
    if m:
        err = _library().she_ks_digits(ctypes.byref(op), out.data_ptr(), m, L_ks - 1, L_ks, log2n,
                                       constants(moduli, c1.device).data_ptr(), _pinv(element, degree),
                                       int(element is not None), _stream())
        _raise_on(err, "ks_digits")
    if trace.launch("ks_digits"):
        trace.count_shape("ks_digits", KsKey("ks_digits", batch + (L_ks - 1, degree), moduli,
                                             (element, None if index is None else c1.shape[0])))
    return out


def ks_mac(fwd: torch.Tensor, key: torch.Tensor, moduli: tuple) -> torch.Tensor:
    """fwd [..., L_t, L_ks, N], key [L_t, 2, L_ks, N] (both contiguous)
    -> [..., 2, L_ks, N]."""
    L_ks, degree = len(moduli), fwd.shape[-1]
    log2n = _check_moduli(moduli, degree)
    if fwd.dim() < 3 or tuple(fwd.shape[-3:]) != (L_ks - 1, L_ks, degree):
        raise ValueError(f"fwd must be [..., {L_ks - 1}, {L_ks}, {degree}], got {tuple(fwd.shape)}")
    if tuple(key.shape) != (L_ks - 1, COMPS, L_ks, degree):
        raise ValueError(f"key must be [{L_ks - 1}, {COMPS}, {L_ks}, {degree}], got {tuple(key.shape)}")
    _check_contiguous(fwd, "fwd")
    _check_contiguous(key, "key")
    if key.device != fwd.device:
        raise ValueError(f"key on {key.device}, fwd on {fwd.device}")
    batch = tuple(fwd.shape[:-3])
    out = torch.empty(batch + (COMPS, L_ks, degree), dtype=torch.int64, device=fwd.device)
    m = fwd.numel() // ((L_ks - 1) * L_ks * degree)
    if m:
        err = _library().she_ks_mac(fwd.data_ptr(), key.data_ptr(), out.data_ptr(), m, L_ks - 1, L_ks, log2n,
                                    constants(moduli, fwd.device).data_ptr(), _stream())
        _raise_on(err, "ks_mac")
    if trace.launch("ks_mac"):
        trace.count_shape("ks_mac", KsKey("ks_mac", tuple(fwd.shape), moduli, ()))
    return out


def ks_finish(inv: torch.Tensor, moduli: tuple, c0=None, c1=None, element: int | None = None,
              index=None) -> torch.Tensor:
    """inv [..., 2, L_ks, N] (contiguous) -> [..., 2, L_t, N]: the
    divide-and-round by q_ks, then one of the three adds its callers make:
    none (the update alone), g(c0) into component 0 (c0 and a Galois
    element: apply_galois) or c0 and c1 into components 0 and 1 (no
    element: relinearize). c0 and c1 are read in place; index: their
    axis 0 gathered."""
    if (c0 is None, c1 is None, element is None) not in ((True, True, True), (False, True, False),
                                                         (False, False, True)):
        raise ValueError("ks_finish takes no addend, c0 with a Galois element, or c0 and c1 without one")
    if index is not None and c0 is None:
        raise ValueError("an index needs c0")
    L_ks, degree = len(moduli), inv.shape[-1]
    log2n = _check_moduli(moduli, degree)
    if inv.dim() < 3 or tuple(inv.shape[-3:]) != (COMPS, L_ks, degree):
        raise ValueError(f"inv must be [..., {COMPS}, {L_ks}, {degree}], got {tuple(inv.shape)}")
    _check_contiguous(inv, "inv")
    batch = tuple(inv.shape[:-3])
    ops = []
    for x, what in ((c0, "c0"), (c1, "c1")):
        if x is None:
            ops.append(None)
            continue
        op, b = operand(x, L_ks - 1, degree, index, what)
        if b != batch:
            raise ValueError(f"{what}'s batch {b} differs from inv's {batch}")
        if x.device != inv.device:
            raise ValueError(f"{what} on {x.device}, inv on {inv.device}")
        ops.append(op)
    out = torch.empty(batch + (COMPS, L_ks - 1, degree), dtype=torch.int64, device=inv.device)
    m = inv.numel() // (COMPS * L_ks * degree)
    if m:
        err = _library().she_ks_finish(
            inv.data_ptr(), None if ops[0] is None else ctypes.byref(ops[0]),
            None if ops[1] is None else ctypes.byref(ops[1]), out.data_ptr(), m, L_ks - 1, log2n,
            constants(moduli, inv.device).data_ptr(), _pinv(element, degree), int(element is not None), _stream())
        _raise_on(err, "ks_finish")
    if trace.launch("ks_finish"):
        slots = None if index is None else c0.shape[0]
        trace.count_shape("ks_finish", KsKey("ks_finish", tuple(inv.shape), moduli,
                                             (element, c0 is not None, c1 is not None, slots)))
    return out


def ks_digits_ntt_mac(c1: torch.Tensor, key: torch.Tensor, moduli: tuple, tables, element: int | None = None,
                      index=None) -> torch.Tensor:
    """The fused route's first kernel: c1 [..., L_t, N] (read in place;
    index: its axis 0 gathered) and the key rows [L_t, 2, L_ks, N] int32
    (contiguous) -> [..., 2, L_ks, N] int32, the products in the Eval
    domain (ks_digits, the forward NTT and ks_mac in one launch); `tables`
    are the moduli's NTT tables (their 32-bit ones are read)."""
    moduli = tuple(moduli)
    L_ks, degree = len(moduli), c1.shape[-1]
    log2n = _check_fused(moduli, degree, tables, c1.device)
    if tuple(key.shape) != (L_ks - 1, COMPS, L_ks, degree):
        raise ValueError(f"key must be [{L_ks - 1}, {COMPS}, {L_ks}, {degree}], got {tuple(key.shape)}")
    if key.dtype != torch.int32:
        raise TypeError(f"key must be int32, got {key.dtype}")
    op, batch = operand(c1, L_ks - 1, degree, index, "c1")
    _check_contiguous(key, "key", torch.int32)
    if key.device != c1.device:
        raise ValueError(f"key on {key.device}, c1 on {c1.device}")
    out = torch.empty(batch + (COMPS, L_ks, degree), dtype=torch.int32, device=c1.device)
    m = prod(batch)
    if m:
        w = tables.w32
        err = _library().she_ks_digits_ntt_mac(
            ctypes.byref(op), key.data_ptr(), out.data_ptr(), m, L_ks - 1, log2n,
            constants(moduli, c1.device).data_ptr(), _pinv(element, degree), int(element is not None),
            w.roots.data_ptr(), w.roots_shoup.data_ptr(), w.q.data_ptr(), _stream())
        _raise_on(err, "ks_digits_ntt_mac")
    if trace.launch("ks_digits_ntt_mac"):
        trace.count_shape("ks_digits_ntt_mac", KsKey("ks_digits_ntt_mac", batch + (L_ks - 1, degree), moduli,
                                                     (element, None if index is None else c1.shape[0])))
    return out


def ks_intt_finish(products: torch.Tensor, moduli: tuple, tables, c0=None, c1=None, element: int | None = None,
                   index=None) -> torch.Tensor:
    """The fused route's second kernel: products [..., 2, L_ks, N] int32
    (ks_digits_ntt_mac's, contiguous) -> [..., 2, L_t, N] int64: the
    inverse NTT, the divide-and-round by q_ks and ks_finish's adds (none,
    g(c0) with a Galois element, or c0 and c1 without one; c0 and c1 read
    in place, index: their axis 0 gathered) in one launch."""
    if (c0 is None, c1 is None, element is None) not in ((True, True, True), (False, True, False),
                                                         (False, False, True)):
        raise ValueError("ks_intt_finish takes no addend, c0 with a Galois element, or c0 and c1 without one")
    if index is not None and c0 is None:
        raise ValueError("an index needs c0")
    moduli = tuple(moduli)
    L_ks, degree = len(moduli), products.shape[-1]
    log2n = _check_fused(moduli, degree, tables, products.device)
    if products.dim() < 3 or tuple(products.shape[-3:]) != (COMPS, L_ks, degree):
        raise ValueError(f"products must be [..., {COMPS}, {L_ks}, {degree}], got {tuple(products.shape)}")
    _check_contiguous(products, "products", torch.int32)
    batch = tuple(products.shape[:-3])
    ops = []
    for x, what in ((c0, "c0"), (c1, "c1")):
        if x is None:
            ops.append(None)
            continue
        op, b = operand(x, L_ks - 1, degree, index, what)
        if b != batch:
            raise ValueError(f"{what}'s batch {b} differs from the products' {batch}")
        if x.device != products.device:
            raise ValueError(f"{what} on {x.device}, products on {products.device}")
        ops.append(op)
    out = torch.empty(batch + (COMPS, L_ks - 1, degree), dtype=torch.int64, device=products.device)
    m = prod(batch)
    if m:
        w = tables.w32
        err = _library().she_ks_intt_finish(
            products.data_ptr(), None if ops[0] is None else ctypes.byref(ops[0]),
            None if ops[1] is None else ctypes.byref(ops[1]), out.data_ptr(), m, L_ks - 1, log2n,
            constants(moduli, products.device).data_ptr(), _pinv(element, degree), int(element is not None),
            w.inv_roots.data_ptr(), w.inv_roots_shoup.data_ptr(), w.q.data_ptr(), w.n_inv.data_ptr(),
            w.n_inv_shoup.data_ptr(), w.n_inv_w.data_ptr(), w.n_inv_w_shoup.data_ptr(), _stream())
        _raise_on(err, "ks_intt_finish")
    if trace.launch("ks_intt_finish"):
        slots = None if index is None else c0.shape[0]
        trace.count_shape("ks_intt_finish", KsKey("ks_intt_finish", tuple(products.shape), moduli,
                                                  (element, c0 is not None, c1 is not None, slots)))
    return out


def expand_combine(pool: torch.Tensor, update: torch.Tensor, parents: torch.Tensor, child0: torch.Tensor,
                   child1: torch.Tensor, shift: int, moduli: tuple, out=None, doubled=None) -> None:
    """pool [slots, ..., L, N], update [n, ..., L, N] (both contiguous),
    parents / child0 / child1 [n] int64 slot indices: writes
    p0 = update + pool[parents] to child0 and
    p1 = (pool[parents] - update) * x^-shift to child1 in place. With
    `out` [outputs, ..., L, N] (contiguous) the level writes leaves: a
    negative child c is the leaf at output position -c - 1, written as
    2 p mod q where `doubled` (bool [2, n], contiguous: the first
    children's flags, then the second's; None where no leaf is doubled)
    says so; the kernel's leaf instance launches and counts as
    expand_leaves. The children must be distinct and differ from the
    parent slots (ops/key_switch.check_level_slots, which the expansion's
    plan passes): the kernel writes children while other blocks still
    read parents."""
    if not 0 < shift < update.shape[-1]:
        raise ValueError(f"expand_combine takes a shift in (0, N), got {shift}")
    _check_contiguous(pool, "pool")
    _check_contiguous(update, "update")
    L, degree = len(moduli), update.shape[-1]
    log2n = _check_moduli(moduli, degree)
    if update.dim() < 3 or tuple(update.shape[-2:]) != (L, degree) or tuple(pool.shape[1:]) != tuple(update.shape[1:]):
        raise ValueError(f"pool [slots, ..., {L}, {degree}] and update [n, ...] must agree, got "
                         f"{tuple(pool.shape)} and {tuple(update.shape)}")
    n = update.shape[0]
    for idx in (parents, child0, child1):
        _check_index(idx, pool.shape[0], pool.device)
        if idx.numel() != n:
            raise ValueError(f"{idx.numel()} slot indices for {n} updates")
    if update.device != pool.device:
        raise ValueError(f"update on {update.device}, pool on {pool.device}")
    if out is not None:
        _check_contiguous(out, "out")
        if tuple(out.shape[1:]) != tuple(pool.shape[1:]) or out.device != pool.device:
            raise ValueError(f"out [outputs, ...] must match the pool's slots and device, got {tuple(out.shape)} on "
                             f"{out.device}")
    if doubled is not None:
        if out is None:
            raise ValueError("a doubling mask needs out")
        if doubled.dtype != torch.bool or tuple(doubled.shape) != (2, n) or not doubled.is_contiguous():
            raise ValueError(f"doubled must be a contiguous bool [2, {n}] tensor")
        if doubled.device != pool.device:
            raise ValueError(f"doubled on {doubled.device}, pool on {pool.device}")
    inner = update[0].numel() // degree if n else 0  # rows of a slot
    if n and inner:
        err = _library().she_expand_combine(pool.data_ptr(), None if out is None else out.data_ptr(),
                                            update.data_ptr(), parents.data_ptr(), child0.data_ptr(),
                                            child1.data_ptr(), None if doubled is None else doubled.data_ptr(), n,
                                            inner, L, log2n, shift, constants(moduli, pool.device).data_ptr(),
                                            _stream())
        _raise_on(err, "expand_combine")
    if out is None:
        if trace.launch("expand_combine"):
            trace.count_shape("expand_combine", KsKey("expand_combine", tuple(update.shape), moduli,
                                                      (shift, pool.shape[0])))
    elif trace.launch("expand_leaves"):
        trace.count_shape("expand_leaves", KsKey("expand_leaves", tuple(update.shape), moduli,
                                                 (shift, pool.shape[0], out.shape[0], doubled is not None)))


@lru_cache(maxsize=None)
def mod_switch_constants(moduli: tuple, target: int, device: torch.device) -> torch.Tensor:
    """The mod switch's drops' tables, one after another (the order the
    kernel drops in): for L = len(moduli) down to target + 1, the L rows of
    constants(moduli[:L]), whose first L - 1 rows divide and round by
    moduli[L - 1], as PolyContext.next walks the chain."""
    return torch.cat([constants(moduli[:count], device) for count in range(len(moduli), target, -1)])


class _ModSwitchLaunch(NamedTuple):
    """What a mod switch's launch shape needs beside its input's and
    output's pointers, made once per shape: its key, the output's shape,
    the Operand (its base filled in at each call) and the C call's
    arguments."""

    key: KsKey
    out_shape: tuple
    op: Operand
    args: list


@lru_cache(maxsize=1024)
def _mod_switch_launch(shape: tuple, strides: tuple, moduli: tuple, target: int) -> _ModSwitchLaunch:
    L, degree = len(moduli), shape[-1]
    log2n = _check_moduli(moduli, degree)
    if not 1 <= target < L <= MAX_MOD_SWITCH_MODULI:
        raise ValueError(f"mod_switch takes {MAX_MOD_SWITCH_MODULI} >= L > target >= 1, got L = {L}, target {target}")
    op, batch = layout(shape, strides, L, degree, "x")
    args = [ctypes.byref(op), None, prod(batch), L, target, log2n, None, None]
    return _ModSwitchLaunch(KsKey("mod_switch", shape, moduli, (target, strides)), batch + (target, degree), op, args)


def mod_switch(x: torch.Tensor, moduli: tuple, target: int) -> torch.Tensor:
    """x [..., L, N] over `moduli` (Coeff; read in place) -> [..., target, N]:
    divided and rounded by the last modulus L - target times, in one
    launch. The launch is made once per shape (_mod_switch_launch)."""
    moduli = tuple(moduli)
    _check_tensor(x, "x")
    launch = _mod_switch_launch(tuple(x.shape), x.stride(), moduli, target)
    if x.data_ptr() % 16:
        raise ValueError("x needs even strides and a 16-byte aligned base")
    out = torch.empty(launch.out_shape, dtype=torch.int64, device=x.device)
    if out.numel():
        launch.op.base = x.data_ptr()
        args = launch.args
        args[1], args[6], args[7] = out.data_ptr(), mod_switch_constants(moduli, target, x.device).data_ptr(), _stream()
        _raise_on(_library().she_mod_switch(*args), "mod_switch")
    if trace.launch("mod_switch"):
        trace.count_shape("mod_switch", launch.key)
    return out
