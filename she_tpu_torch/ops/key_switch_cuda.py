"""Launch wrappers for the key-switch kernels (csrc/key_switch.cu).

The kernels replace the passes that she_tpu leaves to XLA to fuse in a key
switch (she_tpu/bfv/keys.py:270-363, ops/galois.py:61, core/poly.py:207,
bfv/bfv.py:796-840) and in an expansion level (pir/serving.py:160-171:
the combine, and the leaves written by its leaf instance);
ops/key_switch.py holds their plain versions and the dispatch. Each
wrapper checks its operands, allocates its output with torch.empty,
launches on torch.cuda.current_stream() and raises if the launch reports a
CUDA error; there is no fallback. `launches` counts each kernel's launches
and `launch_shapes` counts them by KsKey, so a run can show that its key
switches went through the kernels and time each shape it used.

An operand the kernels read in place (c1, c0 and the source's c1, which
may be views of a stacked ciphertext or of the expansion's slot pool) is
passed as its base pointer with the sizes and strides of its batch axes
(at most MAX_BATCH_AXES), the stride of its RNS axis and, for the slot
pool, an index array that maps axis 0; its last axis must be contiguous,
its strides even and its base 16-byte aligned (the kernels load two
coefficients at a time). The moduli's constants (q, floor(2^128 / q),
and for the divide-and-round floor(q_ks / 2) mod q_i and q_ks^-1 mod q_i
with its Shoup constant) are made on the host once per moduli and device.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from functools import lru_cache
from typing import NamedTuple

import torch

from ..utils import nt
from . import kernel_build

MAX_LOG2N = 13
MAX_MODULUS = 1 << 62
MAX_BATCH_AXES = 6
CONST_WORDS = 8  # per modulus: q, r_lo, r_hi, half mod q, q_ks^-1 mod q, its Shoup constant, 0, 0
COMPS = 2  # the components of every key-switching key (bfv/keys.KeySwitchKey)


class KsKey(NamedTuple):
    """What a launch is counted by in `launch_shapes`: the kernel, the
    shape of its main input (c1 as read, fwd, inv, the update), the
    key-switching moduli (the ciphertext moduli for expand_combine) and
    the kernel's variant: (element, slots) for ks_digits, () for ks_mac,
    (element, c0 given, c1 given, slots) for ks_finish, (shift, slots) for
    expand_combine, (shift, slots, outputs, a doubling mask given) for
    its leaf instance, expand_leaves; slots is the size of an indexed
    operand's axis 0, else None."""

    name: str
    shape: tuple
    moduli: tuple
    variant: tuple


launches = {"ks_digits": 0, "ks_mac": 0, "ks_finish": 0, "expand_combine": 0, "expand_leaves": 0}
launch_shapes: Counter = Counter()


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
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    launch_shapes.clear()


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
    its Shoup constant floor(q_last^-1 * 2^64 / q_i)."""
    q_last = moduli[-1]
    rows = []
    for i, q in enumerate(moduli):
        ratio = (1 << 128) // q
        row = [q, ratio & ((1 << 64) - 1), ratio >> 64, 0, 0, 0, 0, 0]
        if i < len(moduli) - 1:
            inv = nt.inverse_mod(q_last % q, q)
            row[3:6] = [(q_last >> 1) % q, inv, (inv << 64) // q]
        rows.append([_signed(v) for v in row])
    return torch.tensor(rows, dtype=torch.int64, device=device)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check_tensor(x: torch.Tensor, what: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what} must be a tensor")
    if x.dtype != torch.int64:
        raise TypeError(f"{what} must be int64, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {x.device}")


def _check_contiguous(x: torch.Tensor, what: str) -> None:
    _check_tensor(x, what)
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


def _check_index(index, slots: int, device) -> None:
    if index.dtype != torch.int64 or index.dim() != 1 or not index.is_contiguous():
        raise ValueError("an index must be a contiguous 1-D int64 tensor")
    if index.device != device:
        raise ValueError(f"index on {index.device}, data on {device}")


def operand(x: torch.Tensor, L: int, degree: int, index=None, what: str = "operand") -> tuple:
    """The Operand of x [batch..., L, N] read in place, and the shape of
    the batch as the kernel sees it (axis 0 replaced by the index's
    length where an index is given)."""
    _check_tensor(x, what)
    if x.dim() < 2 or tuple(x.shape[-2:]) != (L, degree):
        raise ValueError(f"{what} must be [..., {L}, {degree}], got {tuple(x.shape)}")
    batch, strides = list(x.shape[:-2]), list(x.stride()[:-2])
    if x.stride(-1) != 1:
        raise ValueError(f"{what} needs a contiguous last axis")
    if any(s % 2 for n, s in zip(batch, strides) if n != 1) or x.stride(-2) % 2 or x.data_ptr() % 16:
        raise ValueError(f"{what} needs even strides and a 16-byte aligned base")
    if index is not None:
        if not batch:
            raise ValueError(f"an indexed {what} needs a batch axis")
        _check_index(index, batch[0], x.device)
        batch[0] = index.numel()
    if len(batch) > MAX_BATCH_AXES:
        raise ValueError(f"{what} has {len(batch)} batch axes, the kernels take {MAX_BATCH_AXES}")
    op = Operand()
    op.base = x.data_ptr()
    op.nd = len(batch)
    for d, (n, s) in enumerate(zip(batch, strides)):
        op.size[d], op.stride[d] = n, s
    op.index = None if index is None else index.data_ptr()
    op.lstride = x.stride(-2)
    return op, tuple(batch)


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
    launches["ks_digits"] += 1
    launch_shapes[KsKey("ks_digits", batch + (L_ks - 1, degree), moduli,
                        (element, None if index is None else c1.shape[0]))] += 1
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
    launches["ks_mac"] += 1
    launch_shapes[KsKey("ks_mac", tuple(fwd.shape), moduli, ())] += 1
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
    launches["ks_finish"] += 1
    slots = None if index is None else c0.shape[0]
    launch_shapes[KsKey("ks_finish", tuple(inv.shape), moduli, (element, c0 is not None, c1 is not None, slots))] += 1
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
        launches["expand_combine"] += 1
        launch_shapes[KsKey("expand_combine", tuple(update.shape), moduli, (shift, pool.shape[0]))] += 1
    else:
        launches["expand_leaves"] += 1
        launch_shapes[KsKey("expand_leaves", tuple(update.shape), moduli,
                            (shift, pool.shape[0], out.shape[0], doubled is not None))] += 1
